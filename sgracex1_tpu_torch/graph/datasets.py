"""Datasets: synthetic generators (node classification, MUTAG-shaped
molecules, PPI-shaped multi-label graphs) and parsers of the file formats
the reference trains on (Planetoid, TU, OGB, Amazon, PPI).

Each generator draws from one ``numpy.random.default_rng(seed)`` stream in
the same order as ``sgracex1_tpu.graph.datasets``, so one seed gives the
identical graph, features, labels and splits in both packages. The
parsers read files already on disk (nothing is fetched) and give the JAX
parsers' arrays; a missing file raises.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import List, Tuple

import numpy as np

from sgracex1_tpu_torch.graph.batch import GraphSample
from sgracex1_tpu_torch.graph.csr import unique_sorted


@dataclasses.dataclass(frozen=True)
class NodeClassificationData:
    """One graph + node labels + split masks (Planetoid-style)."""

    edge_index: np.ndarray  # [2, E]
    x: np.ndarray  # [N, F]
    y: np.ndarray  # int[N]
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_features(self) -> int:
        return self.x.shape[1]

    @property
    def num_classes(self) -> int:
        return int(self.y.max()) + 1


def sbm_node_classification(
    n: int = 400,
    num_classes: int = 4,
    num_features: int = 32,
    p_in: float = 0.06,
    p_out: float = 0.005,
    feature_noise: float = 1.0,
    seed: int = 0,
    train_frac: float = 0.6,
    val_frac: float = 0.2,
) -> NodeClassificationData:
    """Stochastic-block-model graph with class-correlated, sparse,
    non-negative features."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, n)
    same = y[:, None] == y[None, :]
    p = np.where(same, p_in, p_out)
    upper = np.triu(rng.random((n, n)) < p, k=1)
    adj = upper | upper.T
    rows, cols = np.nonzero(adj)
    edge_index = np.stack([rows, cols]).astype(np.int64)

    centers = rng.random((num_classes, num_features)) * 2.0
    x = centers[y] + feature_noise * rng.random((n, num_features))
    x = np.maximum(x - 1.0, 0.0).astype(np.float32)

    perm = rng.permutation(n)
    n_tr, n_va = int(n * train_frac), int(n * val_frac)
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[perm[:n_tr]] = True
    val_mask[perm[n_tr : n_tr + n_va]] = True
    test_mask[perm[n_tr + n_va :]] = True
    return NodeClassificationData(edge_index, x, y, train_mask, val_mask, test_mask)


def synthetic_molecules(
    num_graphs: int = 188,
    num_features: int = 7,
    seed: int = 0,
) -> List[GraphSample]:
    """MUTAG-shaped graph-classification set: class = cycle vs tree motif,
    one-hot node-type features (MUTAG has 7 atom types, 188 graphs)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(num_graphs):
        label = int(rng.random() < 0.5)
        n = int(rng.integers(10, 28))
        if label == 1:
            # ring + pendant nodes
            ring = max(3, n - int(rng.integers(0, 5)))
            src = np.arange(ring)
            dst = (src + 1) % ring
            extra_s = rng.integers(0, ring, n - ring)
            extra_d = np.arange(ring, n)
            rows = np.concatenate([src, extra_s])
            cols = np.concatenate([dst, extra_d])
        else:
            # random tree
            rows = np.array([rng.integers(0, k) for k in range(1, n)])
            cols = np.arange(1, n)
        ei = np.stack([np.concatenate([rows, cols]), np.concatenate([cols, rows])]).astype(np.int64)
        types = rng.integers(0, num_features, n)
        x = np.eye(num_features, dtype=np.float32)[types]
        graphs.append(GraphSample(edge_index=ei, x=x, y=label))
    return graphs


@dataclasses.dataclass(frozen=True)
class MultiLabelGraphData:
    """One graph with multi-label node targets (the PPI-style inductive
    task: whole graphs are held out for val and test)."""

    edge_index: np.ndarray  # [2, E]
    x: np.ndarray  # [N, F]
    y: np.ndarray  # float32 [N, C] multi-hot

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_features(self) -> int:
        return self.x.shape[1]

    @property
    def num_labels(self) -> int:
        return self.y.shape[1]


def synthetic_ppi(
    num_graphs: int = 8,
    n_per: int = 192,
    num_features: int = 32,
    num_labels: int = 12,
    seed: int = 0,
    splits: Tuple[int, int] = (2, 2),
) -> Tuple[List[MultiLabelGraphData], List[MultiLabelGraphData], List[MultiLabelGraphData]]:
    """PPI-shaped multi-graph multi-label set: overlapping community
    memberships are the labels, features a noisy linear image of them,
    and edges prefer nodes that share communities. Returns (train, val,
    test) lists of whole graphs, ``splits`` = (val, test) counts."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((num_labels, num_features)).astype(np.float32)
    graphs = []
    for _ in range(num_graphs):
        m = (rng.random((n_per, num_labels)) < 0.25).astype(np.float32)
        # every node gets at least one label
        empty = m.sum(1) == 0
        m[empty, rng.integers(0, num_labels, int(empty.sum()))] = 1.0
        shared = m @ m.T
        p = 0.02 + 0.05 * (shared > 0) + 0.02 * np.minimum(shared, 3)
        upper = np.triu(rng.random((n_per, n_per)) < p, k=1)
        adj = upper | upper.T
        rows, cols = np.nonzero(adj)
        x = (m @ centers + 0.5 * rng.standard_normal((n_per, num_features))).astype(np.float32)
        graphs.append(MultiLabelGraphData(
            edge_index=np.stack([rows, cols]).astype(np.int64), x=x, y=m,
        ))
    n_val, n_test = splits
    n_train = num_graphs - n_val - n_test
    return graphs[:n_train], graphs[n_train : n_train + n_val], graphs[n_train + n_val :]


def powerlaw_node_classification(
    n: int = 65536,
    avg_degree: int = 16,
    num_classes: int = 16,
    num_features: int = 100,
    alpha: float = 1.6,
    seed: int = 0,
) -> NodeClassificationData:
    """ogbn-products-shaped synthetic graph: Chung-Lu edges with power-law
    expected degrees (exponent ``alpha``), homophilous rewiring, community
    labels and class-correlated Gaussian features."""
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1) ** (-1.0 / (alpha - 1.0))).astype(np.float64)
    w *= n * avg_degree / w.sum()
    y = rng.integers(0, num_classes, n)

    e_target = n * avg_degree // 2
    p = w / w.sum()
    src = rng.choice(n, size=e_target, p=p)
    dst = rng.choice(n, size=e_target, p=p)
    same = rng.random(e_target) < 0.5
    cls_nodes = [np.nonzero(y == c)[0] for c in range(num_classes)]
    rewire = same & (y[src] != y[dst])
    if rewire.any():
        dst = dst.copy()
        dst[rewire] = np.concatenate(
            [
                rng.choice(cls_nodes[c], size=int(cnt))
                for c, cnt in zip(*np.unique(y[src[rewire]],
                                             return_counts=True))
            ]
        )
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # symmetrize + dedupe via int64 keys (lexsorted edge list)
    k = unique_sorted(
        np.concatenate(
            [src.astype(np.int64) * n + dst, dst.astype(np.int64) * n + src]
        )
    )
    und = np.stack([k // n, k % n])

    centers = rng.standard_normal((num_classes, num_features)).astype(
        np.float32
    )
    x = (centers[y] + rng.standard_normal((n, num_features))).astype(
        np.float32
    )
    perm = rng.permutation(n)
    masks = np.zeros((3, n), bool)
    masks[0, perm[: int(n * 0.6)]] = True
    masks[1, perm[int(n * 0.6) : int(n * 0.8)]] = True
    masks[2, perm[int(n * 0.8) :]] = True
    return NodeClassificationData(und, x, y.astype(np.int64), *masks)


def products_density_graph(
    n: int = 1 << 22,
    *,
    tail_degree: int = 16,
    ring: int = 12,
    num_classes: int = 16,
    num_features: int = 8,
    seed: int = 0,
) -> NodeClassificationData:
    """ogbn-products-density synthetic graph: ring-lattice community edges
    (``2 * ring`` a node, products' strong locality) plus the Chung-Lu
    power-law tail of ``powerlaw_node_classification``. At the defaults and
    n = 2^22 it holds ~121 M directed edges, ~29 a node: ogbn-products'
    density class (123.7 M), which Chung-Lu alone cannot reach (hub dedup
    holds its real degree near 17)."""
    base = powerlaw_node_classification(
        n=n, avg_degree=tail_degree, num_classes=num_classes,
        num_features=num_features, seed=seed,
    )
    i = np.arange(n, dtype=np.int64)
    offs = np.arange(1, ring + 1, dtype=np.int64)
    src = np.repeat(i, ring)
    dst = (src + np.tile(offs, n)) % n
    ei = np.concatenate([base.edge_index, np.stack([src, dst])], axis=1)
    k = unique_sorted(np.concatenate([ei[0] * n + ei[1], ei[1] * n + ei[0]]))
    und = np.stack([k // n, k % n])
    return NodeClassificationData(
        und, base.x, base.y, base.train_mask, base.val_mask, base.test_mask,
    )


# ------------------------------------------------------ file-format parsers


def load_ppi(root: str, split: str = "train") -> List[MultiLabelGraphData]:
    """The PPI raw format: ``{split}_graph.json`` (networkx node-link),
    ``{split}_feats.npy`` [N, 50], ``{split}_labels.npy`` [N, 121] and
    ``{split}_graph_id.npy`` [N]. One ``MultiLabelGraphData`` per protein
    graph, its edges symmetrized."""
    import json

    with open(os.path.join(root, f"{split}_graph.json")) as f:
        g = json.load(f)
    feats = np.load(os.path.join(root, f"{split}_feats.npy"))
    labels = np.load(os.path.join(root, f"{split}_labels.npy"))
    gid = np.load(os.path.join(root, f"{split}_graph_id.npy"))

    src = np.array([link["source"] for link in g["links"]], dtype=np.int64)
    dst = np.array([link["target"] for link in g["links"]], dtype=np.int64)
    # the file stores each undirected edge once
    und = np.unique(np.concatenate([np.stack([src, dst]), np.stack([dst, src])], axis=1), axis=1)
    graphs = []
    for gi in np.unique(gid):
        nodes = np.nonzero(gid == gi)[0]
        lo, hi = nodes[0], nodes[-1]
        em = (und[0] >= lo) & (und[0] <= hi)
        graphs.append(MultiLabelGraphData(
            edge_index=(und[:, em] - lo).astype(np.int64),
            x=feats[nodes].astype(np.float32),
            y=labels[nodes].astype(np.float32),
        ))
    return graphs


def load_planetoid(root: str, name: str) -> NodeClassificationData:
    """The raw Planetoid format (``ind.<name>.{x,y,tx,ty,allx,ally,graph,
    test.index}``) of Cora, Citeseer and Pubmed: test node
    ``test.index[i]`` gets row i of ``tx`` / ``ty``. The files are
    pickles: load them only from a source you trust.

    Citeseer's test index skips its isolated nodes, which get zero
    features and labels (the row of class 0). The JAX parser stretches
    the test index itself over that range, so its reorder assigns rows of
    unequal count and raises, and it skips the reorder where the range
    has no gap; this parser keeps the file's index, as PyG does. Cora and
    Pubmed give the JAX parser's arrays."""
    import scipy.sparse as sp

    name = name.lower()

    def read(suffix):
        path = os.path.join(root, f"ind.{name}.{suffix}")
        if suffix == "test.index":
            return np.loadtxt(path, dtype=np.int64)
        with open(path, "rb") as f:
            return pickle.load(f, encoding="latin1")

    x, y, tx, ty, allx, ally, graph = (read(s) for s in ["x", "y", "tx", "ty", "allx", "ally", "graph"])
    test_idx = read("test.index")
    test_sorted = np.sort(test_idx)

    if name == "citeseer":  # isolated test nodes: reindex over the full range
        full = np.arange(test_sorted[0], test_sorted[-1] + 1)
        tx_full = sp.lil_matrix((len(full), x.shape[1]))
        tx_full[test_sorted - test_sorted[0]] = tx
        tx = tx_full
        ty_full = np.zeros((len(full), y.shape[1]))
        ty_full[test_sorted - test_sorted[0]] = ty
        ty = ty_full

    features = sp.vstack([allx, tx]).tolil()
    features[test_idx] = features[test_sorted]
    labels = np.vstack([ally, ty])
    labels[test_idx] = labels[test_sorted]

    n = labels.shape[0]
    rows = [src for src, dsts in graph.items() for _ in dsts]
    cols = [d for dsts in graph.values() for d in dsts]
    edge_index = np.stack([np.array(rows), np.array(cols)]).astype(np.int64)
    edge_index = np.unique(np.concatenate([edge_index, edge_index[::-1]], axis=1), axis=1)

    masks = np.zeros((3, n), bool)
    masks[0, : y.shape[0]] = True
    masks[1, y.shape[0] : y.shape[0] + 500] = True
    masks[2, test_sorted] = True
    return NodeClassificationData(
        edge_index, np.asarray(features.todense(), dtype=np.float32),
        labels.argmax(axis=1).astype(np.int64), *masks,
    )


def load_tu_dataset(root: str, name: str = "MUTAG") -> List[GraphSample]:
    """The TU graph-kernel format (``{name}_A.txt``, ``_graph_indicator``,
    ``_graph_labels``, ``_node_labels``) under ``root/name/raw`` or
    ``root``; node labels one-hot, graph labels ``> 0`` as 1."""
    pre = os.path.join(root, name, "raw", name)
    if not os.path.exists(pre + "_A.txt"):
        pre = os.path.join(root, name)
    edges = np.loadtxt(pre + "_A.txt", delimiter=",", dtype=np.int64) - 1
    gid = np.loadtxt(pre + "_graph_indicator.txt", dtype=np.int64) - 1
    glabels = (np.loadtxt(pre + "_graph_labels.txt", dtype=np.int64) > 0).astype(np.int64)
    nlabels = np.loadtxt(pre + "_node_labels.txt", dtype=np.int64)
    num_types = int(nlabels.max()) + 1

    graphs = []
    for g in range(int(gid.max()) + 1):
        nodes = np.nonzero(gid == g)[0]
        emask = (gid[edges[:, 0]] == g) & (gid[edges[:, 1]] == g)
        ei = (edges[emask] - nodes[0]).T.astype(np.int64)
        x = np.eye(num_types, dtype=np.float32)[nlabels[nodes]]
        graphs.append(GraphSample(edge_index=ei, x=x, y=int(glabels[g])))
    return graphs


def _index_masks(n: int, *idxs) -> list:
    masks = []
    for idx in idxs:
        m = np.zeros(n, bool)
        m[idx] = True
        masks.append(m)
    return masks


def load_ogb_node(root: str) -> NodeClassificationData:
    """An OGB node-property dataset (e.g. ogbn-products) on disk:
    ``{root}/processed.npz`` (edge_index, x, y, train_idx, valid_idx,
    test_idx; ``convert_ogb_raw`` writes it) where it exists, else OGB's
    raw layout through ``convert_ogb_raw``."""
    proc = os.path.join(root, "processed.npz")
    if not os.path.exists(proc):
        return convert_ogb_raw(root)
    z = np.load(proc)
    masks = _index_masks(z["x"].shape[0], z["train_idx"], z["valid_idx"], z["test_idx"])
    return NodeClassificationData(
        z["edge_index"], z["x"].astype(np.float32), z["y"].reshape(-1).astype(np.int64), *masks
    )


def convert_ogb_raw(root: str, save: bool = True) -> NodeClassificationData:
    """OGB's raw files: ``raw/edge.csv.gz`` (src,dst rows, symmetrized
    here), ``raw/node-feat.csv.gz``, ``raw/node-label.csv.gz`` and the
    first ``split/*/{train,valid,test}.csv.gz``; with ``save``, cached as
    ``processed.npz``."""
    import glob
    import gzip

    def read_csv_gz(path, dtype):
        with gzip.open(path, "rt") as f:
            return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)

    raw = os.path.join(root, "raw")
    edges = read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64)
    x = read_csv_gz(os.path.join(raw, "node-feat.csv.gz"), np.float32)
    y = read_csv_gz(os.path.join(raw, "node-label.csv.gz"), np.int64).reshape(-1)
    ei = np.concatenate([edges.T, edges.T[::-1]], axis=1)

    split_dirs = sorted(glob.glob(os.path.join(root, "split", "*")))
    if not split_dirs:
        raise FileNotFoundError(f"no split directory under {root}/split")
    idxs = {
        k: read_csv_gz(os.path.join(split_dirs[0], f"{k}.csv.gz"), np.int64).reshape(-1)
        for k in ("train", "valid", "test")
    }
    if save:
        np.savez_compressed(
            os.path.join(root, "processed.npz"), edge_index=ei, x=x, y=y,
            train_idx=idxs["train"], valid_idx=idxs["valid"], test_idx=idxs["test"],
        )
    masks = _index_masks(x.shape[0], idxs["train"], idxs["valid"], idxs["test"])
    return NodeClassificationData(ei, x, y, *masks)


def load_amazon(
    path: str, *, train_frac: float = 0.6, val_frac: float = 0.2, seed: int = 0,
) -> NodeClassificationData:
    """The Amazon Photo/Computers npz (Shchur et al.: CSR adjacency, CSR
    bag-of-words attributes, labels), edges symmetrized, with the random
    split of ``default_rng(seed)`` that the JAX parser draws."""
    import scipy.sparse as sp

    z = np.load(path, allow_pickle=True)
    adj = sp.csr_matrix((z["adj_data"], z["adj_indices"], z["adj_indptr"]), shape=tuple(z["adj_shape"]))
    attr = sp.csr_matrix((z["attr_data"], z["attr_indices"], z["attr_indptr"]), shape=tuple(z["attr_shape"]))
    y = z["labels"].astype(np.int64)
    coo = adj.tocoo()
    ei = np.stack([coo.row, coo.col]).astype(np.int64)
    und = np.unique(np.concatenate([ei, ei[::-1]], axis=1), axis=1)

    n = attr.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    n_tr, n_va = int(n * train_frac), int(n * val_frac)
    masks = _index_masks(n, perm[:n_tr], perm[n_tr : n_tr + n_va], perm[n_tr + n_va :])
    return NodeClassificationData(und, np.asarray(attr.todense(), dtype=np.float32), y, *masks)
