"""Synthetic node-classification graphs.

Each generator draws from one ``numpy.random.default_rng(seed)`` stream in
the same order as ``sgracex1_tpu.graph.datasets``, so one seed gives the
identical graph, features, labels and splits in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
    k = np.unique(
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
