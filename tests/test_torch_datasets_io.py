"""The dataset parsers of sgracex1_tpu_torch.graph.datasets against those
of sgracex1_tpu.graph.datasets, on small files in each format that the
tests write themselves (nothing is fetched): every array equal, and a
missing file raises in both."""

import gzip
import json
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp

from sgracex1_tpu.graph import datasets as j_ds
from sgracex1_tpu_torch.graph import datasets as t_ds


def _same_node_data(a, b):
    for f in ("edge_index", "x", "y", "train_mask", "val_mask", "test_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _write_planetoid(root, name, rng, n_train=20, n_rest=140, n_test=40, gaps=0, F=30, C=5):
    """ind.<name>.* pickles: ``gaps`` nodes of the test range are left out
    of the test index (citeseer's isolated test nodes). Returns the test
    index in the file's order and the pickled parts."""
    n_all = n_rest + n_train  # allx/ally cover the training and the other labelled nodes
    span = np.arange(n_all, n_all + n_test + gaps)
    inner = rng.choice(span[1:-1], n_test - 2, replace=False)
    test_idx = np.sort(np.r_[span[0], inner, span[-1]]) if gaps else span  # the range's ends are test nodes
    feats = lambda k: sp.csr_matrix((rng.random((k, F)) < 0.2).astype(np.float32))
    onehot = lambda k: np.eye(C)[rng.integers(0, C, k)]
    n = n_all + n_test + gaps
    graph = {i: sorted(set(rng.integers(0, n, 3).tolist()) - {i}) for i in range(n)}
    parts = dict(x=feats(n_train), y=onehot(n_train), allx=feats(n_all), ally=onehot(n_all),
                 tx=feats(n_test), ty=onehot(n_test), graph=graph)
    for k, v in parts.items():
        with open(os.path.join(root, f"ind.{name}.{k}"), "wb") as f:
            pickle.dump(v, f)
    order = rng.permutation(test_idx)  # the index file lists the test nodes unsorted, one a line
    np.savetxt(os.path.join(root, f"ind.{name}.test.index"), order, fmt="%d")
    return order, parts


@pytest.mark.parametrize("name", ["cora", "pubmed"])
def test_planetoid_matches_jax(tmp_path, name):
    order, parts = _write_planetoid(str(tmp_path), name, np.random.default_rng(0))
    got = t_ds.load_planetoid(str(tmp_path), name.upper())
    _same_node_data(got, j_ds.load_planetoid(str(tmp_path), name))
    np.testing.assert_array_equal(got.x[order], parts["tx"].toarray())  # test node index[i] has row i
    assert got.num_nodes == 200 and got.test_mask.sum() == 40


def test_planetoid_citeseer_isolated_test_nodes(tmp_path):
    """Test node ``index[i]`` gets row i of tx / ty, the isolated nodes of
    the test range zeros; the JAX parser raises on such a file (its
    reorder assigns rows of unequal count, ROADMAP queue 3)."""
    order, parts = _write_planetoid(str(tmp_path), "citeseer", np.random.default_rng(0), gaps=7)
    got = t_ds.load_planetoid(str(tmp_path), "citeseer")
    assert got.num_nodes == 207 and got.x.dtype == np.float32 and got.y.dtype == np.int64
    np.testing.assert_array_equal(got.x[:160], parts["allx"].toarray())
    np.testing.assert_array_equal(got.y[:160], parts["ally"].argmax(1))
    np.testing.assert_array_equal(got.x[order], parts["tx"].toarray())
    np.testing.assert_array_equal(got.y[order], parts["ty"].argmax(1))
    iso = np.setdiff1d(np.arange(160, 207), order)
    assert len(iso) == 7 and not got.x[iso].any() and not got.y[iso].any()
    np.testing.assert_array_equal(np.nonzero(got.test_mask)[0], np.sort(order))
    assert got.train_mask[:20].all() and got.train_mask.sum() == 20
    assert got.val_mask[20:207].all() and got.val_mask.sum() == 187  # y's 20, then up to 500
    e = got.edge_index
    np.testing.assert_array_equal(np.unique(e[::-1], axis=1), e)  # symmetric, deduplicated
    with pytest.raises(ValueError):
        j_ds.load_planetoid(str(tmp_path), "citeseer")


def _write_tu(root, name, rng, graphs=6):
    sizes = rng.integers(4, 9, graphs)
    gid = np.repeat(np.arange(graphs), sizes)
    lo = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    edges = []
    for g, (s, n) in enumerate(zip(lo, sizes)):
        a, b = rng.integers(0, n, (2, 2 * n))
        edges += [(s + i + 1, s + j + 1) for i, j in zip(a, b) if i != j]
        edges += [(s + j + 1, s + i + 1) for i, j in zip(a, b) if i != j]
    os.makedirs(root, exist_ok=True)
    pre = os.path.join(root, name)
    np.savetxt(pre + "_A.txt", np.array(edges), fmt="%d", delimiter=", ")
    np.savetxt(pre + "_graph_indicator.txt", gid + 1, fmt="%d")
    np.savetxt(pre + "_graph_labels.txt", rng.choice([-1, 1], graphs), fmt="%d")
    np.savetxt(pre + "_node_labels.txt", rng.integers(0, 7, len(gid)), fmt="%d")


@pytest.mark.parametrize("layout", ["raw", "flat"])
def test_tu_dataset_matches_jax(tmp_path, layout):
    root = os.path.join(tmp_path, "MUTAG", "raw") if layout == "raw" else str(tmp_path)
    _write_tu(root, "MUTAG", np.random.default_rng(1))
    got, want = t_ds.load_tu_dataset(str(tmp_path)), j_ds.load_tu_dataset(str(tmp_path))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.y == b.y and a.y in (0, 1)
        for f in ("edge_index", "x"):
            assert getattr(a, f).dtype == getattr(b, f).dtype
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _write_ogb(root, rng, n=120, e=400, F=6):
    def csv_gz(path, arr, fmt):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with gzip.open(path, "wt") as f:
            np.savetxt(f, arr, fmt=fmt, delimiter=",")

    csv_gz(os.path.join(root, "raw", "edge.csv.gz"), rng.integers(0, n, (e, 2)), "%d")
    csv_gz(os.path.join(root, "raw", "node-feat.csv.gz"), rng.standard_normal((n, F)).astype(np.float32), "%.6f")
    csv_gz(os.path.join(root, "raw", "node-label.csv.gz"), rng.integers(0, 9, (n, 1)), "%d")
    perm = rng.permutation(n)
    for k, idx in (("train", perm[:70]), ("valid", perm[70:95]), ("test", perm[95:])):
        csv_gz(os.path.join(root, "split", "sales_ranking", f"{k}.csv.gz"), idx, "%d")


def test_ogb_raw_and_processed_match_jax(tmp_path):
    """``convert_ogb_raw`` on the raw csv.gz files, then ``load_ogb_node``
    through the ``processed.npz`` it wrote: both equal to the JAX
    parsers' results, and to each other."""
    root = str(tmp_path)
    _write_ogb(root, np.random.default_rng(2))
    want = j_ds.convert_ogb_raw(root, save=False)
    raw = t_ds.convert_ogb_raw(root, save=False)
    _same_node_data(raw, want)
    assert not os.path.exists(os.path.join(root, "processed.npz"))
    first = t_ds.load_ogb_node(root)  # no processed.npz yet: parses raw and writes it
    assert os.path.exists(os.path.join(root, "processed.npz"))
    _same_node_data(first, want)
    _same_node_data(t_ds.load_ogb_node(root), j_ds.load_ogb_node(root))
    _same_node_data(t_ds.load_ogb_node(root), want)


def test_ogb_without_split_raises(tmp_path):
    root = str(tmp_path)
    _write_ogb(root, np.random.default_rng(3))
    os.rename(os.path.join(root, "split"), os.path.join(root, "nosplit"))
    for fn in (t_ds.convert_ogb_raw, j_ds.convert_ogb_raw):
        with pytest.raises(FileNotFoundError):
            fn(root, save=False)


def test_amazon_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    n, F = 150, 40
    adj = sp.random(n, n, density=0.03, format="csr", random_state=5, dtype=np.float32)
    attr = sp.random(n, F, density=0.1, format="csr", random_state=6, dtype=np.float32)
    path = str(tmp_path / "amazon_electronics_photo.npz")
    np.savez(path, adj_data=adj.data, adj_indices=adj.indices, adj_indptr=adj.indptr, adj_shape=adj.shape,
             attr_data=attr.data, attr_indices=attr.indices, attr_indptr=attr.indptr, attr_shape=attr.shape,
             labels=rng.integers(0, 8, n))
    for kw in ({}, dict(train_frac=0.5, val_frac=0.1, seed=3)):
        got = t_ds.load_amazon(path, **kw)
        _same_node_data(got, j_ds.load_amazon(path, **kw))
    np.testing.assert_array_equal(np.unique(got.edge_index[::-1], axis=1), got.edge_index)  # symmetric


def _write_ppi(root, split, rng, sizes=(30, 25, 40), F=50, L=121):
    n = sum(sizes)
    gid = np.repeat(np.arange(len(sizes)), sizes) + 1
    lo = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    links = []
    for s, k in zip(lo, sizes):
        a, b = rng.integers(0, k, (2, 3 * k))
        links += [{"source": int(s + i), "target": int(s + j)} for i, j in zip(a, b)]
    with open(os.path.join(root, f"{split}_graph.json"), "w") as f:
        json.dump({"directed": False, "multigraph": False, "graph": {},
                   "nodes": [{"id": i} for i in range(n)], "links": links}, f)
    np.save(os.path.join(root, f"{split}_feats.npy"), rng.standard_normal((n, F)))
    np.save(os.path.join(root, f"{split}_labels.npy"), (rng.random((n, L)) < 0.3).astype(np.int64))
    np.save(os.path.join(root, f"{split}_graph_id.npy"), gid)


@pytest.mark.parametrize("split", ["train", "valid"])
def test_ppi_matches_jax(tmp_path, split):
    _write_ppi(str(tmp_path), split, np.random.default_rng(7))
    got, want = t_ds.load_ppi(str(tmp_path), split), j_ds.load_ppi(str(tmp_path), split)
    assert [g.num_nodes for g in got] == [30, 25, 40]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("edge_index", "x", "y"):
            assert getattr(a, f).dtype == getattr(b, f).dtype
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.edge_index.max() < a.num_nodes and a.num_labels == 121


@pytest.mark.parametrize("call", [
    lambda ds, d: ds.load_ppi(d, "test"),
    lambda ds, d: ds.load_planetoid(d, "pubmed"),
    lambda ds, d: ds.load_tu_dataset(d, "PROTEINS"),
    lambda ds, d: ds.load_ogb_node(d),
    lambda ds, d: ds.load_amazon(os.path.join(d, "amazon_electronics_computers.npz")),
])
def test_missing_files_raise(tmp_path, call):
    for ds in (t_ds, j_ds):
        with pytest.raises((FileNotFoundError, OSError)):
            call(ds, str(tmp_path))
