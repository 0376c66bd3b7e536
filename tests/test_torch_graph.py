"""sgracex1_tpu_torch.graph against sgracex1_tpu.graph: the same numpy
inputs must give identical host arrays (exact equality)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sgracex1_tpu.graph import csr as j_csr
from sgracex1_tpu.graph import datasets as j_ds
from sgracex1_tpu.graph import normalize as j_norm
from sgracex1_tpu.graph import reorder as j_reorder
from sgracex1_tpu_torch.graph import csr as t_csr
from sgracex1_tpu_torch.graph import datasets as t_ds
from sgracex1_tpu_torch.graph import normalize as t_norm
from sgracex1_tpu_torch.graph import reorder as t_reorder

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _assert_same_matrix(a, b):
    for k in ("rows", "cols", "vals"):
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.shape == b.shape and a.nnz == b.nnz
    assert a.rows_sorted == b.rows_sorted


def _coo(rng, n=300, e=1500):
    r = rng.integers(0, n, e)
    c = rng.integers(0, n - 7, e)
    v = rng.standard_normal(e).astype(np.float32)
    return r, c, v, (n, n - 7)


@pytest.mark.parametrize("pad_to", [128, 64, 1000])
def test_from_coo_padding(pad_to):
    r, c, v, shape = _coo(np.random.default_rng(0))
    _assert_same_matrix(
        j_csr.SparseMatrix.from_coo(r, c, v, shape, pad_to=pad_to),
        t_csr.SparseMatrix.from_coo(r, c, v, shape, pad_to=pad_to),
    )
    # unsorted input kept as given
    _assert_same_matrix(
        j_csr.SparseMatrix.from_coo(r, c, v, shape, sort=False),
        t_csr.SparseMatrix.from_coo(r, c, v, shape, sort=False),
    )


def test_dense_scipy_transpose_roundtrip():
    rng = np.random.default_rng(1)
    d = rng.standard_normal((40, 30)) * (rng.random((40, 30)) < 0.1)
    d = d.astype(np.float32)
    J = j_csr.SparseMatrix.from_dense(d)
    T = t_csr.SparseMatrix.from_dense(d)
    _assert_same_matrix(J, T)
    _assert_same_matrix(
        j_csr.SparseMatrix.from_scipy(sp.csr_matrix(d)),
        t_csr.SparseMatrix.from_scipy(sp.csr_matrix(d)),
    )
    np.testing.assert_array_equal(T.to_dense(), d)
    np.testing.assert_array_equal(T.to_scipy().toarray(), d)
    np.testing.assert_array_equal(T.transpose().to_dense(), d.T)
    assert not T.transpose().rows_sorted
    Td = T.to("cpu")
    assert isinstance(Td.rows, torch.Tensor) and Td.rows.dtype == torch.int32
    np.testing.assert_array_equal(Td.to_dense(), d)
    W = T.with_vals(np.asarray(T.vals) * 2)
    np.testing.assert_array_equal(W.to_dense(), 2 * d)
    with pytest.raises(ValueError):
        T.with_vals(np.zeros(3, np.float32))


@pytest.mark.parametrize(
    "fill,weighted", [(0.0, False), (1.0, False), (0.5, True)]
)
def test_sym_norm(fill, weighted):
    rng = np.random.default_rng(2)
    n = 500
    ei = np.unique(rng.integers(0, n, (2, 3000)), axis=1)
    w = rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32) if weighted else None
    _assert_same_matrix(
        j_norm.sym_norm(ei, n, w, fill), t_norm.sym_norm(ei, n, w, fill)
    )
    for a, b in zip(
        j_norm.add_self_loops(ei, w, n, fill), t_norm.add_self_loops(ei, w, n, fill)
    ):
        np.testing.assert_array_equal(a, b)


def _rank1_inputs():
    rng = np.random.default_rng(3)
    n = 400
    ei = np.unique(rng.integers(0, n, (2, 2400)), axis=1)
    normed = t_norm.sym_norm(ei, n)
    # general rank-1 values (not the degree seed): v = s_r[r] * s_c[c]
    r, c = ei
    s_r = rng.uniform(0.1, 3.0, n)
    s_c = rng.uniform(0.1, 3.0, n)
    rank1 = t_csr.SparseMatrix.from_coo(
        r, c, (s_r[r] * s_c[c]).astype(np.float32), (n, n)
    )
    weighted = t_csr.SparseMatrix.from_coo(
        r, c, rng.uniform(0.5, 2.0, len(r)).astype(np.float32), (n, n)
    )
    return {"sym_norm": normed, "rank1": rank1, "weighted": weighted}


@pytest.mark.parametrize("case", ["sym_norm", "rank1", "weighted"])
def test_rank1_factor(case):
    T = _rank1_inputs()[case]
    J = j_csr.SparseMatrix.from_coo(
        T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape
    )
    a, b = j_norm.rank1_factor(J), t_norm.rank1_factor(T)
    if case == "weighted":
        assert a is None and b is None
        return
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_degree_order_and_permute():
    d = t_ds.powerlaw_node_classification(n=3000, num_features=4, seed=5)
    J = j_norm.sym_norm(d.edge_index, d.num_nodes)
    T = t_norm.sym_norm(d.edge_index, d.num_nodes)
    pj, pt = j_reorder.degree_order(J), t_reorder.degree_order(T)
    np.testing.assert_array_equal(pj, pt)
    (Jp, ij), (Tp, it) = j_reorder.permute_graph(J, pj), t_reorder.permute_graph(T, pt)
    _assert_same_matrix(Jp, Tp)
    np.testing.assert_array_equal(ij, it)


def test_rcm_order_reduces_bandwidth():
    """Both packages take the native RCM where the host library builds,
    and then give the identical permutation
    (``test_torch_native.py::test_rcm_order_identical_to_jax``); scipy's,
    the fallback, is another valid order. Each must band the graph."""
    rng = np.random.default_rng(6)
    n = 1000
    i = np.arange(n)
    ei = np.stack([np.r_[i[:-1], i[1:]], np.r_[i[1:], i[:-1]]])
    perm0 = rng.permutation(n)
    scr = t_csr.SparseMatrix.from_coo(perm0[ei[0]], perm0[ei[1]], np.ones(ei.shape[1], np.float32), (n, n))
    P, _ = t_reorder.permute_graph(scr, t_reorder.rcm_order(scr))
    J = j_csr.SparseMatrix.from_coo(scr.rows[: scr.nnz], scr.cols[: scr.nnz], scr.vals[: scr.nnz], scr.shape)
    PJ, _ = j_reorder.permute_graph(J, j_reorder.rcm_order(J))
    assert j_reorder.bandwidth(J) > 100
    assert j_reorder.bandwidth(PJ) <= 2 and j_reorder.bandwidth(P) <= 2


@pytest.mark.parametrize(
    "gen,kw",
    [
        ("powerlaw_node_classification", dict(n=4096, num_features=16, seed=3)),
        ("powerlaw_node_classification", dict(n=2000, avg_degree=8, num_classes=5, seed=0)),
        ("sbm_node_classification", dict(n=300, seed=4)),
        ("products_density_graph", dict(n=4096, num_features=16, seed=2)),
        ("products_density_graph", dict(n=3000, tail_degree=8, ring=4, num_classes=5, seed=0)),
    ],
)
def test_generators_identical(gen, kw):
    a = getattr(j_ds, gen)(**kw)
    b = getattr(t_ds, gen)(**kw)
    for k in ("edge_index", "x", "y", "train_mask", "val_mask", "test_mask"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert (a.num_nodes, a.num_features, a.num_classes) == (
        b.num_nodes, b.num_features, b.num_classes
    )


@pytest.mark.parametrize("extra", [0, 1, 300])
def test_pad_edges_and_uniform_nnz(extra):
    """pad_edges_to (row n_rows - 1, col 0, val 0) and with_uniform_nnz:
    arrays identical to the JAX package's,
    and the fields the padding touches (e_pad, nnz, pad_mask, rowptr,
    density) too."""
    r, c, v, shape = _coo(np.random.default_rng(5))
    a = j_csr.SparseMatrix.from_coo(r, c, v, shape)
    b = t_csr.SparseMatrix.from_coo(r, c, v, shape)
    e_pad = a.e_pad + extra
    assert b.e_pad == a.e_pad and b.dtype == a.dtype
    ja, tb = a.pad_edges_to(e_pad).with_uniform_nnz(), b.pad_edges_to(e_pad).with_uniform_nnz()
    _assert_same_matrix(ja, tb)
    assert tb.e_pad == tb.nnz == e_pad
    for x, y in ((a, b), (a.pad_edges_to(e_pad), b.pad_edges_to(e_pad)), (ja, tb)):
        np.testing.assert_array_equal(np.asarray(x.pad_mask()), y.pad_mask())
        np.testing.assert_array_equal(x.rowptr(), y.rowptr())
        assert x.density() == y.density()
    with pytest.raises(ValueError):
        b.pad_edges_to(b.e_pad - 1)


def test_csr_arrays_and_astype():
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 5, 40)
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    cols = rng.integers(0, 33, rowptr[-1])
    vals = rng.standard_normal(rowptr[-1]).astype(np.float32)
    a = j_csr.SparseMatrix.from_csr_arrays(rowptr, cols, vals, 33, pad_to=64)
    b = t_csr.SparseMatrix.from_csr_arrays(rowptr, cols, vals, 33, pad_to=64)
    _assert_same_matrix(a, b)
    np.testing.assert_array_equal(b.rowptr(), rowptr)
    _assert_same_matrix(a.astype(np.float16), b.astype(np.float16))
