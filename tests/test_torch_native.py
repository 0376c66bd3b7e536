"""sgracex1_tpu_torch.runtime.native against the JAX package's binding of
the same library and against the port's numpy paths (the spec), on the
same inputs: integer arrays equal, float arrays equal (both run the same
float32/float64 arithmetic in the same order), and the port's build
leaves the repository's prebuilt library alone."""

import hashlib
import os

import numpy as np
import pytest
import torch

from sgracex1_tpu.graph import csr as j_csr
from sgracex1_tpu.graph import normalize as j_norm
from sgracex1_tpu.graph import reorder as j_reorder
from sgracex1_tpu.ops import pallas_spmm as j_pallas
from sgracex1_tpu.runtime import native as j_native
from sgracex1_tpu_torch.graph import csr as t_csr
from sgracex1_tpu_torch.graph import normalize as t_norm
from sgracex1_tpu_torch.graph import reorder as t_reorder
from sgracex1_tpu_torch.ops import pallas_spmm as t_pallas
from sgracex1_tpu_torch.runtime import native

torch.set_num_threads(1)

_TRACKED = os.path.join(os.path.dirname(native._SRC), "build", "libsgrace_host.so")


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _same(a, b):
    """Equal tuples / arrays of the two bindings, dtypes included."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_builds_into_the_port_and_leaves_the_tracked_library(tmp_path, monkeypatch):
    """The library loads from ``sgracex1_tpu_torch/_build`` under the
    source's hash; a fresh build writes there (here: a temporary build
    directory) and the repository's ``csrc/build`` stays byte-identical."""
    before = _sha(_TRACKED)
    listing = sorted(os.listdir(os.path.dirname(_TRACKED)))
    assert native.available()
    path = native.lib_path()
    assert os.path.samefile(os.path.dirname(path), os.path.join(os.path.dirname(t_csr.__file__), "..", "_build"))
    assert native.get_lib()._name == path and os.path.exists(path)
    monkeypatch.setattr(native, "_BUILD", str(tmp_path))
    fresh = str(tmp_path / os.path.basename(path))
    native._build(fresh)
    assert os.path.getsize(fresh) > 0
    assert sorted(os.listdir(tmp_path)) == sorted([os.path.basename(path), "native.lock"])
    native._build(fresh)  # built already: returns without compiling
    assert _sha(_TRACKED) == before
    assert sorted(os.listdir(os.path.dirname(_TRACKED))) == listing


def test_switches_turn_the_library_off(monkeypatch):
    assert native.available()
    with native.disabled():
        assert not native.available() and native.coo_sort_perm(np.zeros(1), np.zeros(1)) is None
    assert native.available()
    monkeypatch.setenv("SGRACE_NATIVE", "0")
    assert native.get_lib() is None and native.rcm_order(1, np.zeros(0), np.zeros(0)) is None


@pytest.mark.parametrize(
    "text,want",
    [
        ("0,2,3,6,\n1,2,0,0,1,2,\n1.5,2.5,3.5,4.5,5.5,6.5,\n", [1.5, 2.5, 3.5, 4.5, 5.5, 6.5]),
        ("0,1,3\n0,1,2\n", [1.0, 1.0, 1.0]),  # no values line
        ("0,1,3\n0,1,2\n0.5\n", [0.5, 1.0, 1.0]),  # truncated values line
        ("0, 1, 3\n\n 0 ,1,2,7,7\n0.25,0.5,0.75,9\n", [0.25, 0.5, 0.75]),  # spaces, blank line, long lines
    ],
)
def test_csr_text_matches_jax_binding(tmp_path, text, want):
    path = _write(tmp_path, "m.txt", text)
    got = native.load_csr_text(path)
    _same(got, j_native.load_csr_text(path))
    assert got[2].tolist() == want and got[1].shape == got[2].shape == (got[0][-1],)


def test_csr_text_unparsable_gives_none(tmp_path):
    assert native.load_csr_text(_write(tmp_path, "m.txt", "0,4\n0,1\n")) is None  # short colIdx
    assert native.load_csr_text(str(tmp_path / "missing.txt")) is None


def test_dense_text_matches_jax_binding(tmp_path):
    path = _write(tmp_path, "d.txt", "1,2,3\n4,5\n\n6,7,8,\n")
    got = native.load_dense_text(path)
    _same(got, j_native.load_dense_text(path))
    np.testing.assert_array_equal(got, [[1, 2, 3], [4, 5, 0], [6, 7, 8]])


def test_coo_sort_matches_jax_and_lexsort():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 50, 1000)
    cols = rng.integers(0, 50, 1000)
    perm = native.coo_sort_perm(rows, cols)
    _same(perm, j_native.coo_sort_perm(rows, cols))
    np.testing.assert_array_equal(perm, np.lexsort((cols, rows)))


@pytest.mark.parametrize("weighted,fill", [(True, 1.0), (False, 0.0), (True, 0.0)])
def test_sym_norm_matches_jax_and_numpy(weighted, fill):
    rng = np.random.default_rng(1)
    n, e = 300, 2000
    ei = rng.integers(0, n - 20, (2, e)).astype(np.int64)  # the last 20 nodes isolated
    w = rng.uniform(0.1, 2.0, e).astype(np.float32) if weighted else None
    got = native.sym_norm_edges(ei, n, w, fill)
    _same(got, j_native.sym_norm_edges(ei, n, w, fill))
    fast = t_norm.sym_norm_edges(ei, n, w, fill)
    with native.disabled():
        spec = t_norm.sym_norm_edges(ei, n, w, fill)
    _same(fast, got)
    _same(fast, spec)
    _same(fast, j_norm.sym_norm_edges(ei, n, w, fill))


def _sym_graph(n, e, seed):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, e), rng.integers(0, n, e)
    ei = np.unique(np.concatenate([np.stack([r, c]), np.stack([c, r])], axis=1), axis=1)
    return t_csr.SparseMatrix.from_coo(ei[0], ei[1], np.ones(ei.shape[1], np.float32), (n, n))


def _to_jax(T):
    return j_csr.SparseMatrix.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)


def test_rcm_order_identical_to_jax():
    """The repaired fault: with the native library in both packages the
    port's RCM permutation is the JAX package's (scipy's differs in 15 of
    these 500 entries), and it bands the graph as tightly as scipy's."""
    T = _sym_graph(500, 1500, seed=0)
    J = _to_jax(T)
    assert native.available() and j_native.available()
    perm = t_reorder.rcm_order(T)
    assert perm.dtype == np.int64
    np.testing.assert_array_equal(perm, j_reorder.rcm_order(J))
    r, c = T.rows[: T.nnz], T.cols[: T.nnz]
    _same(native.rcm_order(500, r, c), j_native.rcm_order(500, r, c))
    with native.disabled():
        spec = t_reorder.rcm_order(T)
    assert sorted(spec.tolist()) == sorted(perm.tolist()) == list(range(500))
    band = lambda p: t_reorder.bandwidth(t_reorder.permute_graph(T, p)[0])
    assert (perm != spec).sum() == 15
    assert band(perm) == band(spec) < t_reorder.bandwidth(T)


@pytest.mark.parametrize("rb,cb,be", [(128, 128, 1024), (256, 128, 2048), (1024, 1024, 1024)])
def test_plan_tiles_matches_jax_binding(rb, cb, be):
    T = _sym_graph(700, 6000, seed=2)
    r, c = T.rows[: T.nnz], T.cols[: T.nnz]
    v = np.random.default_rng(3).uniform(0.5, 1.5, T.nnz).astype(np.float32)
    got = native.plan_tiles(r, c, v, rb, cb, be)
    _same(got, j_native.plan_tiles(r, c, v, rb, cb, be))
    _same(got, t_pallas._plan_arrays(r.astype(np.int64), c.astype(np.int64), v, rb, cb, be))


@pytest.mark.parametrize("n,e,tiling", [(700, 6000, dict(rb=128, cb=128, be=1024)),
                                        (2000, 3000, dict(rb=256, cb=512, be=2048)),
                                        (300, 0, dict(rb=128, cb=128, be=1024))])
def test_plan_spmm_native_identical_to_numpy_and_jax(n, e, tiling):
    """Every array of the plan (slot_cv, the launch schedule too) is the
    same on the native and the numpy path, and the JAX package's plan
    reshaped (-1, be); the empty matrix included."""
    T = _sym_graph(n, e, seed=4) if e else t_csr.SparseMatrix.from_coo([], [], np.zeros(0, np.float32), (n, n))
    fast = t_pallas.plan_spmm(T, **tiling)
    with native.disabled():
        spec = t_pallas.plan_spmm(T, **tiling)
    for f in ("lrow", "lcol", "val", "perm", "tile_rb", "tile_cb", "slot_idx", "slot_cv"):
        assert torch.equal(getattr(fast, f), getattr(spec, f)), f
    for f in ("seg_rb", "seg_lo", "seg_hi"):
        assert torch.equal(getattr(fast.segments, f), getattr(spec.segments, f)), f
    jp = j_pallas.plan_spmm(_to_jax(T), **tiling)
    for f in ("lrow", "lcol", "val", "perm"):
        np.testing.assert_array_equal(getattr(fast, f).numpy(), np.asarray(getattr(jp, f)).reshape(-1, tiling["be"]))
    for f in ("tile_rb", "tile_cb"):
        np.testing.assert_array_equal(getattr(fast, f).numpy(), np.asarray(getattr(jp, f)))


@pytest.mark.parametrize("parts", [1, 3, 8])
def test_partition_balance_matches_jax(parts):
    deg = np.random.default_rng(5).zipf(1.8, 400).clip(max=500)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    got = native.partition_balance(rowptr, parts)
    _same(got, j_native.partition_balance(rowptr, parts))
    assert got[0] == 0 and got[-1] == 400 and (np.diff(got) >= 0).all()


def test_out_of_range_indices_raise():
    with pytest.raises(ValueError):
        native.rcm_order(4, np.array([0, 4]), np.array([1, 2]))
    with pytest.raises(ValueError):
        native.sym_norm_edges(np.array([[0, -1], [1, 2]]), 4, None, 0.0)
    with pytest.raises(ValueError):
        native.plan_tiles(np.array([0, 1]), np.array([0, 1]), np.ones(2, np.float32), 0, 128, 1024)
