"""sgracex1_tpu_torch.ops.bsr against sgracex1_tpu.ops.bsr: host tile
builds must be identical; the plain K1 must match the Pallas kernel (run
in interpret mode) on identical bf16 operands."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import bsr as jb
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.ops import bsr as tb_

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _graphs(n=2048, weighted=True, seed=0):
    """(jax matrix, torch matrix) of one random graph; weighted values or
    a sym-normalized (fill=0 self-loops) pattern."""
    rng = np.random.default_rng(seed)
    ei = np.unique(rng.integers(0, n, (2, 4 * n)), axis=1)
    if weighted:
        v = rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32)
        T = TSparse.from_coo(ei[0], ei[1], v, (n, n))
    else:
        T = sym_norm(ei, n)
    J = JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)
    return J, T


def _np_tiles(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "V" or str(a.dtype) == "bfloat16" else a


def _assert_same_bsr(J, T):
    jt = _np_tiles(J.tiles)
    tt = T.tiles.float().numpy() if T.tiles.dtype == torch.bfloat16 else T.tiles.numpy()
    assert jt.shape == tt.shape
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(np.asarray(J.tile_rb), T.tile_rb.numpy())
    np.testing.assert_array_equal(np.asarray(J.tile_cb), T.tile_cb.numpy())
    assert (J.n_rows, J.n_cols, J.tb) == (T.n_rows, T.n_cols, T.tb)


@pytest.mark.parametrize("cover", [(False, False), (True, False), (True, True)])
def test_tile_keys(cover):
    J, T = _graphs(n=3000, seed=1)
    # sparse corner: drop edges so some row/col blocks are empty
    keep = (np.asarray(T.rows[: T.nnz]) < 1000) & (np.asarray(T.cols[: T.nnz]) > 500)
    T = TSparse.from_coo(T.rows[: T.nnz][keep], T.cols[: T.nnz][keep], T.vals[: T.nnz][keep], T.shape)
    J = JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)
    kw = dict(cover_rows=cover[0], cover_cols=cover[1])
    np.testing.assert_array_equal(
        jb.bsr_tile_keys(J, 128, **kw), tb_.bsr_tile_keys(T, 128, **kw)
    )


@pytest.mark.parametrize("form", ["bf16", "f32", "mask"])
def test_bsr_from_sparse(form):
    J, T = _graphs(weighted=form != "mask")
    kw = dict(tb=128, cover_rows=True, cover_cols=True)
    if form == "mask":
        a, b = jb.bsr_mask_from_sparse(J, **kw), tb_.bsr_mask_from_sparse(T, **kw)
        assert b.tiles.dtype == torch.int8
    else:
        jd, td = (jnp.bfloat16, torch.bfloat16) if form == "bf16" else (jnp.float32, torch.float32)
        a = jb.bsr_from_sparse(J, dtype=jd, device_build=False, **kw)
        b = tb_.bsr_from_sparse(T, dtype=td, **kw)
    _assert_same_bsr(a, b)


def test_bitmask_and_unpack():
    J, T = _graphs(weighted=False, seed=2)
    a = jb.bsr_bitmask_from_sparse(J, tb=1024, cover_rows=True, device_build=False)
    b = tb_.bsr_bitmask_from_sparse(T, tb=1024, cover_rows=True)
    assert b.tiles.dtype == torch.uint8 and b.tiles.shape[-1] == 128
    _assert_same_bsr(a, b)
    m = tb_.bsr_mask_from_sparse(T, tb=1024, cover_rows=True)
    np.testing.assert_array_equal(
        tb_.unpack_mask01_tile(b.tiles, 1024).numpy(), m.tiles.float().numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jb.unpack_mask01_tile(jnp.asarray(np.asarray(a.tiles)), 1024)),
        tb_.unpack_mask01_tile(b.tiles, 1024).numpy(),
    )


@pytest.mark.parametrize("mask", [False, True])
def test_bsr_transpose(mask):
    J, T = _graphs(n=1500, weighted=not mask, seed=3)
    kw = dict(tb=128, cover_rows=True, cover_cols=True)
    if mask:
        a, b = jb.bsr_mask_from_sparse(J, **kw), tb_.bsr_mask_from_sparse(T, **kw)
    else:
        a = jb.bsr_from_sparse(J, device_build=False, **kw)
        b = tb_.bsr_from_sparse(T, **kw)
    _assert_same_bsr(jb.bsr_transpose(a), tb_.bsr_transpose(b))
    with pytest.raises(ValueError):
        tb_.bsr_transpose(tb_.bsr_bitmask_from_sparse(T, tb=1024))


def test_run_segments_cover_every_step_once():
    L = tb_.SEG_STEPS
    rb = np.repeat(np.arange(6), [0, 1, 2 * L + 8, L, L + 1, 3])  # block 0 empty
    S = tb_.run_segments(rb, n_rt=7)
    lo, hi, part = S.seg_lo.numpy(), S.seg_hi.numpy(), S.seg_part.numpy()
    seg_rb = S.seg_rb.numpy()
    assert sorted(set(seg_rb)) == list(range(7))  # every block written
    steps = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
    np.testing.assert_array_equal(steps, np.arange(len(rb)))
    np.testing.assert_array_equal(rb[steps], np.repeat(seg_rb, hi - lo))
    # blocks 2 (3 segments) and 4 (2) split; partial slots are contiguous
    np.testing.assert_array_equal(S.fin_rb.numpy(), [2, 4])
    np.testing.assert_array_equal(S.fin_np.numpy(), [3, 2])
    np.testing.assert_array_equal(np.sort(part[part >= 0]), np.arange(S.n_part))
    assert (part[np.isin(seg_rb, [2, 4], invert=True)] == -1).all()


@pytest.mark.parametrize("form", ["values", "int8", "packed"])
def test_bsr_spmm_plain_matches_pallas(form):
    """Identical bf16 operands, f32 sums in another order: 1e-3."""
    J, T = _graphs(n=2048 if form != "packed" else 2500, weighted=form == "values", seed=4)
    kw = dict(cover_rows=True)
    if form == "values":
        a = jb.bsr_from_sparse(J, tb=128, device_build=False, **kw)
        b = tb_.bsr_from_sparse(T, tb=128, **kw)
    elif form == "int8":
        a, b = jb.bsr_mask_from_sparse(J, tb=128, **kw), tb_.bsr_mask_from_sparse(T, tb=128, **kw)
    else:
        a = jb.bsr_bitmask_from_sparse(J, tb=1024, device_build=False, **kw)
        b = tb_.bsr_bitmask_from_sparse(T, tb=1024, **kw)
    H = np.random.default_rng(5).standard_normal((T.n_cols, 48)).astype(np.float32)
    out_j = np.asarray(jb.bsr_spmm_pallas(a, jnp.asarray(H)))
    out_t = tb_.bsr_spmm(b, torch.from_numpy(H))
    assert out_t.dtype == torch.float32 and out_t.shape == (T.n_rows, 48)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-3, atol=1e-3)
    if form != "values":  # masks: A @ H of the positive-edge pattern
        pat = (T.to_scipy() > 0).astype(np.float32)
        ref = pat @ H.astype(jnp.bfloat16).astype(np.float32)
        np.testing.assert_allclose(out_t.numpy(), ref, rtol=1e-3, atol=1e-3)
