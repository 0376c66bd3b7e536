"""sgracex1_tpu_torch.ops.fused_agg against sgracex1_tpu.ops.fused_agg:
identical host schedules, and the plain K2 against the Pallas kernel (run
in interpret mode) and scipy."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import bsr as jb
from sgracex1_tpu.ops import fused_agg as jf
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.graph.normalize import rank1_factor, sym_norm
from sgracex1_tpu_torch.ops import bsr as tb_
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.ops import fused_agg as tf

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _skewed_rank1(rng, n=8192, tb=128):
    """Sym-normalized graph whose row block 3 owns ~600 remainder edges
    (several chunks) beside dense diagonal tiles (tests/test_fused_agg.py)."""
    rows = [np.arange(n), np.arange(n - 1), rng.integers(3 * tb, 4 * tb, 600)]
    cols = [np.arange(n), np.arange(1, n), rng.integers(0, n, 600)]
    ei = np.unique(np.stack([np.concatenate(rows), np.concatenate(cols)]), axis=1)
    return sym_norm(ei, n, fill=1.0)


def _weighted(rng, n=2048, avg_degree=12):
    m = n * avg_degree
    k = np.unique(rng.integers(0, n, m) * n + rng.integers(0, n, m))
    v = rng.uniform(0.5, 2.0, len(k)).astype(np.float32)
    return TSparse.from_coo(k // n, k % n, v, (n, n))


def _to_jax(T):
    return JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)


def _plans(graph, tb, thresh, attach, packed=False, K=128):
    """(jax plan, torch plan, scipy matrix) of one hybrid split."""
    rng = np.random.default_rng(7)
    T = _skewed_rank1(rng) if graph == "skewed" else (
        sym_norm(np.unique(rng.integers(0, 2500, (2, 9000)), axis=1), 2500)
        if graph == "symnorm" else _weighted(rng)
    )
    fac = rank1_factor(T)
    part, rest = tdis.split_by_tile_density(T, tb, thresh)
    if fac is not None:
        rest = tdis._drop_zero_val_edges(rest)
    rest = rest if rest.nnz else None
    cover = dict(cover_rows=True, cover_cols=True)
    jpart = _to_jax(part)
    if packed:
        Bj = jb.bsr_bitmask_from_sparse(jpart, tb=tb, device_build=False, **cover)
        Bt = tb_.bsr_bitmask_from_sparse(part, tb=tb, **cover)
    elif fac is not None:
        Bj, Bt = jb.bsr_mask_from_sparse(jpart, tb=tb, **cover), tb_.bsr_mask_from_sparse(part, tb=tb, **cover)
    else:
        Bj = jb.bsr_from_sparse(jpart, tb=tb, device_build=False, **cover)
        Bt = tb_.bsr_from_sparse(part, tb=tb, **cover)
    r1 = dict(r1_row=fac[0], r1_col=fac[1]) if fac is not None else {}
    keys = tb_.bsr_tile_keys(part, tb, **cover)
    pj = jf.build_fused_plan(
        Bj, _to_jax(rest) if rest is not None else None, K=K, tile_keys=keys,
        attach_chunks=attach, device=False, **r1,
    )
    pt = tf.build_fused_plan(Bt, rest, K=K, tile_keys=keys, attach_chunks=attach, **r1)
    return pj, pt, T.to_scipy()


CASES = [
    ("skewed", 128, 8, True),
    ("skewed", 128, 8, False),
    ("weighted", 128, 40, True),
    ("weighted", 128, 40, False),
]


@pytest.mark.parametrize("graph,tb,thresh,attach", CASES)
def test_schedule_identical(graph, tb, thresh, attach):
    pj, pt, _ = _plans(graph, tb, thresh, attach)
    for k in ("step_rb", "step_cb", "step_tile", "step_chunk", "step_kind", "slot_col", "slot_scale"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, k)), getattr(pt, k).numpy(), err_msg=k)
    np.testing.assert_array_equal(np.asarray(pj.lrow)[:, 0, :], pt.lrow.numpy())
    assert (pj.K, pj.num_steps, pj.num_chunks, pj.num_rest_chunks) == (
        pt.K, pt.num_steps, pt.num_chunks, pt.num_rest_chunks
    )
    assert (pj.colscale is None) == (pt.colscale is None) == (graph == "weighted")
    if pt.colscale is not None:
        np.testing.assert_array_equal(np.asarray(pj.colscale)[:, 0].reshape(-1), pt.colscale.numpy())
        np.testing.assert_array_equal(np.asarray(pj.rowscale)[:, 0].reshape(-1), pt.rowscale.numpy())
    if graph == "skewed":  # the hub block spans several chunks
        assert pt.num_rest_chunks >= 5


@pytest.mark.parametrize(
    "graph,tb,thresh,attach,packed",
    [
        ("skewed", 128, 8, True, False),
        ("weighted", 128, 40, False, False),
        ("symnorm", 1024, 100, True, True),
    ],
)
def test_fused_plain_matches_pallas(graph, tb, thresh, attach, packed):
    """Both write bf16: 2e-2 between them; 5e-2 against scipy f32 (the
    JAX suite's own bound)."""
    pj, pt, mat = _plans(graph, tb, thresh, attach, packed=packed)
    P = 48 if graph != "weighted" else 64
    H = np.random.default_rng(8).standard_normal((mat.shape[1], P)).astype(np.float32)
    out_j = np.asarray(jf.bsr_spmm_fused(pj, jnp.asarray(H))).astype(np.float32)
    out_t = tf.bsr_spmm_fused(pt, torch.from_numpy(H))
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (mat.shape[0], P)
    out_t = out_t.float().numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=2e-2, atol=2e-2)
    ref = mat @ H
    np.testing.assert_allclose(out_t, ref, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(out_j, ref, rtol=5e-2, atol=5e-2)


def test_no_remainder_plan_is_all_tiles():
    """With no remainder, R_pad = 1 all-dead chunk and every step is a
    tile step."""
    pj, pt, mat = _plans("weighted", 128, 1, True)
    assert pt.num_rest_chunks == 0 and pt.num_chunks == 1
    assert (pt.lrow == 128).all() and (pt.step_kind == 0).all()
    H = torch.randn(mat.shape[1], 32, generator=torch.Generator().manual_seed(0))
    out = tf.bsr_spmm_fused(pt, H).float().numpy()
    np.testing.assert_allclose(out, mat @ H.numpy(), rtol=5e-2, atol=5e-2)
