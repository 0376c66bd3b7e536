"""sgracex1_tpu_torch.ops.sddmm / flash_gat against sgracex1_tpu: the edge
path, and the plain K3 / K6 against the Pallas kernels in interpret mode
on the same numpy inputs."""

import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import bsr as jb
from sgracex1_tpu.ops import flash_gat as jfg
from sgracex1_tpu.ops import fused_agg as jf
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.ops import bsr as tb_
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.ops import flash_gat as tfg
from sgracex1_tpu_torch.ops import fused_agg as tf
from sgracex1_tpu_torch.ops import sddmm as tsd

# the JAX ops package exports a function named like this module
jsd = importlib.import_module("sgracex1_tpu.ops.sddmm")

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

EXACT = 1e-3  # the same bf16 operands; f32 sums in another order


def _to_jax(T):
    return JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)


def _graph(n, weighted, seed, isolated=7):
    """Random edges avoiding every ``isolated``-th node (those rows keep
    only their zero-valued self-loop, or nothing when weighted), plus a
    hub block so some row block has a long run."""
    rng = np.random.default_rng(seed)
    ei = np.concatenate([
        rng.integers(0, n, (2, 6 * n)),
        np.stack([rng.integers(0, 40, 3 * n), rng.integers(0, n, 3 * n)]),
    ], axis=1)
    ei = ei[:, (ei % isolated != 3).all(axis=0)]
    ei = np.unique(np.concatenate([ei, ei[::-1]], axis=1), axis=1)
    if not weighted:
        return sym_norm(ei, n)  # fill-0 self-loops: in the edge list, masked out
    v = rng.uniform(0.1, 1.0, ei.shape[1]).astype(np.float32)
    return TSparse.from_coo(ei[0], ei[1], v, (n, n))


def _scores(n, H, F, seed, squeeze=False):
    rng = np.random.default_rng(seed)
    shape = (n,) if squeeze else (n, H)
    s1 = (rng.standard_normal(shape) * 2).astype(np.float32)
    s2 = (rng.standard_normal(shape) * 2).astype(np.float32)
    Wh = rng.standard_normal((n, F) if squeeze else (n, H, F)).astype(np.float32)
    return s1, s2, Wh


def _torch(*a):
    return [torch.from_numpy(x) for x in a]


def _jax(*a):
    return [jnp.asarray(x) for x in a]


@pytest.mark.parametrize("heads", [None, 3])
def test_sddmm_and_edge_softmax_match_jax(heads):
    T = _graph(500, weighted=False, seed=0)
    J = _to_jax(T)
    rng = np.random.default_rng(1)
    Wh = rng.standard_normal((500, 16)).astype(np.float32)
    a1, a2 = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        tsd.sddmm(T, *_torch(Wh, a1, a2)).numpy(),
        np.asarray(jsd.sddmm(J, *_jax(Wh, a1, a2))), rtol=1e-5, atol=1e-5,
    )
    shape = (T.rows.shape[0],) if heads is None else (T.rows.shape[0], heads)
    logits = rng.standard_normal(shape).astype(np.float32) * 3
    np.testing.assert_allclose(
        tsd.leaky_relu(torch.from_numpy(logits), 0.2).numpy(),
        np.asarray(jsd.leaky_relu(jnp.asarray(logits), 0.2)),
    )
    got = tsd.edge_softmax(T, torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsd.edge_softmax(J, jnp.asarray(logits))), rtol=1e-5, atol=1e-6)
    assert (got[T.nnz:] == 0).all() and (got[T.vals == 0] == 0).all()
    mask = rng.random(T.rows.shape[0]) < 0.5
    np.testing.assert_allclose(
        tsd.edge_softmax(T, torch.from_numpy(logits), mask=torch.from_numpy(mask)).numpy(),
        np.asarray(jsd.edge_softmax(J, jnp.asarray(logits), mask=jnp.asarray(mask))),
        rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("H", [None, 2])
def test_edge_reference_matches_jax(H):
    T = _graph(400, weighted=True, seed=2)
    s1, s2, Wh = _scores(400, H or 1, 24, seed=3, squeeze=H is None)
    want = jfg.gat_attention_agg_ref(_to_jax(T), *_jax(s1, s2, Wh)) if H is None else np.stack(
        [jfg.gat_attention_agg_ref(_to_jax(T), *_jax(s1[:, h], s2[:, h], Wh[:, h])) for h in range(H)],
        axis=1,
    )
    got = tfg.gat_attention_agg_ref(T, *_torch(s1, s2, Wh)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


# K3: form, tb, n, H (None = the single-head 1-D call), F, weighted
K3_CASES = [
    ("int8", 128, 300, None, 16, False),
    ("int8", 256, 700, 2, 8, False),
    ("values", 128, 520, 2, 40, True),
    ("values", 128, 391, 1, 16, True),
    ("packed", 1024, 2000, 1, 16, False),
]


def _k3_tiles(form, T, tb):
    J = _to_jax(T)
    cover = dict(cover_rows=True)
    if form == "int8":
        return jb.bsr_mask_from_sparse(J, tb=tb, device_build=False, **cover), tb_.bsr_mask_from_sparse(T, tb=tb, **cover)
    if form == "packed":
        return jb.bsr_bitmask_from_sparse(J, tb=tb, device_build=False, **cover), tb_.bsr_bitmask_from_sparse(T, tb=tb, **cover)
    return jb.bsr_from_sparse(J, tb=tb, device_build=False, **cover), tb_.bsr_from_sparse(T, tb=tb, **cover)


@pytest.mark.parametrize("form,tb,n,H,F,weighted", K3_CASES)
def test_flash_forward_plain_matches_pallas(form, tb, n, H, F, weighted):
    T = _graph(n, weighted, seed=n)
    Bj, Bt = _k3_tiles(form, T, tb)
    if form == "packed":
        assert Bt.num_tiles <= 4 and Bt.packed
    s1, s2, Wh = _scores(n, H or 1, F, seed=n + 1, squeeze=H is None)
    out_j, m_j, l_j = (np.asarray(x) for x in jfg.flash_gat_forward(Bj, *_jax(s1, s2, Wh), return_stats=True))
    out_t, m_t, l_t = tfg.flash_gat_forward(Bt, *_torch(s1, s2, Wh), return_stats=True)
    assert out_t.shape == out_j.shape and m_t.shape == m_j.shape == (Bt.n_row_tiles * tb, H or 1)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(m_t.numpy(), m_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l_t.numpy(), l_j, rtol=EXACT, atol=EXACT)
    # rows with no edge (isolated nodes, padding) come out exactly 0
    has = np.zeros(n, bool)
    has[T.rows[: T.nnz][T.vals[: T.nnz] > 0]] = True
    assert not has.all() and (out_t.numpy()[~has] == 0).all()
    ref = tfg.gat_attention_agg_ref(T, *_torch(s1, s2, Wh)).numpy()
    np.testing.assert_allclose(out_t.numpy(), ref, rtol=2e-2, atol=2e-2)
    # the same call without stats, through the forward-only entry point
    with torch.no_grad():
        np.testing.assert_array_equal(
            tfg.gat_attention_agg_fused(Bt, *_torch(s1, s2, Wh)).numpy(), out_t.numpy()
        )


def _hybrid(n, density, tb, thresh, attach, K=128):
    """One random graph split by tile density into (JAX plan, port plan,
    port edge list), built as tests/test_flash_gat.py builds it."""
    mat = sp.random(n, n, density=density, format="csr", random_state=11).astype(np.float32)
    mat.setdiag(0.9)
    T = TSparse.from_scipy(mat)
    part, rest = tdis.split_by_tile_density(T, tb, thresh)
    assert part.nnz and rest.nnz
    cover = dict(cover_rows=True, cover_cols=True)
    keys = tb_.bsr_tile_keys(part, tb, **cover)
    pj = jf.build_fused_plan(
        jb.bsr_mask_from_sparse(_to_jax(part), tb=tb, device_build=False, **cover),
        _to_jax(rest), K=K, tile_keys=keys, attach_chunks=attach,
    )
    pt = tf.build_fused_plan(
        tb_.bsr_mask_from_sparse(part, tb=tb, **cover), rest, K=K,
        tile_keys=keys, attach_chunks=attach,
    )
    return T, pj, pt, rest


@pytest.mark.parametrize("attach,H,thresh", [(False, 2, 95), (True, 2, 95), (True, None, 130)])
def test_hybrid_forward_plain_matches_pallas(attach, H, thresh):
    T, pj, pt, rest = _hybrid(420, 0.02, 64, thresh, attach)
    kinds = set(pt.step_kind.tolist())
    assert 3 in kinds if attach else kinds == {0, 1}
    s1, s2, Wh = _scores(420, H or 1, 8, seed=5, squeeze=H is None)
    out_j, m_j, l_j = (np.asarray(x) for x in jfg.flash_gat_hybrid_forward(pj, *_jax(s1, s2, Wh), return_stats=True))
    out_t, m_t, l_t = tfg.flash_gat_hybrid_forward(pt, *_torch(s1, s2, Wh), return_stats=True)
    assert out_t.shape == out_j.shape
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(m_t.numpy(), m_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l_t.numpy(), l_j, rtol=EXACT, atol=EXACT)
    ref = tfg.gat_attention_agg_ref(T, *_torch(s1, s2, Wh)).numpy()
    np.testing.assert_allclose(out_t.numpy(), ref, rtol=2e-2, atol=2e-2)
    with torch.no_grad():
        np.testing.assert_array_equal(
            tfg.gat_attention_agg_hybrid(pt, rest, *_torch(s1, s2, Wh)).numpy(), out_t.numpy()
        )


def test_forward_only_entry_points_raise_under_grad():
    T, _, pt, rest = _hybrid(300, 0.03, 64, 130, True)
    s1, s2, Wh = _torch(*_scores(300, 2, 8, seed=6))
    Wh.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        tfg.gat_attention_agg_hybrid(pt, rest, s1, s2, Wh)
    B = tb_.bsr_mask_from_sparse(T, tb=128)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tfg.gat_attention_agg_fused(B, s1, s2, Wh)
    with torch.no_grad():
        assert tfg.gat_attention_agg_fused(B, s1, s2, Wh).shape == (300, 2, 8)
    # a rank-1 plan is not an attention plan; a meta tensor is no device
    with pytest.raises(ValueError, match="value-mode"):
        tfg.flash_gat_hybrid_forward(
            tf.build_fused_plan(B, None, r1_row=np.ones(300, np.float32), r1_col=np.ones(300, np.float32)),
            s1, s2, Wh.detach(),
        )
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfg.flash_gat_forward(B, s1, s2, Wh.detach().to("meta"))
