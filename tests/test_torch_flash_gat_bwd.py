"""The flash-GAT backward against sgracex1_tpu: the plain K4 / K5 against
the Pallas passes ``_bwd_row_pass`` / ``_bwd_col_pass`` in interpret mode
on identical operands, ``flash_gat_backward``, and the autograd gradients
of ``gat_attention_agg_fused`` / ``_hybrid`` against ``jax.grad`` of the
JAX ops and against autograd through the f32 edge path."""

import numpy as np
import pytest
import jax
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

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

EXACT = 1e-3  # identical bf16 operands; f32 sums in another order
GRAD = 2e-2  # bf16 q and dWh products, as tests/test_flash_gat.py holds them
REF = 5e-2  # the same against the f32 edge path, at scores twice as sharp


def _to_jax(T):
    return JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)


def _graph(n, weighted, seed, hub=40, isolated=7):
    """Random edges plus ``hub`` rows linked to random columns, symmetrized
    (so hub columns too); every ``isolated``-th node keeps no edge."""
    rng = np.random.default_rng(seed)
    ei = np.concatenate([
        rng.integers(0, n, (2, 4 * n)),
        np.stack([rng.integers(0, hub, 3 * n), rng.integers(0, n, 3 * n)]),
    ], axis=1)
    ei = ei[:, (ei % isolated != 3).all(axis=0)]
    ei = np.unique(np.concatenate([ei, ei[::-1]], axis=1), axis=1)
    if not weighted:
        return sym_norm(ei, n)  # fill-0 self-loops: in the edge list, masked out
    v = rng.uniform(0.1, 1.0, ei.shape[1]).astype(np.float32)
    return TSparse.from_coo(ei[0], ei[1], v, (n, n))


def _tiles(form, T, tb):
    J = _to_jax(T)
    cover = dict(cover_rows=True)
    if form == "int8":
        return jb.bsr_mask_from_sparse(J, tb=tb, device_build=False, **cover), tb_.bsr_mask_from_sparse(T, tb=tb, **cover)
    if form == "packed":
        return jb.bsr_bitmask_from_sparse(J, tb=tb, device_build=False, **cover), tb_.bsr_bitmask_from_sparse(T, tb=tb, **cover)
    return jb.bsr_from_sparse(J, tb=tb, device_build=False, **cover), tb_.bsr_from_sparse(T, tb=tb, **cover)


def _operands(n, H, F, seed, squeeze=False):
    """s1, s2, Wh and the output cotangent gO (numpy)."""
    rng = np.random.default_rng(seed)
    shape = (n,) if squeeze else (n, H)
    fshape = (n, F) if squeeze else (n, H, F)
    s1 = (rng.standard_normal(shape) * 2).astype(np.float32)
    s2 = (rng.standard_normal(shape) * 2).astype(np.float32)
    Wh = rng.standard_normal(fshape).astype(np.float32)
    gO = rng.standard_normal(fshape).astype(np.float32)
    return s1, s2, Wh, gO


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _jax_passes(Bj, s1, s2, m, l, Wh, gO):
    """JAX K4 and K5 in interpret mode on padded head-last operands."""
    n, H, F = Wh.shape
    s1p, s2p, Whp, gOp = jfg._pad_bwd_operands(
        Bj, jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(Wh.reshape(n, H * F)),
        jnp.asarray(gO.reshape(gO.shape[0], H * F)),
    )
    kw = dict(alpha=0.2, interpret=True)
    t, u1, u2 = jfg._bwd_row_pass(Bj, s1p, s2p, m, l, Whp, gOp, **kw)
    dWh, ds2 = jfg._bwd_col_pass(Bj, s1p, s2p, m, l, t, Whp, gOp, **kw)
    return (t, u1, u2), (np.asarray(dWh).reshape(-1, H, F), ds2)


def _check_passes(Bj, Bt, s1, s2, m, l, Wh, gO):
    (t, u1, u2), (dWh, ds2) = _jax_passes(Bj, s1, s2, m, l, Wh, gO)
    args = _t(s1, s2, m, l)
    got = tfg.flash_gat_bwd_row_plain(Bt, *args, *_t(Wh, gO))
    for name, g, w in zip(("t", "u1", "u2"), got, (t, u1, u2)):
        assert g.shape == w.shape
        _close(g, w, EXACT, name)
    dWh_t, ds2_t = tfg.flash_gat_bwd_col_plain(Bt, *args, torch.from_numpy(np.array(t)), *_t(Wh, gO))
    assert dWh_t.shape == dWh.shape and ds2_t.shape == ds2.shape
    _close(dWh_t, dWh, EXACT, "dWh")
    _close(ds2_t, ds2, EXACT, "ds2")
    return got


# form, tb, n, H, F, weighted
BWD_CASES = [
    ("int8", 32, 1024, 2, 16, False),  # hub row and hub column runs split
    ("int8", 128, 391, 1, 8, False),
    ("values", 128, 520, 2, 16, True),
    ("packed", 1024, 1500, 1, 8, False),
]


@pytest.mark.parametrize("form,tb,n,H,F,weighted", BWD_CASES)
def test_bwd_passes_plain_match_pallas(form, tb, n, H, F, weighted):
    T = _graph(n, weighted, seed=n)
    Bj, Bt = _tiles(form, T, tb)
    if tb == 32:
        assert Bt.segments.n_fin > 0 and Bt.col_segments.n_fin > 0
    s1, s2, Wh, gO = _operands(n, H, F, seed=n + 1)
    _, m, l = jfg.flash_gat_forward(Bj, *(jnp.asarray(x) for x in (s1, s2, Wh)), return_stats=True)
    t, u1, u2 = _check_passes(Bj, Bt, s1, s2, m, l, Wh, gO)
    # rows with no edge: every reduction is exactly 0, ds1 too
    has = np.zeros(Bt.n_row_tiles * tb, bool)
    has[T.rows[: T.nnz][T.vals[: T.nnz] > 0]] = True
    assert not has.all()
    for x in (t, u1, u2):
        assert (x.numpy()[~has] == 0).all()


def _hybrid(n, density, tb, thresh, K=128):
    """A random graph split by tile density into (JAX plan, port plan,
    remainder edge list), as tests/test_flash_gat.py builds it."""
    mat = sp.random(n, n, density=density, format="csr", random_state=11).astype(np.float32)
    mat.setdiag(0.9)
    T = TSparse.from_scipy(mat)
    part, rest = tdis.split_by_tile_density(T, tb, thresh)
    assert part.nnz and rest.nnz
    cover = dict(cover_rows=True, cover_cols=True)
    keys = tb_.bsr_tile_keys(part, tb, **cover)
    pj = jf.build_fused_plan(
        jb.bsr_mask_from_sparse(_to_jax(part), tb=tb, device_build=False, **cover),
        _to_jax(rest), K=K, tile_keys=keys, attach_chunks=True,
    )
    pt = tf.build_fused_plan(
        tb_.bsr_mask_from_sparse(part, tb=tb, **cover), rest, K=K, tile_keys=keys,
        attach_chunks=True,
    )
    return T, pj, pt, rest


def test_bwd_passes_under_merged_hybrid_stats():
    """K4/K5 on the hybrid plan's tiles, recomputing p from the (m, l) K6
    merged over tiles and remainder chunks."""
    T, pj, pt, _ = _hybrid(420, 0.02, 64, 95)
    s1, s2, Wh, gO = _operands(420, 2, 8, seed=5)
    _, m, l = jfg.flash_gat_hybrid_forward(pj, *(jnp.asarray(x) for x in (s1, s2, Wh)), return_stats=True)
    _check_passes(pj.B, pt.B, s1, s2, m, l, Wh, gO)


@pytest.mark.parametrize("squeeze", [False, True])
def test_flash_gat_backward_matches_jax(squeeze):
    T = _graph(520, False, seed=8)
    Bj, Bt = _tiles("int8", T, 128)
    s1, s2, Wh, gO = _operands(520, 2, 16, seed=9, squeeze=squeeze)
    j = [jnp.asarray(x) for x in (s1, s2, Wh)]
    _, m, l = jfg.flash_gat_forward(Bj, *j, return_stats=True)
    want = jfg.flash_gat_backward(Bj, *j, jnp.asarray(gO), m, l, alpha=0.2, interpret=True)
    got = tfg.flash_gat_backward(Bt, *_t(s1, s2, Wh, gO, m, l))
    for name, g, w in zip(("ds1", "ds2", "dWh"), got, want):
        assert g.shape == w.shape, name
        _close(g, w, EXACT, name)


def _torch_grads(fn, s1, s2, Wh, v):
    x = [torch.from_numpy(a).requires_grad_(True) for a in (s1, s2, Wh)]
    (fn(*x) * torch.from_numpy(v)).sum().backward()
    return [a.grad for a in x]


def _jax_grads(fn, s1, s2, Wh, v):
    loss = lambda a, b, c: jnp.vdot(fn(a, b, c), jnp.asarray(v))
    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (s1, s2, Wh)))


@pytest.mark.parametrize("form,tb,n,H", [("int8", 128, 520, 2), ("values", 128, 391, 3), ("packed", 1024, 1500, None)])
def test_fused_autograd_matches_jax_and_edge_path(form, tb, n, H):
    T = _graph(n, form == "values", seed=n + 2)
    Bj, Bt = _tiles(form, T, tb)
    s1, s2, Wh, v = _operands(n, H or 1, 8, seed=n + 3, squeeze=H is None)
    got = _torch_grads(lambda a, b, c: tfg.gat_attention_agg_fused(Bt, a, b, c), s1, s2, Wh, v)
    want = _jax_grads(lambda a, b, c: jfg.gat_attention_agg_fused(Bj, a, b, c), s1, s2, Wh, v)
    ref = _torch_grads(lambda a, b, c: tfg.gat_attention_agg_ref(T, a, b, c), s1, s2, Wh, v)
    for name, g, w, r in zip(("ds1", "ds2", "dWh"), got, want, ref):
        assert g.shape == w.shape == r.shape, name
        _close(g, w, GRAD, name + " vs jax.grad")
        _close(g, r, REF, name + " vs f32 edge path")


@pytest.mark.parametrize("H", [None, 2])
def test_hybrid_autograd_matches_jax_and_edge_path(H):
    T, pj, pt, rest = _hybrid(420, 0.02, 64, 95)
    s1, s2, Wh, v = _operands(420, H or 1, 8, seed=12, squeeze=H is None)
    got = _torch_grads(lambda a, b, c: tfg.gat_attention_agg_hybrid(pt, rest, a, b, c), s1, s2, Wh, v)
    rj = _to_jax(rest)
    want = _jax_grads(lambda a, b, c: jfg.gat_attention_agg_hybrid(pj, rj, a, b, c), s1, s2, Wh, v)
    ref = _torch_grads(lambda a, b, c: tfg.gat_attention_agg_ref(T, a, b, c), s1, s2, Wh, v)
    for name, g, w, r in zip(("ds1", "ds2", "dWh"), got, want, ref):
        assert g.shape == w.shape == r.shape, name
        _close(g, w, GRAD, name + " vs jax.grad")
        _close(g, r, REF, name + " vs f32 edge path")


def test_backward_launches_nothing_on_cpu():
    """CPU tensors take the plain versions: the launch counters stay."""
    T = _graph(300, False, seed=13)
    B = tb_.bsr_mask_from_sparse(T, tb=128, cover_rows=True)
    s1, s2, Wh, v = _operands(300, 2, 8, seed=14)
    counters = (tfg.flash_gat_forward, tfg.flash_gat_bwd_row, tfg.flash_gat_bwd_col)
    before = [k.launches for k in counters]
    g = _torch_grads(lambda a, b, c: tfg.gat_attention_agg_fused(B, a, b, c), s1, s2, Wh, v)
    assert all(torch.isfinite(x).all() for x in g)
    assert [k.launches for k in counters] == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfg.flash_gat_bwd_row(B, *_t(s1, s2), torch.zeros(384, 2), torch.ones(384, 2),
                              torch.from_numpy(Wh).to("meta"), torch.zeros(300, 2, 8))
