"""The flash kernels' ablation options against the JAX package: Schraudolph's
``_fast_exp`` (bit for bit) and ``fast_exp`` in the plain K3 / K4 / K5, and
K6's chunk modes ``noscore`` / ``off`` in the plain K6, each against the
Pallas kernel at the same option in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgracex1_tpu.ops import flash_gat as jfg
from sgracex1_tpu_torch.ops import flash_gat as tfg

from test_torch_flash_gat import EXACT, _graph, _hybrid, _jax, _k3_tiles, _scores, _torch
from test_torch_flash_gat_bwd import _close, _operands, _t

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def test_fast_exp_bits_match_jax():
    """On a grid over [-200, 0] and the masked scores' -1e5 and -1e9: the
    bits of the JAX function's arithmetic, a product rounded and then a sum
    rounded (as the CUDA kernels' _rn intrinsics keep it; under jit XLA
    contracts the two into one FMA)."""
    x = np.concatenate([np.linspace(-200.0, 0.0, 400001, dtype=np.float32),
                        np.float32([-1e5, -1e9, -0.0, -1e-30])])
    want = np.asarray(jfg._fast_exp(jnp.asarray(x))).view(np.int32)
    got = tfg._fast_exp(torch.from_numpy(x)).numpy().view(np.int32)
    np.testing.assert_array_equal(got, want)
    assert (got[-4:-2] == 0).all()
    rel = np.abs(tfg._fast_exp(torch.from_numpy(x[x > -30])).numpy() / np.exp(x[x > -30]) - 1)
    assert rel.max() < 0.031
    # the fused form under jit differs by at most one unit in the last
    # place of the sum A x + B (64 at its magnitude, ~2^30)
    fused = np.asarray(jax.jit(jfg._fast_exp)(jnp.asarray(x))).view(np.int32)
    assert np.abs(fused.astype(np.int64) - got).max() <= 64


@pytest.mark.parametrize("form,tb,n,H,F", [("int8", 64, 600, 2, 16), ("packed", 1024, 1300, 1, 8),
                                           ("values", 128, 520, None, 8)])
def test_fast_exp_k3_plain_matches_pallas(form, tb, n, H, F):
    T = _graph(n, form == "values", seed=n)
    Bj, Bt = _k3_tiles(form, T, tb)
    s1, s2, Wh = _scores(n, H or 1, F, seed=n + 1, squeeze=H is None)
    out_j, m_j, l_j = (np.asarray(x) for x in
                       jfg.flash_gat_forward(Bj, *_jax(s1, s2, Wh), return_stats=True, fast_exp=True))
    out_t, m_t, l_t = tfg.flash_gat_forward(Bt, *_torch(s1, s2, Wh), return_stats=True, fast_exp=True)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(m_t.numpy(), m_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l_t.numpy(), l_j, rtol=EXACT, atol=EXACT)
    exact = tfg.flash_gat_forward(Bt, *_torch(s1, s2, Wh))
    assert not torch.equal(exact, out_t)
    # the probabilities renormalize: within the JAX test's 8e-2 of exact
    np.testing.assert_allclose(out_t.numpy(), exact.numpy(), rtol=8e-2, atol=8e-2)


@pytest.mark.parametrize("form,tb,n,H,F", [("int8", 64, 700, 2, 16), ("values", 128, 520, 1, 8)])
def test_fast_exp_k4_k5_plain_match_pallas(form, tb, n, H, F):
    T = _graph(n, form == "values", seed=n)
    Bj, Bt = _k3_tiles(form, T, tb)
    s1, s2, Wh, gO = _operands(n, H, F, seed=n + 2)
    _, m, l = jfg.flash_gat_forward(Bj, *(jnp.asarray(x) for x in (s1, s2, Wh)), return_stats=True)
    s1p, s2p, Whp, gOp = jfg._pad_bwd_operands(Bj, *(jnp.asarray(x) for x in (s1, s2)),
                                               jnp.asarray(Wh.reshape(n, H * F)), jnp.asarray(gO.reshape(n, H * F)))
    kw = dict(alpha=0.2, interpret=True, fast_exp=True)
    want_row = jfg._bwd_row_pass(Bj, s1p, s2p, m, l, Whp, gOp, **kw)
    dWh, ds2 = jfg._bwd_col_pass(Bj, s1p, s2p, m, l, want_row[0], Whp, gOp, **kw)
    args = _t(s1, s2, m, l)
    got = tfg.flash_gat_bwd_row(Bt, *args, *_t(Wh, gO), fast_exp=True)
    for name, g, w in zip(("t", "u1", "u2"), got, want_row):
        _close(g, w, EXACT, name)
    dWh_t, ds2_t = tfg.flash_gat_bwd_col(Bt, *args, torch.from_numpy(np.array(want_row[0])), *_t(Wh, gO),
                                         fast_exp=True)
    _close(dWh_t, np.asarray(dWh).reshape(-1, H, F), EXACT, "dWh")
    _close(ds2_t, ds2, EXACT, "ds2")
    assert not torch.equal(got[0], tfg.flash_gat_bwd_row_plain(Bt, *args, *_t(Wh, gO))[0])


@pytest.mark.parametrize("mode", ["noscore", "off"])
@pytest.mark.parametrize("attach,H", [(True, 2), (False, None)])
def test_chunk_modes_plain_match_pallas(mode, attach, H):
    T, pj, pt, rest = _hybrid(420, 0.02, 64, 95, attach)
    s1, s2, Wh = _scores(420, H or 1, 8, seed=6, squeeze=H is None)
    want = np.asarray(jfg.flash_gat_hybrid_forward(pj, *_jax(s1, s2, Wh), _chunk_mode=mode))
    got = tfg.flash_gat_hybrid_forward(pt, *_torch(s1, s2, Wh), _chunk_mode=mode)
    # noscore leaves the rows whose edges are all chunks with l = 0: both
    # divide their one-hot sums by 1e-30 alike
    np.testing.assert_allclose(got.numpy(), want, rtol=EXACT, atol=EXACT)
    full = tfg.flash_gat_hybrid_forward(pt, *_torch(s1, s2, Wh))
    assert not torch.equal(got, full)
    # with the stats (the backward's forward) every chunk is scored
    stats = tfg.flash_gat_hybrid_forward(pt, *_torch(s1, s2, Wh), return_stats=True, _chunk_mode=mode)
    assert torch.equal(stats[0], full)
    with pytest.raises(ValueError, match="_chunk_mode"):
        tfg.flash_gat_hybrid_forward(pt, *_torch(s1, s2, Wh), _chunk_mode="fast")


def test_chunk_mode_off_is_the_tiles_alone():
    """``off`` is K3 over the plan's tiles: the remainder is not seen."""
    T, pj, pt, rest = _hybrid(420, 0.02, 64, 95, True)
    s1, s2, Wh = _scores(420, 2, 8, seed=7)
    off = tfg.flash_gat_hybrid_forward(pt, *_torch(s1, s2, Wh), _chunk_mode="off")
    k3 = tfg.flash_gat_forward(pt.B, *_torch(s1, s2, Wh))
    torch.testing.assert_close(off, k3, rtol=1e-6, atol=1e-6)


def test_kernel_flags():
    assert tfg._kernel_flags() == 0
    assert tfg._kernel_flags(fast_exp=True) == 1
    assert [tfg._kernel_flags(chunk_mode=m) for m in tfg.CHUNK_MODES] == [0, 2, 4]
    with pytest.raises(ValueError):
        tfg._kernel_flags(chunk_mode="none")
