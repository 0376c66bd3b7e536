"""The port's halo layers (sgracex1_tpu_torch.parallel.halo) and the halo
flash-GAT entry against sgracex1_tpu on the same numpy inputs, the JAX side
on the conftest's virtual CPU mesh, its Pallas kernels in interpret mode.

Tolerances: host arrays ``array_equal``; the f32 edge paths 1e-5; the plain
flash kernels against the interpret-mode Pallas ones 1e-3; K1 on value
tiles 2e-2 (bf16 tile operands, as tests/test_halo.py holds them)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sgracex1_tpu.ops import flash_gat as jfg
from sgracex1_tpu.ops.bsr import bsr_mask_from_sparse as j_bsr_mask
from sgracex1_tpu.parallel import halo as jh
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.ops import flash_gat as tfg
from sgracex1_tpu_torch.ops.bsr import bsr_mask_from_sparse as t_bsr_mask
from sgracex1_tpu_torch.parallel import halo as th
from sgracex1_tpu_torch.parallel.mesh import make_mesh
from sgracex1_tpu_torch.parallel.partition import pad_nodes
from tests._torch_common import dist_graph, grads_of, jax_mesh_put, leaf, to_jax

torch.set_num_threads(1)

EDGE = 1e-5  # f32 edge paths
FLASH = 1e-3  # plain flash kernels against the Pallas ones in interpret mode
BF16 = 2e-2  # bf16 tile operands against f32 values

FIELDS = ("rows_loc", "cols_loc", "vals_loc", "rows_rem", "cols_halo", "vals_rem", "send_idx")


def _np_graph(G):
    return {f: np.asarray(getattr(G, f)) for f in FIELDS}


@pytest.mark.parametrize("S", [2, 4, 8])
def test_build_halo_arrays_identical(S):
    J, T, JG, TG = dist_graph(96, S, S)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(TG, f)), np.asarray(getattr(JG, f)), err_msg=f)
    assert (TG.n_shards, TG.n_local, TG.n_pad, TG.halo_len) == (JG.n_shards, JG.n_local, JG.n_pad, JG.halo_len)
    if S == 4:
        # a directed graph: the owner -> reader lists are not their own transpose
        si = np.asarray(TG.send_idx)
        assert not np.array_equal(si, si.transpose(1, 0, 2))


def test_build_halo_no_remote_edges():
    """Block-diagonal graph: every edge local, the send lists empty."""
    g = np.random.default_rng(0)
    r = np.concatenate([g.integers(b * 16, b * 16 + 16, 40) for b in range(4)])
    c = np.concatenate([g.integers(b * 16, b * 16 + 16, 40) for b in range(4)])
    T = TSparse.from_coo(r, c, np.ones(len(r), np.float32), (64, 64))
    JG = jh.build_halo(to_jax(T), 4)[0]
    TG = th.build_halo(T, 4, device="cpu")[0]
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(TG, f)), np.asarray(getattr(JG, f)), err_msg=f)
    H = g.standard_normal((64, 8)).astype(np.float32)
    mesh = make_mesh(4, device="cpu")
    np.testing.assert_allclose(th.dist_spmm_halo(mesh, TG, torch.from_numpy(H)).numpy(), T.to_scipy() @ H,
                               rtol=EDGE, atol=EDGE)


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("exchange", [True, False])
def test_dist_spmm_halo(S, exchange):
    J, T, JG, TG = dist_graph(96, 10 + S, S)
    H = np.random.default_rng(S).standard_normal((TG.n_pad, 12)).astype(np.float32)
    jm, JGd, Hd = jax_mesh_put(S, JG, H)
    want = np.asarray(jax.jit(lambda h: jh.dist_spmm_halo(jm, JGd, h, exchange=exchange))(Hd))
    got = th.dist_spmm_halo(make_mesh(S, device="cpu"), TG, torch.from_numpy(H), exchange=exchange)
    np.testing.assert_allclose(got.numpy(), want, rtol=EDGE, atol=EDGE)
    if exchange:
        np.testing.assert_allclose(got.numpy()[: T.n_rows], T.to_scipy() @ H[: T.n_rows], rtol=EDGE, atol=EDGE)


@pytest.mark.parametrize("S", [2, 4])
def test_dist_gnn_layer_halo_grads(S):
    J, T, JG, TG = dist_graph(64, 20 + S, S)
    rng = np.random.default_rng(1)
    X = pad_nodes(rng.standard_normal((64, 8)).astype(np.float32), TG.n_pad)
    W = (rng.standard_normal((8, 6)) * 0.3).astype(np.float32)
    jm, JGd, Xd = jax_mesh_put(S, JG, X)
    loss = lambda x, w: jnp.sum(jh.dist_gnn_layer_halo(jm, JGd, x, w, relu=True) ** 2)
    jl, jg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(Xd, jnp.asarray(W))
    x, w = leaf(X), leaf(W)
    tl = torch.sum(th.dist_gnn_layer_halo(make_mesh(S, device="cpu"), TG, x, w, relu=True) ** 2)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=EDGE)
    for a, b in zip(grads_of(tl, x, w), jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=EDGE, atol=EDGE)


@pytest.mark.parametrize("S,nheads", [(2, 1), (4, 2), (8, 1)])
def test_dist_gat_layer_halo(S, nheads):
    """The edge-path halo GAT: output and the gradients of x, W and the
    attention vector."""
    J, T, JG, TG = dist_graph(96, 30 + S, S)
    rng = np.random.default_rng(2)
    X = pad_nodes(rng.standard_normal((96, 10)).astype(np.float32), TG.n_pad)
    W = (rng.standard_normal((10, 5 * nheads)) * 0.3).astype(np.float32)
    att = (rng.standard_normal((10 * nheads, 1)) * 0.3).astype(np.float32)
    jm, JGd, Xd = jax_mesh_put(S, JG, X)
    f = lambda x, w, a: jh.dist_gat_layer_halo(jm, JGd, x, w, a, nheads=nheads, relu=True)
    jout = np.asarray(jax.jit(f)(Xd, W, att))
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) ** 2), argnums=(0, 1, 2)))(Xd, jnp.asarray(W), jnp.asarray(att))
    x, w, a = leaf(X), leaf(W), leaf(att)
    out = th.dist_gat_layer_halo(make_mesh(S, device="cpu"), TG, x, w, a, nheads=nheads, relu=True)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=EDGE, atol=EDGE)
    for got, want, name in zip(grads_of(torch.sum(out ** 2), x, w, a), jg, "xWa"):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=EDGE, err_msg=name)


def _jax_bsr(JG, **kw):
    host = jax.tree.map(np.asarray, JG)
    return jh.build_halo_bsr(host, **kw)


@pytest.mark.parametrize("S,tb,mode", [(2, 8, "f32"), (4, 8, "mask"), (8, 8, "f32"), (2, 1024, "mask")])
def test_build_halo_bsr_identical(S, tb, mode):
    """Each shard's tiles, row and column blocks, forward and transposed,
    equal the JAX stack's rows for that shard (its zero padding tiles
    aside); every row block holds a tile."""
    n = 4096 if tb == 1024 else 96
    J, T, JG, TG = dist_graph(n, 40 + S, S)
    kw = dict(mask=True) if mode == "mask" else dict(dtype=jnp.float32)
    JP = _jax_bsr(JG, tb=tb, **kw)
    TP = th.build_halo_bsr(TG, tb=tb, **(dict(mask=True) if mode == "mask" else dict(dtype=torch.float32)))
    for s in range(S):
        for B, tiles, rb, cb in ((TP.preps[s].bsr, JP.tiles, JP.tile_rb, JP.tile_cb),
                                 (TP.preps[s].bsr_t, JP.tiles_t, JP.tile_rb_t, JP.tile_cb_t)):
            k = B.num_tiles
            np.testing.assert_array_equal(B.tile_rb.numpy(), np.asarray(rb)[s, :k])
            np.testing.assert_array_equal(B.tile_cb.numpy(), np.asarray(cb)[s, :k])
            np.testing.assert_array_equal(B.tiles.numpy(), np.asarray(tiles)[s, :k])
            assert not np.asarray(tiles)[s, k:].any()
            assert set(B.tile_rb.tolist()) == set(range(B.n_row_tiles))
    assert TP.preps[0].bsr.packed == (tb == 1024)


@pytest.mark.parametrize("S", [2, 4])
def test_dist_halo_bsr_forward_and_grads(S):
    """K1 per shard (plain here) against the Pallas kernel in interpret
    mode: dist_spmm_halo_bsr, and the gradients of x and W of
    dist_gnn_layer_halo_bsr (K1 on the transposed tiles)."""
    J, T, JG, TG = dist_graph(96, 50 + S, S)
    rng = np.random.default_rng(3)
    X = pad_nodes(rng.standard_normal((96, 12)).astype(np.float32), TG.n_pad)
    W = (rng.standard_normal((12, 8)) * 0.3).astype(np.float32)
    JP = _jax_bsr(JG, tb=8, dtype=jnp.float32)
    TP = th.build_halo_bsr(TG, tb=8, dtype=torch.float32)
    jm, JGd, JPd, Xd = jax_mesh_put(S, JG, JP, X)
    mesh = make_mesh(S, device="cpu")
    want = np.asarray(jax.jit(lambda h: jh.dist_spmm_halo_bsr(jm, JGd, JPd, h))(Xd))
    got = th.dist_spmm_halo_bsr(mesh, TG, TP, torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16, atol=BF16)
    loss = lambda x, w: jnp.sum(jh.dist_gnn_layer_halo_bsr(jm, JGd, JPd, x, w, relu=True) ** 2)
    jg = jax.jit(jax.grad(loss, argnums=(0, 1)))(Xd, jnp.asarray(W))
    x, w = leaf(X), leaf(W)
    tl = torch.sum(th.dist_gnn_layer_halo_bsr(mesh, TG, TP, x, w, relu=True) ** 2)
    for a, b in zip(grads_of(tl, x, w), jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=BF16, atol=BF16)


@pytest.mark.parametrize("S,nheads", [(2, 1), (4, 2)])
def test_dist_gat_layer_halo_flash(S, nheads):
    """The distributed flash GAT (K3 with its stats merged with the halo
    edges', K4 under the merged stats, K5 with the full t; plain here)
    against the JAX layer with its Pallas kernels in interpret mode: the
    output and the gradients of x, W and the attention vector; and against
    the port's edge-path layer."""
    J, T, JG, TG = dist_graph(96, 60 + S, S)
    rng = np.random.default_rng(4)
    F = 8
    X = pad_nodes(rng.standard_normal((96, 12)).astype(np.float32), TG.n_pad)
    W = (rng.standard_normal((12, F * nheads)) * 0.3).astype(np.float32)
    att = (rng.standard_normal((2 * F * nheads, 1)) * 0.3).astype(np.float32)
    JP = _jax_bsr(JG, tb=8, mask=True)
    TP = th.build_halo_bsr(TG, tb=8, mask=True)
    jm, JGd, JPd, Xd = jax_mesh_put(S, JG, JP, X)
    f = lambda x, w, a: jh.dist_gat_layer_halo_flash(jm, JGd, JPd, x, w, a, nheads=nheads, relu=True)
    jout = np.asarray(jax.jit(f)(Xd, W, att))
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) ** 2), argnums=(0, 1, 2)))(Xd, jnp.asarray(W), jnp.asarray(att))
    mesh = make_mesh(S, device="cpu")
    x, w, a = leaf(X), leaf(W), leaf(att)
    out = th.dist_gat_layer_halo_flash(mesh, TG, TP, x, w, a, nheads=nheads, relu=True)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=FLASH, atol=FLASH)
    got = grads_of(torch.sum(out ** 2), x, w, a)
    for g, want, name in zip(got, jg, "xWa"):
        np.testing.assert_allclose(g, np.asarray(want), rtol=FLASH, atol=FLASH * np.abs(want).max(), err_msg=name)
    x2, w2, a2 = leaf(X), leaf(W), leaf(att)
    ref = th.dist_gat_layer_halo(mesh, TG, x2, w2, a2, nheads=nheads, relu=True)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=BF16, atol=BF16)
    for g, r in zip(got, grads_of(torch.sum(ref ** 2), x2, w2, a2)):
        np.testing.assert_allclose(g, r, rtol=BF16, atol=BF16 * np.abs(r).max())


def _halo_inputs(rng, n, HL, E, H, F, cover_gap):
    """One shard's local mask tiles (row block ``cover_gap`` without a local
    edge: only its empty cover tile) and halo edges into every row."""
    rows = rng.integers(0, n, 4 * n)
    cols = rng.integers(0, n, 4 * n)
    keep = rows // 8 != cover_gap
    A = TSparse.from_coo(rows[keep], cols[keep], np.ones(int(keep.sum()), np.float32), (n, n))
    t = lambda *shape: (rng.standard_normal(shape) * 0.5).astype(np.float32)
    rows_rem = np.sort(rng.integers(0, n, E)).astype(np.int32)
    return dict(A=A, s1=t(n, H), s2=t(n, H), s2h=t(HL, H), Wh=t(n, H, F), halo=t(HL, H, F),
                rows_rem=rows_rem, cols_halo=rng.integers(0, HL, E).astype(np.int32),
                mask_rem=rng.random(E) < 0.9)


@pytest.mark.parametrize("H", [1, 2])
def test_flash_gat_halo_agg(H):
    """flash_gat_halo_agg alone, on the CPU (plain K3/K4/K5) against the JAX
    entry in interpret mode: the output and the gradients of s1, s2, s2h,
    Wh and halo, with a row block whose only local tile is an empty cover
    tile (its rows' softmax is all halo edges). H = 1 is the 1-D call."""
    rng = np.random.default_rng(5 + H)
    n, HL, E, F = 48, 24, 120, 8
    d = _halo_inputs(rng, n, HL, E, H, F, cover_gap=2)
    JB = j_bsr_mask(to_jax(d["A"]), tb=8, cover_rows=True, cover_cols=True)
    TB = t_bsr_mask(d["A"], tb=8, cover_rows=True, cover_cols=True)
    assert not TB.live[TB.tile_rb == 2].any()
    sq = lambda k: d[k][:, 0] if H == 1 else d[k]
    diff = ("s1", "s2", "s2h", "Wh", "halo")
    jargs = [jnp.asarray(sq(k)) for k in diff]
    edges = (jnp.asarray(d["rows_rem"]), jnp.asarray(d["cols_halo"]), jnp.asarray(d["mask_rem"]))
    gO = rng.standard_normal((n, F) if H == 1 else (n, H, F)).astype(np.float32)
    jf = lambda *a: jfg.flash_gat_halo_agg(JB, *a, *edges, 0.2)
    jout, vjp = jax.vjp(jf, *jargs)
    jg = vjp(jnp.asarray(gO))
    targs = [leaf(sq(k)) for k in diff]
    tedges = [torch.from_numpy(d[k]) for k in ("rows_rem", "cols_halo", "mask_rem")]
    out = tfg.flash_gat_halo_agg(TB, *targs, *tedges, 0.2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=FLASH, atol=FLASH)
    out.backward(torch.from_numpy(gO))
    for x, want, name in zip(targs, jg, diff):
        want = np.asarray(want)
        np.testing.assert_allclose(x.grad.numpy(), want, rtol=FLASH, atol=FLASH * np.abs(want).max(), err_msg=name)
    with torch.no_grad():
        again = tfg.flash_gat_halo_agg(TB, *targs, *tedges, 0.2)
    torch.testing.assert_close(again, out.detach(), rtol=0, atol=0)
