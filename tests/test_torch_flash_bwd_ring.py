"""The backward ring kernels K4 / K5 (csrc/flash_gat_bwd_ring.cu), their
data flow in plain PyTorch on the CPU. K4: work items of R own rows with
every head over the live schedule ``B.ring``, 64-column slabs in the
kernel's permuted order. K5: work items of R own columns over the ring of
the transposed live tiles (``B.live_t``), 64-row slabs, bf16(p)^T @ gO per
slab. Split runs summed in partial order. Held against the plain K4 / K5 at
1e-4 of the largest magnitude and, through them, against the Pallas passes
in interpret mode at 1e-3; also the transposed live tiles against the JAX
package's ``bsr_transpose`` and the shape rule that picks the kernel."""

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

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

TOL = 1e-4  # emulation vs plain, of the largest magnitude: the same f32 terms summed in another order
EXACT = 1e-3  # against the Pallas passes, as tests/test_torch_flash_gat_bwd.py holds the plain versions
ALPHA = 0.2
SLAB = 64
# slab index of position n of n8 block j: a thread's 16 positions are 16
# consecutive mask bytes
PERM = torch.tensor([16 * (n >> 1) + 2 * ((j + (n >> 1)) & 7) + (n & 1) for j in range(8) for n in range(8)])


def _own_rows(H: int) -> int:
    """R of the kernels: 8 consumer warps of 32 own rows and 1-2 heads."""
    return 128 if H == 4 else 256


def _bf16r(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _slabs(T, L, s, row0, R):
    """(own rows in the tile, [(mask [r, 64] of the slab, streamed block,
    slab indices)]) of work item (segment s, own rows from row0)."""
    tb = T.tb
    rows = torch.arange(row0, min(row0 + R, tb))
    S, step = L.segments, L.step.long()
    out = []
    for g in range(int(S.seg_lo[s]), int(S.seg_hi[s])):
        tile, blk = int(step[g, 0]), int(step[g, 1])
        if tile < 0:
            continue
        mask = tfg._mask01(T.tiles[tile][None], tb)[0][rows] > 0
        for k0 in range(0, tb, SLAB):
            idx = k0 + PERM
            out.append((mask[:, idx], blk, idx))
    return rows, out


def _finish(out, part, S, tb):
    for f in range(S.n_fin):
        rb, p0, np_ = int(S.fin_rb[f]), int(S.fin_p0[f]), int(S.fin_np[f])
        acc = torch.zeros_like(part[0])
        for q in range(np_):  # in partial order
            acc += part[p0 + q]
        out[rb * tb: (rb + 1) * tb] = acc
    return out


def row_emulation(B, L, ops):
    """(t, u1, u2) [n_rt*tb, H] by the ring K4's data flow over ``L``."""
    tb, H = B.tb, ops["s1"].shape[1]
    S1, S2, M = ops["s1"], ops["s2"], ops["m"]
    Li = 1.0 / torch.clamp(ops["l"], min=1e-30)
    W, G = ops["Wh"].float(), ops["gO"].float()
    S = L.segments
    out = torch.zeros((B.n_row_tiles * tb, 3, H))
    part = torch.zeros((max(S.n_part, 1), tb, 3, H))
    for s in range(S.n_seg):
        rb, pi = int(S.seg_rb[s]), int(S.seg_part[s])
        for row0 in range(0, tb, _own_rows(H)):
            rows, slabs = _slabs(B, L, s, row0, _own_rows(H))
            gr = rb * tb + rows
            acc = torch.zeros((len(rows), 3, H))
            for mask, cb, idx in slabs:
                gc = cb * tb + idx
                x = S1[gr][:, None] + S2[gc][None]  # [r, 64, H]
                lr = torch.where(x > 0, 1.0, ALPHA)
                e = torch.maximum(x, ALPHA * x) - M[gr][:, None]
                p = torch.where(mask[..., None], torch.exp(e) * Li[gr][:, None], 0.0)
                q = torch.einsum("rhf,chf->rch", G[gr], W[gc])
                acc += torch.stack(((p * q).sum(1), (p * q * lr).sum(1), (p * lr).sum(1)), dim=1)
            if pi >= 0:
                part[pi, rows] = acc
            else:
                out[gr] = acc
    out = _finish(out, part, S, tb)
    return out[:, 0], out[:, 1], out[:, 2]


def col_emulation(B, L, ops):
    """(dWh [n_ct*tb, H, F], ds2 [n_ct*tb, H]) by the ring K5's data flow
    over ``L``, the ring of ``B.live_t`` (own rows: A's columns)."""
    Bt = B.live_t
    tb, H, F = B.tb, ops["s1"].shape[1], ops["Wh"].shape[2]
    S1, S2, M, T = ops["s1"], ops["s2"], ops["m"], ops["t"]
    Li = 1.0 / torch.clamp(ops["l"], min=1e-30)
    W, G = ops["Wh"].float(), ops["gO"].float()
    S = L.segments
    n_ct = -(-B.n_cols // tb)
    dW = torch.zeros((n_ct * tb, H, F))
    ds2 = torch.zeros((n_ct * tb, H))
    pdW = torch.zeros((max(S.n_part, 1), tb, H, F))
    pds2 = torch.zeros((max(S.n_part, 1), tb, H))
    for s in range(S.n_seg):
        cb, pi = int(S.seg_rb[s]), int(S.seg_part[s])
        for col0 in range(0, tb, _own_rows(H)):
            cols, slabs = _slabs(Bt, L, s, col0, _own_rows(H))
            gc = cb * tb + cols
            aw = torch.zeros((len(cols), H, F))
            ad = torch.zeros((len(cols), H))
            for mask, rb, idx in slabs:  # mask [own columns, 64 rows]
                gr = rb * tb + idx
                x = S2[gc][:, None] + S1[gr][None]  # [c, 64, H]
                lr = torch.where(x > 0, 1.0, ALPHA)
                e = torch.maximum(x, ALPHA * x) - M[gr][None]
                p = torch.where(mask[..., None], torch.exp(e) * Li[gr][None], 0.0)
                q = torch.einsum("chf,rhf->crh", W[gc], G[gr])
                ad += (p * (q - T[gr][None]) * lr).sum(1)
                aw += torch.einsum("crh,rhf->chf", _bf16r(p), G[gr])
            if pi >= 0:
                pdW[pi, cols], pds2[pi, cols] = aw, ad
            else:
                dW[gc], ds2[gc] = aw, ad
    return _finish(dW, pdW, S, tb), _finish(ds2, pds2, S, tb)


def _graph(n, weighted, seed, isolated=7, hub=40):
    """Random edges avoiding every ``isolated``-th node, plus hub rows and
    (symmetrized) hub columns, so some row and column runs are long."""
    rng = np.random.default_rng(seed)
    ei = np.concatenate([
        rng.integers(0, n, (2, 5 * n)),
        np.stack([rng.integers(0, hub, 3 * n), rng.integers(0, n, 3 * n)]),
    ], axis=1)
    ei = ei[:, (ei % isolated != 3).all(axis=0)]
    ei = np.unique(np.concatenate([ei, ei[::-1]], axis=1), axis=1)
    if not weighted:
        return sym_norm(ei, n)
    v = rng.uniform(0.1, 1.0, ei.shape[1]).astype(np.float32)
    return TSparse.from_coo(ei[0], ei[1], v, (n, n))


def _operands(n, H, F, seed):
    rng = np.random.default_rng(seed)
    s1 = (rng.standard_normal((n, H)) * 2).astype(np.float32)
    s2 = (rng.standard_normal((n, H)) * 2).astype(np.float32)
    Wh = rng.standard_normal((n, H, F)).astype(np.float32)
    gO = rng.standard_normal((n, H, F)).astype(np.float32)
    return s1, s2, Wh, gO


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def _hold(got, want, tol=TOL):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=0, atol=tol * max(scale, 1e-30))


def _to_jax(T):
    return JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)


def _both(B, L4, L5, s1, s2, m, l, Wh, gO):
    """Both emulations against the plain K4 / K5 on the same operands; the
    results (t, u1, u2, dWh, ds2)."""
    s1, s2, Wh, gO, m, l = (torch.as_tensor(np.array(x)) for x in (s1, s2, Wh, gO, m, l))
    ops = tfg.bwd_operands(B, s1, s2, Wh, gO, m, l)
    row = row_emulation(B, L4, ops)
    _hold(row, tfg.flash_gat_bwd_row_plain(B, **ops))
    ops["t"] = row[0]
    col = col_emulation(B, L5, ops)
    _hold(col, tfg.flash_gat_bwd_col_plain(B, **ops))
    return (*row, *col)


def _pallas(Bj, s1, s2, m, l, Wh, gO):
    """The JAX passes in interpret mode, with the stats padded as
    ``flash_gat_backward`` pads them."""
    n, H, F = Wh.shape
    nl = Bj.n_rows
    m = np.array(m); l = np.array(l)
    m[nl:], l[nl:] = 0.0, 1.0
    s1p, s2p, Whp, gOp = jfg._pad_bwd_operands(
        Bj, jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(Wh.reshape(n, H * F)),
        jnp.asarray(gO.reshape(n, H * F)),
    )
    kw = dict(alpha=ALPHA, interpret=True)
    t, u1, u2 = jfg._bwd_row_pass(Bj, s1p, s2p, jnp.asarray(m), jnp.asarray(l), Whp, gOp, **kw)
    dWh, ds2 = jfg._bwd_col_pass(Bj, s1p, s2p, jnp.asarray(m), jnp.asarray(l), t, Whp, gOp, **kw)
    return [np.asarray(x) for x in (t, u1, u2)] + [np.asarray(dWh).reshape(-1, H, F), np.asarray(ds2)]


def _hold_pallas(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=EXACT, atol=EXACT)


# form, tb, n, H, weighted, seg_steps
CASES = [
    ("int8", 64, 500, 2, False, 3),
    ("int8", 128, 700, 4, False, 2),
    ("int8", 256, 900, 1, True, 16),
    ("values", 128, 600, 1, True, 4),
    ("values", 256, 700, 4, True, 2),
    ("values", 64, 450, 4, True, 16),
]


@pytest.mark.parametrize("form,tb,n,H,weighted,seg_steps", CASES)
def test_bwd_ring_flow_equals_plain_and_pallas(form, tb, n, H, weighted, seg_steps):
    """K4 and K5's ring data flow against the plain K4 / K5 and the Pallas
    passes, with isolated rows and split runs."""
    T = _graph(n, weighted, seed=n + H)
    cover = dict(tb=tb, cover_rows=True, cover_cols=True)
    B = tb_.bsr_mask_from_sparse(T, **cover) if form == "int8" else tb_.bsr_from_sparse(T, **cover)
    L4 = tb_.recut_live_schedule(B.ring, B.n_row_tiles, seg_steps)
    L5 = tb_.recut_live_schedule(B.live_t.ring, B.live_t.n_row_tiles, seg_steps)
    if seg_steps < 16:
        assert L4.segments.n_fin > 0 and L5.segments.n_fin > 0  # split runs: the sums are exercised
    s1, s2, Wh, gO = _operands(n, H, 64, seed=n + 1)
    J = _to_jax(T)
    jcover = dict(cover, device_build=False)
    Bj = jb.bsr_mask_from_sparse(J, **jcover) if form == "int8" else jb.bsr_from_sparse(J, **jcover)
    _, m, l = jfg.flash_gat_forward(Bj, *(jnp.asarray(x) for x in (s1, s2, Wh)), return_stats=True)
    got = _both(B, L4, L5, s1, s2, m, l, Wh, gO)
    _hold_pallas(got, _pallas(Bj, s1, s2, m, l, Wh, gO))
    # rows with no edge: every row reduction is exactly 0
    has = torch.zeros(B.n_row_tiles * tb, dtype=torch.bool)
    has[torch.from_numpy(np.asarray(T.rows[: T.nnz])[np.asarray(T.vals[: T.nnz]) > 0]).long()] = True
    assert not has.all()
    assert all((x[~has] == 0).all() for x in got[:3])


@pytest.mark.parametrize("H", [2, 4])
def test_bwd_ring_flow_under_merged_hybrid_stats(H):
    """K4/K5 on a hybrid plan's tiles, with the (m, l) K6 merged over tiles
    and remainder chunks."""
    n, tb = 700, 64
    mat = sp.random(n, n, density=0.02, format="csr", random_state=11).astype(np.float32)
    mat.setdiag(0.9)
    T = TSparse.from_scipy(mat)
    part, rest = tdis.split_by_tile_density(T, tb, 60)
    assert part.nnz and rest.nnz
    cover = dict(cover_rows=True, cover_cols=True)
    keys = tb_.bsr_tile_keys(part, tb, **cover)
    pj = jf.build_fused_plan(jb.bsr_mask_from_sparse(_to_jax(part), tb=tb, device_build=False, **cover),
                             _to_jax(rest), K=128, tile_keys=keys, attach_chunks=True)
    pt = tf.build_fused_plan(tb_.bsr_mask_from_sparse(part, tb=tb, **cover), rest, K=128, tile_keys=keys,
                             attach_chunks=True)
    s1, s2, Wh, gO = _operands(n, H, 64, seed=5)
    _, m, l = jfg.flash_gat_hybrid_forward(pj, *(jnp.asarray(x) for x in (s1, s2, Wh)), return_stats=True)
    B = pt.B
    L5 = tb_.recut_live_schedule(B.live_t.ring, B.live_t.n_row_tiles, 3)
    got = _both(B, tb_.recut_live_schedule(B.ring, B.n_row_tiles, 3), L5, s1, s2, m, l, Wh, gO)
    _hold_pallas(got, _pallas(pj.B, s1, s2, m, l, Wh, gO))


def test_bwd_ring_flow_cover_only_blocks():
    """A row block and a column block whose only tile is an empty cover
    tile: no live step, one empty work item each, and their t, u1, u2, dWh
    and ds2 come out exactly 0."""
    n, tb = 640, 128
    rng = np.random.default_rng(3)
    ei = np.unique(rng.integers(0, n, (2, 6 * n)), axis=1)
    ei = ei[:, ((ei[0] // tb) != 2) & ((ei[1] // tb) != 3) & ((ei % 9 != 4).all(axis=0))]
    T = TSparse.from_coo(ei[0], ei[1], rng.uniform(0.5, 1.0, ei.shape[1]).astype(np.float32), (n, n))
    B = tb_.bsr_mask_from_sparse(T, tb=tb, cover_rows=True, cover_cols=True)
    assert int((B.tile_rb == 2).sum()) == 1 and not B.live[B.tile_rb == 2].any()
    assert int((B.tile_cb == 3).sum()) == 1 and not B.live[B.tile_cb == 3].any()
    Bt = B.live_t
    assert not (B.ring.rb == 2).any() and int((B.ring.segments.seg_rb == 2).sum()) == 1
    assert not (Bt.ring.rb == 3).any() and int((Bt.ring.segments.seg_rb == 3).sum()) == 1
    s1, s2, Wh, gO = _operands(n, 4, 64, seed=4)
    _, m, l = tfg.flash_gat_forward_plain(B, *_t(s1, s2, Wh), return_stats=True)
    t, u1, u2, dW, ds2 = _both(B, B.ring, Bt.ring, s1, s2, m, l, Wh, gO)
    rows, cols = slice(2 * tb, 3 * tb), slice(3 * tb, 4 * tb)
    assert all((x[rows] == 0).all() for x in (t, u1, u2))
    assert (dW[cols] == 0).all() and (ds2[cols] == 0).all()
    assert (t[rows.stop:] != 0).any() and (dW[: cols.start] != 0).any()


@pytest.mark.parametrize("form,tb", [("int8", 128), ("values", 64), ("int8", 256)])
def test_live_transpose_is_jax_transpose_of_live_tiles(form, tb):
    """``B.live_t`` holds exactly the JAX package's ``bsr_transpose`` tiles
    whose tile is not all zero (the live ones), in its order, and its ring
    covers every column block of A once with every tile live."""
    n = 700
    rng = np.random.default_rng(tb)
    ei = np.unique(rng.integers(0, n, (2, 3 * n)), axis=1)
    ei = ei[:, ((ei[0] // tb) != 2) & ((ei[1] // tb) != 1)]  # a cover tile in row block 2 and column block 1
    T = TSparse.from_coo(ei[0], ei[1], rng.uniform(0.5, 1.0, ei.shape[1]).astype(np.float32), (n, n))
    cover = dict(tb=tb, cover_rows=True, cover_cols=True)
    B = tb_.bsr_mask_from_sparse(T, **cover) if form == "int8" else tb_.bsr_from_sparse(T, **cover)
    J = _to_jax(T)
    jcover = dict(cover, device_build=False)
    Bj = jb.bsr_mask_from_sparse(J, **jcover) if form == "int8" else jb.bsr_from_sparse(J, **jcover)
    Jt = jb.bsr_transpose(Bj)
    tiles = np.asarray(Jt.tiles.astype(jnp.float32))
    keep = np.flatnonzero(tiles.reshape(len(tiles), -1).any(axis=1))
    Bt = B.live_t
    assert Bt is B.live_t  # built once, kept with the tile set
    assert Bt.num_tiles == len(keep) == int(B.live.sum()) < B.num_tiles
    np.testing.assert_array_equal(Bt.tiles.float().numpy(), tiles[keep])
    np.testing.assert_array_equal(Bt.tile_rb.numpy(), np.asarray(Jt.tile_rb)[keep])
    np.testing.assert_array_equal(Bt.tile_cb.numpy(), np.asarray(Jt.tile_cb)[keep])
    assert (Bt.n_rows, Bt.n_cols, Bt.tb) == (B.n_cols, B.n_rows, tb) and bool(Bt.live.all())
    n_ct = -(-B.n_cols // tb)
    S = Bt.ring.segments
    assert sorted(set(S.seg_rb.tolist())) == list(range(n_ct))
    assert Bt.ring.step.shape[0] == Bt.num_tiles
    with pytest.raises(ValueError, match="packed"):
        tb_.bsr_bitmask_from_sparse(T, tb=1024, cover_rows=True).live_t


def test_flash_bwd_ring_shape_rule():
    """The backward ring kernels take int8 and bf16 tiles of height
    64..256, F = 64 and H in {1, 2, 4}; everything else is the single-stage
    kernels'. The rule reads the tile form and the shapes only, and on the
    CPU the wrappers run the plain versions and count nothing."""
    ok = tfg.flash_bwd_ring_shape_ok
    bf16, f32, i8, bits = 0, 1, 2, 3
    for mode in (bf16, i8):
        for tb in (64, 128, 192, 256):
            for H in (1, 2, 4):
                assert ok(mode, tb, H, 64)
    assert not ok(f32, 256, 4, 64) and not ok(bits, 1024, 1, 64)
    assert not ok(i8, 32, 4, 64) and not ok(i8, 96, 4, 64) and not ok(i8, 512, 1, 64) and not ok(i8, 0, 1, 64)
    assert not ok(i8, 256, 3, 64) and not ok(i8, 256, 8, 64) and not ok(i8, 256, 4, 32) and not ok(bf16, 128, 1, 128)
    T = _graph(300, False, seed=1)
    B = tb_.bsr_mask_from_sparse(T, tb=128, cover_rows=True)
    s1, s2, Wh, gO = _t(*_operands(300, 4, 64, seed=2))
    assert tfg._takes_bwd_ring(B, Wh) and not tfg._takes_bwd_ring(B, Wh[:, :3])
    assert not tfg._takes_bwd_ring(B, Wh[:, :, :40]) and not tfg._takes_bwd_ring(B, Wh[:, 0])
    _, m, l = tfg.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=True)
    counters = (tfg.flash_gat_bwd_row, tfg.flash_gat_bwd_col)
    before = [(k.launches, k.launches_ring, k.launches_single) for k in counters]
    got = tfg.flash_gat_bwd_row(B, s1, s2, m, l, Wh, gO)
    want = tfg.flash_gat_bwd_row_plain(B, s1, s2, m, l, Wh, gO)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = tfg.flash_gat_bwd_col(B, s1, s2, m, l, want[0], Wh, gO)
    assert all(torch.equal(g, w) for g, w in zip(got, tfg.flash_gat_bwd_col_plain(B, s1, s2, m, l, want[0], Wh, gO)))
    assert [(k.launches, k.launches_ring, k.launches_single) for k in counters] == before
