"""The ring kernel of K3 / K6 (csrc/flash_gat_ring.cu), its data flow in
plain PyTorch on the CPU: the live schedules ``B.ring`` / ``plan.ring``, a
work item of R rows with every head, 64-column slabs, the running max moved
once a slab, a chunk slab reduced to the slots in the work item's rows,
split runs merged in partial order. Held against the plain K3 / K6 (``m``
equal, ``out`` and ``l`` within 2e-2: bf16(p) rounds against another running
max) and, through them, against the Pallas kernels in interpret mode; and
the shape rule that picks the kernel. K12 on the same kernel: the bitmap
folded into the live steps (``subskip_schedule``: the 64-column slabs a
populated sub-block meets) and the mask bits of empty sub-blocks cleared,
held equal to K3's flow on a bitmap of the tiles' own edges and within 2e-2
of the plain K12 on any bitmap."""

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

TOL = 2e-2  # out and l: bf16(p) rounds against the slab-granular running max
SLAB = 64  # columns a stage of the ring holds


def _rows_per_cta(H: int) -> int:
    """R of the kernel: 8 consumer warps of 32 rows and 1-2 heads each."""
    return 128 if H == 4 else 256


def _bf16r(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _keep_mask(pop, tile, tb, sb):
    """[tb, tb] bool: the positions of tile ``tile`` whose sub-block bit is
    set."""
    ns = tb // sb
    b = torch.arange(ns * ns)
    bits = ((pop[tile, b // 32] >> (b % 32)) & 1).view(ns, ns).bool()
    return bits.repeat_interleave(sb, 0).repeat_interleave(sb, 1)


def ring_emulation(B, L, s1, s2, Wh, *, alpha=0.2, plan=None, pop=None, sb=0):
    """(out [n_rows, H, F], m, l [n_rt*tb, H]) by the ring kernel's data
    flow over the live schedule ``L`` (``B.ring`` for K3, ``plan.ring`` for
    K6). Work item (segment, row group of R rows): every head at once; a
    tile step is tb/64 slabs of the tile's columns, a chunk step the slabs
    up to its last live slot, holding only the slots whose row is the work
    item's. Per slab and row the running max moves to LeakyReLU(s1 + the
    largest s2 over the row's edges in the slab); the sums are rescaled
    when it grows; p = exp(e - m) on edges, l += p, acc += bf16(p) @
    bf16(Wh). A split run's partials merge in order. With ``pop`` (K12 on
    ``subskip_schedule``'s steps) a tile step loads only the slabs of its
    last field's mask and clears the edges of empty sub-blocks."""
    if s1.dim() == 1:
        s1, s2, Wh = s1[:, None], s2[:, None], Wh[:, None, :]
    tb, H, F = B.tb, Wh.shape[1], Wh.shape[2]
    n_rt, n_ct = B.n_row_tiles, -(-B.n_cols // tb)
    R = _rows_per_cta(H)
    S1 = torch.zeros((n_rt * tb, H)); S1[: s1.shape[0]] = s1
    S2 = torch.zeros((n_ct * tb, H)); S2[: s2.shape[0]] = s2
    W = torch.zeros((n_ct * tb, H, F)); W[: Wh.shape[0]] = _bf16r(Wh)
    S, step = L.segments, L.step.long()
    out = torch.zeros((n_rt * tb, H, F))
    m_out = torch.full((n_rt * tb, H), -1e5)
    l_out = torch.zeros((n_rt * tb, H))
    n_part = max(S.n_part, 1)
    pm, pl, pacc = torch.zeros((n_part, tb, H)), torch.zeros((n_part, tb, H)), torch.zeros((n_part, tb, H, F))
    for s in range(S.n_seg):
        rb, part = int(S.seg_rb[s]), int(S.seg_part[s])
        for row0 in range(0, tb, R):
            rows = torch.arange(row0, min(row0 + R, tb))
            grow = rb * tb + rows
            m = torch.full((len(rows), H), -1e5)
            l = torch.zeros((len(rows), H))
            acc = torch.zeros((len(rows), H, F))
            slabs = []
            for g in range(int(S.seg_lo[s]), int(S.seg_hi[s])):
                tile, cb, chunk, slots = step[g].tolist()
                if tile >= 0:
                    mask = tfg._mask01(B.tiles[tile][None], tb)[0][rows] > 0  # [r, tb]
                    on = ~0
                    if pop is not None:
                        mask = mask & _keep_mask(pop, tile, tb, sb)[rows]
                        on = slots  # K12: the slabs to load
                    for k0 in range(0, tb, SLAB):
                        if (on >> (k0 // SLAB)) & 1:
                            slabs.append((mask[:, k0: k0 + SLAB], cb * tb + k0 + torch.arange(SLAB)))
                if chunk >= 0:
                    for k0 in range(0, slots, SLAB):
                        lr = plan.lrow[chunk, k0: k0 + SLAB].long()
                        mine = (lr >= row0) & (lr < row0 + R) & (lr < tb)  # the slots this work item gathers
                        cols = torch.where(mine, plan.slot_col[chunk * plan.K + k0 + torch.arange(SLAB)].long(), 0)
                        slabs.append(((lr[None, :] == rows[:, None]) & mine[None, :], cols))
            for mask, cols in slabs:
                s2c = S2[cols].T[None]  # [1, H, 64]
                edge = mask[:, None, :]  # [r, 1, 64]
                big = torch.where(edge, s2c, -torch.inf).amax(dim=-1)  # [r, H]
                x = S1[grow] + big
                x = torch.maximum(x, alpha * x)
                m_new = torch.where(big > -torch.inf, torch.maximum(m, x), m)
                corr = torch.exp(m - m_new)
                e = S1[grow][..., None] + s2c
                e = torch.maximum(e, alpha * e)
                p = torch.where(edge, torch.exp(e - m_new[..., None]), 0.0)
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + torch.einsum("rhk,khf->rhf", _bf16r(p), W[cols])
                m = m_new
            if part >= 0:
                pm[part, rows], pl[part, rows], pacc[part, rows] = m, l, acc
            else:
                m_out[grow], l_out[grow] = m, l
                out[grow] = acc / torch.clamp(l, min=1e-30)[..., None]
    for f in range(S.n_fin):
        rb, p0, np_ = int(S.fin_rb[f]), int(S.fin_p0[f]), int(S.fin_np[f])
        rows = slice(rb * tb, (rb + 1) * tb)
        M = pm[p0: p0 + np_].amax(dim=0)
        w = torch.exp(pm[p0: p0 + np_] - M)  # in partial order
        Lsum = (pl[p0: p0 + np_] * w).sum(dim=0)
        m_out[rows], l_out[rows] = M, Lsum
        out[rows] = (pacc[p0: p0 + np_] * w[..., None]).sum(dim=0) / torch.clamp(Lsum, min=1e-30)[..., None]
    return out[: B.n_rows], m_out, l_out


def _graph(n, weighted, seed, isolated=7, hub_rows=40):
    """Random edges avoiding every ``isolated``-th node, plus hub rows so
    some row block has a long run (split at a small RING_SEG_STEPS)."""
    rng = np.random.default_rng(seed)
    ei = np.concatenate([
        rng.integers(0, n, (2, 6 * n)),
        np.stack([rng.integers(0, hub_rows, 3 * n), rng.integers(0, n, 3 * n)]),
    ], axis=1)
    ei = ei[:, (ei % isolated != 3).all(axis=0)]
    ei = np.unique(np.concatenate([ei, ei[::-1]], axis=1), axis=1)
    if not weighted:
        return sym_norm(ei, n)
    v = rng.uniform(0.1, 1.0, ei.shape[1]).astype(np.float32)
    return TSparse.from_coo(ei[0], ei[1], v, (n, n))


def _scores(n, H, F, seed):
    rng = np.random.default_rng(seed)
    s1 = torch.from_numpy((rng.standard_normal((n, H)) * 2).astype(np.float32))
    s2 = torch.from_numpy((rng.standard_normal((n, H)) * 2).astype(np.float32))
    return s1, s2, torch.from_numpy(rng.standard_normal((n, H, F)).astype(np.float32))


def _hold(got, ref, squeeze=False):
    out, m, l = got
    out_r, m_r, l_r = ref
    if squeeze:
        out = out[:, 0]
    assert torch.equal(m, m_r)
    torch.testing.assert_close(out, out_r, rtol=TOL, atol=TOL)
    torch.testing.assert_close(l, l_r, rtol=TOL, atol=TOL)


def _to_jax(T):
    return JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)


# form, tb, n, H, weighted, seg_steps
K3_CASES = [
    ("int8", 128, 700, 4, False, 3),
    ("int8", 256, 900, 4, True, 2),
    ("int8", 64, 500, 2, False, 16),
    ("values", 128, 600, 1, True, 4),
    ("values", 192, 650, 2, True, 16),
]


@pytest.mark.parametrize("form,tb,n,H,weighted,seg_steps", K3_CASES)
def test_ring_flow_equals_plain_k3_and_pallas(form, tb, n, H, weighted, seg_steps):
    """K3's ring data flow against the plain K3 and the Pallas kernel."""
    T = _graph(n, weighted, seed=n)
    cover = dict(tb=tb, cover_rows=True, cover_cols=True)
    Bt = tb_.bsr_mask_from_sparse(T, **cover) if form == "int8" else tb_.bsr_from_sparse(T, **cover)
    L = tb_.recut_live_schedule(Bt.ring, Bt.n_row_tiles, seg_steps)
    s1, s2, Wh = _scores(n, H, 64, seed=n + 1)
    got = ring_emulation(Bt, L, s1, s2, Wh)
    ref = tfg.flash_gat_forward_plain(Bt, s1, s2, Wh, return_stats=True)
    _hold(got, ref)
    if seg_steps < 16:
        assert L.segments.n_fin > 0  # split runs: the merge is exercised
    # the Pallas kernel in interpret mode on the same tiles
    J = _to_jax(T)
    jcover = dict(tb=tb, cover_rows=True, cover_cols=True, device_build=False)
    Bj = jb.bsr_mask_from_sparse(J, **jcover) if form == "int8" else jb.bsr_from_sparse(J, **jcover)
    oj, mj, lj = (np.asarray(x) for x in jfg.flash_gat_forward(
        Bj, *(jnp.asarray(x.numpy()) for x in (s1, s2, Wh)), return_stats=True))
    np.testing.assert_allclose(got[0].numpy(), oj, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1].numpy(), mj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), lj, rtol=TOL, atol=TOL)


def _hybrid(n, density, tb, thresh, attach, K=128, seed=11):
    """A random graph split by tile density into (JAX plan, port plan)."""
    mat = sp.random(n, n, density=density, format="csr", random_state=seed).astype(np.float32)
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
        tb_.bsr_mask_from_sparse(part, tb=tb, **cover), rest, K=K, tile_keys=keys, attach_chunks=attach,
    )
    return pj, pt


# attach, H, tb, K, n, density, thresh
K6_CASES = [(True, 4, 128, 128, 700, 0.02, 140), (False, 2, 64, 64, 700, 0.02, 60),
            (True, 1, 256, 128, 900, 0.01, 600), (True, 4, 256, 64, 900, 0.01, 600)]


@pytest.mark.parametrize("attach,H,tb,K,n,density,thresh", K6_CASES)
def test_ring_flow_equals_plain_k6_and_pallas(attach, H, tb, K, n, density, thresh):
    """K6's ring data flow (tile slabs and chunk slabs, a work item holding
    only its rows' slots) against the plain K6 and the Pallas kernel."""
    pj, pt = _hybrid(n, density, tb, thresh, attach, K=K)
    L = tb_.recut_live_schedule(pt.ring, pt.B.n_row_tiles, 3)
    assert (L.step[:, 2] >= 0).any() and (L.step[:, 0] >= 0).any()
    s1, s2, Wh = _scores(n, H, 64, seed=5)
    got = ring_emulation(pt.B, L, s1, s2, Wh, plan=pt)
    _hold(got, tfg.flash_gat_hybrid_forward_plain(pt, s1, s2, Wh, return_stats=True))
    oj, mj, lj = (np.asarray(x) for x in jfg.flash_gat_hybrid_forward(
        pj, *(jnp.asarray(x.numpy()) for x in (s1, s2, Wh)), return_stats=True))
    np.testing.assert_allclose(got[0].numpy(), oj, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1].numpy(), mj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), lj, rtol=TOL, atol=TOL)


def test_ring_flow_cover_only_row_block_and_isolated_rows():
    """A row block whose only tile is an empty cover tile keeps one empty
    work item: its rows, like the isolated ones, come out with out exactly
    0, m = -1e5 and l = 0."""
    n, tb = 640, 128
    rng = np.random.default_rng(3)
    ei = np.unique(rng.integers(0, n, (2, 6 * n)), axis=1)
    ei = ei[:, ((ei[0] // tb) != 2) & ((ei % 9 != 4).all(axis=0))]  # row block 2 and every 9th node: no edge
    T = TSparse.from_coo(ei[0], ei[1], rng.uniform(0.5, 1.0, ei.shape[1]).astype(np.float32), (n, n))
    B = tb_.bsr_mask_from_sparse(T, tb=tb, cover_rows=True, cover_cols=True)
    only = B.tile_rb == 2
    assert int(only.sum()) == 1 and not B.live[only].any()  # one cover tile, and it is dead
    assert not (B.ring.rb == 2).any() and (B.ring.segments.seg_rb == 2).sum() == 1
    s1, s2, Wh = _scores(n, 2, 64, seed=4)
    out, m, l = ring_emulation(B, B.ring, s1, s2, Wh)
    _hold((out, m, l), tfg.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=True))
    none = torch.ones(n, dtype=torch.bool)
    none[torch.from_numpy(ei[0])] = False
    assert none[2 * tb: 3 * tb].all() and none.sum() > tb
    assert (out[none] == 0).all() and (m[:n][none] == -1e5).all() and (l[:n][none] == 0).all()


def test_ring_flow_single_head_call():
    """1-D scores with a 2-D Wh: the single-head call, R = 256."""
    T = _graph(500, False, seed=9)
    B = tb_.bsr_mask_from_sparse(T, tb=256, cover_rows=True, cover_cols=True)
    s1, s2, Wh = _scores(500, 1, 64, seed=10)
    got = ring_emulation(B, B.ring, s1[:, 0], s2[:, 0], Wh[:, 0])
    ref = tfg.flash_gat_forward_plain(B, s1[:, 0], s2[:, 0], Wh[:, 0], return_stats=True)
    _hold(got, ref, squeeze=True)


def test_flash_ring_shape_rule():
    """The ring kernel takes int8 and bf16 tiles of height 64..256, F = 64,
    H in {1, 2, 4} and chunks of whole 64-slot slabs; everything else is
    the single-stage kernel's. The rule reads the tile form and the shapes
    only, and the wrappers on the CPU run the plain versions and count
    nothing."""
    ok = tfg.flash_ring_shape_ok
    bf16, f32, i8, bits = 0, 1, 2, 3
    for mode in (bf16, i8):
        for tb in (64, 128, 192, 256):
            for H in (1, 2, 4):
                assert ok(mode, tb, H, 64) and ok(mode, tb, H, 64, 128) and ok(mode, tb, H, 64, 64)
    assert not ok(f32, 256, 4, 64) and not ok(bits, 1024, 1, 64)
    assert not ok(i8, 32, 4, 64) and not ok(i8, 96, 4, 64) and not ok(i8, 512, 1, 64) and not ok(i8, 0, 1, 64)
    assert not ok(i8, 256, 3, 64) and not ok(i8, 256, 8, 64) and not ok(i8, 256, 4, 32)
    assert not ok(i8, 256, 1, 128) and not ok(bf16, 128, 2, 40) and not ok(i8, 256, 4, 64, 32)
    assert not ok(bf16, 128, 1, 64, 96)
    T = _graph(300, False, seed=1)
    B = tb_.bsr_mask_from_sparse(T, tb=128, cover_rows=True)
    s1, s2, Wh = _scores(300, 4, 64, seed=2)
    assert tfg._takes_ring(B, Wh) and not tfg._takes_ring(B, Wh[:, :3])
    assert tfg._takes_ring(B, Wh[:, 0]) and not tfg._takes_ring(B, Wh[:, 0, :40])
    k = tfg.flash_gat_forward
    before = (k.launches, k.launches_ring, k.launches_single)
    torch.testing.assert_close(k(B, s1, s2, Wh), tfg.flash_gat_forward_plain(B, s1, s2, Wh), rtol=0, atol=0)
    assert (k.launches, k.launches_ring, k.launches_single) == before


# ------------------------------------------------------------------- K12


def _edge_pop(B, T, sb):
    return torch.from_numpy(tfg.subblock_pop_bitmap(B, T, sb))


@pytest.mark.parametrize("pop_kind", ["edges", "cut"])
@pytest.mark.parametrize("form,tb,sb", [("int8", 256, 8), ("int8", 256, 32), ("int8", 128, 64),
                                        ("values", 128, 16), ("values", 192, 48), ("int8", 64, 1)])
def test_subskip_ring_flow(form, tb, sb, pop_kind):
    """K12's ring data flow on ``subskip_schedule``: on a bitmap of the
    tiles' own edges, every result torch.equal to K3's flow on the same
    tiles (what is skipped adds exact zeros); on a bitmap that clears
    populated sub-blocks, within 2e-2 of the plain K12, and the slabs loaded
    are those a set bit meets."""
    n = 5 * tb + 31
    T = _graph(n, form == "values", seed=tb + sb)
    B = tb_.bsr_mask_from_sparse(T, tb=tb, cover_rows=True) if form == "int8" else tb_.bsr_from_sparse(
        T, tb=tb, cover_rows=True)
    s1, s2, Wh = (x[:, 0] for x in _scores(n, 1, 64, seed=sb))
    pop = _edge_pop(B, T, sb)
    if pop_kind == "cut":
        rng = np.random.default_rng(sb)
        pop = pop & torch.from_numpy(rng.integers(-2**31, 2**31, pop.shape, dtype=np.int64).astype(np.int32))
        pop[1] = 0  # a live tile with no bit: no slab loaded
    L = tfg.subskip_schedule(B, pop, sb)
    assert torch.equal(L.step[:, [1, 2]], B.ring.step[:, [1, 2]]) and L.segments is B.ring.segments
    for (tile, _, _, on), live in zip(L.step.tolist(), B.ring.step[:, 0].tolist()):
        want = int((_keep_mask(pop, live, tb, sb).view(tb, -1, SLAB).any(dim=(0, 2)).int()
                    << torch.arange(-(-tb // SLAB))).sum())
        assert on == want and tile == (live if want else -1)
    got = ring_emulation(B, L, s1, s2, Wh, pop=pop, sb=sb)
    ref = tfg.flash_gat_forward_subskip_plain(B, pop, s1, s2, Wh, sb=sb)
    torch.testing.assert_close(got[0][:, 0], ref, rtol=TOL, atol=TOL)
    if pop_kind == "edges":
        k3 = ring_emulation(B, B.ring, s1, s2, Wh)
        assert all(torch.equal(a, b) for a, b in zip(got, k3))
    else:
        assert (L.step[:, 0] < 0).any() and not torch.equal(got[0], ring_emulation(B, B.ring, s1, s2, Wh)[0])


@pytest.mark.parametrize("tb,sb", [(256, 1), (256, 8), (256, 64), (256, 128), (192, 3), (192, 96), (128, 128)])
def test_subskip_slabs(tb, sb):
    """Bit j of a tile's slab mask is set exactly when a set bit's sub-block
    meets columns 64j .. 64j + 63."""
    ns = tb // sb
    rng = np.random.default_rng(tb * sb)
    pop = torch.from_numpy(rng.integers(-2**31, 2**31, (9, -(-(ns * ns) // 32)), dtype=np.int64).astype(np.int32))
    pop[3] = 0
    pop[4] = 0
    pop[4, 0] = 1 << ((ns - 1) % 31)  # one sub-block of row 0
    got = tfg.subskip_slabs(pop, tb, sb)
    for t in range(9):
        keep = _keep_mask(pop, t, tb, sb).any(dim=0)  # [tb] columns
        want = sum(1 << j for j in range(-(-tb // SLAB)) if keep[j * SLAB:(j + 1) * SLAB].any())
        assert int(got[t]) == want
    assert int(got[3]) == 0 and int(got[4]) != 0


def test_subskip_route_rule():
    """K12 takes the ring kernel where flash_ring_shape_ok holds at one head
    (int8 or bf16 tiles of height 64..256, F = 64), any sb dividing tb;
    elsewhere the single-stage kernel. On the CPU the wrapper runs the plain
    version and counts nothing."""
    T = _graph(300, False, seed=1)
    B = tb_.bsr_mask_from_sparse(T, tb=128, cover_rows=True)
    s1, s2, Wh = (x[:, 0] for x in _scores(300, 1, 64, seed=2))
    assert tfg._takes_ring(B, Wh) and not tfg._takes_ring(B, Wh[:, :40])
    big = tb_.bsr_mask_from_sparse(T, tb=512, cover_rows=True)
    assert not tfg._takes_ring(big, Wh)
    k = tfg.flash_gat_forward_subskip
    for sb in (4, 16, 128):
        pop = _edge_pop(B, T, sb)
        before = (k.launches, k.launches_ring, k.launches_single)
        torch.testing.assert_close(k(B, pop, s1, s2, Wh, sb=sb),
                                   tfg.flash_gat_forward_subskip_plain(B, pop, s1, s2, Wh, sb=sb), rtol=0, atol=0)
        assert (k.launches, k.launches_ring, k.launches_single) == before
