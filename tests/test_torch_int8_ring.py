"""The host side and the data flow of the int8 ring K8
(``csrc/fused_agg_int8_ring.cu``), on the CPU, against the plain K8 and the
JAX package's Pallas kernel in interpret mode on the same numpy inputs; and
the same kernel as the ring K7 (tile steps only, over
``BSRMatrix.edge_ring``'s row pieces) against the plain K7 and its Pallas
kernel.

The kernel walks ``FusedAggPlan.edge_ring`` (tile products only on the
tiles that carry an edge, i.e. hold a byte other than -128), flips bit 7 of
each shifted byte to get the unsigned Aq, multiplies u8 x s8 into int32 in
64-deep slabs (a tile step's B is Hq staged transposed, a chunk slab's B the
gathered Hq rows transposed, its A a value-carrying one-hot built from
``slot_lv8``), and sums split runs' int32 partials in order.
``_ring_walk`` repeats that walk in PyTorch."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import bsr as jbsr
from sgracex1_tpu.ops import dispatch as jdis
from sgracex1_tpu.ops import fused_agg as jfa
from sgracex1_tpu.quant import int8 as jq
from sgracex1_tpu.quant.affine import QuantConstants as JConst
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.graph.csr import _round_up
from sgracex1_tpu_torch.ops import bsr as tbsr
from sgracex1_tpu_torch.ops import fused_agg as tfa
from sgracex1_tpu_torch.ops.dispatch import split_by_tile_density
from sgracex1_tpu_torch.quant import int8 as tq
from sgracex1_tpu_torch.quant.affine import QuantConstants as TConst

torch.set_num_threads(1)

SLAB = 64  # reduction depth of a ring slab


def _uc(cls):
    return cls(s_o=1.0, s=1.0 / 255.0, z=0, qbits=8, signed=False)


def _graph(n, tb, seed):
    """Hub rows (dense tiles; row block 0 a run longer than a work item),
    random edges (a remainder), row block 2 without an edge (its only tile a
    cover tile), column block 3 without a dense tile (a cover tile (0, 3)),
    and edges whose value quantizes to 0."""
    rng = np.random.default_rng(seed)
    hub = np.stack([rng.integers(0, tb // 2, 20 * n), rng.integers(0, n, 20 * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 3 * n)), hub, hub[::-1]], axis=1), axis=1)
    ei = ei[:, (ei[0] // tb != 2) & ~((ei[1] // tb == 3) & (ei[0] < tb // 2))]
    v = rng.uniform(0.01, 1.0, ei.shape[1]).astype(np.float32)
    v[rng.random(ei.shape[1]) < 0.05] = 1e-4  # below half a grid step: 0
    T = pt.SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))
    J = JSparse.from_coo(ei[0], ei[1], v, (n, n))
    return J, T


def _jax_thresh(tb):
    return int(np.ceil(jdis._tile_cost_s(tb, 1.0) / (jdis._REST_SLOT_S + jdis._REST_CHUNK_S / jdis._REST_K)))


def _plan(T, tb, attach, thresh):
    """The int8 hybrid plan with the ring schedule, either attach mode."""
    c_a = _uc(TConst)
    part, rest = split_by_tile_density(T, tb, thresh)
    keys = tbsr.bsr_tile_keys(part, tb, cover_rows=True, cover_cols=True)
    B8 = tq.bsr_int8_from_sparse(part, c_a, tb=tb, cover_cols=True, device="cpu")
    return tfa.build_fused_plan(B8, rest.with_vals(tq._quantize_vals(rest.vals, c_a)), attach_chunks=attach,
                                edge_tiles=tq.int8_edge_tiles(part, c_a, tb, keys))


def _ring_walk(plan, Hq):
    """The int8 ring K8's data flow, in int64 (exact) wrapped to int32."""
    B, L, K = plan.B, plan.edge_ring, plan.K
    tb, P = B.tb, Hq.shape[1]
    HqT = tbsr.stage_hqt_plain(Hq, _round_up(B.n_cols, tb), B.n_cols).long()
    rows = torch.arange(tb)
    S = L.segments
    partial = torch.zeros((max(S.n_part, 1), tb, P), dtype=torch.int64)
    out = torch.zeros((B.n_row_tiles * tb, P), dtype=torch.int64)
    for rb, lo, hi, part in zip(S.seg_rb.tolist(), S.seg_lo.tolist(), S.seg_hi.tolist(), S.seg_part.tolist()):
        acc = torch.zeros((tb, P), dtype=torch.int64)
        for tile, cb, chunk, slots in L.step[lo:hi].tolist():
            if tile >= 0:
                aq = (B.tiles[tile].view(torch.uint8) ^ 0x80).long()  # the shifted byte with bit 7 flipped
                for k0 in range(0, tb, SLAB):
                    acc += aq[:, k0:k0 + SLAB] @ HqT[:, cb * tb + k0: cb * tb + k0 + SLAB].t()
            if chunk >= 0:
                for k0 in range(0, slots, SLAB):
                    lv = plan.slot_lv8[(chunk * K + k0) // SLAB].long()
                    a = torch.where(lv[None, :SLAB] == rows[:, None], lv[None, SLAB:], 0)  # value one-hot
                    s = chunk * K + k0 + torch.arange(SLAB)
                    live = plan.lrow.reshape(-1)[s] < tb
                    g = torch.where(live[:, None], Hq[plan.slot_col[s].long()].long(), 0)
                    gt = g.t()  # [P, 64]: the slab as the consumers transpose it, K-major
                    acc += a @ gt.t()
        if part >= 0:
            partial[part] = acc
        else:
            out[rb * tb:(rb + 1) * tb] = acc
    for rb, p0, np_ in zip(S.fin_rb.tolist(), S.fin_p0.tolist(), S.fin_np.tolist()):
        out[rb * tb:(rb + 1) * tb] = partial[p0:p0 + np_].sum(0)
    wrapped = (out + 2**31) % 2**32 - 2**31
    return wrapped.to(torch.int32)[: B.n_rows]


def _carry(B):
    return (B.tiles != -128).flatten(1).any(1)


@pytest.mark.parametrize("tb,attach", [(64, True), (64, False), (128, True), (128, False)])
def test_edge_schedule_lists_each_edge_tile_once(tb, attach):
    """edge_ring takes every tile with a nonzero unsigned byte exactly once
    and no all -128 tile; its chunk steps are ring's; B.live keeps its
    meaning (every shifted tile live); slot_lv8 holds each 64-slot slab's
    rows and values as bytes."""
    _, T = _graph(20 * tb + 45, tb, seed=tb)
    plan = _plan(T, tb, attach, max(tb * tb // 600, 2))
    carry = _carry(plan.B)
    assert (~carry).any() and bool(plan.B.live.all())
    step = plan.edge_ring.step
    tiles = step[:, 0][step[:, 0] >= 0]
    assert sorted(tiles.tolist()) == torch.nonzero(carry).flatten().tolist()
    assert plan.edge_ring.n_tile_steps == int(carry.sum())
    assert plan.edge_ring.n_dead_tile_steps == int((~carry).sum())
    chunks = lambda L: L.step[L.step[:, 2] >= 0][:, 2:].tolist()
    assert chunks(plan.edge_ring) == chunks(plan.ring)
    S = plan.edge_ring.segments
    assert set(S.seg_rb.tolist()) == set(range(plan.B.n_row_tiles)) and S.n_fin > 0
    lv = plan.slot_lv8.view(-1, 2, SLAB)
    assert torch.equal(lv[:, 0].reshape(-1), (plan.lrow.reshape(-1) & 255).to(torch.uint8))
    assert torch.equal(lv[:, 1].reshape(-1), plan.slot_scale.to(torch.uint8))
    assert (plan.slot_scale[plan.lrow.reshape(-1) < tb] == 0).any()  # a live slot whose value is 0


def test_prepare_builds_the_edge_schedule():
    """prepare_int8_hybrid's edge flags are those of its tiles."""
    tb = 64
    _, T = _graph(20 * tb + 45, tb, seed=7)
    plan = tq.prepare_int8_hybrid(T, _uc(TConst), tb=tb, rest_thresh=8, device="cpu")
    tiles = plan.edge_ring.step[:, 0]
    assert sorted(tiles[tiles >= 0].tolist()) == torch.nonzero(_carry(plan.B)).flatten().tolist()
    assert plan.edge_ring.n_dead_tile_steps > 0


@pytest.mark.parametrize("tb,P", [(64, 16), (128, 8)])
def test_ring_walk_equals_plain_and_pallas(tb, P):
    """The walk on prepare_int8_hybrid's plan: torch.equal to the plain K8
    and array_equal to the Pallas kernel (interpret mode) and its JAX plan."""
    n = 20 * tb + 45
    J, T = _graph(n, tb, seed=3 * tb + P)
    plan = tq.prepare_int8_hybrid(T, _uc(TConst), tb=tb, K=128, rest_thresh=_jax_thresh(tb), device="cpu")
    pj = jq.prepare_int8_hybrid(J, _uc(JConst), tb=tb, K=128)
    assert plan.num_rest_chunks == pj.num_rest_chunks > 0 and (~_carry(plan.B)).any()
    hq = np.random.default_rng(tb).integers(-128, 128, (n, P)).astype(np.int8)
    Hq = torch.from_numpy(hq)
    got = _ring_walk(plan, Hq)
    assert torch.equal(got, tfa.bsr_spmm_int8_fused_plain(plan, Hq))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.int8_hybrid_agg(pj, jnp.asarray(hq))))
    assert not got[2 * tb: 3 * tb].any()


@pytest.mark.parametrize("tb,P", [(64, 32), (128, 16)])
def test_ring_walk_unattached_chunks(tb, P):
    """Chunk-only steps (kind 1) beside tile steps: the walk equals the plain
    K8 and the Pallas kernel on the JAX package's plan of the same split."""
    n = 20 * tb + 45
    J, T = _graph(n, tb, seed=5 * tb)
    thresh = max(tb * tb // 600, 2)
    plan = _plan(T, tb, False, thresh)
    assert set(plan.step_kind.tolist()) == {0, 1}
    cj = _uc(JConst)
    jpart, jrest = jdis.split_by_tile_density(J, tb, thresh)
    jplan = jfa.build_fused_plan(jq.bsr_int8_from_sparse(jpart, cj, tb=tb, cover_cols=True),
                                 jrest.with_vals(tq._quantize_vals(np.asarray(jrest.vals), cj)),
                                 attach_chunks=False)
    hq = np.random.default_rng(P).integers(-127, 128, (n, P)).astype(np.int8)
    got = _ring_walk(plan, torch.from_numpy(hq))
    assert torch.equal(got, tfa.bsr_spmm_int8_fused_plain(plan, torch.from_numpy(hq)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfa.bsr_spmm_int8_fused(jplan, jnp.asarray(hq))))


def test_stage_hqt_plain_is_the_padded_transpose():
    hq = torch.from_numpy(np.random.default_rng(0).integers(-128, 128, (300, 48)).astype(np.int8))
    t = tbsr.stage_hqt_plain(hq, 320, 290)
    assert t.shape == (48, 320) and t.dtype == torch.int8
    assert torch.equal(t[:, :290], hq[:290].t()) and not t[:, 290:].any()


@pytest.mark.parametrize("tb,P,K,ptr,ok", [(256, 128, 128, 0, True), (64, 16, 64, 16, True), (192, 144, 128, 0, True),
                                           (128, 8, 128, 0, False), (128, 100, 128, 0, False),
                                           (32, 128, 128, 0, False), (512, 128, 128, 0, False),
                                           (128, 128, 32, 0, False), (128, 128, 128, 8, False)])
def test_int8_ring_shape_rule(tb, P, K, ptr, ok):
    """Tile heights 64-256 in steps of 64, Hq rows of whole 16-byte pieces
    at an aligned address, chunks of whole 64-slot slabs."""
    assert tfa.int8_ring_shape_ok(tb, P, K, ptr) == ok


def test_edge_tiles_contract():
    """edge_tiles belongs to value-mode plans on the 0..255 grid."""
    tb = 64
    _, T = _graph(20 * tb + 45, tb, seed=9)
    plan = _plan(T, tb, True, 8)
    edge = _carry(plan.B).numpy()
    with pytest.raises(ValueError, match="one flag a tile"):
        tfa.build_fused_plan(plan.B, None, edge_tiles=edge[:-1])
    part, rest = split_by_tile_density(T, tb, 8)
    with pytest.raises(ValueError, match="0..255"):
        tfa.build_fused_plan(plan.B, rest, edge_tiles=edge)  # unquantized values
    bare = tfa.build_fused_plan(plan.B, None)
    assert bare.edge_ring is None and bare.slot_lv8 is None
    assert dataclasses.replace(plan, edge_ring=None).edge_ring is None


# ------------------------------------------------------- the ring K7


def _k7_graph(n, tb, seed):
    """Hub rows (row block 0 a run longer than a work item), random edges,
    row block 1 without an edge (its only tile a cover tile), no edge in the
    lower rows of row block 2's tiles (at tb = 512 a row half of -128 bytes
    only), and edges whose value quantizes to 0."""
    rng = np.random.default_rng(seed)
    hub = np.stack([rng.integers(0, 40, 12 * n), rng.integers(0, n, 12 * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 3 * n)), hub], axis=1), axis=1)
    ei = ei[:, (ei[0] // tb != 1) & ~((ei[0] // tb == 2) & (ei[0] % tb >= tb // 2))]
    v = rng.uniform(0.01, 1.0, ei.shape[1]).astype(np.float32)
    v[rng.random(ei.shape[1]) < 0.05] = 1e-4  # below half a grid step: 0
    return JSparse.from_coo(ei[0], ei[1], v, (n, n)), pt.SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))


def _k7_walk(B, Hq):
    """The ring K7's data flow: each work item a row piece of th rows over
    ``B.edge_ring``'s piece steps, the shifted bytes with bit 7 flipped times
    HqT in 64-deep slabs over the whole tile width, in int64 (exact) wrapped
    to int32; split runs summed in order; rows without a step zero."""
    L = B.edge_ring
    tb, P = B.tb, Hq.shape[1]
    th = tbsr.k7_row_piece(tb)
    HqT = tbsr.stage_hqt_plain(Hq, _round_up(B.n_cols, tb), min(Hq.shape[0], B.n_cols)).long()
    pieces = B.tiles.view(-1, th, tb)
    S = L.segments
    partial = torch.zeros((max(S.n_part, 1), th, P), dtype=torch.int64)
    out = torch.zeros((B.n_row_tiles * tb, P), dtype=torch.int64)
    for q, lo, hi, part in zip(S.seg_rb.tolist(), S.seg_lo.tolist(), S.seg_hi.tolist(), S.seg_part.tolist()):
        acc = torch.zeros((th, P), dtype=torch.int64)
        for piece, cb, chunk, _ in L.step[lo:hi].tolist():
            assert chunk == -1 and piece >= 0
            aq = (pieces[piece].view(torch.uint8) ^ 0x80).long()
            for k0 in range(0, tb, SLAB):
                acc += aq[:, k0:k0 + SLAB] @ HqT[:, cb * tb + k0: cb * tb + k0 + SLAB].t()
        if part >= 0:
            partial[part] = acc
        else:
            out[q * th:(q + 1) * th] = acc
    for q, p0, np_ in zip(S.fin_rb.tolist(), S.fin_p0.tolist(), S.fin_np.tolist()):
        out[q * th:(q + 1) * th] = partial[p0:p0 + np_].sum(0)
    return ((out + 2**31) % 2**32 - 2**31).to(torch.int32)


@pytest.mark.parametrize("tb", [64, 256, 512])
def test_k7_edge_schedule_lists_each_edge_piece_once(tb):
    """edge_ring takes every row piece with a byte other than -128 exactly
    once, in run order (piece row blocks ascending), drops the all -128
    pieces, and keeps a work item for every piece row block; B.live and
    B.ring keep their meaning."""
    n = 18 * tb + 37  # row block 0 a run of more than RING_SEG_STEPS pieces
    _, T = _k7_graph(n, tb, seed=tb)
    B = tq.bsr_int8_from_sparse(T, _uc(TConst), tb=tb, device="cpu")
    th = tbsr.k7_row_piece(tb)
    nh = tb // th
    carry = (B.tiles.view(-1, th * tb) != -128).any(1)
    assert (~carry).any() and bool(B.live.all())
    assert torch.equal(B.ring.step[:, 0], torch.arange(B.num_tiles, dtype=torch.int32))
    L = B.edge_ring
    assert B.edge_ring is L  # built once and kept with the tile set
    piece = L.step[:, 0]
    assert sorted(piece.tolist()) == torch.nonzero(carry).flatten().tolist()
    assert (L.step[:, 2] == -1).all() and (L.step[:, 3] == 0).all()
    assert torch.equal(L.step[:, 1], B.tile_cb[piece.long() // nh])
    q = B.tile_rb[piece.long() // nh] * nh + piece % nh  # the piece's row block
    assert torch.equal(L.rb, q.to(torch.int32)) and bool((q[1:] >= q[:-1]).all())
    assert L.n_tile_steps == int(carry.sum()) and L.n_dead_tile_steps == int((~carry).sum())
    assert set(L.segments.seg_rb.tolist()) == set(range(B.n_row_tiles * nh)) and L.segments.n_fin > 0


@pytest.mark.parametrize("tb,th", [(64, 64), (128, 128), (192, 192), (256, 256), (320, 64), (384, 192),
                                   (512, 256), (1024, 256)])
def test_k7_row_pieces_cover_each_row_once(tb, th):
    """A tile taller than 256 rows is cut into pieces of at most 256 rows,
    a multiple of 64; the pieces of a tile cover each of its rows once."""
    assert tbsr.k7_row_piece(tb) == th
    rows = torch.arange(tb * tb).view(tb, tb)  # one tile's bytes, numbered
    pieces = rows.view(-1, th, tb)  # as the kernel's TMA map reads them
    assert pieces.shape[0] * th == tb
    assert torch.equal(torch.cat([p[:, 0] // tb for p in pieces]), torch.arange(tb))


@pytest.mark.parametrize("tb,P", [(64, 16), (64, 128), (256, 16), (256, 128), (512, 16), (512, 128)])
def test_k7_ring_walk_equals_plain_and_pallas(tb, P):
    """The ring K7's walk: torch.equal to the plain K7 and array_equal to
    the Pallas kernel (interpret mode) on the JAX package's tiles."""
    n = 3 * tb + 37
    J, T = _k7_graph(n, tb, seed=7 * tb + P)
    B = tq.bsr_int8_from_sparse(T, _uc(TConst), tb=tb, device="cpu")
    Bj = jq.bsr_int8_from_sparse(J, _uc(JConst), tb=tb)
    hq = np.random.default_rng(P).integers(-128, 128, (n, P)).astype(np.int8)
    Hq = torch.from_numpy(hq)
    got = _k7_walk(B, Hq)
    assert B.edge_ring.n_dead_tile_steps > 0
    assert torch.equal(got, tbsr.bsr_spmm_int8_plain(B, Hq))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbsr.bsr_spmm_int8(Bj, jnp.asarray(hq), interpret=True)))
    assert not got[tb: 2 * tb].any()


@pytest.mark.parametrize("tb,P,ptr,ok", [(256, 128, 0, True), (512, 16, 16, True), (64, 16, 0, True),
                                         (192, 144, 0, True), (1024, 32, 0, True), (256, 100, 0, False),
                                         (256, 8, 0, False), (96, 128, 0, False), (32, 128, 0, False),
                                         (512, 128, 8, False)])
def test_k7_ring_shape_rule(tb, P, ptr, ok):
    """Any tile height a multiple of 64 (row pieces above 256), Hq rows of
    whole 16-byte pieces at an aligned address."""
    assert tbsr.int8_ring_shape_ok_k7(tb, P, ptr) == ok
