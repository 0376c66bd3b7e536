"""The host side and the data flow of the int8 ring K8
(``csrc/fused_agg_int8_ring.cu``), on the CPU, against the plain K8 and the
JAX package's Pallas kernel in interpret mode on the same numpy inputs.

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
    HqT = tfa.stage_hqt_plain(Hq, _round_up(B.n_cols, tb), B.n_cols).long()
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
    t = tfa.stage_hqt_plain(hq, 320, 290)
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
