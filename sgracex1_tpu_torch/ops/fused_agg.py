"""Fused block-sparse aggregation: tiles + remainder edges + rank-1
scalings in one kernel pass.

``A @ H = diag(r1_row) (M @ diag(r1_col) H) + rest @ H`` for a rank-1
factored adjacency (M the {0,1} mask tiles), or ``tiles @ H + rest @ H``
with value tiles. The host schedule (``FusedAggPlan``, built by
``build_fused_plan`` exactly as ``sgracex1_tpu.ops.fused_agg`` builds it)
lists, per row block, the steps that touch its output: a tile step
multiplies one tile by the column-scaled H block; a chunk step adds K
remainder edges, each a pre-scaled H row ``G = H[slot_col] * slot_scale``
landing on local row ``lrow``; kind 3 does both. The row scale applies once
per row block at the end, and the output is written in bf16.

Kernel K2, ``bsr_spmm_fused``: on a CUDA tensor it launches a hand-written
kernel: the ring kernel ``csrc/fused_agg_ring.cu`` for int8 and bf16 tiles
at the shapes ``ops/bsr.ring_shape_ok`` names (the scaled H staged once in
bf16, only the live steps of ``FusedAggPlan.ring``, a multi-stage
shared-memory ring), else the single-stage kernel ``csrc/fused_agg.cu``; on a
CPU tensor it runs ``bsr_spmm_fused_plain``, the plain PyTorch version of
the same function.

Kernel K11, ``bsr_spmm_fused_k``: K2 taking ``plan.k_steps`` schedule
entries per loop iteration on a plan built with ``k_steps=k``, as
``sgracex1_tpu.ops.fused_agg.bsr_spmm_fused_k``. On a CUDA tensor it launches
K2's ring kernel ``csrc/fused_agg_ring.cu`` with ``k`` slabs a ring stage at
the shapes ``fused_k_ring_shape_ok`` names, else
the single-stage kernel ``csrc/fused_agg_k.cu``; on a CPU tensor it runs
``bsr_spmm_fused_k_plain``.

Kernel K8, ``bsr_spmm_int8_fused``: the exact int32 ``Aq @ Hq`` of a
value-mode plan whose tiles are shifted int8 and whose slot scales are the
remainder's 0..255 values (``quant/int8.prepare_int8_hybrid``), as
``sgracex1_tpu.ops.fused_agg.bsr_spmm_int8_fused``. On a CUDA tensor it
launches the int8 ring kernel ``csrc/fused_agg_int8_ring.cu`` on a plan
that carries ``edge_ring`` at the shapes ``int8_ring_shape_ok`` names (u8 x
s8 tensor-core products over the tiles that carry an edge, Hq staged
transposed once), else the single-stage kernel ``csrc/fused_agg_int8.cu``;
on a CPU tensor it runs ``bsr_spmm_int8_fused_plain``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from sgracex1_tpu_torch.graph.csr import SparseMatrix, _np, _round_up
from sgracex1_tpu_torch.ops import _cuda
from sgracex1_tpu_torch.ops.bsr import (
    BSRMatrix,
    LiveSchedule,
    RunSegments,
    _check_cuda_operands,
    _check_int8_operands,
    _h_block_rows,
    _hq_blocks,
    _int8_launch_args,
    _h_operand,
    _launch_ring,
    _ptr,
    _stage_hqt,
    _seg_args,
    _tensor,
    _tile_mode,
    _tile_products,
    _tile_products_int8,
    _TILE_MODES,
    SEG_STEPS,
    live_schedule,
    ring_shape_ok,
    run_segments,
)

# remainder slots per chunk of a plan built with an explicit width (the
# default of build_fused_plan; the int8 hybrid and the distributed shards'
# plans): K=None takes ops/dispatch.choose_chunk_k's among 128/256/512
DEFAULT_K = 128

_TILE_I8 = _TILE_MODES[torch.int8]


@dataclasses.dataclass(frozen=True)
class FusedAggPlan:
    """One direction of the fused aggregation.

    ``step_*`` define the S steps: ``step_kind`` 0 is a tile step (tile
    ``step_tile``), 1 a chunk step (chunk ``step_chunk``), 3 both; the
    chunk of a kind-0 step is a dead id and is never read. ``step_rb``
    carries a trailing sentinel ``n_rt``. ``lrow`` [R, K] holds each
    chunk's local output rows (``tb`` marks a dead slot); ``slot_col`` /
    ``slot_scale`` [R*K] drive ``G = H[slot_col] * slot_scale``.
    ``colscale`` [n_ct*tb] / ``rowscale`` [n_rt*tb] are the rank-1
    scalings (None in value mode); with them ``slot_scale`` equals
    ``colscale[slot_col]``, which lets the ring K2 read a chunk row from the
    same scaled H as a tile's block. ``segments`` is the launch schedule
    over the step runs, every step included (K6, K8, K11 and the
    single-stage K2); ``ring`` is the ring K2's schedule over the steps
    that do work: tile products on live tiles and chunks with a live slot.

    ``edge_ring`` is the int8 ring K8's own schedule (``build_fused_plan``
    with ``edge_tiles``, as ``quant/int8.prepare_int8_hybrid`` builds it):
    tile products only on the tiles that carry an edge, i.e. hold a byte
    other than -128 (a nonzero value on the unsigned grid), and the chunks
    of ``ring``. ``B.live`` keeps its meaning: for K1 a shifted cover tile is
    not zero, so every shifted tile is live there; K8 undoes the shift
    exactly, and an all -128 tile adds 0. ``slot_lv8`` [R*K/64, 128] holds,
    for each 64-slot slab of a chunk, its 64 local rows (``lrow & 255``)
    then its 64 values as bytes: what the int8 ring reads of a chunk slab."""

    B: BSRMatrix
    step_rb: torch.Tensor  # int32[S+1]
    step_cb: torch.Tensor  # int32[S]
    step_tile: torch.Tensor  # int32[S]
    step_chunk: torch.Tensor  # int32[S]
    step_kind: torch.Tensor  # int32[S]
    lrow: torch.Tensor  # int32[R, K]
    slot_col: torch.Tensor  # int32[R*K]
    slot_scale: torch.Tensor  # f32[R*K]
    colscale: Optional[torch.Tensor]  # f32[n_ct*tb]
    rowscale: Optional[torch.Tensor]  # f32[n_rt*tb]
    K: int
    num_rest_chunks: int  # true remainder chunks (0 without a remainder)
    segments: RunSegments
    ring: LiveSchedule
    # schedule entries per loop iteration of ``bsr_spmm_fused_k``: every
    # row-block run is padded to a multiple of it with dead chunk steps
    k_steps: int = 1
    edge_ring: Optional[LiveSchedule] = None
    slot_lv8: Optional[torch.Tensor] = None  # uint8[R*K/64, 128]

    @property
    def num_steps(self) -> int:
        return self.step_cb.shape[0]

    @property
    def num_chunks(self) -> int:
        """Padded chunk count R >= 1 (the lrow leading dim)."""
        return self.lrow.shape[0]

    def to(self, device) -> "FusedAggPlan":
        mv = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(self, **{
            f.name: mv(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if f.name not in ("K", "num_rest_chunks", "k_steps")
        })


def build_fused_plan(
    B: BSRMatrix,
    rest: Optional[SparseMatrix],
    *,
    r1_row: Optional[np.ndarray] = None,
    r1_col: Optional[np.ndarray] = None,
    K: Optional[int] = DEFAULT_K,
    tile_keys: Optional[np.ndarray] = None,
    attach_chunks: bool = False,
    k_steps: int = 1,
    edge_tiles: Optional[np.ndarray] = None,
    costs=None,
) -> FusedAggPlan:
    """Host-side schedule build (numpy), moved to ``B``'s device.

    ``r1_row``/``r1_col`` present => rank-1 mask-tile mode: slot scales
    are ``r1_col[col]``. Absent => value mode: slot scales are the rest
    edge values. ``B`` must cover every row block (cover_rows=True).
    ``tile_keys`` (``bsr_tile_keys`` of the same matrix and cover flags)
    gives the tile layout without reading ``B``'s index tensors back.

    Without ``attach_chunks`` a row block's steps are [first tile][its
    chunks][remaining tiles]; with it, chunks ride the block's tile steps
    (kind 3) and only the overflow gets chunk-only steps.

    ``k_steps > 1`` pads every row-block run to a multiple of ``k_steps``
    with dead chunk steps (kind 1 on one extra chunk whose ``lrow`` is all
    ``tb``), for ``bsr_spmm_fused_k``; every kernel reads such a plan.

    ``edge_tiles`` (bool [T], value mode with shifted-int8 tiles and slot
    scales on the 0..255 grid) marks the tiles that carry an edge and builds
    the int8 ring K8's ``edge_ring`` and ``slot_lv8``.

    ``K=None`` takes the slot width the JAX package's ``build_fused_plan(K=
    None)`` rule prices cheapest for this remainder's edges a row block
    (``ops/dispatch.choose_chunk_k`` on the cost table ``costs``, default
    ``ops/dispatch.H100_COSTS``)."""
    if tile_keys is not None:
        tile_rb = (tile_keys >> 32).astype(np.int64)
        tile_cb = (tile_keys & 0xFFFFFFFF).astype(np.int64)
        if len(tile_keys) == 0:
            tile_rb = np.zeros(1, np.int64)
            tile_cb = np.zeros(1, np.int64)
    else:
        tile_rb = _np(B.tile_rb).astype(np.int64)
        tile_cb = _np(B.tile_cb).astype(np.int64)
    T, tb = len(tile_rb), B.tb
    n_rt = B.n_row_tiles
    n_ct = _round_up(B.n_cols, tb) // tb
    rank1 = r1_col is not None

    if rest is not None and rest.nnz:
        rows = _np(rest.rows)[: rest.nnz].astype(np.int64)
        cols = _np(rest.cols)[: rest.nnz].astype(np.int64)
        vals = _np(rest.vals)[: rest.nnz].astype(np.float32)
        order = np.argsort(rows // tb, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
        counts = np.bincount(rows // tb, minlength=n_rt)
    else:
        counts = np.zeros(n_rt, np.int64)
    if K is None:
        from sgracex1_tpu_torch.ops import dispatch

        K = dispatch.choose_chunk_k(counts, tb, dispatch.H100_COSTS if costs is None else costs)
    if K % 32:
        raise ValueError(f"K must be a multiple of 32, got {K}")

    nc = (-(-counts // K)).astype(np.int64)  # chunks per row block
    R = int(nc.sum())
    R_pad = max(R, 1)
    lrow = np.full((R_pad, K), tb, np.int32)
    slot_col = np.zeros(R_pad * K, np.int64)
    slot_scale = np.zeros(R_pad * K, np.float32)
    if R:
        edge_start = np.concatenate([[0], np.cumsum(counts)])
        cid = 0
        for b in np.nonzero(nc)[0]:
            base = edge_start[b]
            cnt = counts[b]
            for j in range(nc[b]):
                k = int(min(K, cnt - j * K))
                e = slice(base + j * K, base + j * K + k)
                # slots sorted by column: ascending gather addresses
                sub = np.argsort(cols[e], kind="stable")
                ec, er = cols[e][sub], rows[e][sub]
                lrow[cid, :k] = er - b * tb
                sl = slice(cid * K, cid * K + k)
                slot_col[sl] = ec
                slot_scale[sl] = r1_col[ec] if rank1 else vals[e][sub]
                cid += 1

    # step_kind: != 1 -> process the tile; >= 1 -> process the chunk
    if attach_chunks:
        tiles_per_block = np.diff(np.searchsorted(tile_rb, np.arange(n_rt + 1)))
        S = T + int(np.maximum(nc - tiles_per_block, 0).sum())
    else:
        S = T + R
    s_rb = np.empty(S + 1, np.int32)
    s_cb = np.empty(S, np.int32)
    s_tile = np.empty(S, np.int32)
    s_chunk = np.empty(S, np.int32)
    s_kind = np.empty(S, np.int32)
    tile_start = np.searchsorted(tile_rb, np.arange(n_rt + 1))
    chunk_start = np.concatenate([[0], np.cumsum(nc)])
    pos = 0
    last_chunk = 0
    for b in range(n_rt):
        t0, t1 = tile_start[b], tile_start[b + 1]
        c0, c1 = chunk_start[b], chunk_start[b + 1]
        if t0 == t1:
            if c0 != c1:
                raise ValueError(
                    "rest edges in a row block with no tiles — build the "
                    "tile set with cover_rows=True"
                )
            continue
        nt, ncb = t1 - t0, c1 - c0
        if attach_chunks:
            na = min(ncb, nt)
            n = nt + (ncb - na)
            tids = np.concatenate([np.arange(t0, t1), np.full(ncb - na, t1 - 1)])
            kinds = np.concatenate([
                np.full(na, 3, np.int64),
                np.zeros(nt - na, np.int64),
                np.ones(ncb - na, np.int64),
            ])
            dead = max(c1 - 1, 0) if ncb else last_chunk
            chks = np.concatenate([
                np.arange(c0, c0 + na),
                np.full(nt - na, dead),
                np.arange(c0 + na, c1),
            ])
        else:
            n = nt + ncb
            tids = np.concatenate([[t0], np.full(ncb, t0), np.arange(t0 + 1, t1)])
            kinds = np.concatenate(
                [[0], np.ones(ncb, np.int64), np.zeros(nt - 1, np.int64)]
            )
            chks = np.concatenate([
                [last_chunk if c0 == c1 else c0],
                np.arange(c0, c1),
                np.full(nt - 1, max(c1 - 1, 0) if c1 > c0 else last_chunk),
            ])
        sl = slice(pos, pos + n)
        s_rb[sl] = tile_rb[t0]
        s_tile[sl] = tids
        s_kind[sl] = kinds
        s_chunk[sl] = chks
        s_cb[sl] = tile_cb[tids]
        if ncb:
            last_chunk = c1 - 1
        pos += n
    if pos != S:
        raise AssertionError(f"schedule length {pos} != {S}")
    s_rb[S] = n_rt  # sentinel

    if k_steps > 1:
        run_starts = np.flatnonzero(np.r_[True, s_rb[1:S] != s_rb[: S - 1]])
        run_ends = np.r_[run_starts[1:], S]
        pads = (-(run_ends - run_starts)) % k_steps
        if pads.sum():
            # the dead chunk: all-sentinel rows, column 0, scale 0
            lrow = np.concatenate([lrow, np.full((1, K), tb, np.int32)])
            slot_col = np.concatenate([slot_col, np.zeros(K, np.int64)])
            slot_scale = np.concatenate([slot_scale, np.zeros(K, np.float32)])
            # every step, then the pads of its run: a dead step repeats the
            # run's last step with kind 1 on the dead chunk
            last = np.repeat(run_ends - 1, pads)
            src = np.concatenate([np.arange(S), last])
            is_pad = np.r_[np.zeros(S, bool), np.ones(len(last), bool)]
            order = np.argsort(src, kind="stable")
            src, is_pad = src[order], is_pad[order]
            s_cb, s_tile = s_cb[src], s_tile[src]
            s_chunk = np.where(is_pad, R_pad, s_chunk[src]).astype(np.int32)
            s_kind = np.where(is_pad, 1, s_kind[src]).astype(np.int32)
            s_rb = np.r_[s_rb[src], np.int32(n_rt)].astype(np.int32)
            S = len(src)

    # the ring K2's schedule: a tile product only on a live tile, a chunk
    # only where a slot is live (the k_steps pads are not) and only up to
    # its last live slot (the live slots lead, so a chunk that is half full
    # costs half the reduction depth)
    live = _np(B.live)[s_tile]
    tile_step = s_kind != 1
    slot_live = lrow < tb
    last_live = np.where(slot_live.any(axis=1), K - np.argmax(slot_live[:, ::-1], axis=1), 0)
    chunk_live = (last_live[s_chunk] > 0) & (s_kind >= 1)
    ring = live_schedule(
        s_rb[:S], np.where(tile_step & live, s_tile, -1), s_cb,
        np.where(chunk_live, s_chunk, -1), n_rt, B.tiles.device,
        n_dead_tile_steps=int((tile_step & ~live).sum()),
        chunk_slots=np.where(chunk_live, last_live[s_chunk], 0),
    )

    device = B.tiles.device
    edge_ring = slot_lv8 = None
    if edge_tiles is not None:
        edge = np.asarray(edge_tiles, bool)
        if rank1 or len(edge) != T:
            raise ValueError(f"edge_tiles needs a value-mode plan and one flag a tile ({T}), got {len(edge)}")
        if ((slot_scale < 0) | (slot_scale > 255) | (slot_scale != np.round(slot_scale))).any():
            raise ValueError("edge_tiles needs slot scales on the unsigned 0..255 grid")
        on = tile_step & edge[s_tile]
        edge_ring = live_schedule(
            s_rb[:S], np.where(on, s_tile, -1), s_cb, np.where(chunk_live, s_chunk, -1), n_rt, device,
            n_dead_tile_steps=int((tile_step & ~on).sum()),
            chunk_slots=np.where(chunk_live, last_live[s_chunk], 0),
        )
        if K % 64 == 0:
            slot_lv8 = _tensor(_slot_lv8(lrow, slot_scale), device)
    colscale = rowscale = None
    if rank1:
        cs = np.zeros(n_ct * tb, np.float32)
        cs[: len(r1_col)] = r1_col
        rs = np.zeros(n_rt * tb, np.float32)
        rs[: len(r1_row)] = r1_row
        colscale, rowscale = _tensor(cs, device), _tensor(rs, device)
    return FusedAggPlan(
        B=B,
        step_rb=_tensor(s_rb, device),
        step_cb=_tensor(s_cb, device),
        step_tile=_tensor(s_tile, device),
        step_chunk=_tensor(s_chunk, device),
        step_kind=_tensor(s_kind, device),
        lrow=_tensor(lrow, device),
        slot_col=_tensor(slot_col.astype(np.int32), device),
        slot_scale=_tensor(slot_scale, device),
        colscale=colscale,
        rowscale=rowscale,
        K=K,
        num_rest_chunks=R,
        # segments are cut on multiples of k_steps
        segments=run_segments(
            s_rb[:S], n_rt, device,
            seg_steps=max(SEG_STEPS // k_steps, 1) * k_steps,
        ),
        ring=ring,
        k_steps=k_steps,
        edge_ring=edge_ring,
        slot_lv8=slot_lv8,
    )


def _slot_lv8(lrow: np.ndarray, slot_scale: np.ndarray) -> np.ndarray:
    """uint8 [R*K/64, 128]: each 64-slot slab's local rows (``lrow & 255``)
    then its values as bytes (``FusedAggPlan.slot_lv8``)."""
    slabs = lambda a: a.astype(np.uint8).reshape(-1, 64)
    return np.concatenate([slabs(lrow & 255), slabs(slot_scale)], axis=1)


def pad_fused_plan(plan: FusedAggPlan, *, S: int, T: int, R: int, K: int) -> FusedAggPlan:
    """``plan`` padded to S steps, T tiles, R chunks of K slots, as JAX
    ``pad_fused_plan`` (``train/loop._pad_prep_tiles`` drives it, so that
    re-prepared batches keep one shape). Each padding adds nothing:

    - tiles pad with all-zero tiles (``ops/bsr.pad_bsr_tile_count``) that no
      step names;
    - chunks pad with dead slots (local row ``tb``, column 0, scale 0), and
      K widens every chunk with dead slots;
    - steps pad with chunk steps on chunk ``R - 1``, which must be dead,
      revisiting the last row block's run, so its output is written after
      them from the same sums. ``_pad_prep_tiles`` keeps one dead chunk
      past the true ones for that.

    The ring kernels' schedules ``ring`` and ``edge_ring`` are carried over:
    a padding step holds no live tile or slot, so the ring would drop it,
    and a live step's chunk keeps its id and live slots whatever K. The
    single-stage kernels' ``segments`` take the padding steps in;
    ``slot_lv8`` is rebuilt at the new R and K. Targets below the plan's
    raise, as does a ``k_steps`` plan (its runs are multiples of
    ``k_steps``). JAX also refuses a plan split into several calls (its
    SMEM step cap); the port launches a plan whole, so no plan is split."""
    from sgracex1_tpu_torch.ops.bsr import pad_bsr_tile_count

    S0, T0, R0, K0 = plan.num_steps, plan.B.num_tiles, plan.num_chunks, plan.K
    if (S, T, R, K) == (S0, T0, R0, K0):
        return plan
    if not (S >= S0 and T >= T0 and R >= R0 and K >= K0):
        raise ValueError(f"pad_fused_plan targets must dominate: have {(S0, T0, R0, K0)}, asked {(S, T, R, K)}")
    if plan.k_steps > 1:
        raise ValueError("cannot pad a k_steps plan: padding steps would break its runs' multiples")
    if K % 32:
        raise ValueError(f"K must be a multiple of 32, got {K}")
    tb, n_rt = plan.B.tb, plan.B.n_row_tiles
    lrow = torch.nn.functional.pad(plan.lrow, (0, K - K0, 0, R - R0), value=tb)
    slots = lambda a: torch.nn.functional.pad(a.view(R0, K0), (0, K - K0, 0, R - R0)).reshape(-1)
    slot_col, slot_scale = slots(plan.slot_col), slots(plan.slot_scale)
    pad = S - S0
    tail = lambda a, v: torch.cat([a[:S0], torch.full((pad,), int(v), dtype=a.dtype, device=a.device)])
    step_rb = torch.cat([tail(plan.step_rb, plan.step_rb[S0 - 1]), plan.step_rb[S0:]])
    slot_lv8 = plan.slot_lv8
    if slot_lv8 is not None and (K, R) != (K0, R0):
        slot_lv8 = _tensor(_slot_lv8(_np(lrow), _np(slot_scale)), slot_lv8.device)
    return dataclasses.replace(
        plan,
        B=pad_bsr_tile_count(plan.B, T),
        step_rb=step_rb,
        step_cb=tail(plan.step_cb, plan.step_cb[S0 - 1]),
        step_tile=tail(plan.step_tile, plan.step_tile[S0 - 1]),
        step_chunk=tail(plan.step_chunk, R - 1),
        step_kind=tail(plan.step_kind, 1),
        lrow=lrow, slot_col=slot_col, slot_scale=slot_scale, K=K,
        segments=run_segments(_np(step_rb[:S]), n_rt, step_rb.device),
        slot_lv8=slot_lv8,
    )


# ------------------------------------------------------------- kernel K2


def _bf16r(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def bsr_spmm_fused_plain(plan: FusedAggPlan, H: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2, rounding where the JAX kernel rounds: H to bf16;
    ``bf16(h * bf16(colscale))``; tiles to bf16; ``G`` in bf16; f32 sums;
    ``acc * rowscale`` in f32 written as bf16. Returns bf16 [n_rows, P]."""
    B = plan.B
    tb, K, P = B.tb, plan.K, H.shape[1]
    n_ct = _round_up(B.n_cols, tb) // tb
    dev = H.device
    Hb = _h_block_rows(H, n_ct * tb)
    Hs = Hb if plan.colscale is None else _bf16r(Hb * _bf16r(plan.colscale)[:, None])
    acc = torch.zeros((B.n_row_tiles, tb, P), dtype=torch.float32, device=dev)
    S = plan.num_steps
    rb = plan.step_rb[:S].long()
    kind = plan.step_kind
    t = kind != 1
    _tile_products(
        B.tiles, tb, plan.step_tile[t].long(), rb[t], plan.step_cb[t].long(),
        Hs.view(n_ct, tb, P), acc,
    )
    c = kind >= 1
    chunk = plan.step_chunk[c].long()
    slots = (chunk[:, None] * K + torch.arange(K, device=dev)).reshape(-1)
    lrow = plan.lrow.reshape(-1)[slots].long()
    live = lrow < tb
    G = _bf16r(Hb[plan.slot_col[slots].long()] * _bf16r(plan.slot_scale[slots])[:, None])
    rows = (rb[c].repeat_interleave(K) * tb + lrow)[live]
    acc.view(-1, P).index_add_(0, rows, G[live])
    out = acc.view(-1, P)
    if plan.rowscale is not None:
        out = out * plan.rowscale[:, None]
    return out[: B.n_rows].to(torch.bfloat16)


def _launch_fused(name: str, plan: FusedAggPlan, H: torch.Tensor, k_steps: int) -> torch.Tensor:
    """Check the operands and launch K2 (``k_steps`` 1, csrc/fused_agg.cu)
    or K11 (csrc/fused_agg_k.cu) on a CUDA tensor."""
    B = plan.B
    mode = _tile_mode(B.tiles, B.tb)
    is_bf16, vec = _h_operand(H, B.n_cols, B.tb)
    S = plan.segments
    ints = dict(
        step_cb=plan.step_cb, step_tile=plan.step_tile,
        step_chunk=plan.step_chunk, step_kind=plan.step_kind,
        lrow=plan.lrow, slot_col=plan.slot_col, **S.tensors(),
    )
    floats = dict(
        slot_scale=plan.slot_scale, colscale=plan.colscale,
        rowscale=plan.rowscale,
    )
    _check_cuda_operands(dict(tiles=B.tiles, **ints, **floats), H.device)
    for k, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{k} must be int32, got {t.dtype}")
    for k, t in floats.items():
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{k} must be float32, got {t.dtype}")
    if plan.K % 32 or plan.lrow.shape != (plan.num_chunks, plan.K):
        raise ValueError(f"lrow must be [R, K] with K % 32 == 0, got {tuple(plan.lrow.shape)}")
    P = H.shape[1]
    out = torch.empty((B.n_rows, P), dtype=torch.bfloat16, device=H.device)
    partial = torch.empty(
        (max(S.n_part, 1), B.tb, P), dtype=torch.float32, device=H.device
    )
    lib = _cuda.library()
    head = [_ptr(B.tiles), mode, B.tb] + ([k_steps] if k_steps > 1 else [])
    err = (lib.sg_fused_agg_k if k_steps > 1 else lib.sg_fused_agg)(
        *head, *_seg_args(S),
        _ptr(plan.step_cb), _ptr(plan.step_tile), _ptr(plan.step_chunk),
        _ptr(plan.step_kind), _ptr(plan.lrow), _ptr(plan.slot_col),
        _ptr(plan.slot_scale), plan.K, _ptr(plan.colscale), _ptr(plan.rowscale),
        _ptr(H), int(is_bf16), B.n_cols, P, vec, _ptr(out), _ptr(partial),
        B.n_rows,
        ctypes.c_void_p(torch.cuda.current_stream(H.device).cuda_stream),
    )
    _cuda.check(err, name)
    return out


def _bsr_spmm_fused_single(plan: FusedAggPlan, H: torch.Tensor) -> torch.Tensor:
    """K2 by the single-stage kernel ``csrc/fused_agg.cu``: every tile
    form, every step of ``plan.segments``."""
    out = _launch_fused("bsr_spmm_fused", plan, H, 1)
    bsr_spmm_fused.launches += 1
    bsr_spmm_fused.launches_single += 1
    return out


def _launch_fused_ring(plan: FusedAggPlan, H: torch.Tensor, k: int) -> torch.Tensor:
    """The fused ring kernel over ``plan.ring``, ``k`` slabs a ring stage
    (1: K2; 2 or 4: K11)."""
    if plan.lrow.shape != (plan.num_chunks, plan.K):
        raise ValueError(f"lrow must be [R, K], got {tuple(plan.lrow.shape)}")
    return _launch_ring(
        "fused_agg_ring", plan.B, plan.ring, H, torch.bfloat16,
        colscale=plan.colscale, rowscale=plan.rowscale, lrow=plan.lrow,
        slot_col=plan.slot_col, slot_scale=plan.slot_scale, K=plan.K,
        extra=(k, k_ring_slab_depth(k)),
    )


def _bsr_spmm_fused_ring(plan: FusedAggPlan, H: torch.Tensor) -> torch.Tensor:
    """K2 by the ring kernel ``csrc/fused_agg_ring.cu`` over ``plan.ring``."""
    out = _launch_fused_ring(plan, H, 1)
    bsr_spmm_fused.launches += 1
    bsr_spmm_fused.launches_ring += 1
    return out


def bsr_spmm_fused(plan: FusedAggPlan, H: torch.Tensor) -> torch.Tensor:
    """K2: out = A @ H for the plan's tiles, remainder and scalings, bf16
    [n_rows, P]. A CPU tensor runs ``bsr_spmm_fused_plain``; a CUDA tensor
    launches the ring kernel where ``ring_shape_ok`` holds, else the
    single-stage kernel, or raises. ``launches`` counts both;
    ``launches_ring`` / ``launches_single`` each one."""
    if H.device.type == "cpu":
        return bsr_spmm_fused_plain(plan, H)
    if H.device.type != "cuda":
        raise ValueError(f"bsr_spmm_fused runs on cpu or cuda, not {H.device}")
    B = plan.B
    if H.dim() == 2 and ring_shape_ok(_tile_mode(B.tiles, B.tb), B.tb, H.shape[1], plan.K):
        return _bsr_spmm_fused_ring(plan, H)
    return _bsr_spmm_fused_single(plan, H)


bsr_spmm_fused.launches = 0
bsr_spmm_fused.launches_ring = 0
bsr_spmm_fused.launches_single = 0


# ------------------------------------------------------------ kernel K11


def _check_k_plan(plan: FusedAggPlan, runs: bool) -> int:
    """``plan.k_steps``, after checking that the schedule is a multiple of
    it long (a kernel reads ``k_steps`` entries at a time) and, with
    ``runs``, that no group of ``k_steps`` entries straddles two row
    blocks (a comparison on the plan's device)."""
    k = plan.k_steps
    S = plan.num_steps
    ok = S % k == 0
    if ok and runs:
        ok = bool((plan.step_rb[:S].view(-1, k) == plan.step_rb[:S:k, None]).all())
    if not ok:
        raise ValueError(
            f"the plan's runs are not padded to multiples of k_steps={k}; "
            "build it with build_fused_plan(..., k_steps=k)"
        )
    return k


def bsr_spmm_fused_k_plain(plan: FusedAggPlan, H: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K11: K2's arithmetic on the padded plan (its dead
    chunk steps point at the all-sentinel chunk and add nothing), bf16
    [n_rows, P]."""
    _check_k_plan(plan, runs=True)
    return bsr_spmm_fused_plain(plan, H)


def fused_k_ring_shape_ok(mode: int, tb: int, P: int, K: int, k: int) -> bool:
    """Whether the K11 ring kernel (``csrc/fused_agg_ring.cu`` with k slabs
    a stage) takes these operands: K2's ring shapes (``ring_shape_ok``) at
    k = 2, and k = 4 for int8 tiles, whose stages of four 32-deep slabs fit
    three to the shared memory (four bf16 slabs fit one stage only).
    Everything else goes to the single-stage kernel. The rule reads shapes
    and the tile form only."""
    return ring_shape_ok(mode, tb, P, K) and (k == 2 or (k == 4 and mode == _TILE_I8))


def k_ring_slab_depth(k: int) -> int:
    """Reduction depth of one slab of the fused ring kernel at ``k`` slabs
    a stage (what fits in shared memory): 64 at k = 1 (K2) and 2, 32 at
    k = 4. The launch passes it to the kernel, which has an instantiation
    for each (tile form, k, depth) that ``fused_k_ring_shape_ok`` admits."""
    return 32 if k == 4 else 64


def _bsr_spmm_fused_k_ring(plan: FusedAggPlan, H: torch.Tensor) -> torch.Tensor:
    """K11 by the fused ring kernel ``csrc/fused_agg_ring.cu`` with ``k``
    slabs a stage (``k = plan.k_steps``) over K2's ring schedule
    ``plan.ring`` (the pads do no work and are not on it)."""
    out = _launch_fused_ring(plan, H, plan.k_steps)
    bsr_spmm_fused_k.launches += 1
    bsr_spmm_fused_k.launches_ring += 1
    return out


def _bsr_spmm_fused_k_single(plan: FusedAggPlan, H: torch.Tensor) -> torch.Tensor:
    """K11 by the single-stage kernel ``csrc/fused_agg_k.cu``: every tile
    form, every step of the padded ``plan.segments``."""
    out = _launch_fused("bsr_spmm_fused_k", plan, H, plan.k_steps)
    bsr_spmm_fused_k.launches += 1
    bsr_spmm_fused_k.launches_single += 1
    return out


def bsr_spmm_fused_k(plan: FusedAggPlan, H: torch.Tensor) -> torch.Tensor:
    """K11: ``bsr_spmm_fused`` taking ``plan.k_steps`` schedule entries per
    loop iteration (JAX ``bsr_spmm_fused_k``; build the plan with
    ``k_steps=k``, 2 or 4 on the card). The same function as K2;
    ``k_steps == 1`` is K2 itself. A CPU tensor runs
    ``bsr_spmm_fused_k_plain``; a CUDA tensor launches the ring kernel
    (``k`` slabs a ring stage) where ``fused_k_ring_shape_ok`` holds, else
    the single-stage kernel, or raises. ``launches`` counts both;
    ``launches_ring`` / ``launches_single`` each one."""
    if plan.k_steps == 1:
        return bsr_spmm_fused(plan, H)
    if H.device.type == "cpu":
        return bsr_spmm_fused_k_plain(plan, H)
    if H.device.type != "cuda":
        raise ValueError(f"bsr_spmm_fused_k runs on cpu or cuda, not {H.device}")
    # the run check would wait for the device on every launch; a plan from
    # build_fused_plan holds it, and the plain version checks it
    k = _check_k_plan(plan, runs=False)
    if k not in (2, 4):
        raise ValueError(f"the CUDA kernel takes k_steps 2 or 4, got {k}")
    B = plan.B
    if H.dim() == 2 and fused_k_ring_shape_ok(_tile_mode(B.tiles, B.tb), B.tb, H.shape[1], plan.K, k):
        return _bsr_spmm_fused_k_ring(plan, H)
    return _bsr_spmm_fused_k_single(plan, H)


bsr_spmm_fused_k.launches = 0
bsr_spmm_fused_k.launches_ring = 0
bsr_spmm_fused_k.launches_single = 0


# ------------------------------------------------------------- kernel K8


def _value_mode(plan: FusedAggPlan) -> None:
    if plan.colscale is not None or plan.rowscale is not None:
        raise ValueError("the int8 schedule must be value-mode (no rank-1 scalings)")


def bsr_spmm_int8_fused_plain(plan: FusedAggPlan, Hq: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K8: the tile steps as plain K7 (``kind != 1``), the
    chunk steps (``kind >= 1``) as int32 ``v * Hq[slot_col]`` scattered on
    the live slots' rows. Returns int32 [n_rows, P]."""
    _value_mode(plan)
    B = plan.B
    tb, K, P = B.tb, plan.K, Hq.shape[1]
    n_ct = _round_up(B.n_cols, tb) // tb
    dev = Hq.device
    Hblk, colsum = _hq_blocks(Hq, n_ct, tb)
    acc = torch.zeros((B.n_row_tiles, tb, P), dtype=torch.int32, device=dev)
    S = plan.num_steps
    rb = plan.step_rb[:S].long()
    kind = plan.step_kind
    t = kind != 1
    _tile_products_int8(
        B.tiles, tb, plan.step_tile[t].long(), rb[t], plan.step_cb[t].long(),
        Hblk, colsum, acc,
    )
    c = kind >= 1
    chunk = plan.step_chunk[c].long()
    slots = (chunk[:, None] * K + torch.arange(K, device=dev)).reshape(-1)
    lrow = plan.lrow.reshape(-1)[slots].long()
    rows = rb[c].repeat_interleave(K) * tb + lrow
    live = lrow < tb
    slots, rows = slots[live], rows[live]
    G = Hq[plan.slot_col[slots].long()].to(torch.int32)
    acc.view(-1, P).index_add_(0, rows, G * plan.slot_scale[slots].to(torch.int32)[:, None])
    return acc.view(-1, P)[: B.n_rows]


def int8_ring_shape_ok(tb: int, P: int, K: int, data_ptr: int = 0) -> bool:
    """Whether the int8 ring kernel (csrc/fused_agg_int8_ring.cu) takes
    these operands: a tile height of 64, 128, 192 or 256 (one CTA owns the
    whole height; a slab is 64 deep), Hq rows of whole 16-byte pieces at a
    16-byte-aligned address (the chunk rows are gathered 16 bytes a lane),
    chunks of whole slabs. Everything else goes to the single-stage kernel.
    The rule reads shapes and the address only."""
    return tb % 64 == 0 and tb <= 256 and P % 16 == 0 and K % 64 == 0 and data_ptr % 16 == 0


def _check_int8_plan(plan: FusedAggPlan, Hq: torch.Tensor, ints: dict) -> None:
    B = plan.B
    if Hq.shape[0] < B.n_cols:
        raise ValueError(f"Hq must be [>= {B.n_cols}, P], got {tuple(Hq.shape)}")
    _check_cuda_operands(dict(tiles=B.tiles, slot_scale=plan.slot_scale, **ints), Hq.device)
    for name, t in ints.items():
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if plan.slot_scale.dtype != torch.float32:
        raise ValueError(f"slot_scale must be float32, got {plan.slot_scale.dtype}")
    if plan.lrow.shape != (plan.num_chunks, plan.K):
        raise ValueError(f"lrow must be [R, K], got {tuple(plan.lrow.shape)}")


def _bsr_spmm_int8_fused_single(plan: FusedAggPlan, Hq: torch.Tensor) -> torch.Tensor:
    """K8 by the single-stage kernel ``csrc/fused_agg_int8.cu``: every
    step of ``plan.segments``, the shift undone by column sums."""
    _value_mode(plan)
    B, S = plan.B, plan.segments
    vec, vec4, colsum, out, partial = _int8_launch_args(B, S, Hq, B.n_rows)
    _check_int8_plan(plan, Hq, dict(
        step_cb=plan.step_cb, step_tile=plan.step_tile, step_chunk=plan.step_chunk,
        step_kind=plan.step_kind, lrow=plan.lrow, slot_col=plan.slot_col, **S.tensors(),
    ))
    err = _cuda.library().sg_fused_agg_int8(
        _ptr(B.tiles), B.tb, *_seg_args(S),
        _ptr(plan.step_cb), _ptr(plan.step_tile), _ptr(plan.step_chunk),
        _ptr(plan.step_kind), _ptr(plan.lrow), _ptr(plan.slot_col),
        _ptr(plan.slot_scale), plan.K, _ptr(Hq), Hq.shape[0], colsum.shape[0],
        Hq.shape[1], vec, vec4, _ptr(colsum), _ptr(out), _ptr(partial), B.n_rows,
        ctypes.c_void_p(torch.cuda.current_stream(Hq.device).cuda_stream),
    )
    _cuda.check(err, "bsr_spmm_int8_fused")
    bsr_spmm_int8_fused.launches += 1
    bsr_spmm_int8_fused.launches_single += 1
    return out


def _bsr_spmm_int8_fused_ring(plan: FusedAggPlan, Hq: torch.Tensor) -> torch.Tensor:
    """K8 by the int8 ring kernel ``csrc/fused_agg_int8_ring.cu`` over
    ``plan.edge_ring``: Hq staged transposed once, u8 x s8 products."""
    _value_mode(plan)
    B, L = plan.B, plan.edge_ring
    _check_int8_operands(B, Hq)
    tb, P = B.tb, Hq.shape[1]
    if L is None or plan.slot_lv8 is None or not int8_ring_shape_ok(tb, P, plan.K, Hq.data_ptr()):
        raise ValueError("the int8 ring kernel needs edge_ring, slot_lv8 and int8_ring_shape_ok")
    if not Hq.is_contiguous():
        raise ValueError("Hq must be contiguous")
    S = L.segments
    _check_int8_plan(plan, Hq, dict(step=L.step, lrow=plan.lrow, slot_col=plan.slot_col, **S.tensors()))
    _check_cuda_operands(dict(slot_lv8=plan.slot_lv8), Hq.device)
    n_pad = _round_up(B.n_cols, tb)
    HqT = _stage_hqt(Hq, n_pad, B.n_cols)
    out = torch.empty((B.n_rows, P), dtype=torch.int32, device=Hq.device)
    partial = torch.empty((max(S.n_part, 1), tb, P), dtype=torch.int32, device=Hq.device)
    err = _cuda.library().sg_fused_agg_int8_ring(
        _ptr(B.tiles), tb, tb, B.tiles.shape[0], *_seg_args(S), _ptr(L.step), _ptr(plan.lrow),
        _ptr(plan.slot_col), _ptr(plan.slot_lv8), plan.K, _ptr(HqT), n_pad, _ptr(Hq), P,
        _ptr(out), _ptr(partial), B.n_rows,
        torch.cuda.get_device_properties(Hq.device).multi_processor_count,
        ctypes.c_void_p(torch.cuda.current_stream(Hq.device).cuda_stream),
    )
    _cuda.check(err, "bsr_spmm_int8_fused_ring")
    bsr_spmm_int8_fused.launches += 1
    bsr_spmm_int8_fused.launches_ring += 1
    return out


def bsr_spmm_int8_fused(plan: FusedAggPlan, Hq: torch.Tensor) -> torch.Tensor:
    """K8: the exact int32 ``Aq @ Hq`` of a hybrid full-integer plan:
    shifted-int8 tiles plus remainder chunks whose ``slot_scale`` holds the
    edges' 0..255 values. ``Hq`` is signed int8 [N, P] with
    N >= n_cols; any P runs. Returns int32 [n_rows, P]. A CPU tensor runs
    ``bsr_spmm_int8_fused_plain``; a CUDA tensor launches the int8 ring
    kernel on a plan with ``edge_ring`` where ``int8_ring_shape_ok`` holds,
    else the single-stage kernel, or raises. ``launches`` counts both;
    ``launches_ring`` / ``launches_single`` each one."""
    if Hq.device.type == "cpu":
        return bsr_spmm_int8_fused_plain(plan, Hq)
    if Hq.device.type != "cuda":
        raise ValueError(f"bsr_spmm_int8_fused runs on cpu or cuda, not {Hq.device}")
    if (plan.edge_ring is not None and Hq.dim() == 2
            and int8_ring_shape_ok(plan.B.tb, Hq.shape[1], plan.K, Hq.data_ptr())):
        return _bsr_spmm_int8_fused_ring(plan, Hq)
    return _bsr_spmm_int8_fused_single(plan, Hq)


bsr_spmm_int8_fused.launches = 0
bsr_spmm_int8_fused.launches_ring = 0
bsr_spmm_int8_fused.launches_single = 0
