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

Kernel K2, ``bsr_spmm_fused``: on a CUDA tensor it launches the
hand-written kernel in ``csrc/fused_agg.cu``; on a CPU tensor it runs
``bsr_spmm_fused_plain``, the plain PyTorch version of the same function.

Kernel K8, ``bsr_spmm_int8_fused``: the exact int32 ``Aq @ Hq`` of a
value-mode plan whose tiles are shifted int8 and whose slot scales are the
remainder's 0..255 values (``quant/int8.prepare_int8_hybrid``), as
``sgracex1_tpu.ops.fused_agg.bsr_spmm_int8_fused``:
``csrc/fused_agg_int8.cu`` on a CUDA tensor, ``bsr_spmm_int8_fused_plain``
on a CPU tensor.
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
    RunSegments,
    _check_cuda_operands,
    _h_block_rows,
    _hq_blocks,
    _int8_launch_args,
    _h_operand,
    _ptr,
    _seg_args,
    _tensor,
    _tile_mode,
    _tile_products,
    _tile_products_int8,
    run_segments,
)

# remainder slots per chunk: a fixed starting point for the H100 (the JAX
# package picks among 128/256/512 by TPU-measured step costs)
DEFAULT_K = 128


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
    scalings (None in value mode). ``segments`` is the K2 launch schedule
    over the step runs."""

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
            if f.name not in ("K", "num_rest_chunks")
        })


def build_fused_plan(
    B: BSRMatrix,
    rest: Optional[SparseMatrix],
    *,
    r1_row: Optional[np.ndarray] = None,
    r1_col: Optional[np.ndarray] = None,
    K: int = DEFAULT_K,
    tile_keys: Optional[np.ndarray] = None,
    attach_chunks: bool = False,
) -> FusedAggPlan:
    """Host-side schedule build (numpy), moved to ``B``'s device.

    ``r1_row``/``r1_col`` present => rank-1 mask-tile mode: slot scales
    are ``r1_col[col]``. Absent => value mode: slot scales are the rest
    edge values. ``B`` must cover every row block (cover_rows=True).
    ``tile_keys`` (``bsr_tile_keys`` of the same matrix and cover flags)
    gives the tile layout without reading ``B``'s index tensors back.

    Without ``attach_chunks`` a row block's steps are [first tile][its
    chunks][remaining tiles]; with it, chunks ride the block's tile steps
    (kind 3) and only the overflow gets chunk-only steps."""
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
    if K % 32:
        raise ValueError(f"K must be a multiple of 32, got {K}")

    if rest is not None and rest.nnz:
        rows = _np(rest.rows)[: rest.nnz].astype(np.int64)
        cols = _np(rest.cols)[: rest.nnz].astype(np.int64)
        vals = _np(rest.vals)[: rest.nnz].astype(np.float32)
        order = np.argsort(rows // tb, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
        counts = np.bincount(rows // tb, minlength=n_rt)
    else:
        counts = np.zeros(n_rt, np.int64)

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

    device = B.tiles.device
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
        segments=run_segments(s_rb[:S], n_rt, device),
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


def bsr_spmm_fused(plan: FusedAggPlan, H: torch.Tensor) -> torch.Tensor:
    """K2: out = A @ H for the plan's tiles, remainder and scalings, bf16
    [n_rows, P]. A CPU tensor runs ``bsr_spmm_fused_plain``; a CUDA tensor
    launches ``csrc/fused_agg.cu`` or raises."""
    if H.device.type == "cpu":
        return bsr_spmm_fused_plain(plan, H)
    if H.device.type != "cuda":
        raise ValueError(f"bsr_spmm_fused runs on cpu or cuda, not {H.device}")
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
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    for name, t in floats.items():
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if plan.K % 32 or plan.lrow.shape != (plan.num_chunks, plan.K):
        raise ValueError(f"lrow must be [R, K] with K % 32 == 0, got {tuple(plan.lrow.shape)}")
    P = H.shape[1]
    out = torch.empty((B.n_rows, P), dtype=torch.bfloat16, device=H.device)
    partial = torch.empty(
        (max(S.n_part, 1), B.tb, P), dtype=torch.float32, device=H.device
    )
    err = _cuda.library().sg_fused_agg(
        _ptr(B.tiles), mode, B.tb, *_seg_args(S),
        _ptr(plan.step_cb), _ptr(plan.step_tile), _ptr(plan.step_chunk),
        _ptr(plan.step_kind), _ptr(plan.lrow), _ptr(plan.slot_col),
        _ptr(plan.slot_scale), plan.K, _ptr(plan.colscale), _ptr(plan.rowscale),
        _ptr(H), int(is_bf16), B.n_cols, P, vec, _ptr(out), _ptr(partial),
        B.n_rows,
        ctypes.c_void_p(torch.cuda.current_stream(H.device).cuda_stream),
    )
    _cuda.check(err, "bsr_spmm_fused")
    bsr_spmm_fused.launches += 1
    return out


bsr_spmm_fused.launches = 0


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


def bsr_spmm_int8_fused(plan: FusedAggPlan, Hq: torch.Tensor) -> torch.Tensor:
    """K8: the exact int32 ``Aq @ Hq`` of a hybrid full-integer plan:
    shifted-int8 tiles plus remainder chunks whose ``slot_scale`` holds the
    edges' 0..255 values. ``Hq`` is signed int8 [N, P] with
    N >= n_cols; any P runs (the kernel guards the feature dimension).
    Returns int32 [n_rows, P]. A CPU tensor runs
    ``bsr_spmm_int8_fused_plain``; a CUDA tensor launches
    ``csrc/fused_agg_int8.cu`` or raises."""
    if Hq.device.type == "cpu":
        return bsr_spmm_int8_fused_plain(plan, Hq)
    if Hq.device.type != "cuda":
        raise ValueError(f"bsr_spmm_int8_fused runs on cpu or cuda, not {Hq.device}")
    _value_mode(plan)
    B, S = plan.B, plan.segments
    vec, vec4, colsum, out, partial = _int8_launch_args(B, S, Hq, B.n_rows)
    if Hq.shape[0] < B.n_cols:
        raise ValueError(f"Hq must be [>= {B.n_cols}, P], got {tuple(Hq.shape)}")
    ints = dict(
        step_cb=plan.step_cb, step_tile=plan.step_tile,
        step_chunk=plan.step_chunk, step_kind=plan.step_kind,
        lrow=plan.lrow, slot_col=plan.slot_col, **S.tensors(),
    )
    _check_cuda_operands(dict(tiles=B.tiles, slot_scale=plan.slot_scale, **ints), Hq.device)
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if plan.slot_scale.dtype != torch.float32:
        raise ValueError(f"slot_scale must be float32, got {plan.slot_scale.dtype}")
    if plan.lrow.shape != (plan.num_chunks, plan.K):
        raise ValueError(f"lrow must be [R, K], got {tuple(plan.lrow.shape)}")
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
    return out


bsr_spmm_int8_fused.launches = 0
