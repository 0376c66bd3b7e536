"""The one-hot plan SpMM (the ``pallas`` kind): ``out = A @ H`` over edge
groups sorted into (row block, column block) tiles.

Host side (the native library or numpy, then one move to the device):
``plan_spmm`` sorts the edges by tile, row and column and pads every
tile's edges to groups of ``be`` slots, exactly as
``sgracex1_tpu.ops.pallas_spmm.plan_spmm`` does;
the arrays are stored ``[G, be]`` (the JAX package's ``[G*8, be/8]``
sublane layout reshaped ``(-1, be)`` holds the same numbers in the same
order). ``plan_with_vals`` substitutes runtime edge values, which this
layout takes for the price of one gather.

Kernel K9, ``spmm_plan``: per slot ``f32(bf16(f32(bf16(H[col])) * val))``,
summed in f32 on the slot's row, as the TPU kernel's one-hot products
round. The TPU gathers and scatters with one-hot matmuls on its matrix
unit; here rows of H are gathered directly. On a CUDA tensor it launches
the gather kernel ``csrc/plan_spmm_gather.cu`` (H rounded to bf16 once,
the compacted slot arrays ``slot_cv``, row gathers issued ahead of their
sums) at every width: the kernel reads bf16 rows of whole 16-byte pieces,
so an H of another width, or at an address not aligned to 16 bytes, is
first copied into zero columns padded to a multiple of 8 (the columns are
independent, so the padding changes no bit of the others). On a CPU tensor
it runs ``spmm_plan_plain``, the plain PyTorch version of the same
function.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from sgracex1_tpu_torch.graph.csr import SparseMatrix, _np, _round_up
from sgracex1_tpu_torch.ops import _cuda
from sgracex1_tpu_torch.ops.bsr import (
    RunSegments,
    _PLAIN_BATCH_BYTES,
    _check_cuda_operands,
    _ptr,
    _seg_args,
    _stage_h,
    _tensor,
    run_segments,
)
from sgracex1_tpu_torch.runtime import native
from sgracex1_tpu_torch.utils.profiling import span

# slots of one output row that one worker sums before the row is split
# over several workers (a starting point, not tuned)
ROW_SEG_SLOTS = 64


@dataclasses.dataclass(frozen=True)
class SpMMPlan:
    """Host-preprocessed edge schedule of the plan kernel.

    Group ``g`` holds ``be`` slots of the tile (``tile_rb[g]``,
    ``tile_cb[g]``): local row and column, value, and the slot's edge in
    the source matrix's order (``perm``, -1 for padding; padding slots
    carry ``val == 0`` and ``lrow == lcol == 0``). Groups are sorted by
    (row block, column block); inside a tile the edges are sorted by row,
    then column.

    ``slot_idx`` lists the live slots (``perm >= 0``) sorted by output
    row, then slot, and ``segments`` cuts each row's run of that list
    into pieces of at most ``ROW_SEG_SLOTS`` (``seg_rb`` there holds the
    row): the K9 launch schedule, which value substitution leaves as it
    is. ``slot_cv`` compacts what the gather kernel reads of a live slot,
    in ``slot_idx`` order: its global column ``tile_cb[slot // be] * cb +
    lcol[slot]`` and the f32 bits of ``val[slot]``, one 8-byte pair a slot
    (``with_val`` keeps it in step with ``val``)."""

    lrow: torch.Tensor  # int32[G, be]
    lcol: torch.Tensor  # int32[G, be]
    val: torch.Tensor  # float32[G, be]
    perm: torch.Tensor  # int32[G, be]
    tile_rb: torch.Tensor  # int32[G]
    tile_cb: torch.Tensor  # int32[G]
    n_rows: int
    n_cols: int
    rb: int
    cb: int
    nnz: int
    slot_idx: torch.Tensor  # int32[nnz]
    segments: RunSegments
    slot_cv: torch.Tensor  # int32[nnz, 2]: global column, f32 bits of the value

    @property
    def num_groups(self) -> int:
        return self.val.shape[0]

    @property
    def be(self) -> int:
        return self.val.shape[1]

    def with_val(self, val: torch.Tensor) -> "SpMMPlan":
        """This plan with the group values ``val`` [G, be] (f32) and the
        compacted slot values to match."""
        val = val.to(torch.float32)
        v = val.reshape(-1).index_select(0, self.slot_idx.long()).contiguous()
        cv = torch.stack([self.slot_cv[:, 0], v.view(torch.int32)], dim=1)
        return dataclasses.replace(self, val=val, slot_cv=cv)

    def to(self, device) -> "SpMMPlan":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if f.name not in ("n_rows", "n_cols", "rb", "cb", "nnz")
        })


def _plan_arrays(r, c, v, rb: int, cb: int, be: int) -> tuple:
    """The numpy spec of ``runtime/native.plan_tiles``: (lrow, lcol, val,
    perm) each [G*be] linear and (tile_rb, tile_cb) each [G]."""
    trb, tcb = r // rb, c // cb
    order = np.lexsort((c, r, tcb, trb))
    r, c, v, trb, tcb = r[order], c[order], v[order], trb[order], tcb[order]
    uniq, starts, counts = np.unique(
        trb * (1 << 32) + tcb, return_index=True, return_counts=True
    )
    ng = -(-counts // be)  # groups per tile
    G = max(int(ng.sum()), 1)
    lrow = np.zeros(G * be, np.int32)
    lcol = np.zeros(G * be, np.int32)
    val = np.zeros(G * be, np.float32)
    perm = np.full(G * be, -1, np.int32)
    tile_rb = np.zeros(G, np.int32)
    tile_cb = np.zeros(G, np.int32)
    if len(uniq):
        tile_of_group = np.repeat(np.arange(len(uniq)), ng)
        tile_rb[:] = (uniq >> 32)[tile_of_group]
        tile_cb[:] = (uniq & 0xFFFFFFFF)[tile_of_group]
        tile_of_edge = np.repeat(np.arange(len(uniq)), counts)
        pos = np.arange(len(r)) - starts[tile_of_edge]  # rank inside the tile
        slot = ((np.cumsum(ng) - ng)[tile_of_edge] + pos // be) * be + pos % be
        lrow[slot] = r - trb * rb
        lcol[slot] = c - tcb * cb
        val[slot] = v
        perm[slot] = order
    return lrow, lcol, val, perm, tile_rb, tile_cb


def plan_spmm(
    A: SparseMatrix, *, rb: int = 1024, cb: int = 1024, be: int = 1024,
    device="cpu",
) -> SpMMPlan:
    """Sort edges into (row-block, col-block) tiles and pad to edge groups
    (on the host: the native library's ``plan_tiles`` where it is
    available, as the JAX package, else the numpy spec; the tensors land on
    ``device``).

    Groups never straddle a tile boundary and are ordered by (row block,
    column block), so one row block's groups form one contiguous run.
    ``be`` must be a multiple of 1024, as in the JAX package, so that both
    build the same plans. An empty matrix gets one all-padding group.
    Spans: ``plan.tiles`` (``plan_tiles`` or its numpy spec),
    ``plan.schedule`` (the live slots by row, ``slot_cv``),
    ``plan.segments`` (``run_segments``) and ``plan.upload`` (the moves to
    ``device``)."""
    if be % 1024:
        raise ValueError(f"edge block must be a multiple of 1024, got {be}")
    r = _np(A.rows)[: A.nnz].astype(np.int64)
    c = _np(A.cols)[: A.nnz].astype(np.int64)
    v = _np(A.vals)[: A.nnz].astype(np.float32)
    with span("plan.tiles"):
        fast = native.plan_tiles(r, c, v, rb, cb, be) if A.nnz else None
        lrow, lcol, val, perm, tile_rb, tile_cb = fast if fast is not None else _plan_arrays(r, c, v, rb, cb, be)
    G = tile_rb.shape[0]
    with span("plan.schedule"):  # the live slots by output row, then slot
        slot_idx = np.flatnonzero(perm >= 0)
        row = tile_rb[slot_idx // be].astype(np.int64) * rb + lrow[slot_idx]
        by_row = np.argsort(row, kind="stable")
        slot_idx, row_of = slot_idx[by_row], row[by_row]
        col_of = tile_cb[slot_idx // be].astype(np.int64) * cb + lcol[slot_idx]
        slot_cv = np.stack([col_of.astype(np.int32), val[slot_idx].view(np.int32)], axis=1)
    with span("plan.segments"):
        segments = run_segments(row_of, A.n_rows, device, seg_steps=ROW_SEG_SLOTS)
    with span("plan.upload"):
        shape2 = lambda a: _tensor(a.reshape(G, be), device)
        return SpMMPlan(
            lrow=shape2(lrow), lcol=shape2(lcol), val=shape2(val), perm=shape2(perm),
            tile_rb=_tensor(tile_rb, device), tile_cb=_tensor(tile_cb, device),
            n_rows=A.n_rows, n_cols=A.n_cols, rb=rb, cb=cb, nnz=A.nnz,
            slot_idx=_tensor(slot_idx.astype(np.int32), device),
            segments=segments, slot_cv=_tensor(slot_cv, device),
        )


def recut_rows(plan: SpMMPlan, seg_slots: int) -> SpMMPlan:
    """``plan`` with its rows cut into pieces of at most ``seg_slots``
    slots (the sweep of ``ROW_SEG_SLOTS``)."""
    slot = plan.slot_idx.long()
    row = plan.tile_rb.long()[slot // plan.be] * plan.rb + plan.lrow.reshape(-1)[slot].long()
    return dataclasses.replace(
        plan, segments=run_segments(_np(row), plan.n_rows, plan.val.device, seg_steps=seg_slots)
    )


def plan_with_vals(plan: SpMMPlan, vals: torch.Tensor) -> SpMMPlan:
    """Substitute runtime edge values (attention weights, quantized values)
    into a plan. ``vals`` follows the source matrix's edge order."""
    v = torch.where(
        plan.perm >= 0,
        vals.index_select(0, plan.perm.clamp(min=0).reshape(-1).long()).view(plan.perm.shape),
        torch.zeros((), dtype=vals.dtype, device=vals.device),
    )
    return plan.with_val(v)


# ------------------------------------------------------------- kernel K9


def spmm_plan_plain(plan: SpMMPlan, H: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K9: gather ``bf16(H[col])``, times ``val``, round to
    bf16, scatter-add in f32 on the slot's row, in bounded batches of
    groups. H is [>= n_cols, P]; rows it lacks read as zero. Returns f32
    [n_rows, P]."""
    be, P = plan.be, H.shape[1]
    n_rt = _round_up(plan.n_rows, plan.rb) // plan.rb
    n_ct = _round_up(plan.n_cols, plan.cb) // plan.cb
    Hb = torch.zeros((max(n_ct * plan.cb, H.shape[0]), P), dtype=torch.float32, device=H.device)
    Hb[: H.shape[0]] = H.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((n_rt * plan.rb, P), dtype=torch.float32, device=H.device)
    batch = max(1, _PLAIN_BATCH_BYTES // (be * P * 4 * 3))
    for g0 in range(0, plan.num_groups, batch):
        g = slice(g0, g0 + batch)
        col = (plan.tile_cb[g].long()[:, None] * plan.cb + plan.lcol[g]).reshape(-1)
        row = (plan.tile_rb[g].long()[:, None] * plan.rb + plan.lrow[g]).reshape(-1)
        w = Hb.index_select(0, col) * plan.val[g].reshape(-1, 1)
        out.index_add_(0, row, w.to(torch.bfloat16).to(torch.float32))
    return out[: plan.n_rows]


def _gather_operand(P: int, data_ptr: int) -> tuple:
    """The gather kernel's operand for an H of width ``P`` at address
    ``data_ptr``: its width ``round_up(P, 8)`` (bf16 rows of whole 16-byte
    pieces), and whether H must first be copied into a fresh, zero-padded
    tensor of that width (an odd width, or an H not aligned to 16 bytes).
    The rule reads the width and the address only."""
    Pp = _round_up(P, 8)
    return Pp, Pp != P or data_ptr % 16 != 0


def _check_k9_operands(plan: SpMMPlan, H: torch.Tensor, ints: dict) -> None:
    if H.dim() != 2 or H.shape[0] < plan.n_cols:
        raise ValueError(f"H must be [>= {plan.n_cols}, P], got {tuple(H.shape)}")
    if H.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"H must be float32 or bfloat16, got {H.dtype}")
    if not H.is_contiguous():
        raise ValueError("H must be contiguous")
    _check_cuda_operands(dict(val=plan.val, **ints), H.device)
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")


def _stream(H: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(H.device).cuda_stream)


def _spmm_plan_gather(plan: SpMMPlan, H: torch.Tensor) -> torch.Tensor:
    """K9 by the gather kernel ``csrc/plan_spmm_gather.cu``: H padded where
    ``_gather_operand`` asks, then rounded to bf16 once (the pre-pass of the
    ring kernels, ``ops/bsr._stage_h``; a bf16 H is read as it is), the
    slots' (column, value) pairs from ``slot_cv``."""
    S = plan.segments
    _check_k9_operands(plan, H, dict(slot_cv=plan.slot_cv, **S.tensors()))
    if plan.slot_cv.shape != (plan.slot_idx.shape[0], 2):
        raise ValueError(f"slot_cv must be [nnz, 2], got {tuple(plan.slot_cv.shape)}")
    P = H.shape[1]
    Pp, copy = _gather_operand(P, H.data_ptr())
    if copy:
        Hp = H.new_zeros((plan.n_cols, Pp))
        Hp[:, :P] = H[: plan.n_cols]
        H = Hp
    Hs = _stage_h(H, None, plan.n_cols, plan.n_cols)
    out = torch.empty((plan.n_rows, Pp), dtype=torch.float32, device=H.device)
    partial = torch.empty((max(S.n_part, 1), Pp), dtype=torch.float32, device=H.device)
    err = _cuda.library().sg_plan_spmm_gather(
        _ptr(plan.slot_cv), *_seg_args(S), _ptr(Hs), Pp, _ptr(out), _ptr(partial), _stream(H),
    )
    _cuda.check(err, "spmm_plan_gather")
    spmm_plan.launches += 1
    spmm_plan.launches_finalize += int(S.n_fin > 0)
    return out if Pp == P else out[:, :P].contiguous()


def spmm_plan(plan: SpMMPlan, H: torch.Tensor) -> torch.Tensor:
    """K9: out = A @ H over the plan's edge groups, f32 [n_rows, P]
    (H rounds to bf16, each weighted row rounds to bf16, f32 sums in slot
    order). A CPU tensor runs ``spmm_plan_plain``; a CUDA tensor launches
    the gather kernel at every width and address (``_spmm_plan_gather``),
    or raises. ``launches`` counts its launches, ``launches_finalize``
    those whose plan has split rows, which the split rows' reduction then
    sums."""
    if H.device.type == "cpu":
        return spmm_plan_plain(plan, H)
    if H.device.type != "cuda":
        raise ValueError(f"spmm_plan runs on cpu or cuda, not {H.device}")
    return _spmm_plan_gather(plan, H)


spmm_plan.launches = 0
spmm_plan.launches_finalize = 0
