"""GAT attention on the ``pallas`` kind's edge-group plans: the attention
that needs no tile mask.

    out[r, h] = sum_c softmax_c(LeakyReLU(s1[r, h] + s2[c, h])) * Wh[c, h]

over the slots the attention takes: those with a value > 0 (the flash
kernels' and the edge path's mask) and, with ``self_loops``, one self slot
a row in place of any stored self-loop (PyTorch Geometric's
``GATConv(add_self_loops=True)``: the harness's ``sym_norm`` stores each
self-loop with value 0, which the mask alone would drop).

The kernels walk an ``SpMMPlan``'s compacted slots (``slot_cv``) in its
row pieces (``segments``), as K9 does, so their work is the plan's live
slots and nothing else: on a graph without id locality, where any flash
layout's mask tiles hold a few entries a tile, this is the layout that
fits.

- ``plan_gat_fwd``: the forward on ``plan``, a running softmax a row piece
  and head over the rows of ``Wh`` staged once as bf16, f32 scores and
  sums; split rows merged in piece order (the flash block-combine). Returns
  ``(out, m, l)``, the row statistics the backward reads.
- ``plan_gat_bwd_rows``: the backward's row pass on ``plan``: ``t = sum p
  q``, ``u1 = sum p q lr'``, ``u2 = sum p lr'`` with ``q = gO[r] . Wh[c]``
  a head, so ``ds1 = u1 - t u2``.
- ``plan_gat_bwd_cols``: the column pass on ``plan_t``: ``dWh[c] = sum_r p
  gO[r]`` and ``ds2[c] = sum_r p (q - t[r]) lr'``.
- ``plan_gat_agg``: the layer's entry, differentiable, in a ``gat.agg``
  span (its backward in ``gat.agg.backward``, which also carries the column
  pass's ring: ``ring_stages``, ``ring_slots``, ``ring_bytes``). Its
  attributes count the launches: ``launches`` (forward),
  ``launches_bwd_rows``, ``launches_bwd_cols``, ``launches_bwd_cols_ring``
  (column passes through the shared-memory ring: all of them), and
  ``launches_merge`` (launches on a plan with split rows, which the merge or
  the split rows' sum then finishes).

The column pass stages each gathered ``gO`` row and its heads' row
statistics in a ring of shared memory a warp (``bwd_cols_ring``: its depth
follows from a slot's bytes, so that three blocks share an SM).

The backward is ``flash_gat_backward``'s softmax-Jacobian identity; no
per-edge ``[E, H, F]`` tensor exists on the card. Operands are staged head
by head at a width ``Fp`` (``plan_gat_width``): the head width rounded up to
a multiple of 8, and to a power of two where the heads outgrow one 256-wide
slice of the kernels, with zero features in the padding.

On a CUDA tensor each kernel wrapper launches ``csrc/plan_gat.cu``; on a
CPU tensor it runs its plain PyTorch version (``*_plain``), which walks the
same pieces, merges them by row and rounds where the kernel does (bf16 rows
of ``Wh`` and ``gO``, everything else f32).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from sgracex1_tpu_torch.ops import _cuda
from sgracex1_tpu_torch.ops.bsr import (
    _PLAIN_BATCH_BYTES,
    _check_cuda_operands,
    _ptr,
    _seg_args,
    _stage_h,
)
from sgracex1_tpu_torch.ops.pallas_spmm import SpMMPlan
from sgracex1_tpu_torch.utils.profiling import span

SLICE = 256  # features a warp of the kernels covers in one walk
RING_WARPS = 8  # warps a block of the column pass, each with its own ring
RING_WALK = 2 * SLICE  # features of a gathered row the column pass stages a slot
RING_MAX_STAGES = 16  # slots a warp's ring holds at most
RING_BLOCK_BYTES = 72 * 1024  # a block's ring: three blocks of 256 threads share an SM
SMEM_BLOCK_MAX = 232448  # the shared memory a block can have on the H100 (227 KB)


def plan_gat_width(H: int, F: int) -> Optional[int]:
    """The staged head width ``Fp`` for ``H`` heads of ``F`` features: F
    rounded up to a multiple of 8 (a kernel lane's 8 features lie in one
    head), and up to a power of two where ``H * Fp`` outgrows a slice (no
    head across two slices); None past a slice a head."""
    fp = -(-F // 8) * 8
    if H * fp > SLICE and SLICE % fp:
        fp = 1 << (fp - 1).bit_length()
    return fp if fp <= SLICE else None


class ColsRing(NamedTuple):
    """The column pass's ring at one staged shape."""

    stages: int  # slots in flight a warp, one mbarrier each
    slot_bytes: int  # a slot: a walk's features of a gathered gO row, then its heads' st
    smem_bytes: int  # a block's shared memory: RING_WARPS rings and their barriers


def bwd_cols_ring(H: int, Fp: int) -> Optional[ColsRing]:
    """The ring of ``plan_gat_bwd_cols`` at ``H`` heads of the staged width
    ``Fp``, or None where the kernels' shape rule refuses the shape (the
    host's rule of ``csrc/plan_gat.cu``, which checks what it is given). A
    slot holds the ``gf = min(H Fp, RING_WALK)`` features of one walk of a
    gO row (bf16) and the (s1, m, 1 / l, t) of their ``gf / Fp`` heads (16 B
    each); as many slots a warp as ``RING_BLOCK_BYTES`` holds, with an
    8-byte barrier each, up to ``RING_MAX_STAGES``."""
    if H < 1 or Fp < 8 or plan_gat_width(H, Fp) != Fp:
        return None
    gf = min(H * Fp, RING_WALK)
    slot = 2 * gf + 16 * (gf // Fp)
    stages = min(RING_MAX_STAGES, RING_BLOCK_BYTES // (RING_WARPS * (slot + 8)))
    return ColsRing(stages, slot, RING_WARPS * stages * (slot + 8))


def bwd_cols_occupancy(H: int, Fp: int) -> dict:
    """What the column pass gets on the current card at its ring for (H,
    Fp): registers a thread, blocks an SM, the ring's stages and a block's
    shared memory, and local (spilled) bytes a thread."""
    ring = bwd_cols_ring(H, Fp)
    if ring is None:
        raise ValueError(f"no column pass for {H} heads of {Fp}")
    out = (ctypes.c_int * 4)()
    _cuda.check(_cuda.library().sg_plan_gat_bwd_cols_occupancy(H, Fp, ring.stages, out),
                "plan_gat_bwd_cols_occupancy")
    return dict(regs=out[0], blocks_per_sm=out[1], stages=ring.stages, smem_bytes=out[2],
                spill_bytes=out[3])


def stage(X: torch.Tensor, Fp: int) -> torch.Tensor:
    """``X`` [n, H, F] as bf16 [n, H, Fp], zeros past F: the kernels'
    gathered operand. At ``Fp == F`` on the card, the ring kernels' pre-pass
    (``ops/bsr._stage_h``); else a cast into a zeroed buffer."""
    n, H, F = X.shape
    if Fp == F and X.device.type == "cuda":
        X = X.reshape(n, H * F).contiguous()
        return _stage_h(X, None, n, n).view(n, H, F)
    out = torch.zeros((n, H, Fp), dtype=torch.bfloat16, device=X.device)
    out[..., :F] = X
    return out


# ------------------------------------------------------- plain versions


def _pieces(plan: SpMMPlan, self_loops: bool) -> tuple:
    """The kernels' walk as flat entries: (piece, column) of every slot the
    attention takes, then one (piece, row) self entry a row's first piece
    where ``self_loops``. Pieces are the plan's segments, their rows
    ``seg_rb``."""
    S = plan.segments
    rows = S.seg_rb.long()
    piece = torch.repeat_interleave(
        torch.arange(S.n_seg, device=rows.device), (S.seg_hi - S.seg_lo).long()
    )
    col = plan.slot_cv[:, 0].long()
    keep = plan.slot_cv[:, 1].view(torch.float32) > 0
    if self_loops:
        keep &= col != rows[piece]
    piece, col = piece[keep], col[keep]
    if self_loops:
        first = torch.ones_like(rows, dtype=torch.bool)
        first[1:] = rows[1:] != rows[:-1]
        own = torch.nonzero(first).flatten()
        piece, col = torch.cat([piece, own]), torch.cat([col, rows[own]])
    return piece, col, rows


def _batches(n: int, per: int):
    step = max(1, _PLAIN_BATCH_BYTES // max(per, 1))
    for i in range(0, n, step):
        yield slice(i, i + step)


def _scores(s1, s2, r, c, alpha: float):
    pre = s1.index_select(0, r) + s2.index_select(0, c)
    return torch.where(pre > 0, pre, alpha * pre), torch.where(pre > 0, 1.0, alpha)


def _inv(l: torch.Tensor) -> torch.Tensor:
    return torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)


def plan_gat_fwd_plain(plan: SpMMPlan, s1, s2, Whs, *, alpha: float = 0.2, self_loops: bool = False):
    """Plain PyTorch forward: each piece's softmax (its max, denominator and
    unnormalised sum), then the pieces of a row combined under the row's
    max. ``Whs`` bf16 [>= n_cols, H, Fp]; returns f32 ``out`` [n_rows, H,
    Fp], ``m`` and ``l`` [n_rows, H] (-inf and 0 on a row with no slot)."""
    piece, col, rows = _pieces(plan, self_loops)
    H, Fp = Whs.shape[1], Whs.shape[2]
    n_seg, dev = rows.shape[0], Whs.device
    r = rows.index_select(0, piece)
    e, _ = _scores(s1.float(), s2.float(), r, col, alpha)
    idx = piece[:, None].expand(-1, H)
    m_p = torch.full((n_seg, H), float("-inf"), device=dev).scatter_reduce(0, idx, e, "amax")
    p = torch.exp(e - m_p.index_select(0, piece))
    l_p = torch.zeros((n_seg, H), device=dev).index_add_(0, piece, p)
    acc = torch.zeros((n_seg, H, Fp), device=dev)
    for b in _batches(piece.shape[0], H * Fp * 4 * 3):
        acc.index_add_(0, piece[b], p[b, :, None] * Whs.index_select(0, col[b]).float())
    n = plan.n_rows
    m = torch.full((n, H), float("-inf"), device=dev).scatter_reduce(
        0, rows[:, None].expand(-1, H), m_p, "amax"
    )
    a = torch.where(m_p == float("-inf"), 0.0, torch.exp(m_p - m.index_select(0, rows)))
    l = torch.zeros((n, H), device=dev).index_add_(0, rows, l_p * a)
    out = torch.zeros((n, H, Fp), device=dev).index_add_(0, rows, acc * a[..., None])
    return out * _inv(l)[..., None], m, l


def plan_gat_bwd_rows_plain(plan: SpMMPlan, s1, s2, m, l, Whs, gOs, *, alpha: float = 0.2,
                            self_loops: bool = False):
    """Plain PyTorch row pass: ``(t, u1, u2)`` [n_rows, H]."""
    piece, col, rows = _pieces(plan, self_loops)
    H, Fp = Whs.shape[1], Whs.shape[2]
    r = rows.index_select(0, piece)
    e, d = _scores(s1.float(), s2.float(), r, col, alpha)
    p = torch.exp(e - m.index_select(0, r)) * _inv(l).index_select(0, r)
    q = torch.empty_like(p)
    for b in _batches(piece.shape[0], H * Fp * 4 * 3):
        q[b] = (gOs.index_select(0, r[b]).float() * Whs.index_select(0, col[b]).float()).sum(-1)
    z = lambda x: torch.zeros((plan.n_rows, H), device=p.device).index_add_(0, r, x)
    return z(p * q), z(p * q * d), z(p * d)


def plan_gat_bwd_cols_plain(plan_t: SpMMPlan, s1, s2, m, l, t, Whs, gOs, *, alpha: float = 0.2,
                            self_loops: bool = False):
    """Plain PyTorch column pass on the transposed plan: ``dWh`` [n_cols,
    H, Fp] and ``ds2`` [n_cols, H]."""
    piece, r, cols = _pieces(plan_t, self_loops)  # plan_t's rows are the columns
    H, Fp = Whs.shape[1], Whs.shape[2]
    c = cols.index_select(0, piece)
    e, d = _scores(s1.float(), s2.float(), r, c, alpha)
    p = torch.exp(e - m.index_select(0, r)) * _inv(l).index_select(0, r)
    n, dev = plan_t.n_rows, p.device
    dwh = torch.zeros((n, H, Fp), device=dev)
    ds = torch.empty_like(p)
    for b in _batches(r.shape[0], H * Fp * 4 * 3):
        g = gOs.index_select(0, r[b]).float()
        q = (g * Whs.index_select(0, c[b]).float()).sum(-1)
        ds[b] = p[b] * (q - t.index_select(0, r[b])) * d[b]
        dwh.index_add_(0, c[b], p[b, :, None] * g)
    return dwh, torch.zeros((n, H), device=dev).index_add_(0, c, ds)


# --------------------------------------------------------------- kernels


def _check(plan: SpMMPlan, s1, s2, Whs, gOs=None) -> tuple:
    H, Fp = Whs.shape[1], Whs.shape[2]
    if Whs.dtype != torch.bfloat16 or Whs.dim() != 3 or Whs.shape[0] < plan.n_cols:
        raise ValueError(f"Whs must be bf16 [>= {plan.n_cols}, H, Fp], got {Whs.dtype} {tuple(Whs.shape)}")
    if plan_gat_width(H, Fp) != Fp:
        raise ValueError(f"head width {Fp} is not a staged width for {H} heads (plan_gat_width)")
    for name, s, n in (("s1", s1, plan.n_rows), ("s2", s2, plan.n_cols)):
        if s.dtype != torch.float32 or s.dim() != 2 or s.shape[1] != H or s.shape[0] < n:
            raise ValueError(f"{name} must be float32 [>= {n}, {H}], got {s.dtype} {tuple(s.shape)}")
    if gOs is not None and (gOs.dtype != torch.bfloat16 or gOs.shape[1:] != Whs.shape[1:]):
        raise ValueError(f"gOs must be bf16 [n, {H}, {Fp}], got {gOs.dtype} {tuple(gOs.shape)}")
    _check_cuda_operands(dict(slot_cv=plan.slot_cv, s1=s1, s2=s2, Whs=Whs, gOs=gOs,
                              **plan.segments.tensors()), Whs.device)
    return H, Fp


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _count(plan: SpMMPlan, name: str) -> None:
    setattr(plan_gat_agg, name, getattr(plan_gat_agg, name) + 1)
    plan_gat_agg.launches_merge += int(plan.segments.n_fin > 0)


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return False


def plan_gat_fwd(plan: SpMMPlan, s1, s2, Whs, *, alpha: float = 0.2, self_loops: bool = False):
    """The forward over ``plan``: ``(out [n_rows, H, Fp] f32, m, l)``. A CPU
    tensor runs ``plan_gat_fwd_plain``; a CUDA tensor launches
    ``sg_plan_gat_fwd`` (and the merge of split rows) or raises."""
    if _on_cpu(Whs, "plan_gat_fwd"):
        return plan_gat_fwd_plain(plan, s1, s2, Whs, alpha=alpha, self_loops=self_loops)
    H, Fp = _check(plan, s1, s2, Whs)
    S, n, dev = plan.segments, plan.n_rows, Whs.device
    out = torch.empty((n, H, Fp), dtype=torch.float32, device=dev)
    m = torch.empty((n, H), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    npart = max(S.n_part, 1)
    pacc = torch.empty((npart, H, Fp), dtype=torch.float32, device=dev)
    pm = torch.empty((npart, H), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    err = _cuda.library().sg_plan_gat_fwd(
        _ptr(plan.slot_cv), *_seg_args(S), _ptr(Whs), _ptr(s1), _ptr(s2), H, Fp,
        ctypes.c_float(alpha), int(self_loops), _ptr(out), _ptr(m), _ptr(l), _ptr(pacc), _ptr(pm),
        _ptr(pl), _stream(Whs),
    )
    _cuda.check(err, "plan_gat_fwd")
    _count(plan, "launches")
    return out, m, l


def plan_gat_bwd_rows(plan: SpMMPlan, s1, s2, m, l, Whs, gOs, *, alpha: float = 0.2,
                      self_loops: bool = False):
    """The backward's row pass over ``plan``: ``(t, u1, u2)`` [n_rows, H]. A
    CPU tensor runs ``plan_gat_bwd_rows_plain``; a CUDA tensor launches
    ``sg_plan_gat_bwd_rows`` or raises."""
    if _on_cpu(Whs, "plan_gat_bwd_rows"):
        return plan_gat_bwd_rows_plain(plan, s1, s2, m, l, Whs, gOs, alpha=alpha, self_loops=self_loops)
    H, Fp = _check(plan, s1, s2, Whs, gOs)
    _check_cuda_operands(dict(m=m, l=l), Whs.device)
    S, dev = plan.segments, Whs.device
    tuu = torch.empty((plan.n_rows, 3, H), dtype=torch.float32, device=dev)
    ptuu = torch.empty((max(S.n_part, 1), 3, H), dtype=torch.float32, device=dev)
    err = _cuda.library().sg_plan_gat_bwd_rows(
        _ptr(plan.slot_cv), *_seg_args(S), _ptr(Whs), _ptr(gOs), _ptr(s1), _ptr(s2), _ptr(m), _ptr(l),
        H, Fp, ctypes.c_float(alpha), int(self_loops), _ptr(tuu), _ptr(ptuu), _stream(Whs),
    )
    _cuda.check(err, "plan_gat_bwd_rows")
    _count(plan, "launches_bwd_rows")
    return tuu[:, 0], tuu[:, 1], tuu[:, 2]


def plan_gat_bwd_cols(plan_t: SpMMPlan, s1, s2, m, l, t, Whs, gOs, *, alpha: float = 0.2,
                      self_loops: bool = False):
    """The backward's column pass over the transposed plan ``plan_t``:
    ``(dWh [n_cols, H, Fp] f32, ds2 [n_cols, H])``. A CPU tensor runs
    ``plan_gat_bwd_cols_plain``; a CUDA tensor launches
    ``sg_plan_gat_bwd_cols`` (and the sums of split rows) or raises."""
    if _on_cpu(Whs, "plan_gat_bwd_cols"):
        return plan_gat_bwd_cols_plain(plan_t, s1, s2, m, l, t, Whs, gOs, alpha=alpha,
                                       self_loops=self_loops)
    # plan_t's rows are the columns: its "s1" side is s2 and its "s2" side s1
    H, Fp = _check(plan_t, s2, s1, Whs, gOs)
    S, n, dev = plan_t.segments, plan_t.n_rows, Whs.device
    st = torch.stack([s1, m, _inv(l), t], dim=-1).contiguous()
    if gOs.data_ptr() % 16:  # the ring's bulk copies move 16-byte units
        raise ValueError("gOs must start on a 16-byte boundary")
    ring = bwd_cols_ring(H, Fp)
    dwh = torch.empty((n, H, Fp), dtype=torch.float32, device=dev)
    ds2 = torch.empty((n, H), dtype=torch.float32, device=dev)
    npart = max(S.n_part, 1)
    pdwh = torch.empty((npart, H, Fp), dtype=torch.float32, device=dev)
    pds2 = torch.empty((npart, H), dtype=torch.float32, device=dev)
    err = _cuda.library().sg_plan_gat_bwd_cols(
        _ptr(plan_t.slot_cv), *_seg_args(S), _ptr(Whs), _ptr(gOs), _ptr(st), _ptr(s2), H, Fp,
        ctypes.c_float(alpha), int(self_loops), _ptr(dwh), _ptr(ds2), _ptr(pdwh), _ptr(pds2),
        ring.stages, _stream(Whs),
    )
    _cuda.check(err, "plan_gat_bwd_cols")
    _count(plan_t, "launches_bwd_cols")
    plan_gat_agg.launches_bwd_cols_ring += 1
    return dwh, ds2


# ------------------------------------------------------- the layer's entry


def _unpad(x: torch.Tensor, F: int) -> torch.Tensor:
    """``x`` [n, H, Fp] without its padding features."""
    return x if x.shape[2] == F else x[..., :F].contiguous()


def _attrs(H: int, F: int, plan: SpMMPlan) -> dict:
    return dict(kind="plan", nnz=plan.nnz, H=H, F=F, split_rows=plan.segments.n_fin)


class _PlanGat(torch.autograd.Function):
    """The forward on ``prep.plan`` with its stats and staged ``Wh``; the
    backward's row pass on ``plan``, then its column pass on ``plan_t``."""

    @staticmethod
    def forward(ctx, prep, alpha, self_loops, s1, s2, Wh):
        F = Wh.shape[2]
        Whs = stage(Wh, plan_gat_width(Wh.shape[1], F))
        out, m, l = plan_gat_fwd(prep.plan, s1, s2, Whs, alpha=alpha, self_loops=self_loops)
        ctx.prep, ctx.alpha, ctx.self_loops, ctx.F = prep, alpha, self_loops, F
        ctx.save_for_backward(s1, s2, Whs, m, l)
        return _unpad(out, F)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gO):
        s1, s2, Whs, m, l = ctx.saved_tensors
        prep, kw = ctx.prep, dict(alpha=ctx.alpha, self_loops=ctx.self_loops)
        with span("gat.agg.backward") as s:
            if s:
                ring = bwd_cols_ring(Whs.shape[1], Whs.shape[2])
                s.set(**_attrs(Whs.shape[1], ctx.F, prep.plan), ring_stages=ring.stages,
                      ring_slots=RING_WARPS * ring.stages, ring_bytes=ring.smem_bytes)
            gOs = stage(gO.float(), Whs.shape[2])
            t, u1, u2 = plan_gat_bwd_rows(prep.plan, s1, s2, m, l, Whs, gOs, **kw)
            ds1 = u1 - t * u2
            dWh, ds2 = plan_gat_bwd_cols(prep.plan_t, s1, s2, m, l, t, Whs, gOs, **kw)
            return None, None, None, ds1, ds2, _unpad(dWh, ctx.F)


def plan_gat_agg(prep, s1, s2, Wh, alpha: float = 0.2, self_loops: bool = False):
    """GAT attention aggregation on a ``pallas`` prep's plans,
    differentiable: ``s1`` / ``s2`` [n, H] f32 scores of the rows and
    columns, ``Wh`` [n, H, F]; returns f32 [n, H, F]. The forward runs on
    ``prep.plan``; under grad the backward runs the row pass on ``plan`` and
    the column pass on ``plan_t``, and gradients flow to ``s1``, ``s2`` and
    ``Wh``. ``self_loops`` attends over one self-loop a node (PyG's
    ``add_self_loops``) in place of the stored ones."""
    H, F = Wh.shape[1], Wh.shape[2]
    Fp = plan_gat_width(H, F)
    if Fp is None:
        raise ValueError(f"the plan attention takes heads of at most {SLICE} features, got {F}")
    with span("gat.agg") as s:
        if s:
            s.set(**_attrs(H, F, prep.plan))
        s1, s2 = s1.float().contiguous(), s2.float().contiguous()
        if torch.is_grad_enabled() and any(x.requires_grad for x in (s1, s2, Wh)):
            return _PlanGat.apply(prep, alpha, self_loops, s1, s2, Wh)
        out, _, _ = plan_gat_fwd(prep.plan, s1, s2, stage(Wh, Fp), alpha=alpha, self_loops=self_loops)
        return _unpad(out, F)


plan_gat_agg.launches = 0
plan_gat_agg.launches_bwd_rows = 0
plan_gat_agg.launches_bwd_cols = 0
plan_gat_agg.launches_bwd_cols_ring = 0
plan_gat_agg.launches_merge = 0
