"""Flash-GAT: GAT attention aggregation over block-sparse adjacency tiles.

    out[r] = sum_c softmax_c(LeakyReLU(s1[r] + s2[c]) | A[r, c] > 0) * Wh[c]

as ``sgracex1_tpu.ops.flash_gat``. The adjacency's nonempty ``tb x tb``
tiles are the attention mask: each tile step scores ``s1[rows] +
s2[cols]``, masks it additively, and folds it into a running row softmax
(max ``m``, denominator ``l``, accumulator ``acc``), so no per-edge score
vector ever exists.

- ``gat_attention_agg_ref``: the edge-path spec (sddmm + edge softmax +
  weighted scatter-add).
- Kernel K3, ``flash_gat_forward``: tile steps over a ``BSRMatrix``.
- Kernel K6, ``flash_gat_hybrid_forward``: K3's tile steps plus remainder
  chunk steps of a value-mode ``FusedAggPlan`` in one exact row softmax.
- ``gat_attention_agg_fused`` / ``gat_attention_agg_hybrid``: the layer
  entry points, forward only for now.

Scores ``s1``/``s2`` are ``[N, H]`` and features ``Wh`` ``[N, H, F]``
(heads last, one launch for all heads); 1-D scores with 2-D ``Wh`` are the
single-head call. On a CUDA tensor each kernel wrapper launches
``csrc/flash_gat.cu`` or raises; on a CPU tensor it runs its plain PyTorch
version (``*_plain``), which walks every run's steps in schedule order
with the TPU kernel's rounding points: ``bf16(p) @ bf16(Wh)`` with f32
sums, f32 ``p`` in ``l``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from sgracex1_tpu_torch.graph.csr import SparseMatrix, _round_up
from sgracex1_tpu_torch.ops import _cuda
from sgracex1_tpu_torch.ops.bsr import (
    BSRMatrix,
    RunSegments,
    _PLAIN_BATCH_BYTES,
    _check_cuda_operands,
    _ptr,
    _seg_args,
    _tile_mode,
    unpack_mask01_tile,
)
from sgracex1_tpu_torch.ops.fused_agg import FusedAggPlan, _bf16r
from sgracex1_tpu_torch.ops.sddmm import edge_softmax, leaky_relu
from sgracex1_tpu_torch.ops.spmm import _edges

_M_INIT = -1e5  # running-max start: exp(masked - m) underflows to 0
_MASK_BIG = 1e9  # additive mask: masked scores sit 1e9 below real ones


def _norm_heads(s1, s2, Wh):
    """(s1 [N, H], s2 [N, H], Wh [N, H, F], squeeze): 1-D scores with a
    2-D ``Wh`` are the single-head call."""
    if s1.dim() == 1:
        return s1[:, None], s2[:, None], Wh[:, None, :], True
    return s1, s2, Wh, False


def _forward_only(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward-only so far: its backward kernels K4/K5 come "
            "with the training slice (ROADMAP queue 1, item 9); run under "
            "torch.no_grad() or detach the inputs"
        )


# ------------------------------------------------------------ edge path


def _edge_scores(A: SparseMatrix, s1, s2, alpha: float):
    """(e_pre, softmax s, mask) per edge, heads as a trailing dim."""
    rows, cols, vals = _edges(A, s1.device)
    e_pre = s1.index_select(0, rows.long()) + s2.index_select(0, cols.long())
    s = edge_softmax(A, leaky_relu(e_pre, alpha))
    return e_pre, s, vals > 0


def gat_attention_agg_ref(A: SparseMatrix, s1, s2, Wh, alpha: float = 0.2):
    """Edge-path spec of the flash aggregation: sddmm + edge softmax +
    weighted scatter-add (1-D scores with ``Wh [N, F]``, or ``[N, H]`` with
    ``[N, H, F]``)."""
    rows, cols, _ = _edges(A, Wh.device)
    _, s, _ = _edge_scores(A, s1, s2, alpha)
    msg = Wh.index_select(0, cols.long()) * s[..., None]
    out = torch.zeros((A.n_rows, *Wh.shape[1:]), dtype=msg.dtype, device=Wh.device)
    return out.index_add_(0, rows.long(), msg)


# ------------------------------------------------ plain versions of K3, K6


def _mask01(tiles: torch.Tensor, tb: int) -> torch.Tensor:
    """Tiles -> f32 {0,1} masks: int8 masks cast, packed masks unpacked,
    value tiles ``> 0``."""
    if tiles.shape[-1] != tb:
        return unpack_mask01_tile(tiles, tb)
    if tiles.dtype == torch.int8:
        return tiles.to(torch.float32)
    return (tiles.to(torch.float32) > 0).to(torch.float32)


class _Online:
    """Running (m, l, acc) of every row block, head-major per block:
    m, l [n_rt, H, tb], acc [n_rt, H, tb, F]."""

    def __init__(self, n_rt, H, tb, F, device):
        self.m = torch.full((n_rt, H, tb), _M_INIT, dtype=torch.float32, device=device)
        self.l = torch.zeros((n_rt, H, tb), dtype=torch.float32, device=device)
        self.acc = torch.zeros((n_rt, H, tb, F), dtype=torch.float32, device=device)

    def update(self, rb: torch.Tensor, e: torch.Tensor, feats: torch.Tensor) -> None:
        """One online-softmax step for the row blocks ``rb``: masked scores
        e [b, H, tb, X], bf16-rounded features feats [b, H, X, F]."""
        m_old = self.m[rb]
        m_new = torch.maximum(m_old, e.amax(dim=-1))
        p = torch.exp(e - m_new[..., None])
        corr = torch.exp(m_old - m_new)
        self.l[rb] = self.l[rb] * corr + p.sum(dim=-1)
        self.acc[rb] = self.acc[rb] * corr[..., None] + torch.matmul(_bf16r(p), feats)
        self.m[rb] = m_new

    def result(self, n_rows: int, squeeze: bool, return_stats: bool):
        n_rt, H, tb, F = self.acc.shape
        out = self.acc / torch.clamp(self.l, min=1e-30)[..., None]
        out = out.permute(0, 2, 1, 3).reshape(n_rt * tb, H, F)[:n_rows]
        if squeeze:
            out = out[:, 0, :]
        if not return_stats:
            return out
        stat = lambda x: x.permute(0, 2, 1).reshape(n_rt * tb, H)
        return out, stat(self.m), stat(self.l)


def _walk_runs(step_rb: torch.Tensor, n_rt: int, per_rb_bytes: int, fn) -> None:
    """Call ``fn(rb, steps)`` for step index j = 0, 1, ... of every run at
    once (the runs of a row-block-sorted step array), in batches of row
    blocks of bounded scratch: each run's steps go in schedule order."""
    dev = step_rb.device
    start = torch.searchsorted(step_rb.contiguous(), torch.arange(n_rt + 1, device=dev, dtype=step_rb.dtype))
    length = (start[1:] - start[:-1]).long()
    order = torch.argsort(length, descending=True, stable=True)
    lens = length[order].cpu().numpy()
    first = start[:-1].long()[order]
    batch = max(1, _PLAIN_BATCH_BYTES // max(per_rb_bytes, 1))
    for j in range(int(lens[0]) if len(lens) else 0):
        active = int(np.searchsorted(-lens, -j, side="left"))  # runs longer than j
        for b0 in range(0, active, batch):
            b1 = min(active, b0 + batch)
            fn(order[b0:b1], first[b0:b1] + j)


def _padded(s1, s2, Wh, n_rt, n_ct, tb):
    """Head-major, tile-grid-padded operands: s1 [n_rt, H, tb],
    s2 [n_ct, H, tb], bf16-rounded Wh [n_ct, H, tb, F] (f32)."""
    H, F = Wh.shape[1], Wh.shape[2]
    dev = Wh.device
    S1 = torch.zeros((n_rt * tb, H), dtype=torch.float32, device=dev)
    S1[: s1.shape[0]] = s1.float()
    S2 = torch.zeros((n_ct * tb, H), dtype=torch.float32, device=dev)
    S2[: s2.shape[0]] = s2.float()
    W = torch.zeros((n_ct * tb, H, F), dtype=torch.float32, device=dev)
    W[: Wh.shape[0]] = _bf16r(Wh.float())
    return (
        S1.view(n_rt, tb, H).permute(0, 2, 1),
        S2.view(n_ct, tb, H).permute(0, 2, 1),
        W.view(n_ct, tb, H, F).permute(0, 2, 1, 3),
    )


def _lrelu_masked(e, m01, alpha):
    e = torch.maximum(e, alpha * e)
    return e + (m01 * _MASK_BIG - _MASK_BIG)


def _tile_update(st, B, S1, S2, W, alpha, rb, tile, cb):
    m01 = _mask01(B.tiles[tile], B.tb)[:, None]  # [b, 1, tb, tb]
    e = S1[rb][..., :, None] + S2[cb][..., None, :]
    st.update(rb, _lrelu_masked(e, m01, alpha), W[cb])


def flash_gat_forward_plain(
    B: BSRMatrix, s1, s2, Wh, *, alpha: float = 0.2, return_stats: bool = False
):
    """Plain PyTorch K3: each row block's tiles in order, one tile step of
    every run at a time. Returns out [n_rows, H, F] (or [n_rows, F] for
    the single-head call) and with ``return_stats`` the true (m, l)
    [n_rt*tb, H]."""
    s1, s2, Wh, squeeze = _norm_heads(s1, s2, Wh)
    tb, H, F = B.tb, Wh.shape[1], Wh.shape[2]
    n_rt, n_ct = B.n_row_tiles, _round_up(B.n_cols, tb) // tb
    S1, S2, W = _padded(s1, s2, Wh, n_rt, n_ct, tb)
    st = _Online(n_rt, H, tb, F, Wh.device)
    tile_cb = B.tile_cb.long()
    _walk_runs(
        B.tile_rb, n_rt, 4 * H * tb * (4 * tb + 2 * F),
        lambda rb, t: _tile_update(st, B, S1, S2, W, alpha, rb, t, tile_cb[t]),
    )
    return st.result(B.n_rows, squeeze, return_stats)


def flash_gat_hybrid_forward_plain(
    plan: FusedAggPlan, s1, s2, Wh, *, alpha: float = 0.2,
    return_stats: bool = False,
):
    """Plain PyTorch K6: each row block's steps in schedule order; a step
    of kind != 1 is a tile step, kind >= 1 a chunk step (kind 3: the tile,
    then the chunk). A chunk scores its K slots on a one-hot [tb, K] grid,
    as the TPU kernel does; dead slots (lrow == tb) match no row."""
    B = plan.B
    s1, s2, Wh, squeeze = _norm_heads(s1, s2, Wh)
    tb, K, H, F = B.tb, plan.K, Wh.shape[1], Wh.shape[2]
    n_rt, n_ct = B.n_row_tiles, _round_up(B.n_cols, tb) // tb
    S1, S2, W = _padded(s1, s2, Wh, n_rt, n_ct, tb)
    Wflat = W.permute(0, 2, 1, 3).reshape(n_ct * tb, H, F)
    S2flat = S2.permute(0, 2, 1).reshape(n_ct * tb, H)
    st = _Online(n_rt, H, tb, F, Wh.device)
    S = plan.num_steps
    kind = plan.step_kind.long()
    tile, cb, chunk = plan.step_tile.long(), plan.step_cb.long(), plan.step_chunk.long()
    iota = torch.arange(tb, device=Wh.device)
    kar = torch.arange(K, device=Wh.device)

    def step(rb, g):
        t = kind[g] != 1
        if t.any():
            _tile_update(st, B, S1, S2, W, alpha, rb[t], tile[g[t]], cb[g[t]])
        c = kind[g] >= 1
        if c.any():
            ch = chunk[g[c]]
            slots = (ch[:, None] * K + kar).reshape(-1)
            cols = plan.slot_col[slots].long()
            oh = (iota[:, None] == plan.lrow[ch][:, None, :]).to(torch.float32)  # [b, tb, K]
            sg = S2flat[cols].view(-1, K, H).permute(0, 2, 1)  # [b, H, K]
            e = S1[rb[c]][..., :, None] + sg[..., None, :]
            feats = Wflat[cols].view(-1, K, H, F).permute(0, 2, 1, 3)
            st.update(rb[c], _lrelu_masked(e, oh[:, None], alpha), feats)

    _walk_runs(
        plan.step_rb[:S], n_rt, 4 * H * tb * (4 * max(tb, K) + 2 * F), step,
    )
    return st.result(B.n_rows, squeeze, return_stats)


# ------------------------------------------------------------ K3 and K6


def _launch(name, B, S: RunSegments, s1, s2, Wh, alpha, return_stats, plan=None):
    """Launch csrc/flash_gat.cu over run segments ``S``: K3 on ``B``'s
    tiles, or K6 on ``plan``'s steps."""
    s1, s2, Wh, squeeze = _norm_heads(s1, s2, Wh)
    dev = Wh.device
    tb = B.tb
    mode = _tile_mode(B.tiles, tb)
    if tb % 32 or tb > 1024:
        raise ValueError(f"the flash kernel needs tb % 32 == 0 and tb <= 1024, got {tb}")
    n_rt, n_ct = B.n_row_tiles, _round_up(B.n_cols, tb) // tb
    H, F = Wh.shape[1], Wh.shape[2]
    if s1.dim() != 2 or s2.dim() != 2 or Wh.dim() != 3 or s1.shape[1] != H or s2.shape[1] != H:
        raise ValueError(
            f"want s1 [N, H], s2 [N, H], Wh [N, H, F]; got {tuple(s1.shape)}, "
            f"{tuple(s2.shape)}, {tuple(Wh.shape)}"
        )
    if s1.shape[0] > n_rt * tb or s2.shape[0] != Wh.shape[0] or Wh.shape[0] > n_ct * tb:
        raise ValueError(
            f"s1 rows {s1.shape[0]} must fit {n_rt * tb}; s2/Wh rows "
            f"{s2.shape[0]}/{Wh.shape[0]} must agree and fit {n_ct * tb}"
        )
    if s1.dtype != torch.float32 or s2.dtype != torch.float32:
        raise ValueError(f"s1/s2 must be float32, got {s1.dtype}/{s2.dtype}")
    if Wh.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"Wh must be float32 or bfloat16, got {Wh.dtype}")
    ints = dict(tile_cb=B.tile_cb, **S.tensors())
    if plan is not None:
        if plan.K % 32 or plan.K > 512 or plan.lrow.shape != (plan.num_chunks, plan.K):
            raise ValueError(f"lrow must be [R, K], K % 32 == 0, K <= 512; got {tuple(plan.lrow.shape)}")
        ints.update(
            step_cb=plan.step_cb, step_tile=plan.step_tile,
            step_chunk=plan.step_chunk, step_kind=plan.step_kind,
            lrow=plan.lrow, slot_col=plan.slot_col,
        )
    _check_cuda_operands(dict(tiles=B.tiles, s1=s1, s2=s2, Wh=Wh, **ints), dev)
    for k, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{k} must be int32, got {t.dtype}")
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((B.n_rows, H, F), **f32)
    m = l = None
    if return_stats:
        m = torch.empty((n_rt * tb, H), **f32)
        l = torch.empty((n_rt * tb, H), **f32)
    n_part = max(S.n_part, 1)
    pm = torch.empty((n_part, tb, H), **f32)
    pl = torch.empty((n_part, tb, H), **f32)
    pacc = torch.empty((n_part, tb, H, F), **f32)
    chunk_args = (
        [_ptr(plan.step_cb), _ptr(plan.step_tile), _ptr(plan.step_chunk),
         _ptr(plan.step_kind), _ptr(plan.lrow), _ptr(plan.slot_col), plan.K]
        if plan is not None else [_ptr(None)] * 6 + [0]
    )
    # the kernel reads Wh in bf16, rounded once here (the plain version and
    # the TPU kernel round the same values per tile)
    Whb = Wh.to(torch.bfloat16)
    wvec = int(F % 8 == 0 and Whb.data_ptr() % 16 == 0)
    err = _cuda.library().sg_flash_gat(
        _ptr(B.tiles), mode, tb, *_seg_args(S), _ptr(B.tile_cb), *chunk_args,
        _ptr(s1), s1.shape[0], _ptr(s2), s2.shape[0],
        _ptr(Whb), wvec, H, F, float(alpha),
        _ptr(out), B.n_rows, _ptr(m), _ptr(l), _ptr(pm), _ptr(pl), _ptr(pacc),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _cuda.check(err, name)
    out = out[:, 0, :] if squeeze else out
    return (out, m, l) if return_stats else out


def _device_of(Wh: torch.Tensor, name: str) -> str:
    if Wh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {Wh.device}")
    return Wh.device.type


def flash_gat_forward(
    B: BSRMatrix, s1, s2, Wh, *, alpha: float = 0.2, return_stats: bool = False
):
    """K3: the masked online-softmax aggregation over ``B``'s tiles (mask
    ``> 0``; int8 and packed masks as stored). A CPU tensor runs
    ``flash_gat_forward_plain``; a CUDA tensor launches
    ``csrc/flash_gat.cu`` or raises."""
    if _device_of(Wh, "flash_gat_forward") == "cpu":
        return flash_gat_forward_plain(B, s1, s2, Wh, alpha=alpha, return_stats=return_stats)
    res = _launch("flash_gat_forward", B, B.segments, s1, s2, Wh, alpha, return_stats)
    flash_gat_forward.launches += 1
    return res


flash_gat_forward.launches = 0


def flash_gat_hybrid_forward(
    plan: FusedAggPlan, s1, s2, Wh, *, alpha: float = 0.2,
    return_stats: bool = False,
):
    """K6: tile steps and remainder chunk steps of a value-mode fused plan
    in one exact row softmax over all edges. A CPU tensor runs
    ``flash_gat_hybrid_forward_plain``; a CUDA tensor launches
    ``csrc/flash_gat.cu`` or raises."""
    if plan.colscale is not None:
        raise ValueError("the hybrid flash forward takes a value-mode plan (no rank-1 scalings)")
    if _device_of(Wh, "flash_gat_hybrid_forward") == "cpu":
        return flash_gat_hybrid_forward_plain(
            plan, s1, s2, Wh, alpha=alpha, return_stats=return_stats
        )
    res = _launch(
        "flash_gat_hybrid_forward", plan.B, plan.segments, s1, s2, Wh, alpha,
        return_stats, plan=plan,
    )
    flash_gat_hybrid_forward.launches += 1
    return res


flash_gat_hybrid_forward.launches = 0


def gat_attention_agg_fused(B: BSRMatrix, s1, s2, Wh, alpha: float = 0.2):
    """Flash GAT aggregation on full-cover mask tiles (K3). Forward only:
    raises when an input requires grad."""
    _forward_only("gat_attention_agg_fused", s1, s2, Wh)
    return flash_gat_forward(B, s1, s2, Wh, alpha=alpha)


def gat_attention_agg_hybrid(
    plan: FusedAggPlan, rest: Optional[SparseMatrix], s1, s2, Wh,
    alpha: float = 0.2, edges_sorted: bool = False,
):
    """Hybrid flash GAT aggregation: dense tiles and remainder chunks in one
    pass (K6). ``rest`` and ``edges_sorted`` feed only the backward, which
    comes with training. Forward only: raises when an input requires
    grad."""
    _forward_only("gat_attention_agg_hybrid", s1, s2, Wh)
    return flash_gat_hybrid_forward(plan, s1, s2, Wh, alpha=alpha)
