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
- Kernel K12, ``flash_gat_forward_subskip``: K3 for one head with a
  host-built bitmap (``subblock_pop_bitmap``) that lets it skip empty
  ``sb x sb`` sub-blocks of a tile, any ``sb`` that divides ``tb``.
- Kernel K6, ``flash_gat_hybrid_forward``: K3's tile steps plus remainder
  chunk steps of a value-mode ``FusedAggPlan`` in one exact row softmax.
- Kernels K4, ``flash_gat_bwd_row``, and K5, ``flash_gat_bwd_col``: the
  backward's row and column passes over the same tiles, recomputing the
  probabilities from the forward's ``(m, l)``; ``flash_gat_backward``
  combines them into ``(ds1, ds2, dWh)``.
- ``gat_attention_agg_fused`` / ``gat_attention_agg_hybrid``: the layer
  entry points, ``torch.autograd.Function``s whose backward runs K4 and K5
  (the hybrid one adds its remainder edges' terms in plain torch).
- ``gat_attention_agg``: K3 forward with the reference's per-edge backward
  on the edge list (single head).
- ``fast_exp`` (K3, K4, K5: Schraudolph's exp, ``_fast_exp``) and K6's
  ``_chunk_mode`` (``CHUNK_MODES``): the JAX package's ablations of the
  consumer work, as options of the kernels. The ring kernels run them as
  variants built from sources of their own (``_ring_var``), the
  single-stage kernels as runtime flags (``_kernel_flags``).
- ``flash_gat_halo_agg``: one shard of the distributed layer
  (``parallel/halo.dist_gat_layer_halo_flash``): K3 with its stats on the
  shard's local tiles, merged with its halo edges' softmax terms; the
  backward runs K4 under the merged stats and K5 with ``t`` summed over
  local and halo edges.

Scores ``s1``/``s2`` are ``[N, H]`` and features ``Wh`` ``[N, H, F]``
(heads last, one launch for all heads); 1-D scores with 2-D ``Wh`` are the
single-head call. On a CUDA tensor each kernel wrapper launches a
hand-written kernel or raises: K3, K6 and K12 the ring kernel
``csrc/flash_gat_ring.cu`` where ``flash_ring_shape_ok`` holds (only the live
steps of ``B.ring`` / ``plan.ring``, every head in one CTA, a multi-stage
shared-memory ring; K12 on ``subskip_schedule``'s slabs), else the
single-stage ``csrc/flash_gat.cu``; K4, K5
the ring kernels ``csrc/flash_gat_bwd_ring.cu`` where
``flash_bwd_ring_shape_ok`` holds (live tiles only, K5 on the transposed
live tiles ``B.live_t``, every head in one CTA), else the single-stage
``csrc/flash_gat_bwd.cu``. On a CPU tensor it runs its plain PyTorch version
(``*_plain``)
with the TPU kernel's rounding points: ``bf16(p) @ bf16(Wh)`` with f32
sums and f32 ``p`` in ``l`` forward (every run's steps in schedule order);
``q = bf16(gO) @ bf16(Wh)^T`` and ``bf16(p)^T @ bf16(gO)`` with f32 sums
backward.
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
    _TILE_MODES,
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
_MASKED = -1e9  # a masked halo edge's score (JAX ``_MASKED``)

# Schraudolph's exp (JAX ``_fast_exp``): bitcast_f32(int32(max(A x + B, 0))),
# x <= 0 here (a score less the running max); the clamp sends deep-negative x
# to 0.0. Relative error at most ~3% on [-30, 0] with this B.
_FEXP_A = 12102203.161561485  # 2^23 / ln 2
_FEXP_B = 1064986816.0  # 127 * 2^23 - 366400

# K6's chunk steps (``flash_gat_hybrid_forward(_chunk_mode=)``), the JAX
# package's ablations: "full" scores them; "noscore" adds onehot(lrow) @ Wh
# with no score, max or denominator; "off" skips them
CHUNK_MODES = ("full", "noscore", "off")


def _fast_exp(x: torch.Tensor) -> torch.Tensor:
    """The bits of JAX ``_fast_exp`` on f32 ``x``."""
    i = torch.clamp(_FEXP_A * x + _FEXP_B, min=0.0).to(torch.int32)
    return i.view(torch.float32)


def _kernel_flags(fast_exp: bool = False, chunk_mode: str = "full") -> int:
    """The single-stage flash kernels' runtime flags: bit 0 fast_exp, bits
    1-2 the chunk mode's index in ``CHUNK_MODES``."""
    if chunk_mode not in CHUNK_MODES:
        raise ValueError(f"_chunk_mode must be one of {CHUNK_MODES}, got {chunk_mode!r}")
    return int(bool(fast_exp)) | CHUNK_MODES.index(chunk_mode) << 1


def _ring_var(fast_exp: bool = False, chunk_mode: str = "full") -> int:
    """The flash ring kernel's variant (its template's VAR, each built from
    a source of its own): 1 fast_exp, 2 K6's noscore chunks, 0 the kernel.
    K6's ``off`` is no variant: the wrapper runs K3 over the plan's tiles."""
    _kernel_flags(fast_exp, chunk_mode)
    return 1 if fast_exp else 2 if chunk_mode == "noscore" else 0


def _norm_heads(s1, s2, Wh):
    """(s1 [N, H], s2 [N, H], Wh [N, H, F], squeeze): 1-D scores with a
    2-D ``Wh`` are the single-head call."""
    if s1.dim() == 1:
        return s1[:, None], s2[:, None], Wh[:, None, :], True
    return s1, s2, Wh, False


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

    def update(self, rb: torch.Tensor, e: torch.Tensor, feats: torch.Tensor, exp=torch.exp) -> None:
        """One online-softmax step for the row blocks ``rb``: masked scores
        e [b, H, tb, X], bf16-rounded features feats [b, H, X, F]; ``exp``
        for the scores' exps (the rescale's stays exact)."""
        m_old = self.m[rb]
        m_new = torch.maximum(m_old, e.amax(dim=-1))
        p = exp(e - m_new[..., None])
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


def _tile_update(st, B, S1, S2, W, alpha, rb, tile, cb, exp=torch.exp):
    m01 = _mask01(B.tiles[tile], B.tb)[:, None]  # [b, 1, tb, tb]
    e = S1[rb][..., :, None] + S2[cb][..., None, :]
    st.update(rb, _lrelu_masked(e, m01, alpha), W[cb], exp)


def flash_gat_forward_plain(
    B: BSRMatrix, s1, s2, Wh, *, alpha: float = 0.2, return_stats: bool = False,
    fast_exp: bool = False,
):
    """Plain PyTorch K3: each row block's tiles in order, one tile step of
    every run at a time. Returns out [n_rows, H, F] (or [n_rows, F] for
    the single-head call) and with ``return_stats`` the true (m, l)
    [n_rt*tb, H]. ``fast_exp`` takes ``_fast_exp`` for the scores' exps."""
    exp = _fast_exp if fast_exp else torch.exp
    s1, s2, Wh, squeeze = _norm_heads(s1, s2, Wh)
    tb, H, F = B.tb, Wh.shape[1], Wh.shape[2]
    n_rt, n_ct = B.n_row_tiles, _round_up(B.n_cols, tb) // tb
    S1, S2, W = _padded(s1, s2, Wh, n_rt, n_ct, tb)
    st = _Online(n_rt, H, tb, F, Wh.device)
    tile_cb = B.tile_cb.long()
    _walk_runs(
        B.tile_rb, n_rt, 4 * H * tb * (4 * tb + 2 * F),
        lambda rb, t: _tile_update(st, B, S1, S2, W, alpha, rb, t, tile_cb[t], exp),
    )
    return st.result(B.n_rows, squeeze, return_stats)


def flash_gat_hybrid_forward_plain(
    plan: FusedAggPlan, s1, s2, Wh, *, alpha: float = 0.2,
    return_stats: bool = False, _chunk_mode: str = "full",
):
    """Plain PyTorch K6: each row block's steps in schedule order; a step
    of kind != 1 is a tile step, kind >= 1 a chunk step (kind 3: the tile,
    then the chunk). A chunk scores its K slots on a one-hot [tb, K] grid,
    as the TPU kernel does; dead slots (lrow == tb) match no row.
    ``_chunk_mode`` (``CHUNK_MODES``) applies without ``return_stats`` only,
    as in JAX: with the stats every chunk is scored."""
    mode = "full" if return_stats else _chunk_mode
    _kernel_flags(chunk_mode=mode)
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
        if c.any() and mode != "off":
            ch = chunk[g[c]]
            slots = (ch[:, None] * K + kar).reshape(-1)
            cols = plan.slot_col[slots].long()
            oh = (iota[:, None] == plan.lrow[ch][:, None, :]).to(torch.float32)  # [b, tb, K]
            feats = Wflat[cols].view(-1, K, H, F).permute(0, 2, 1, 3)
            if mode == "noscore":  # onehot(lrow) @ Wh into the sums alone
                st.acc[rb[c]] = st.acc[rb[c]] + torch.matmul(oh[:, None], feats)
                return
            sg = S2flat[cols].view(-1, K, H).permute(0, 2, 1)  # [b, H, K]
            e = S1[rb[c]][..., :, None] + sg[..., None, :]
            st.update(rb[c], _lrelu_masked(e, oh[:, None], alpha), feats)

    _walk_runs(
        plan.step_rb[:S], n_rt, 4 * H * tb * (4 * max(tb, K) + 2 * F), step,
    )
    return st.result(B.n_rows, squeeze, return_stats)


# ------------------------------------------------ plain versions of K4, K5


def _grid(x: torch.Tensor, n_blocks: int, tb: int, dtype=torch.float32) -> torch.Tensor:
    """Head-last ``x`` ([N, H] or [N, H, F]) zero-padded to
    ``n_blocks * tb`` rows in ``dtype``, contiguous."""
    rows = n_blocks * tb
    if x.shape[0] == rows:
        return x.to(dtype).contiguous()
    out = torch.zeros((rows, *x.shape[1:]), dtype=dtype, device=x.device)
    out[: x.shape[0]] = x
    return out


def _head_major(x: torch.Tensor, tb: int) -> torch.Tensor:
    """[nb*tb, H] -> [nb, H, tb]; [nb*tb, H, F] -> [nb, H, tb, F]."""
    x = x.view(-1, tb, *x.shape[1:])
    return x.permute(0, 2, 1) if x.dim() == 3 else x.permute(0, 2, 1, 3)


def _bwd_walk(B: BSRMatrix, s1, s2, m, l, Wh, gO, alpha: float, fn, fast_exp: bool = False) -> None:
    """Call ``fn(rb, cb, p, lr, q)`` for batches of tiles, with the TPU
    kernel's per-tile terms (``_tile_probs`` and the cotangent SDDMM)
    [b, H, tb(rows), tb(cols)]: p = exp(masked e - m) / max(l, 1e-30)
    (``_fast_exp`` with ``fast_exp``), lr = LeakyReLU', q = bf16(gO) @
    bf16(Wh)^T with f32 sums."""
    exp = _fast_exp if fast_exp else torch.exp
    tb, H, F = B.tb, Wh.shape[1], Wh.shape[2]
    n_rt, n_ct = B.n_row_tiles, _round_up(B.n_cols, tb) // tb
    S1, M, L = (_head_major(_grid(x, n_rt, tb), tb) for x in (s1, m, l))
    S2 = _head_major(_grid(s2, n_ct, tb), tb)
    W = _head_major(_bf16r(_grid(Wh, n_ct, tb)), tb)
    G = _head_major(_bf16r(_grid(gO, n_rt, tb)), tb)
    Linv = 1.0 / torch.clamp(L, min=1e-30)
    batch = max(1, _PLAIN_BATCH_BYTES // (4 * H * tb * (8 * tb + 2 * F)))
    for b0 in range(0, B.num_tiles, batch):
        ids = torch.arange(b0, min(B.num_tiles, b0 + batch), device=Wh.device)
        rb, cb = B.tile_rb[ids].long(), B.tile_cb[ids].long()
        e_pre = S1[rb][..., :, None] + S2[cb][..., None, :]
        e = _lrelu_masked(e_pre, _mask01(B.tiles[ids], tb)[:, None], alpha)
        p = exp(e - M[rb][..., None]) * Linv[rb][..., None]
        lr = torch.where(e_pre > 0, 1.0, alpha)
        fn(rb, cb, p, lr, torch.matmul(G[rb], W[cb].transpose(-1, -2)))


def flash_gat_bwd_row_plain(B: BSRMatrix, s1, s2, m, l, Wh, gO, *, alpha: float = 0.2, fast_exp: bool = False):
    """Plain PyTorch K4 (JAX ``_bwd_row_pass``): the row reductions
    ``t = sum_c p q``, ``u1 = sum_c p q lr``, ``u2 = sum_c p lr`` over
    ``B``'s tiles, each f32 [n_rt*tb, H]. ``s1`` [N, H], ``s2`` [M, H],
    ``Wh`` [M, H, F], ``gO`` [N, H, F] and the stats ``m``, ``l``
    [<= n_rt*tb, H] are zero-padded to the tile grid."""
    tb, H = B.tb, Wh.shape[1]
    n_rt = B.n_row_tiles
    sums = torch.zeros((3, n_rt, H, tb), dtype=torch.float32, device=Wh.device)

    def add(rb, cb, p, lr, q):
        pq = p * q
        for k, v in enumerate((pq, pq * lr, p * lr)):
            sums[k].index_add_(0, rb, v.sum(dim=-1))

    _bwd_walk(B, s1, s2, m, l, Wh, gO, alpha, add, fast_exp)
    t, u1, u2 = (x.permute(0, 2, 1).reshape(n_rt * tb, H) for x in sums)
    return t, u1, u2


def flash_gat_bwd_col_plain(B: BSRMatrix, s1, s2, m, l, t, Wh, gO, *, alpha: float = 0.2,
                            fast_exp: bool = False):
    """Plain PyTorch K5 (JAX ``_bwd_col_pass``): the column reductions
    ``dWh = bf16(p)^T @ bf16(gO)`` f32 [n_ct*tb, H, F] and ``ds2 =
    colsum(p (q - t) lr)`` f32 [n_ct*tb, H]. ``t`` is the full row
    reduction (tiles plus any other edges of the rows); operands as
    ``flash_gat_bwd_row_plain``."""
    tb, H, F = B.tb, Wh.shape[1], Wh.shape[2]
    n_rt, n_ct = B.n_row_tiles, _round_up(B.n_cols, tb) // tb
    T = _head_major(_grid(t, n_rt, tb), tb)
    G = _head_major(_bf16r(_grid(gO, n_rt, tb)), tb)
    dW = torch.zeros((n_ct, H, tb, F), dtype=torch.float32, device=Wh.device)
    ds2 = torch.zeros((n_ct, H, tb), dtype=torch.float32, device=Wh.device)

    def add(rb, cb, p, lr, q):
        dW.index_add_(0, cb, torch.matmul(_bf16r(p).transpose(-1, -2), G[rb]))
        ds2.index_add_(0, cb, (p * (q - T[rb][..., None]) * lr).sum(dim=-2))

    _bwd_walk(B, s1, s2, m, l, Wh, gO, alpha, add, fast_exp)
    return (
        dW.permute(0, 2, 1, 3).reshape(n_ct * tb, H, F),
        ds2.permute(0, 2, 1).reshape(n_ct * tb, H),
    )


# ------------------------------------------------------------ K3 and K6


def _check_scores(s1, s2, Wh, rows: int, cols: int) -> tuple:
    """(H, F) of head-last kernel operands, or a ValueError."""
    H, F = Wh.shape[1], Wh.shape[2]
    if s1.dim() != 2 or s2.dim() != 2 or Wh.dim() != 3 or s1.shape[1] != H or s2.shape[1] != H:
        raise ValueError(
            f"want s1 [N, H], s2 [N, H], Wh [N, H, F]; got {tuple(s1.shape)}, "
            f"{tuple(s2.shape)}, {tuple(Wh.shape)}"
        )
    if s1.shape[0] > rows or s2.shape[0] != Wh.shape[0] or Wh.shape[0] > cols:
        raise ValueError(
            f"s1 rows {s1.shape[0]} must fit {rows}; s2/Wh rows "
            f"{s2.shape[0]}/{Wh.shape[0]} must agree and fit {cols}"
        )
    if s1.dtype != torch.float32 or s2.dtype != torch.float32:
        raise ValueError(f"s1/s2 must be float32, got {s1.dtype}/{s2.dtype}")
    if Wh.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"Wh must be float32 or bfloat16, got {Wh.dtype}")
    return H, F


def _launch(name, B, S: RunSegments, s1, s2, Wh, alpha, return_stats, plan=None,
            pop=None, sb=0, flags=0):
    """Launch csrc/flash_gat.cu over run segments ``S``: K3 on ``B``'s
    tiles (K12 with the sub-block bitmap ``pop``), or K6 on ``plan``'s
    steps, with the runtime ``flags`` of ``_kernel_flags``."""
    s1, s2, Wh, squeeze = _norm_heads(s1, s2, Wh)
    dev = Wh.device
    tb = B.tb
    mode = _tile_mode(B.tiles, tb)
    if tb % 32 or tb > 1024:
        raise ValueError(f"the flash kernel needs tb % 32 == 0 and tb <= 1024, got {tb}")
    n_rt, n_ct = B.n_row_tiles, _round_up(B.n_cols, tb) // tb
    H, F = _check_scores(s1, s2, Wh, n_rt * tb, n_ct * tb)
    ints = dict(tile_cb=B.tile_cb, **S.tensors())
    if plan is not None:
        if plan.K % 32 or plan.K > 512 or plan.lrow.shape != (plan.num_chunks, plan.K):
            raise ValueError(f"lrow must be [R, K], K % 32 == 0, K <= 512; got {tuple(plan.lrow.shape)}")
        ints.update(
            step_cb=plan.step_cb, step_tile=plan.step_tile,
            step_chunk=plan.step_chunk, step_kind=plan.step_kind,
            lrow=plan.lrow, slot_col=plan.slot_col,
        )
    if pop is not None:
        ints.update(pop=pop)
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
        _ptr(pop), sb, _ptr(s1), s1.shape[0], _ptr(s2), s2.shape[0],
        _ptr(Whb), wvec, H, F, float(alpha),
        _ptr(out), B.n_rows, _ptr(m), _ptr(l), _ptr(pm), _ptr(pl), _ptr(pacc), flags,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _cuda.check(err, name)
    out = out[:, 0, :] if squeeze else out
    return (out, m, l) if return_stats else out


def flash_ring_shape_ok(mode: int, tb: int, H: int, F: int, K: Optional[int] = None) -> bool:
    """Whether the ring kernel (csrc/flash_gat_ring.cu) takes these operands:
    int8 or bf16 tiles of height 64, 128, 192 or 256 (a stage is 64 columns
    deep), F = 64 features a head and H in {1, 2, 4} heads (a CTA keeps its
    rows' R x H*F f32 accumulators in registers), chunks of whole 64-slot
    slabs. Everything else goes to the single-stage kernel. The rule reads
    shapes and the tile form only."""
    return (
        mode in (_TILE_MODES[torch.bfloat16], _TILE_MODES[torch.int8])
        and tb % 64 == 0 and 0 < tb <= 256 and F == 64 and H in (1, 2, 4)
        and (K is None or K % 64 == 0)
    )


def _takes_ring(B: BSRMatrix, Wh: torch.Tensor, K: Optional[int] = None) -> bool:
    H, F = (1, Wh.shape[1]) if Wh.dim() == 2 else (Wh.shape[1], Wh.shape[2])
    return flash_ring_shape_ok(_tile_mode(B.tiles, B.tb), B.tb, H, F, K)


def _launch_ring(name, B, L: LiveSchedule, s1, s2, Wh, alpha, return_stats, plan=None,
                 pop=None, sb=0, var=0):
    """Launch csrc/flash_gat_ring.cu over the live schedule ``L``: K3 on
    ``B``'s live tiles (``B.ring``), K6 on ``plan``'s live steps
    (``plan.ring``), or K12 with the bitmap ``pop`` on
    ``subskip_schedule``'s steps. s2 goes over zero-padded to the tile grid
    and Wh in bf16 (rounded once here, as the single-stage launch does);
    ``var`` the kernel's variant (``_ring_var``)."""
    s1, s2, Wh, squeeze = _norm_heads(s1, s2, Wh)
    dev = Wh.device
    tb = B.tb
    mode = _tile_mode(B.tiles, tb)
    n_rt, n_ct = B.n_row_tiles, _round_up(B.n_cols, tb) // tb
    H, F = _check_scores(s1, s2, Wh, n_rt * tb, n_ct * tb)
    S = L.segments
    ints = dict(step=L.step, pop=pop, **S.tensors())
    K = 0
    if plan is not None:
        if plan.lrow.shape != (plan.num_chunks, plan.K):
            raise ValueError(f"lrow must be [R, K], got {tuple(plan.lrow.shape)}")
        ints.update(lrow=plan.lrow, slot_col=plan.slot_col)
        K = plan.K
    if not flash_ring_shape_ok(mode, tb, H, F, K):
        raise ValueError(f"the ring kernel does not take tile mode {mode}, tb={tb}, H={H}, F={F}, K={K}")
    _check_cuda_operands(dict(tiles=B.tiles, s1=s1, s2=s2, Wh=Wh, **ints), dev)
    for k, t in ints.items():
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{k} must be int32, got {t.dtype}")
    s2p = _grid(s2, n_ct, tb)
    Whb = Wh.to(torch.bfloat16).contiguous()
    if Whb.data_ptr() % 16:
        raise ValueError("the ring kernel needs Wh aligned to 16 bytes")
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
    err = _cuda.library().sg_flash_gat_ring(
        _ptr(B.tiles), mode, tb, B.num_tiles, *_seg_args(S), _ptr(L.step),
        _ptr(ints.get("lrow")), _ptr(ints.get("slot_col")), K,
        _ptr(s1), s1.shape[0], _ptr(s2p), _ptr(Whb), Whb.shape[0], H, float(alpha),
        _ptr(out), B.n_rows, _ptr(m), _ptr(l), _ptr(pm), _ptr(pl), _ptr(pacc), _ptr(pop), sb, var,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _cuda.check(err, name)
    out = out[:, 0, :] if squeeze else out
    return (out, m, l) if return_stats else out


def _device_of(Wh: torch.Tensor, name: str) -> str:
    if Wh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {Wh.device}")
    return Wh.device.type


def _flash_gat_forward_single(
    B: BSRMatrix, s1, s2, Wh, *, alpha: float = 0.2, return_stats: bool = False, fast_exp: bool = False,
):
    """K3 by the single-stage kernel ``csrc/flash_gat.cu``: every tile form
    and shape, every tile of ``B.segments``."""
    res = _launch("flash_gat_forward", B, B.segments, s1, s2, Wh, alpha, return_stats,
                  flags=_kernel_flags(fast_exp))
    flash_gat_forward.launches += 1
    flash_gat_forward.launches_single += 1
    return res


def _flash_gat_forward_ring(
    B: BSRMatrix, s1, s2, Wh, *, alpha: float = 0.2, return_stats: bool = False, fast_exp: bool = False,
):
    """K3 by the ring kernel ``csrc/flash_gat_ring.cu`` over ``B.ring``."""
    res = _launch_ring("flash_gat_forward", B, B.ring, s1, s2, Wh, alpha, return_stats,
                       var=_ring_var(fast_exp))
    flash_gat_forward.launches += 1
    flash_gat_forward.launches_ring += 1
    return res


def flash_gat_forward(
    B: BSRMatrix, s1, s2, Wh, *, alpha: float = 0.2, return_stats: bool = False, fast_exp: bool = False,
):
    """K3: the masked online-softmax aggregation over ``B``'s tiles (mask
    ``> 0``; int8 and packed masks as stored); ``fast_exp`` swaps the
    scores' exps for Schraudolph's (``_fast_exp``), as JAX. A CPU tensor
    runs ``flash_gat_forward_plain``; a CUDA tensor launches the ring kernel
    where ``flash_ring_shape_ok`` holds, else the single-stage kernel, or
    raises. ``launches`` counts both; ``launches_ring`` /
    ``launches_single`` each one."""
    kw = dict(alpha=alpha, return_stats=return_stats, fast_exp=fast_exp)
    if _device_of(Wh, "flash_gat_forward") == "cpu":
        return flash_gat_forward_plain(B, s1, s2, Wh, **kw)
    if _takes_ring(B, Wh):
        return _flash_gat_forward_ring(B, s1, s2, Wh, **kw)
    return _flash_gat_forward_single(B, s1, s2, Wh, **kw)


flash_gat_forward.launches = 0
flash_gat_forward.launches_ring = 0
flash_gat_forward.launches_single = 0


# ----------------------------------------------------------------- K12


def subblock_pop_bitmap(B: BSRMatrix, A: SparseMatrix, sb: int) -> np.ndarray:
    """int32 [T, ceil((tb/sb)^2 / 32)] population bits of every tile's
    ``sb x sb`` sub-blocks, from the host edge list (JAX
    ``subblock_pop_bitmap``): bit ``i * (tb/sb) + j`` of tile t is set when
    sub-block (i, j) holds an edge of positive value."""
    tb = B.tb
    ns = tb // sb
    r = _np(A.rows)[: A.nnz].astype(np.int64)
    c = _np(A.cols)[: A.nnz].astype(np.int64)
    v = _np(A.vals)[: A.nnz]
    r, c = r[v > 0], c[v > 0]
    key_of_tile = _np(B.tile_rb).astype(np.int64) << 32 | _np(B.tile_cb).astype(np.int64)
    t_of_e = np.searchsorted(key_of_tile, (r // tb) << 32 | (c // tb))
    sub = ((r // sb) % ns) * ns + (c // sb) % ns
    pop = np.zeros((B.num_tiles, -(-(ns * ns) // 32)), np.int32)
    np.bitwise_or.at(pop, (t_of_e, sub // 32), (1 << (sub % 32)).astype(np.int32))
    return pop


def _subskip_operands(B: BSRMatrix, pop, s1, sb: int, device) -> torch.Tensor:
    """The checks of the JAX entry point; ``pop`` as an int32 tensor."""
    if s1.dim() != 1 and s1.shape[1] != 1:
        raise AssertionError("subskip experiment is single-head")
    if B.packed:
        raise NotImplementedError("subskip consumes unpacked tiles only")
    ns = B.tb // sb if sb > 0 and B.tb % sb == 0 else 0
    pop = torch.as_tensor(pop, device=device)
    if ns == 0 or pop.dtype != torch.int32 or pop.shape != (B.num_tiles, -(-(ns * ns) // 32)):
        raise ValueError(
            f"want sb dividing tb={B.tb} and pop int32 [T, ceil((tb/sb)^2/32)]; "
            f"got sb={sb}, pop {pop.dtype} {tuple(pop.shape)}"
        )
    return pop.contiguous()


def flash_gat_forward_subskip_plain(
    B: BSRMatrix, pop, s1, s2, Wh, *, alpha: float = 0.2, sb: int = 128
):
    """Plain PyTorch K12: each tile folds into the row softmax one
    ``sb``-column strip at a time, as the TPU kernel walks its sub-blocks,
    on the tile's mask with every sub-block whose bit in ``pop`` is 0
    cleared (the kernel never looks at such a sub-block; a strip without an
    edge in a row leaves that row's state exactly as it was)."""
    pop = _subskip_operands(B, pop, s1, sb, Wh.device)
    s1, s2, Wh, squeeze = _norm_heads(s1, s2, Wh)
    tb, ns, F = B.tb, B.tb // sb, Wh.shape[2]
    n_rt, n_ct = B.n_row_tiles, _round_up(B.n_cols, tb) // tb
    S1, S2, W = _padded(s1, s2, Wh, n_rt, n_ct, tb)
    st = _Online(n_rt, 1, tb, F, Wh.device)
    tile_cb = B.tile_cb.long()
    bit = torch.arange(ns * ns, device=Wh.device)

    def update(rb, t):
        keep = ((pop[t][:, bit // 32] >> (bit % 32)) & 1).view(-1, ns, ns)
        keep = keep.repeat_interleave(sb, 1).repeat_interleave(sb, 2)
        m01 = (_mask01(B.tiles[t], tb) * keep)[:, None]  # [b, 1, tb, tb]
        cb = tile_cb[t]
        for j in range(ns):
            cj = slice(j * sb, (j + 1) * sb)
            e = S1[rb][..., :, None] + S2[cb][..., None, cj]
            st.update(rb, _lrelu_masked(e, m01[..., cj], alpha), W[cb][:, :, cj])

    _walk_runs(B.tile_rb, n_rt, 4 * tb * (5 * tb + 2 * F), update)
    return st.result(B.n_rows, squeeze, False)


def subskip_slabs(pop: torch.Tensor, tb: int, sb: int) -> torch.Tensor:
    """int32 [T] on ``pop``'s device: bit j set when a populated sub-block of
    the tile (bitmap ``pop`` [T, nw] of ``sb x sb`` sub-blocks) meets its
    64-column slab j (columns 64j .. 64j + 63), in any row. Batches of
    tiles bound the scratch."""
    ns, n_slabs = tb // sb, -(-tb // 64)
    dev = pop.device
    bit = torch.arange(ns * ns, device=dev)
    word, shift = bit // 32, (bit % 32).to(torch.int32)
    cs = torch.arange(ns, device=dev)
    j = torch.arange(n_slabs, device=dev)
    meets = (cs[None, :] * sb < 64 * (j[:, None] + 1)) & ((cs[None, :] + 1) * sb > 64 * j[:, None])
    out = torch.empty(pop.shape[0], dtype=torch.int32, device=dev)
    batch = max(1, _PLAIN_BATCH_BYTES // (8 * ns * ns))
    for b0 in range(0, pop.shape[0], batch):
        bits = (pop[b0: b0 + batch][:, word] >> shift) & 1
        col = bits.view(-1, ns, ns).amax(dim=1) > 0  # [b, ns]: a populated sub-block in that column
        hit = (col[:, None, :] & meets).any(dim=-1)  # [b, n_slabs]
        out[b0: b0 + batch] = (hit.to(torch.int32) << j.to(torch.int32)).sum(dim=-1, dtype=torch.int32)
    return out


def subskip_schedule(B: BSRMatrix, pop: torch.Tensor, sb: int) -> LiveSchedule:
    """The ring K12's schedule: ``B.ring``'s live tile steps with the bitmap
    folded in. At one head a work item holds every row of its tile, so a
    step loads only the 64-column slabs that a populated sub-block meets
    (``subskip_slabs``), their mask in the step's last field (its chunk-slot
    field, free on a tile-only schedule); a step whose tile meets none keeps
    its place with no tile (-1). The plain version of the fold kernel of
    csrc/flash_gat_ring.cu (``_subskip_fold``), which the ring K12 runs on
    the card: one launch in place of a dozen small ones, whose launch gaps
    outlast their work."""
    step = B.ring.step.clone()
    tile = step[:, 0].long()
    slabs = torch.where(tile >= 0, subskip_slabs(pop, B.tb, sb)[tile.clamp(min=0)], 0)
    step[:, 3] = slabs
    step[:, 0] = torch.where(slabs != 0, step[:, 0], -1)
    return dataclasses.replace(B.ring, step=step)


def _subskip_fold(B: BSRMatrix, pop: torch.Tensor, sb: int) -> LiveSchedule:
    """``subskip_schedule``'s result by the fold kernel of
    csrc/flash_gat_ring.cu: one launch, a warp a live step."""
    step = torch.empty_like(B.ring.step)
    err = _cuda.library().sg_subskip_fold(
        _ptr(B.ring.step), step.shape[0], _ptr(pop), B.tb, sb, _ptr(step),
        ctypes.c_void_p(torch.cuda.current_stream(pop.device).cuda_stream),
    )
    _cuda.check(err, "subskip_fold")
    return dataclasses.replace(B.ring, step=step)


def _flash_gat_forward_subskip_single(B: BSRMatrix, pop, s1, s2, Wh, *, alpha: float = 0.2, sb: int = 128):
    """K12 by the single-stage kernel ``csrc/flash_gat.cu``: every tile of
    ``B.segments``, the bitmap read per CTA row group and per 8 columns."""
    pop = _subskip_operands(B, pop, s1, sb, Wh.device)
    res = _launch("flash_gat_forward_subskip", B, B.segments, s1, s2, Wh, alpha, False, pop=pop, sb=sb)
    flash_gat_forward_subskip.launches += 1
    flash_gat_forward_subskip.launches_single += 1
    return res


def _flash_gat_forward_subskip_ring(B: BSRMatrix, pop, s1, s2, Wh, *, alpha: float = 0.2, sb: int = 128):
    """K12 by the ring kernel ``csrc/flash_gat_ring.cu`` over
    ``subskip_schedule(B, pop, sb)``, folded on the card (``_subskip_fold``)."""
    pop = _subskip_operands(B, pop, s1, sb, Wh.device)
    _check_cuda_operands(dict(step=B.ring.step, pop=pop), Wh.device)
    res = _launch_ring("flash_gat_forward_subskip", B, _subskip_fold(B, pop, sb), s1, s2, Wh, alpha,
                       False, pop=pop, sb=sb)
    flash_gat_forward_subskip.launches += 1
    flash_gat_forward_subskip.launches_ring += 1
    return res


def flash_gat_forward_subskip(
    B: BSRMatrix, pop, s1, s2, Wh, *, alpha: float = 0.2, sb: int = 128
):
    """K12: ``flash_gat_forward`` for one head that skips every ``sb x sb``
    sub-block whose bit in the host-built bitmap ``pop``
    (``subblock_pop_bitmap``) is 0: its mask bytes, scores, exps and
    product (JAX ``flash_gat_forward_subskip``); any ``sb`` that divides
    ``tb``. int8 or value tiles only. A CPU tensor runs
    ``flash_gat_forward_subskip_plain``; a CUDA tensor launches the ring
    kernel where ``flash_ring_shape_ok`` holds at one head, else the
    single-stage kernel, or raises. ``launches`` counts both;
    ``launches_ring`` / ``launches_single`` each one."""
    if _device_of(Wh, "flash_gat_forward_subskip") == "cpu":
        return flash_gat_forward_subskip_plain(B, pop, s1, s2, Wh, alpha=alpha, sb=sb)
    if _takes_ring(B, Wh):
        return _flash_gat_forward_subskip_ring(B, pop, s1, s2, Wh, alpha=alpha, sb=sb)
    return _flash_gat_forward_subskip_single(B, pop, s1, s2, Wh, alpha=alpha, sb=sb)


flash_gat_forward_subskip.launches = 0
flash_gat_forward_subskip.launches_ring = 0
flash_gat_forward_subskip.launches_single = 0


def flash_gat_hybrid_forward(
    plan: FusedAggPlan, s1, s2, Wh, *, alpha: float = 0.2,
    return_stats: bool = False, _chunk_mode: str = "full",
):
    """K6: tile steps and remainder chunk steps of a value-mode fused plan
    in one exact row softmax over all edges. ``_chunk_mode`` is the JAX
    package's ablation of the chunk steps (``CHUNK_MODES``), taken without
    ``return_stats`` only: a forward that saves stats for the backward
    always scores its chunks. A CPU tensor runs
    ``flash_gat_hybrid_forward_plain``; a CUDA tensor launches the ring
    kernel where ``flash_ring_shape_ok`` holds, else the single-stage
    kernel, or raises. ``launches`` counts both; ``launches_ring`` /
    ``launches_single`` each one."""
    if plan.colscale is not None:
        raise ValueError("the hybrid flash forward takes a value-mode plan (no rank-1 scalings)")
    kw = dict(alpha=alpha, return_stats=return_stats, _chunk_mode=_chunk_mode)
    if _device_of(Wh, "flash_gat_hybrid_forward") == "cpu":
        return flash_gat_hybrid_forward_plain(plan, s1, s2, Wh, **kw)
    if _takes_ring(plan.B, Wh, plan.K):
        return _flash_gat_hybrid_forward_ring(plan, s1, s2, Wh, **kw)
    return _flash_gat_hybrid_forward_single(plan, s1, s2, Wh, **kw)


def _flash_gat_hybrid_forward_single(
    plan: FusedAggPlan, s1, s2, Wh, *, alpha: float = 0.2, return_stats: bool = False,
    _chunk_mode: str = "full",
):
    """K6 by the single-stage kernel ``csrc/flash_gat.cu`` over every step
    of ``plan.segments``."""
    res = _launch(
        "flash_gat_hybrid_forward", plan.B, plan.segments, s1, s2, Wh, alpha,
        return_stats, plan=plan, flags=_kernel_flags(chunk_mode="full" if return_stats else _chunk_mode),
    )
    flash_gat_hybrid_forward.launches += 1
    flash_gat_hybrid_forward.launches_single += 1
    return res


def _flash_gat_hybrid_forward_ring(
    plan: FusedAggPlan, s1, s2, Wh, *, alpha: float = 0.2, return_stats: bool = False,
    _chunk_mode: str = "full",
):
    """K6 by the ring kernel ``csrc/flash_gat_ring.cu`` over ``plan.ring``;
    at chunk mode ``off`` the ring over the plan's tiles alone
    (``plan.B.ring``), K3's launch."""
    mode = "full" if return_stats else _chunk_mode
    if mode == "off":
        res = _launch_ring("flash_gat_hybrid_forward", plan.B, plan.B.ring, s1, s2, Wh, alpha, return_stats)
    else:
        res = _launch_ring(
            "flash_gat_hybrid_forward", plan.B, plan.ring, s1, s2, Wh, alpha, return_stats, plan=plan,
            var=_ring_var(chunk_mode=mode),
        )
    flash_gat_hybrid_forward.launches += 1
    flash_gat_hybrid_forward.launches_ring += 1
    return res


flash_gat_hybrid_forward.launches = 0
flash_gat_hybrid_forward.launches_ring = 0
flash_gat_hybrid_forward.launches_single = 0


# ------------------------------------------------------------ K4 and K5


def _bwd_check(B: BSRMatrix, Wh, gO, given: dict) -> tuple:
    """(mode, H, F, n_rt, n_ct, ops) of a K4/K5 launch: the operands padded
    to the tile grid, Wh and gO rounded to bf16 (the plain version and the
    TPU kernel round the same values per tile); no copy where
    ``bwd_operands`` already did both."""
    tb = B.tb
    mode = _tile_mode(B.tiles, tb)
    n_rt, n_ct = B.n_row_tiles, _round_up(B.n_cols, tb) // tb
    if Wh.dim() != 3 or gO.dim() != 3 or gO.shape[1:] != Wh.shape[1:]:
        raise ValueError(f"want Wh and gO [N, H, F]; got {tuple(Wh.shape)}, {tuple(gO.shape)}")
    H, F = Wh.shape[1], Wh.shape[2]
    rows = dict(s1=n_rt, m=n_rt, l=n_rt, t=n_rt, s2=n_ct, Wh=n_ct, gO=n_rt)
    for k, x in given.items():
        if x is None:
            continue
        if x.dim() != (3 if k in ("Wh", "gO") else 2) or x.shape[1] != H or x.shape[0] > rows[k] * tb:
            raise ValueError(f"{k} {tuple(x.shape)} must be [<= {rows[k] * tb}, {H}(, F)]")
        if x.dtype not in ((torch.float32, torch.bfloat16) if k in ("Wh", "gO") else (torch.float32,)):
            raise ValueError(f"{k} has dtype {x.dtype}")
    ops = {
        k: _grid(x, rows[k], tb, torch.bfloat16 if k in ("Wh", "gO") else torch.float32)
        for k, x in given.items() if x is not None
    }
    return mode, H, F, n_rt, n_ct, ops


def _launch_bwd(name, B: BSRMatrix, s1, s2, m, l, Wh, gO, alpha, t=None, fast_exp: bool = False):
    """Launch csrc/flash_gat_bwd.cu on head-last operands: K4 over the
    row-block runs (``t`` None), else K5 over the column-block runs."""
    dev = Wh.device
    tb = B.tb
    if tb % 32 or tb > 1024:
        raise ValueError(f"the flash kernels need tb % 32 == 0 and tb <= 1024, got {tb}")
    mode, H, F, n_rt, n_ct, ops = _bwd_check(B, Wh, gO, dict(s1=s1, m=m, l=l, t=t, s2=s2, Wh=Wh, gO=gO))
    S = B.segments if t is None else B.col_segments
    ints = dict(tile_cb=B.tile_cb, tile_rb=B.tile_rb, col_perm=B.col_perm, **S.tensors())
    _check_cuda_operands(dict(tiles=B.tiles, **ops, **ints), dev)
    for k, x in ints.items():
        if x.dtype != torch.int32:
            raise ValueError(f"{k} must be int32, got {x.dtype}")
    wvec = int(F % 8 == 0 and ops["Wh"].data_ptr() % 16 == 0 and ops["gO"].data_ptr() % 16 == 0)
    f32 = dict(dtype=torch.float32, device=dev)
    n_part = max(S.n_part, 1)
    common = (
        _ptr(ops["Wh"]), _ptr(ops["gO"]), wvec, H, F, float(alpha), int(fast_exp),
    )
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    if t is None:
        tuu = torch.empty((n_rt * tb, 3 * H), **f32)
        partial = torch.empty((n_part, tb, 3 * H), **f32)
        err = _cuda.library().sg_flash_gat_bwd_row(
            _ptr(B.tiles), mode, tb, *_seg_args(S), _ptr(B.tile_cb),
            _ptr(ops["s1"]), _ptr(ops["s2"]), _ptr(ops["m"]), _ptr(ops["l"]), *common,
            _ptr(tuu), n_rt * tb, _ptr(partial), stream,
        )
        _cuda.check(err, name)
        return tuu[:, :H], tuu[:, H : 2 * H], tuu[:, 2 * H :]
    dwh = torch.empty((n_ct * tb, H, F), **f32)
    ds2 = torch.empty((n_ct * tb, H), **f32)
    pdwh = torch.empty((n_part, tb, H, F), **f32)
    pds2 = torch.empty((n_part, tb, H), **f32)
    err = _cuda.library().sg_flash_gat_bwd_col(
        _ptr(B.tiles), mode, tb, *_seg_args(S), _ptr(B.col_perm), _ptr(B.tile_rb),
        _ptr(ops["s1"]), _ptr(ops["s2"]), _ptr(ops["m"]), _ptr(ops["l"]), _ptr(ops["t"]),
        *common, _ptr(dwh), _ptr(ds2), n_ct * tb, _ptr(pdwh), _ptr(pds2), stream,
    )
    _cuda.check(err, name)
    return dwh, ds2


def flash_bwd_ring_shape_ok(mode: int, tb: int, H: int, F: int) -> bool:
    """Whether the backward ring kernels (csrc/flash_gat_bwd_ring.cu) take
    these operands: int8 or bf16 tiles of height 64, 128, 192 or 256 (a
    stage is 64 deep), F = 64 features a head and H in {1, 2, 4} heads (a
    CTA owns every head of its rows; K5 keeps R x H*F f32 dWh sums in
    registers). Everything else goes to the single-stage kernels. The rule
    reads shapes and the tile form only."""
    return (
        mode in (_TILE_MODES[torch.bfloat16], _TILE_MODES[torch.int8])
        and tb % 64 == 0 and 0 < tb <= 256 and F == 64 and H in (1, 2, 4)
    )


def _takes_bwd_ring(B: BSRMatrix, Wh: torch.Tensor) -> bool:
    return Wh.dim() == 3 and flash_bwd_ring_shape_ok(_tile_mode(B.tiles, B.tb), B.tb, Wh.shape[1], Wh.shape[2])


def _launch_bwd_ring(name, B: BSRMatrix, s1, s2, m, l, Wh, gO, alpha, t=None, fast_exp: bool = False):
    """Launch csrc/flash_gat_bwd_ring.cu: K4 (``t`` None) over ``B.ring``,
    own rows A's rows, Wh streamed; K5 over ``B.live_t.ring`` (the
    transposed live tiles), own rows A's columns, gO streamed with the
    slab rows' stats packed as [n_rt*tb, 4, H] = (s1, m, 1/max(l, 1e-30),
    t)."""
    dev = Wh.device
    tb = B.tb
    mode, H, F, n_rt, n_ct, ops = _bwd_check(B, Wh, gO, dict(s1=s1, m=m, l=l, t=t, s2=s2, Wh=Wh, gO=gO))
    if not flash_bwd_ring_shape_ok(mode, tb, H, F):
        raise ValueError(f"the backward ring kernel does not take tile mode {mode}, tb={tb}, H={H}, F={F}")
    T = B if t is None else B.live_t
    L, S = T.ring, T.ring.segments
    _check_cuda_operands(dict(tiles=T.tiles, step=L.step, **ops, **S.tensors()), dev)
    for k, x in dict(step=L.step, **S.tensors()).items():
        if x.dtype != torch.int32:
            raise ValueError(f"{k} must be int32, got {x.dtype}")
    f32 = dict(dtype=torch.float32, device=dev)
    n_part = max(S.n_part, 1)
    if t is None:
        out = torch.empty((n_rt * tb, 3 * H), **f32)
        out2 = part2 = None
        part = torch.empty((n_part, tb, 3 * H), **f32)
        stat, op, res, own = ops["s2"], ops["Wh"], ops["gO"], (ops["s1"], ops["m"], ops["l"])
    else:
        out = torch.empty((n_ct * tb, H, F), **f32)
        out2 = torch.empty((n_ct * tb, H), **f32)
        part = torch.empty((n_part, tb, H, F), **f32)
        part2 = torch.empty((n_part, tb, H), **f32)
        linv = 1.0 / torch.clamp(ops["l"], min=1e-30)
        stat = torch.stack((ops["s1"], ops["m"], linv, ops["t"]), dim=1)
        op, res, own = ops["gO"], ops["Wh"], (ops["s2"], None, None)
    err = _cuda.library().sg_flash_gat_bwd_ring(
        int(t is not None), _ptr(T.tiles), mode, tb, T.num_tiles, *_seg_args(S), _ptr(L.step),
        _ptr(stat), _ptr(op), op.shape[0], _ptr(res), *(_ptr(x) for x in own), H, float(alpha),
        int(fast_exp), _ptr(out), _ptr(out2), _ptr(part), _ptr(part2),
        torch.cuda.get_device_properties(dev).multi_processor_count,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _cuda.check(err, name)
    if t is None:
        return out[:, :H], out[:, H : 2 * H], out[:, 2 * H :]
    return out, out2


def _count(kern, ring: bool) -> None:
    kern.launches += 1
    if ring:
        kern.launches_ring += 1
    else:
        kern.launches_single += 1


def _flash_gat_bwd_row_single(B: BSRMatrix, s1, s2, m, l, Wh, gO, *, alpha: float = 0.2,
                             fast_exp: bool = False):
    """K4 by the single-stage kernel ``csrc/flash_gat_bwd.cu``: every tile
    form and shape, every tile of ``B.segments``, one head a CTA."""
    res = _launch_bwd("flash_gat_bwd_row", B, s1, s2, m, l, Wh, gO, alpha, fast_exp=fast_exp)
    _count(flash_gat_bwd_row, False)
    return res


def _flash_gat_bwd_row_ring(B: BSRMatrix, s1, s2, m, l, Wh, gO, *, alpha: float = 0.2,
                           fast_exp: bool = False):
    """K4 by the ring kernel ``csrc/flash_gat_bwd_ring.cu`` over ``B.ring``."""
    res = _launch_bwd_ring("flash_gat_bwd_row", B, s1, s2, m, l, Wh, gO, alpha, fast_exp=fast_exp)
    _count(flash_gat_bwd_row, True)
    return res


def flash_gat_bwd_row(B: BSRMatrix, s1, s2, m, l, Wh, gO, *, alpha: float = 0.2, fast_exp: bool = False):
    """K4: the backward's row reductions ``(t, u1, u2)`` over ``B``'s
    tiles, each f32 [n_rt*tb, H]; ``fast_exp`` recomputes the
    probabilities with ``_fast_exp``, as JAX. A CPU tensor runs
    ``flash_gat_bwd_row_plain``; a CUDA tensor launches the ring kernel
    where ``flash_bwd_ring_shape_ok`` holds, else the single-stage kernel,
    or raises. ``launches`` counts both; ``launches_ring`` /
    ``launches_single`` each one."""
    if _device_of(Wh, "flash_gat_bwd_row") == "cpu":
        return flash_gat_bwd_row_plain(B, s1, s2, m, l, Wh, gO, alpha=alpha, fast_exp=fast_exp)
    kern = _flash_gat_bwd_row_ring if _takes_bwd_ring(B, Wh) else _flash_gat_bwd_row_single
    return kern(B, s1, s2, m, l, Wh, gO, alpha=alpha, fast_exp=fast_exp)


flash_gat_bwd_row.launches = 0
flash_gat_bwd_row.launches_ring = 0
flash_gat_bwd_row.launches_single = 0


def _flash_gat_bwd_col_single(B: BSRMatrix, s1, s2, m, l, t, Wh, gO, *, alpha: float = 0.2,
                             fast_exp: bool = False):
    """K5 by the single-stage kernel ``csrc/flash_gat_bwd.cu`` over every
    tile of ``B.col_segments``, one head a CTA."""
    res = _launch_bwd("flash_gat_bwd_col", B, s1, s2, m, l, Wh, gO, alpha, t=t, fast_exp=fast_exp)
    _count(flash_gat_bwd_col, False)
    return res


def _flash_gat_bwd_col_ring(B: BSRMatrix, s1, s2, m, l, t, Wh, gO, *, alpha: float = 0.2,
                           fast_exp: bool = False):
    """K5 by the ring kernel ``csrc/flash_gat_bwd_ring.cu`` over
    ``B.live_t.ring``."""
    res = _launch_bwd_ring("flash_gat_bwd_col", B, s1, s2, m, l, Wh, gO, alpha, t=t, fast_exp=fast_exp)
    _count(flash_gat_bwd_col, True)
    return res


def flash_gat_bwd_col(B: BSRMatrix, s1, s2, m, l, t, Wh, gO, *, alpha: float = 0.2, fast_exp: bool = False):
    """K5: the backward's column reductions ``(dWh [n_ct*tb, H, F], ds2
    [n_ct*tb, H])`` over ``B``'s tiles in column order, with ``t`` the full
    row reduction; ``fast_exp`` as in ``flash_gat_bwd_row``. A CPU tensor
    runs ``flash_gat_bwd_col_plain``; a CUDA
    tensor launches the ring kernel where ``flash_bwd_ring_shape_ok``
    holds (on the transposed live tiles ``B.live_t``, built at its first
    call), else the single-stage kernel, or raises. ``launches`` counts
    both; ``launches_ring`` / ``launches_single`` each one."""
    if _device_of(Wh, "flash_gat_bwd_col") == "cpu":
        return flash_gat_bwd_col_plain(B, s1, s2, m, l, t, Wh, gO, alpha=alpha, fast_exp=fast_exp)
    kern = _flash_gat_bwd_col_ring if _takes_bwd_ring(B, Wh) else _flash_gat_bwd_col_single
    return kern(B, s1, s2, m, l, t, Wh, gO, alpha=alpha, fast_exp=fast_exp)


flash_gat_bwd_col.launches = 0
flash_gat_bwd_col.launches_ring = 0
flash_gat_bwd_col.launches_single = 0


def _edge_row_terms(rows, cols, mask, s1, s2, Wh, gO, m, l, alpha: float, n_rows: int):
    """Edges' part of the row reductions, as JAX ``_halo_agg_bwd``
    computes its remote edges' (``s2`` / ``Wh`` the column side: the halo
    rows' there): per-edge ``p`` under the merged stats, f32 ``q = gO[r] .
    Wh[c]``, LeakyReLU' and the row sums ``(t, u1, u2)`` [n_rows, H]."""
    e_pre = s1.index_select(0, rows) + s2.index_select(0, cols)
    lr = torch.where(e_pre > 0, 1.0, alpha)
    e = torch.maximum(e_pre, alpha * e_pre)
    p = torch.where(mask, torch.exp(e - m.index_select(0, rows)), 0.0)
    p = p / torch.clamp(l, min=1e-30).index_select(0, rows)
    q = (gO.index_select(0, rows) * Wh.index_select(0, cols).float()).sum(dim=-1)
    seg = lambda x: torch.zeros((n_rows, x.shape[1]), dtype=x.dtype, device=x.device).index_add_(0, rows, x)
    edge = dict(rows=rows, cols=cols, mask=mask, p=p, q=q, lr=lr)
    return edge, seg(p * q), seg(p * q * lr), seg(p * lr)


def _rest_row_terms(rest: SparseMatrix, s1, s2, Wh, gO, m, l, alpha: float):
    """The remainder edges' part of the row reductions
    (``_edge_row_terms`` with ``s2h = s2``, ``halo = Wh``)."""
    rows, cols, vals = (x[: rest.nnz] for x in _edges(rest, Wh.device))
    return _edge_row_terms(rows.long(), cols.long(), (vals > 0)[:, None], s1, s2, Wh, gO, m, l, alpha,
                           rest.n_rows)


def _rest_fan_in(edge: dict, gO, t, n_cols: int):
    """The remainder edges' cotangents of ``s2`` and ``Wh`` [n_cols, H(, F)]
    once the full row reduction ``t`` is known."""
    rows, cols, p = edge["rows"], edge["cols"], edge["p"]
    dE = torch.where(edge["mask"], p * (edge["q"] - t.index_select(0, rows)) * edge["lr"], 0.0)
    ds2 = torch.zeros((n_cols, p.shape[1]), dtype=p.dtype, device=p.device).index_add_(0, cols, dE)
    msg = gO.index_select(0, rows) * p[..., None]
    dWh = torch.zeros((n_cols, *msg.shape[1:]), dtype=msg.dtype, device=msg.device)
    return ds2, dWh.index_add_(0, cols, msg)


def bwd_operands(B: BSRMatrix, s1, s2, Wh, gO, m, l) -> dict:
    """The operands K4 and K5 share, as ``flash_gat_backward`` hands them
    over: head-last, padded to the tile grid, Wh and gO rounded to bf16 once
    (the remainder terms read the f32 Wh and gO), and the stats of rows past
    ``n_rows`` (which hold no edge) set to (0, 1) as in JAX."""
    nl, tb, n_rt = B.n_rows, B.tb, B.n_row_tiles
    n_ct = _round_up(B.n_cols, tb) // tb
    m_p, l_p = m.clone(), l.clone()
    m_p[nl:], l_p[nl:] = 0.0, 1.0
    return dict(
        s1=_grid(s1, n_rt, tb), s2=_grid(s2, n_ct, tb), m=m_p, l=l_p,
        Wh=_grid(Wh, n_ct, tb, torch.bfloat16), gO=_grid(gO, n_rt, tb, torch.bfloat16),
    )


def flash_gat_backward(
    B: BSRMatrix, s1, s2, Wh, gO, m, l, *, alpha: float = 0.2,
    rest: Optional[SparseMatrix] = None,
):
    """``(ds1, ds2, dWh)`` of the flash aggregation from the forward's row
    stats ``m``, ``l`` [n_rt*tb, H] (the softmax-Jacobian identity of the
    reference, JAX ``flash_gat_backward``): K4, ``ds1 = u1 - t u2``, then
    K5. With ``rest``, the hybrid split's remainder edges (the stats are
    K6's, merged over both) add their terms in plain torch, as JAX
    ``_hybrid_agg_bwd``: their row sums join ``t`` before K5 subtracts
    it, their fan-in terms add to ``ds2`` and ``dWh``. 1-D scores with
    2-D ``Wh`` are the single-head call."""
    s1, s2, Wh, squeeze = _norm_heads(s1, s2, Wh)
    n1, n2, nw = s1.shape[0], s2.shape[0], Wh.shape[0]
    gO = gO.reshape(gO.shape[0], *Wh.shape[1:])
    nl, tb, n_rt = B.n_rows, B.tb, B.n_row_tiles
    ops = bwd_operands(B, s1, s2, Wh, gO, m, l)
    t, u1, u2 = (x[:nl] for x in flash_gat_bwd_row(B, **ops, alpha=alpha))
    edge = None
    if rest is not None and rest.nnz:
        edge, t_r, u1_r, u2_r = _rest_row_terms(rest, s1, s2, Wh, gO, m[:nl], l[:nl], alpha)
        t, u1, u2 = t + t_r, u1 + u1_r, u2 + u2_r
    ds1 = (u1 - t * u2)[:n1]
    dWh, ds2 = flash_gat_bwd_col(B, **ops, t=_grid(t, n_rt, tb), alpha=alpha)
    del ops  # the bf16 copies go before the fan-in sums allocate (peak memory)
    ds2, dWh = ds2[:n2], dWh[:nw]
    if edge is not None:
        ds2h, d_halo = _rest_fan_in(edge, gO, t, nw)
        ds2, dWh = ds2 + ds2h, dWh + d_halo
    if squeeze:
        return ds1[:, 0], ds2[:, 0], dWh[:, 0, :]
    return ds1, ds2, dWh


# ------------------------------------------------- differentiable entries


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


class _Flash(torch.autograd.Function):
    """``forward`` (K3 on tiles ``op`` or K6 on a plan ``op``) with its
    stats; ``flash_gat_backward`` on the tiles ``B`` (K4 + K5, plus the
    remainder ``rest`` of a hybrid split)."""

    @staticmethod
    def forward(ctx, forward, op, B, rest, alpha, s1, s2, Wh):
        out, m, l = forward(op, s1, s2, Wh, alpha=alpha, return_stats=True)
        ctx.B, ctx.rest, ctx.alpha = B, rest, alpha
        ctx.save_for_backward(s1, s2, Wh, m, l)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gO):
        s1, s2, Wh, m, l = ctx.saved_tensors
        ds1, ds2, dWh = flash_gat_backward(
            ctx.B, s1, s2, Wh, gO, m, l, alpha=ctx.alpha, rest=ctx.rest
        )
        return None, None, None, None, None, ds1, ds2, dWh.to(Wh.dtype)


class _EdgeBwd(torch.autograd.Function):
    """K3 forward on the tiles ``B``; the reference's per-edge backward on
    the edge list ``A`` (JAX ``_gat_agg_bwd``), single head."""

    @staticmethod
    def forward(ctx, A, B, alpha, s1, s2, Wh):
        ctx.A, ctx.alpha = A, alpha
        ctx.save_for_backward(s1, s2, Wh)
        return flash_gat_forward(B, s1, s2, Wh, alpha=alpha)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gO):
        s1, s2, Wh = ctx.saved_tensors
        A, alpha = ctx.A, ctx.alpha
        rows, cols, _ = (x.long() for x in _edges(A, Wh.device))
        e_pre, s, mask = _edge_scores(A, s1, s2, alpha)
        gO_r = gO.float().index_select(0, rows)
        q = (gO_r * Wh.float().index_select(0, cols)).sum(dim=1)  # SDDMM of the cotangent
        seg = lambda x, idx, n: torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device).index_add_(0, idx, x)
        # the softmax Jacobian, dE = s (q - sum_row(s q)), times LeakyReLU'
        t = seg(s * q, rows, A.n_rows)
        dE = s * (q - t.index_select(0, rows)) * torch.where(e_pre > 0, 1.0, alpha)
        dE = torch.where(mask, dE, 0.0)
        ds1 = seg(dE, rows, A.n_rows)[: s1.shape[0]]
        ds2 = seg(dE, cols, A.n_cols)[: s2.shape[0]]
        dWh = seg(gO_r * s[:, None], cols, Wh.shape[0])  # the transposed aggregation
        return None, None, None, ds1.to(s1.dtype), ds2.to(s2.dtype), dWh.to(Wh.dtype)


def gat_attention_agg(A: SparseMatrix, B: BSRMatrix, s1, s2, Wh, alpha: float = 0.2):
    """Single-head flash GAT aggregation with the reference's edge
    backward (JAX ``gat_attention_agg``): K3 on ``B`` forward; under grad
    the backward runs on the edge list ``A`` of the same adjacency
    (per-edge softmax with ``mask = vals > 0``, the Jacobian identity,
    segment sums), not K4/K5 (``gat_attention_agg_fused``). s1, s2 are
    [N], Wh is [N, F]; gradients flow to all three."""
    if _needs_grad(s1, s2, Wh):
        return _EdgeBwd.apply(A, B, alpha, s1, s2, Wh)
    return flash_gat_forward(B, s1, s2, Wh, alpha=alpha)


def gat_attention_agg_fused(B: BSRMatrix, s1, s2, Wh, alpha: float = 0.2):
    """Flash GAT aggregation on full-cover mask tiles, differentiable
    (JAX ``gat_attention_agg_fused``): K3 forward; under grad it keeps
    K3's ``(m, l)`` and the backward runs K4 and K5. Gradients flow to
    ``s1``, ``s2`` and ``Wh``."""
    if _needs_grad(s1, s2, Wh):
        return _Flash.apply(flash_gat_forward, B, B, None, alpha, s1, s2, Wh)
    return flash_gat_forward(B, s1, s2, Wh, alpha=alpha)


def gat_attention_agg_hybrid(
    plan: FusedAggPlan, rest: Optional[SparseMatrix], s1, s2, Wh,
    alpha: float = 0.2, edges_sorted: bool = False,
):
    """Hybrid flash GAT aggregation, differentiable (JAX
    ``gat_attention_agg_hybrid``): dense tiles and remainder chunks in one
    pass (K6). ``rest`` is the remainder as an edge list, read only by the
    backward (``flash_gat_backward``). ``edges_sorted`` (rest's rows
    are sorted) is accepted for the JAX signature; the scatter-adds here
    do not use it."""
    if _needs_grad(s1, s2, Wh):
        return _Flash.apply(flash_gat_hybrid_forward, plan, plan.B, rest, alpha, s1, s2, Wh)
    return flash_gat_hybrid_forward(plan, s1, s2, Wh, alpha=alpha)


# ------------------------------------- one shard of the distributed layer


def _halo_gat_forward(B: BSRMatrix, s1, s2, s2h, Wh, halo, rows_rem, cols_halo, mask_rem, alpha: float):
    """One shard's row softmax over its local tiles and its remote (halo)
    edges, head-last (s1/s2 [n, H], s2h [HL, H], Wh [n, H, F], halo
    [HL, H, F]): K3 with its stats ``(m_l, l_l)`` on the tiles, the
    streaming-softmax pieces on the remote edges, combined by the flash
    block-combine identity

        m = max(m_l, m_r);  l = l_l e^(m_l - m) + l_r e^(m_r - m)
        out = (acc_l e^(m_l - m) + acc_r e^(m_r - m)) / l

    which is the row softmax over all edges (JAX ``_halo_gat_forward``).
    A row block with no local edge holds only an empty cover tile, where
    K3 leaves m at the running-max start and l = 0. Returns (out [nl, H,
    F], merged (m, l) [nl, H])."""
    nl, H = B.n_rows, s1.shape[1]
    o_l, m_l, l_l = flash_gat_forward(B, s1, s2, Wh, alpha=alpha, return_stats=True)
    m_l, l_l = m_l[:nl], l_l[:nl]
    acc_l = o_l * l_l[..., None]  # the local partial result, un-normalized
    rows, cols = rows_rem.long(), cols_halo.long()
    mask = mask_rem[:, None]  # one adjacency mask for every head
    e = s1.index_select(0, rows) + s2h.index_select(0, cols)
    e = torch.where(mask, torch.maximum(e, alpha * e), _MASKED)
    m_r = torch.full((nl, H), float("-inf"), dtype=e.dtype, device=e.device).scatter_reduce(
        0, rows[:, None].expand_as(e), e, reduce="amax")
    m_r = torch.clamp(m_r, min=_M_INIT)  # rows without a remote edge
    ex = torch.where(mask, torch.exp(e - m_r.index_select(0, rows)), 0.0)
    seg = lambda x: torch.zeros((nl, *x.shape[1:]), dtype=x.dtype, device=x.device).index_add_(0, rows, x)
    l_r = seg(ex)
    acc_r = seg(halo.index_select(0, cols).float() * ex[..., None])
    m = torch.maximum(m_l, m_r)
    c_l, c_r = torch.exp(m_l - m), torch.exp(m_r - m)
    l = l_l * c_l + l_r * c_r
    num = acc_l * c_l[..., None] + acc_r * c_r[..., None]
    out = torch.where(l[..., None] > 0, num / torch.clamp(l, min=1e-30)[..., None], 0.0)
    return out, m, l


class _HaloFlash(torch.autograd.Function):
    """``_halo_gat_forward`` with its merged stats; the backward recomputes
    the local tiles' probabilities from the MERGED ``(m, l)`` (padded to
    the tile grid with (0, 1)): K4, the remote edges' row terms, then K5
    with ``t`` summed over local AND remote edges (JAX ``_halo_agg_bwd``)."""

    @staticmethod
    def forward(ctx, B, alpha, rows_rem, cols_halo, mask_rem, s1, s2, s2h, Wh, halo):
        out, m, l = _halo_gat_forward(B, s1, s2, s2h, Wh, halo, rows_rem, cols_halo, mask_rem, alpha)
        ctx.B, ctx.alpha = B, alpha
        ctx.save_for_backward(rows_rem, cols_halo, mask_rem, s1, s2, s2h, Wh, halo, m, l)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gO):
        rows_rem, cols_halo, mask_rem, s1, s2, s2h, Wh, halo, m, l = ctx.saved_tensors
        B, alpha = ctx.B, ctx.alpha
        nl, tb, n_rt = B.n_rows, B.tb, B.n_row_tiles
        gO = gO.reshape(gO.shape[0], *Wh.shape[1:])
        m_p = m.new_zeros((n_rt * tb, m.shape[1]))
        l_p = l.new_ones((n_rt * tb, l.shape[1]))
        m_p[:nl], l_p[:nl] = m, l
        ops = bwd_operands(B, s1, s2, Wh, gO, m_p, l_p)
        t, u1, u2 = (x[:nl] for x in flash_gat_bwd_row(B, **ops, alpha=alpha))
        edge, t_r, u1_r, u2_r = _edge_row_terms(
            rows_rem.long(), cols_halo.long(), mask_rem[:, None], s1, s2h, halo, gO, m, l, alpha, nl)
        t = t + t_r
        ds1 = (u1 + u1_r) - t * (u2 + u2_r)
        dWh, ds2 = flash_gat_bwd_col(B, **ops, t=_grid(t, n_rt, tb), alpha=alpha)
        del ops
        ds2h, d_halo = _rest_fan_in(edge, gO, t, halo.shape[0])
        return (None,) * 5 + (ds1[: s1.shape[0]], ds2[: s2.shape[0]], ds2h,
                              dWh[: Wh.shape[0]].to(Wh.dtype), d_halo.to(halo.dtype))


def flash_gat_halo_agg(
    B: BSRMatrix, s1, s2, s2h, Wh, halo, rows_rem, cols_halo, mask_rem, alpha: float = 0.2,
    edges_sorted: bool = False,
):
    """One shard's GAT aggregation over its local tiles ``B`` plus its halo
    edges (``rows_rem`` local rows, ``cols_halo`` slots of ``halo``,
    ``mask_rem`` the edges that take part), differentiable (JAX
    ``flash_gat_halo_agg``): K3 forward with the softmax stats merged over
    both edge populations, K4 and K5 backward under the merged stats. All
    heads in one launch a pass: ``s1``/``s2`` [n, H], ``s2h`` [HL, H],
    ``Wh`` [n, H, F], ``halo`` [HL, H, F]; 1-D scores with 2-D ``Wh`` /
    ``halo`` are the single-head call. No collective: ``halo`` is an
    ordinary input, so the cotangent reaches the owning shards through
    the mesh's all_to_all. Gradients flow to s1, s2, s2h, Wh and halo.
    ``edges_sorted`` is accepted for the JAX signature; the scatter-adds
    here do not use it."""
    squeeze = s1.dim() == 1
    s1, s2, Wh, _ = _norm_heads(s1, s2, Wh)
    if squeeze:
        s2h, halo = s2h[:, None], halo[:, None, :]
    args = (B, alpha, rows_rem, cols_halo, mask_rem, s1, s2, s2h, Wh, halo)
    if _needs_grad(s1, s2, s2h, Wh, halo):
        out = _HaloFlash.apply(*args)
    else:
        out = _halo_gat_forward(B, s1, s2, s2h, Wh, halo, rows_rem, cols_halo, mask_rem, alpha)[0]
    return out[:, 0, :] if squeeze else out
