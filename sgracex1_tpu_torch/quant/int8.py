"""True-integer int8 inference, as ``sgracex1_tpu.quant.int8``.

Both layer matmuls run int8 x int8 -> int32 with requantization between
the stages; the float fake-quant path (``quant/affine``) only *emulates*
this. The dense products (``X @ W``, the GAT score matvecs) are library
integer matmuls; the aggregations over the quantized adjacency run the
port's kernels: K7 ``ops.bsr.bsr_spmm_int8`` on a full tile cover, K8
``ops.fused_agg.bsr_spmm_int8_fused`` on the hybrid split, K3
``ops.flash_gat.flash_gat_forward`` for the GAT layer on mask tiles.

Convention (the JAX package's): tensors on the unsigned grid (input
features and the adjacency: z = 0, range [0, 2^qbits - 1]) are stored
shifted by -128 into int8, and a product is corrected with

    Uq @ S = (Us + 128) @ S = Us @ S + 128 * colsum(S).

The hidden ``XW`` grid is signed symmetric: negative pre-aggregation
values survive until the ReLU after the aggregation, which is the lower
clamp at 0 of the next requantization. Requantization computes
``round(acc * m)`` in float32 with the multiplier formed in double.

Functions that build tensors take ``device=None``, the card; pass
``device="cpu"`` to stay on the CPU. The forward functions run where
their operands lie.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from sgracex1_tpu_torch._device import resolve_device
from sgracex1_tpu_torch.graph.csr import SparseMatrix, _np
from sgracex1_tpu_torch.ops.bsr import BSRMatrix, bsr_from_sparse, bsr_spmm_int8, bsr_tile_keys
from sgracex1_tpu_torch.ops.flash_gat import flash_gat_forward
from sgracex1_tpu_torch.ops.fused_agg import (
    DEFAULT_K,
    FusedAggPlan,
    bsr_spmm_int8_fused,
    build_fused_plan,
)
from sgracex1_tpu_torch.quant.affine import QuantConstants, _affine
from sgracex1_tpu_torch.quant.calibration import CalibrationTable

_SHIFT = 128  # unsigned-grid -> int8 storage shift


# --------------------------------------------------------------------- quant


def quantize_unsigned_shifted(x: torch.Tensor, c: QuantConstants) -> torch.Tensor:
    """Quantize to the unsigned grid [0, beta_q] (z = 0 for [0, beta] ranges)
    and store shifted into int8."""
    xq = torch.clamp(torch.round(_affine(x, c)), 0, c.beta_q)
    return (xq - _SHIFT).to(torch.int8)


def quantize_signed(x: torch.Tensor, c: QuantConstants) -> torch.Tensor:
    """Quantize to the signed grid [alpha_q, beta_q] as int8."""
    return torch.clamp(torch.round(_affine(x, c)), c.alpha_q, c.beta_q).to(torch.int8)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t.contiguous()
    out = t.new_zeros((rows, cols))
    out[: t.shape[0], : t.shape[1]] = t
    return out


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> exact int32. On the card one
    ``torch._int_mm`` (a library matmul, as the JAX package leaves this
    product to XLA), zero-padded to what cuBLASLt takes: K and N to
    multiples of 8 as the call asks, and M to a multiple of 32 (with M a
    mere multiple of 8, shapes such as 2000 x 104 x 32 are refused on the
    H100). On the CPU an int32 matmul."""
    if a.device.type != "cuda":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    M, K = a.shape
    N = b.shape[1]
    up = lambda v, m: -(-v // m) * m
    out = torch._int_mm(_pad_to(a, up(M, 32), up(K, 8)), _pad_to(b, up(K, 8), up(N, 8)))
    return out[:M, :N]


def matmul_unsigned_x_signed(us: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    """acc = Uq @ Sq where ``us`` stores Uq - 128 (unsigned grid, shifted)
    and ``sq`` is signed int8. Exact int32."""
    corr = _SHIFT * torch.sum(sq, dim=0, dtype=torch.int32)
    return _int8_matmul(us, sq) + corr[None, :]


# ---------------------------------------------------------------- requantize


def requantize_signed(acc: torch.Tensor, multiplier: float, beta_q: int = 127) -> torch.Tensor:
    """int32 accumulator -> signed int8 grid: clamp(round(acc * m))."""
    q = torch.round(acc.to(torch.float32) * float(np.float32(multiplier)))
    return torch.clamp(q, -float(beta_q), float(beta_q)).to(torch.int8)


def requantize_unsigned_shifted(
    acc: torch.Tensor, multiplier: float, beta_q: int = 255
) -> torch.Tensor:
    """int32 accumulator -> unsigned grid (z = 0), stored shifted int8.

    The lower clamp at 0 is the integer-domain ReLU (z = 0)."""
    q = torch.round(acc.to(torch.float32) * float(np.float32(multiplier)))
    q = torch.clamp(q, 0.0, float(beta_q))
    return (q - _SHIFT).to(torch.int8)


def dequantize_acc(acc: torch.Tensor, scale: float) -> torch.Tensor:
    return acc.to(torch.float32) * float(np.float32(scale))


# ------------------------------------------------------------ prepared layer


@dataclasses.dataclass(frozen=True)
class Int8GCNLayer:
    """One GCN layer frozen for integer inference.

    ``wq``: int8 [F_in, F_out] signed weights. ``s_x``/``s_w``/``s_a`` are
    the input / weight / adjacency scales; ``s_h`` is the signed hidden
    (XW) grid scale derived from amax telemetry."""

    wq: torch.Tensor
    s_x: float
    s_w: float
    s_a: float
    s_h: float


def _quantize_weights(W, c_w: QuantConstants) -> np.ndarray:
    return np.clip(
        np.round(_np(W) / c_w.s + c_w.z), c_w.alpha_q, c_w.beta_q
    ).astype(np.int8)


def freeze_gcn_layer(
    W,
    c_x: QuantConstants,
    c_w: QuantConstants,
    c_a: QuantConstants,
    *,
    h_absmax: float,
    device=None,
) -> Int8GCNLayer:
    """Quantize layer weights and derive the hidden-activation grid from an
    observed |XW| amax."""
    s_h = max(float(h_absmax), 1e-8) / 127.0
    wq = torch.from_numpy(_quantize_weights(W, c_w)).to(resolve_device(device))
    return Int8GCNLayer(wq=wq, s_x=c_x.s, s_w=c_w.s, s_a=c_a.s, s_h=s_h)


def _hidden_q(layer, xs: torch.Tensor) -> torch.Tensor:
    """requant(Xq @ Wq): the signed int8 hidden states of a frozen layer."""
    acc1 = matmul_unsigned_x_signed(xs, layer.wq)  # Xq @ Wq, exact int32
    # real(acc1) = s_x * s_w * acc1 -> requantize onto the signed hidden grid
    return requantize_signed(acc1, layer.s_x * layer.s_w / layer.s_h)


def int8_gcn_layer(
    layer: Int8GCNLayer, a_s: torch.Tensor, xs: torch.Tensor
) -> Tuple[torch.Tensor, float]:
    """Full-integer GCN layer on a dense adjacency:
    acc = Aq @ requant(Xq @ Wq).

    ``a_s``: dense adjacency on the unsigned grid, shifted int8 [N, N].
    ``xs``: features on the unsigned grid, shifted int8 [N, F]. Returns
    (int32 accumulator, its dequant scale); the ReLU is the caller's next
    requantization."""
    acc2 = matmul_unsigned_x_signed(a_s, _hidden_q(layer, xs))  # Aq @ Hq
    return acc2, layer.s_a * layer.s_h


def _quantize_vals(v: np.ndarray, c_a: QuantConstants) -> np.ndarray:
    """Edge values on the unsigned grid, as f32 (host)."""
    return np.clip(np.round(v / c_a.s + c_a.z), 0, c_a.beta_q).astype(np.float32)


def dense_adjacency_int8(A_dense, c_a: QuantConstants, *, device=None) -> torch.Tensor:
    """Quantize a dense adjacency onto the unsigned grid, shifted int8."""
    aq = np.clip(np.round(_np(A_dense) / c_a.s + c_a.z), 0, c_a.beta_q)
    return torch.from_numpy((aq - _SHIFT).astype(np.int8)).to(resolve_device(device))


def bsr_int8_from_sparse(
    A: SparseMatrix, c_a: QuantConstants, *, tb: int = 512,
    cover_cols: bool = False, device=None,
) -> BSRMatrix:
    """Quantize a sparse adjacency onto the unsigned grid and densify its
    nonempty tiles as shifted int8, every row block covered. Absent
    positions and whole cover tiles hold -128, the shifted zero, so a cover
    tile adds ``(-128) * colsum + 128 * colsum = 0``. ``A`` is coalesced
    (duplicate edges would sum past 255). Read by K7 ``bsr_spmm_int8``."""
    device = resolve_device(device)
    aq = _quantize_vals(_np(A.vals), c_a)
    return bsr_from_sparse(
        A.with_vals(aq), tb=tb, dtype=torch.int8, cover_rows=True,
        cover_cols=cover_cols, shift=float(_SHIFT), device=device,
    )


def int8_gcn_layer_sparse(
    layer: Int8GCNLayer, a_bsr: BSRMatrix, xs: torch.Tensor
) -> Tuple[torch.Tensor, float]:
    """Full-integer GCN layer on shifted-int8 tiles (K7): no dense N x N."""
    acc2 = bsr_spmm_int8(a_bsr, _hidden_q(layer, xs))[: xs.shape[0]]
    return acc2, layer.s_a * layer.s_h


# --------------------------------------------------------- two-layer network


@dataclasses.dataclass(frozen=True)
class Int8GCN2:
    """The 2-layer GCN frozen for full-integer inference on a dense
    quantized adjacency (small graphs)."""

    layer1: Int8GCNLayer
    layer2: Int8GCNLayer
    a_s: torch.Tensor  # shared quantized adjacency


@dataclasses.dataclass(frozen=True)
class Int8GCN2Sparse:
    """The 2-layer GCN frozen for full-integer inference on shifted-int8
    tiles (``bsr_int8_from_sparse``); the aggregation runs K7."""

    layer1: Int8GCNLayer
    layer2: Int8GCNLayer
    a_bsr: BSRMatrix


def _freeze_layers(W1, W2, cal: CalibrationTable, h1_absmax, x2_absmax, h2_absmax, device):
    c_x2 = QuantConstants(
        s_o=1.0, s=max(float(x2_absmax), 1e-8) / 255.0, z=0, qbits=8,
        signed=False,
    )
    l1 = freeze_gcn_layer(
        W1, cal.features, cal.weights, cal.adjacency, h_absmax=h1_absmax, device=device
    )
    l2 = freeze_gcn_layer(
        W2, c_x2, cal.weights2, cal.adjacency, h_absmax=h2_absmax, device=device
    )
    return l1, l2


def freeze_gcn2(
    W1, W2, A_dense, cal: CalibrationTable, *,
    h1_absmax: float, x2_absmax: float, h2_absmax: float, device=None,
) -> Int8GCN2:
    """Freeze a trained 2-layer GCN (weights, calibration table, activation
    amax telemetry) into the integer inference form.

    ``h1``/``h2_absmax``: observed |X W| amax per layer; ``x2_absmax``:
    observed amax of the layer-1 output (layer 2's input range)."""
    device = resolve_device(device)
    l1, l2 = _freeze_layers(W1, W2, cal, h1_absmax, x2_absmax, h2_absmax, device)
    return Int8GCN2(
        layer1=l1, layer2=l2,
        a_s=dense_adjacency_int8(A_dense, cal.adjacency, device=device),
    )


def freeze_gcn2_sparse(
    W1, W2, A: SparseMatrix, cal: CalibrationTable, *,
    h1_absmax: float, x2_absmax: float, h2_absmax: float, tb: int = 512,
    device=None,
) -> Int8GCN2Sparse:
    """``freeze_gcn2`` with a sparse adjacency quantized into shifted-int8
    tiles instead of a dense N x N matrix."""
    device = resolve_device(device)
    l1, l2 = _freeze_layers(W1, W2, cal, h1_absmax, x2_absmax, h2_absmax, device)
    return Int8GCN2Sparse(
        layer1=l1, layer2=l2,
        a_bsr=bsr_int8_from_sparse(A, cal.adjacency, tb=tb, device=device),
    )


def collect_amax_gcn2(A_dense: np.ndarray, X: np.ndarray, W1: np.ndarray, W2: np.ndarray) -> dict:
    """One float forward pass (numpy) recording the activation ranges
    ``freeze_gcn2`` needs."""
    h1_pre = X @ W1
    h1 = np.maximum(A_dense @ h1_pre, 0.0)
    h2_pre = h1 @ W2
    return dict(
        h1_absmax=float(np.abs(h1_pre).max()),
        x2_absmax=float(h1.max()),
        h2_absmax=float(np.abs(h2_pre).max()),
    )


def collect_amax_gcn2_sparse(A_sp, X: np.ndarray, W1, W2) -> dict:
    """``collect_amax_gcn2`` for a scipy or ``SparseMatrix`` adjacency."""
    mat = A_sp.to_scipy() if hasattr(A_sp, "to_scipy") else A_sp
    return collect_amax_gcn2(mat, X, np.asarray(W1), np.asarray(W2))


def _gcn2_forward(layer_fn, net, adj, xs: torch.Tensor) -> torch.Tensor:
    acc1, scale1 = layer_fn(net.layer1, adj, xs)
    # ReLU and requantization onto layer 2's unsigned input grid in one step
    x2 = requantize_unsigned_shifted(acc1, scale1 / net.layer2.s_x)
    acc2, scale2 = layer_fn(net.layer2, adj, x2)
    return dequantize_acc(acc2, scale2)


def int8_gcn2_forward(net: Int8GCN2, xs: torch.Tensor) -> torch.Tensor:
    """Integer forward through both layers; returns float hidden [N, F2]."""
    return _gcn2_forward(int8_gcn_layer, net, net.a_s, xs)


def int8_gcn2_sparse_forward(net: Int8GCN2Sparse, xs: torch.Tensor) -> torch.Tensor:
    """``int8_gcn2_forward`` on shifted-int8 tiles: K7 twice a request."""
    return _gcn2_forward(int8_gcn_layer_sparse, net, net.a_bsr, xs)


# ------------------------------------------------------------------ int8 GAT


@dataclasses.dataclass(frozen=True)
class Int8GATLayer:
    """GAT layer frozen for integer inference (single head): ``X @ W`` and
    the attention score matvecs in int8, the edge softmax in float, the
    attention-weighted aggregation an exact integer sum carried in f32
    (255-grid attention x int8 hidden stays far below 2^24)."""

    wq: torch.Tensor  # int8 [F_in, F_out]
    aq_src: torch.Tensor  # int8 [F_out]
    aq_dst: torch.Tensor  # int8 [F_out]
    s_x: float
    s_w: float
    s_a: float  # attention vector
    s_h: float
    alpha: float


def freeze_gat_layer(
    W, attention, c_x: QuantConstants, c_w: QuantConstants, *,
    h_absmax: float, alpha: float = 0.2, device=None,
) -> Int8GATLayer:
    """Quantize GAT weights and the [2F, 1] attention vector."""
    device = resolve_device(device)
    W = _np(W)
    F = W.shape[1]
    a = _np(attention).reshape(-1)
    a_absmax = max(float(np.abs(a).max()), 1e-8)
    s_a = a_absmax / 127.0
    aq = np.clip(np.round(a / s_a), -127, 127).astype(np.int8)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return Int8GATLayer(
        wq=t(_quantize_weights(W, c_w)), aq_src=t(aq[:F]), aq_dst=t(aq[F:]),
        s_x=c_x.s, s_w=c_w.s, s_a=s_a,
        s_h=max(float(h_absmax), 1e-8) / 127.0, alpha=alpha,
    )


def _gat_scores(layer: Int8GATLayer, h_q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 score matvecs ``h_q . aq_src`` and ``h_q . aq_dst`` as
    float32 (one integer product for both)."""
    S = _int8_matmul(h_q, torch.stack([layer.aq_src, layer.aq_dst], dim=1)).to(torch.float32)
    return S[:, 0], S[:, 1]


def int8_gat_layer(
    layer: Int8GATLayer,
    rows: torch.Tensor,
    cols: torch.Tensor,
    edge_mask: torch.Tensor,
    n_nodes: int,
    xs: torch.Tensor,
) -> Tuple[torch.Tensor, float]:
    """Full GAT layer with integer matmuls, on the edge list.

    ``rows``/``cols``/``edge_mask``: padded COO edges of the adjacency
    (mask = real edge with positive weight). Returns (int32 accumulator,
    dequant scale)."""
    h_q = _hidden_q(layer, xs)
    s1, s2 = _gat_scores(layer, h_q)
    rows, cols = rows.long(), cols.long()
    sc = float(np.float32(layer.s_h * layer.s_a))
    e = (s1[rows] + s2[cols]) * sc
    e = torch.where(e > 0, e, float(np.float32(layer.alpha)) * e)

    # edge softmax (float); a row whose maximum is not finite reads 0
    masked = torch.where(edge_mask, e, torch.full_like(e, -9e15))
    row_max = torch.full((n_nodes,), -torch.inf, dtype=e.dtype, device=e.device)
    row_max = row_max.scatter_reduce(0, rows, masked, "amax", include_self=True)
    row_max = torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))
    ex = torch.where(edge_mask, torch.exp(masked - row_max[rows]), torch.zeros_like(e))
    denom = torch.zeros(n_nodes, dtype=e.dtype, device=e.device).index_add_(0, rows, ex)
    att = ex / torch.where(denom > 0, denom, torch.ones_like(denom))[rows]

    # attention on the unsigned [0, 255] grid, per edge; the aggregation is
    # an exact integer sum in f32 (each row's att_q sums to ~255)
    att_q = torch.round(att * 255.0)
    contrib = h_q[cols].to(torch.float32) * att_q[:, None]
    acc2 = torch.zeros((n_nodes, h_q.shape[1]), dtype=torch.float32, device=e.device)
    acc2.index_add_(0, rows, contrib)
    return acc2.to(torch.int32), (1.0 / 255.0) * layer.s_h


def int8_gat_layer_flash(
    layer: Int8GATLayer, B: BSRMatrix, xs: torch.Tensor
) -> Tuple[torch.Tensor, float]:
    """``Int8GATLayer`` with the attention aggregation on the flash tile
    kernel K3 instead of the edge list. ``B``: mask tiles of the adjacency
    (``bsr_mask_from_sparse`` / ``bsr_bitmask_from_sparse``). The softmax
    runs in the kernel's float pipeline; the int8-valued hidden states go
    through it in bf16, which holds them exactly. Returns (float32
    accumulator in h_q units, its dequant scale ``s_h``)."""
    h_q = _hidden_q(layer, xs)
    s1, s2 = _gat_scores(layer, h_q)
    sc = float(np.float32(layer.s_h * layer.s_a))
    out = flash_gat_forward(B, s1 * sc, s2 * sc, h_q.to(torch.float32), alpha=layer.alpha)
    return out[: xs.shape[0]], layer.s_h


# ------------------------------------------------- hybrid int8 at scale


def prepare_int8_hybrid(
    A: SparseMatrix, c_a: QuantConstants, *, tb: Optional[int] = None,
    K: int = DEFAULT_K, rest_thresh: Optional[int] = None, costs=None, device=None,
) -> FusedAggPlan:
    """Full-integer aggregation plan for large graphs: the hybrid density
    split with shifted-int8 dense tiles and quantized remainder chunks in
    one fused schedule (K8, ``ops.fused_agg.bsr_spmm_int8_fused``). The
    full-adjacency int8 tile set of ``Int8GCN2Sparse`` grows with the
    square of the node count; the hybrid dense part stays small and the
    remainder rides value-carrying chunks. ``tb`` defaults to the ring
    kernels' ``ops.dispatch.DEFAULT_TB`` (the JAX default, 1024, runs the
    single-stage kernel here); ``rest_thresh`` to the JAX package's
    threshold at ``tb``: one int8 tile's seconds over a chunk slot's, on
    the cost table ``costs`` (default ``ops.dispatch.H100_COSTS``).
    Returns a value-mode ``FusedAggPlan`` whose slot scales are the
    remainder's unsigned-grid values."""
    from sgracex1_tpu_torch.ops import dispatch as D

    device = resolve_device(device)
    tb = D.DEFAULT_TB if tb is None else tb
    costs = D.H100_COSTS if costs is None else costs
    thresh = rest_thresh
    if thresh is None:
        thresh = int(np.ceil(D._tile_cost_s(tb, 1.0, costs) / D._rest_slot_cost_s(tb, costs)))
    part, rest = D.split_by_tile_density(A, tb, thresh)
    B8 = bsr_int8_from_sparse(part, c_a, tb=tb, cover_cols=True, device=device)
    rest_q = None
    if rest.nnz:
        rest_q = rest.with_vals(_quantize_vals(_np(rest.vals), c_a))
    keys = bsr_tile_keys(part, tb, cover_rows=True, cover_cols=True)
    return build_fused_plan(
        B8, rest_q, K=K, tile_keys=keys, attach_chunks=True,
        edge_tiles=int8_edge_tiles(part, c_a, tb, keys),
    )


def int8_edge_tiles(A: SparseMatrix, c_a: QuantConstants, tb: int, keys: np.ndarray) -> np.ndarray:
    """bool [T]: which tiles of ``bsr_int8_from_sparse(A, c_a, tb=tb, ...)``
    (tile keys ``keys``, ``ops.bsr.bsr_tile_keys``) carry an edge, i.e. hold
    a byte other than -128: an edge whose value quantizes above 0 (host).
    The int8 ring K8 multiplies those tiles only (``FusedAggPlan.edge_ring``)."""
    edge = np.zeros(max(len(keys), 1), bool)
    aq = _quantize_vals(_np(A.vals)[: A.nnz], c_a)
    r = _np(A.rows)[: A.nnz][aq > 0].astype(np.int64)
    c = _np(A.cols)[: A.nnz][aq > 0].astype(np.int64)
    if len(keys) and len(r):
        edge[np.searchsorted(keys, (r // tb) << 32 | (c // tb))] = True
    return edge


def int8_hybrid_agg(plan: FusedAggPlan, Hq: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``Aq @ Hq`` on the hybrid full-integer plan (K8)."""
    return bsr_spmm_int8_fused(plan, Hq)
