"""GCN and GAT layers as ``torch.nn`` modules.

``GCNConv`` computes ``ReLU?(A_hat @ (X @ W))``; ``GATConv`` the multi-head
attention aggregation; both are differentiable on every adjacency form.
Weights are stored ``[in, out]`` as in the JAX package, so converted
parameters load as they are.

``quant`` (a ``LayerQuantParams``) switches a layer to the fake-quant
datapath of the JAX layers: features fake-quantized unsigned, weights (and
the GAT attention vector, with the weights' constants) signed, the
internal fixed-point pipeline after ``X @ W``, the adjacency values
quantized, the output scaled by ``deq_o`` in the forward only. Every
quantizer takes straight-through gradients. With ``telemetry`` set a layer
records ``x_amax``, ``w_absmax`` and ``wh_absmax`` of each forward in
``telemetry_stats`` (``quant/autocal`` reads them).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.ops.dispatch import (
    PreparedAdjacency,
    agg_matmul,
    map_adjacency_vals,
)
from sgracex1_tpu_torch.ops.flash_gat import (
    gat_attention_agg_fused,
    gat_attention_agg_hybrid,
)
from sgracex1_tpu_torch.ops.fused_gnn import gnn_layer_quant_backward, relu_hw
from sgracex1_tpu_torch.ops.sddmm import edge_softmax, leaky_relu
from sgracex1_tpu_torch.ops.spmm import _edges, spmm
from sgracex1_tpu_torch.quant.affine import (
    QuantConstants,
    fake_quant_signed,
    fake_quant_unsigned,
    internal_fixed_point,
    ste,
)
from sgracex1_tpu_torch.quant.calibration import LayerQuantParams


def _agg(A, H: torch.Tensor) -> torch.Tensor:
    """A @ H for a PreparedAdjacency or a SparseMatrix."""
    if isinstance(A, PreparedAdjacency):
        return agg_matmul(A, H)
    if isinstance(A, SparseMatrix):
        return spmm(A, H)
    raise TypeError(f"adjacency must be PreparedAdjacency or SparseMatrix, got {type(A)}")


def _quantize_adj(A, q: LayerQuantParams):
    """The adjacency with its values fake-quantized (fn(0) == 0)."""
    fn = lambda v: fake_quant_unsigned(v, q.adjacency, q.w_qbits)
    if isinstance(A, PreparedAdjacency):
        return map_adjacency_vals(A, fn)
    with torch.no_grad():
        return A.with_vals(fn(torch.as_tensor(A.vals)))


class _AmaxMixin:
    """Range telemetry: with ``telemetry`` set, a forward records the
    |x|, |W| and |XW| maxima (after the layer's own fake quantization of x
    and W, before the internal fixed-point stage) in ``telemetry_stats``,
    the calibration read-back that ``quant/autocal.calibrate`` feeds to
    ``CalibrationTable``."""

    telemetry: bool = False

    def _record_amax(self, x, W, Wh) -> None:
        if not self.telemetry:
            return
        with torch.no_grad():
            self.telemetry_stats = {
                "x_amax": x.abs().max(), "w_absmax": W.abs().max(),
                "wh_absmax": Wh.abs().max(),
            }


def _xavier_uniform_(
    w: torch.Tensor, gain: float = 1.414, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Xavier uniform on an ``[in, out]`` weight with the reference's gain."""
    fan_in, fan_out = w.shape[0], w.shape[-1]
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-a, a, generator=generator)


class ReluHW(nn.Module):
    """Standalone ReLU module (the reference's ``Relu_SGRACE``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu_hw(x)


class GCNConv(nn.Module, _AmaxMixin):
    """GCN convolution ``ReLU?(A_hat @ (X @ W))``; ``quant`` enables the
    fake-quant datapath. ``go_quant`` (the gradient-output constants)
    quantizes the backward's cotangent to its bit width: that path runs
    the edge list and skips the internal fixed-point stage, the adjacency
    quantizer and the output scale, as the JAX layer."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        use_bias: bool = False,
        quant: Optional[LayerQuantParams] = None,
        go_quant: Optional[QuantConstants] = None,
        telemetry: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.quant, self.go_quant, self.telemetry = quant, go_quant, telemetry
        self.telemetry_stats = {}
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        _xavier_uniform_(self.weight, generator=generator)

    def quantize_adjacency(self, A):
        """The adjacency as the forward aggregates over it: its values
        fake-quantized on the fake-quant datapath (not the ``go_quant``
        one), else ``A`` itself. The forward takes the result with
        ``adj_quantized=True``, so a caller maps it once for several
        forwards (the models' ``remat`` recompute)."""
        if self.quant is None or self.go_quant is not None:
            return A
        return _quantize_adj(A, self.quant)

    def forward(
        self, A, x: torch.Tensor, *, relu: bool = False, adj_quantized: bool = False,
    ) -> torch.Tensor:
        W, q = self.weight, self.quant
        if q is not None:
            x = fake_quant_unsigned(x, q.features, q.w_qbits)
            W = fake_quant_signed(W, q.weights, q.w_qbits)
        if self.go_quant is not None:
            A_e = A.A if isinstance(A, PreparedAdjacency) else A
            out = gnn_layer_quant_backward(A_e, x, W, self.go_quant)
            if self.bias is not None:
                out = out + self.bias
            return relu_hw(out) if relu else out
        Wh = torch.matmul(x, W)
        self._record_amax(x, W, Wh)
        if q is not None:
            Wh = internal_fixed_point(Wh, q.scale_fea, q.internal_quantization)
            if not adj_quantized:
                A = _quantize_adj(A, q)
        out = _agg(A, Wh)
        if self.bias is not None:
            out = out + self.bias
        if relu:
            out = relu_hw(out)
        if q is not None:
            out = ste(out, out * q.deq_o)  # the forward is scaled, the gradient is not
        return out


class GATConv(nn.Module, _AmaxMixin):
    """GAT convolution: ``nheads`` attention heads over the adjacency's
    edges, concatenated. ``weight`` is ``[in, F*H]`` and ``attention``
    ``[2*F*H, 1]`` (source halves, then destination halves), both Xavier
    uniform with gain 1.414, as the JAX ``GATConv``.

    On a ``PreparedAdjacency`` with flash tiles the aggregation runs the
    flash kernels (K6 on the hybrid split, K3 on full-cover tiles; K4 and
    K5 in the backward); on a ``SparseMatrix`` (or a prep without flash
    tiles) it runs the edge path under autograd.

    ``exact_gradients=False`` (the default) is the reference's backward:
    the scores read ``Wh`` detached, so ``x`` and ``weight`` get no
    gradient through the attention weights (``attention`` still does).
    ``True`` differentiates through the score product as well. ``quant``
    enables the fake-quant datapath: the attention vector is quantized
    with the weights' constants, the adjacency before its edges are
    read."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        nheads: int = 1,
        alpha: float = 0.2,
        quant: Optional[LayerQuantParams] = None,
        exact_gradients: bool = False,
        telemetry: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.quant, self.telemetry = quant, telemetry
        self.telemetry_stats = {}
        self.exact_gradients = exact_gradients
        self.in_features = in_features
        self.out_features = out_features
        self.nheads = nheads
        self.alpha = alpha
        F, H = out_features, nheads
        self.weight = nn.Parameter(torch.empty(in_features, F * H))
        self.attention = nn.Parameter(torch.empty(2 * F * H, 1))
        _xavier_uniform_(self.weight, generator=generator)
        _xavier_uniform_(self.attention, generator=generator)

    def quantize_adjacency(self, A):
        """The adjacency as the forward reads its edges: its values
        fake-quantized on the fake-quant datapath, else ``A`` itself (see
        ``GCNConv.quantize_adjacency``)."""
        return A if self.quant is None else _quantize_adj(A, self.quant)

    def forward(
        self, A, x: torch.Tensor, *, relu: bool = False,
        return_attention: bool = False, adj_quantized: bool = False,
    ):
        F, H = self.out_features, self.nheads
        W, att, q = self.weight, self.attention, self.quant
        if q is not None:
            x = fake_quant_unsigned(x, q.features, q.w_qbits)
            W = fake_quant_signed(W, q.weights, q.w_qbits)
            att = fake_quant_signed(att, q.weights, q.w_qbits)
            if not adj_quantized:
                A = _quantize_adj(A, q)
        Wh = torch.matmul(x, W)  # [N, F*H]
        self._record_amax(x, W, Wh)
        if q is not None:
            Wh = internal_fixed_point(Wh, q.scale_fea, q.internal_quantization)
        # per-head score halves S1 = Wh_h . a_src_h, S2 = Wh_h . a_dst_h, all
        # heads in one product with the block-diagonal [F*H, 2H] matrix
        a = att.view(2, H, F, 1)
        Wh_s = Wh if self.exact_gradients else Wh.detach()
        S = torch.matmul(Wh_s, torch.cat([torch.block_diag(*a[0]), torch.block_diag(*a[1])], dim=1))
        S1, S2 = S[:, :H].contiguous(), S[:, H:].contiguous()
        Wh = Wh.view(-1, H, F)
        A_e = A.A if isinstance(A, PreparedAdjacency) else A
        if not isinstance(A_e, SparseMatrix):
            raise TypeError(
                f"adjacency must be PreparedAdjacency or SparseMatrix, got {type(A)}"
            )
        flash = A.flash_tiles if isinstance(A, PreparedAdjacency) else None
        if flash is not None and A.gat_plan is not None:
            out = gat_attention_agg_hybrid(
                A.gat_plan, A.gat_rest, S1, S2, Wh, self.alpha,
                A.gat_rest.rows_sorted,
            )
        elif flash is not None:
            out = gat_attention_agg_fused(flash, S1, S2, Wh, self.alpha)
        else:
            rows, cols, _ = _edges(A_e, Wh.device)
            s_all = edge_softmax(A_e, self._logits(A_e, S1, S2))
            out = torch.zeros((A_e.n_rows, H, F), dtype=Wh.dtype, device=Wh.device)
            out.index_add_(0, rows.long(), Wh.index_select(0, cols.long()) * s_all[..., None])
        out = out.reshape(-1, F * H)
        if relu:
            out = relu_hw(out)
        if q is not None:
            out = ste(out, out * q.deq_o)
        if return_attention:
            # per-edge logits and probabilities [H, E_pad]: the reference
            # engine's E / S read-back buffers, from the edge list
            e_all = self._logits(A_e, S1, S2)
            return out, (e_all.T, edge_softmax(A_e, e_all).T)
        return out

    def _logits(self, A_e: SparseMatrix, S1, S2) -> torch.Tensor:
        rows, cols, _ = _edges(A_e, S1.device)
        return leaky_relu(
            S1.index_select(0, rows.long()) + S2.index_select(0, cols.long()),
            self.alpha,
        )
