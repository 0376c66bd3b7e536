"""GCN and GAT layers as ``torch.nn`` modules.

``GCNConv`` computes ``ReLU?(A_hat @ (X @ W))``; ``GATConv`` the multi-head
attention aggregation. Weights are stored ``[in, out]`` as in the JAX
package, so converted parameters load as they are. The quantized datapath
(``quant``, ``go_quant``) and the amax telemetry of the JAX layers are not
ported yet (ROADMAP queue 1, item 13) and raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.ops.dispatch import PreparedAdjacency, agg_matmul
from sgracex1_tpu_torch.ops.flash_gat import (
    gat_attention_agg_fused,
    gat_attention_agg_hybrid,
)
from sgracex1_tpu_torch.ops.fused_gnn import relu_hw
from sgracex1_tpu_torch.ops.sddmm import edge_softmax, leaky_relu
from sgracex1_tpu_torch.ops.spmm import _edges, spmm


def _agg(A, H: torch.Tensor) -> torch.Tensor:
    """A @ H for a PreparedAdjacency or a SparseMatrix."""
    if isinstance(A, PreparedAdjacency):
        return agg_matmul(A, H)
    if isinstance(A, SparseMatrix):
        return spmm(A, H)
    raise TypeError(f"adjacency must be PreparedAdjacency or SparseMatrix, got {type(A)}")


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


class GCNConv(nn.Module):
    """GCN convolution ``ReLU?(A_hat @ (X @ W))`` on the float datapath."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        use_bias: bool = False,
        quant=None,
        go_quant=None,
        telemetry: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if quant is not None or go_quant is not None or telemetry:
            raise NotImplementedError(
                "quantized GCNConv (quant, go_quant) and amax telemetry are "
                "not ported yet (ROADMAP queue 1, item 13)"
            )
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        _xavier_uniform_(self.weight, generator=generator)

    def forward(self, A, x: torch.Tensor, *, relu: bool = False) -> torch.Tensor:
        out = _agg(A, torch.matmul(x, self.weight))
        if self.bias is not None:
            out = out + self.bias
        return relu_hw(out) if relu else out


class GATConv(nn.Module):
    """GAT convolution: ``nheads`` attention heads over the adjacency's
    edges, concatenated. ``weight`` is ``[in, F*H]`` and ``attention``
    ``[2*F*H, 1]`` (source halves, then destination halves), both Xavier
    uniform with gain 1.414, as the JAX ``GATConv``.

    On a ``PreparedAdjacency`` with flash tiles the aggregation runs the
    flash kernels (K6 on the hybrid split, K3 on full-cover tiles); on a
    ``SparseMatrix`` (or a prep without flash tiles) it runs the edge path.
    Forward only so far. ``quant`` and ``exact_gradients=True`` are not
    ported yet and raise."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        nheads: int = 1,
        alpha: float = 0.2,
        quant=None,
        exact_gradients: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if quant is not None:
            raise NotImplementedError(
                "quantized GATConv (quant) is not ported yet (ROADMAP queue 1, item 13)"
            )
        if exact_gradients:
            raise NotImplementedError(
                "GATConv(exact_gradients=True) needs the GAT backward, not "
                "ported yet (ROADMAP queue 1, item 9)"
            )
        self.in_features = in_features
        self.out_features = out_features
        self.nheads = nheads
        self.alpha = alpha
        F, H = out_features, nheads
        self.weight = nn.Parameter(torch.empty(in_features, F * H))
        self.attention = nn.Parameter(torch.empty(2 * F * H, 1))
        _xavier_uniform_(self.weight, generator=generator)
        _xavier_uniform_(self.attention, generator=generator)

    def forward(
        self, A, x: torch.Tensor, *, relu: bool = False,
        return_attention: bool = False,
    ):
        F, H = self.out_features, self.nheads
        Wh = torch.matmul(x, self.weight)  # [N, F*H]
        # per-head score halves S1 = Wh_h . a_src_h, S2 = Wh_h . a_dst_h, all
        # heads in one product with the block-diagonal [F*H, 2H] matrix
        a = self.attention.view(2, H, F, 1)
        S = torch.matmul(Wh, torch.cat([torch.block_diag(*a[0]), torch.block_diag(*a[1])], dim=1))
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
