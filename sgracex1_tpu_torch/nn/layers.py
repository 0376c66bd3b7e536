"""GCN layers as ``torch.nn`` modules.

``GCNConv`` computes ``ReLU?(A_hat @ (X @ W))`` with the weight stored
``[in, out]`` as in the JAX package, so converted parameters load as they
are. The quantized datapath (``quant``, ``go_quant``) and the amax
telemetry of the JAX layers are not ported yet (ROADMAP queue 1, item 12)
and raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.ops.dispatch import PreparedAdjacency, agg_matmul
from sgracex1_tpu_torch.ops.fused_gnn import relu_hw
from sgracex1_tpu_torch.ops.spmm import spmm


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
                "not ported yet (ROADMAP queue 1, item 12)"
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
