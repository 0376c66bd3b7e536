"""The two-stage GNN layer ``D = ReLU?(A @ (X @ W))``."""

from __future__ import annotations

import torch

from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.ops.spmm import spmm


def relu_hw(x: torch.Tensor) -> torch.Tensor:
    """ReLU whose gradient is masked where the output is zero (g = 0 at
    x = 0), as the reference hardware's backward."""
    return torch.where(x > 0, x, torch.zeros_like(x))


def gnn_layer(
    A: SparseMatrix, X, W: torch.Tensor, *, relu: bool = False,
    accum_dtype=torch.float32,
) -> torch.Tensor:
    """GCN layer ``ReLU?(A @ (X @ W))``. ``X`` is a dense tensor or a
    ``SparseMatrix`` of features (then ``X @ W`` runs on the edge path)."""
    if isinstance(X, SparseMatrix):
        H = spmm(X, W.to(accum_dtype), accum_dtype=accum_dtype)
    else:
        H = torch.matmul(X.to(accum_dtype), W.to(accum_dtype)).to(X.dtype)
    out = spmm(A, H, accum_dtype=accum_dtype)
    return relu_hw(out) if relu else out
