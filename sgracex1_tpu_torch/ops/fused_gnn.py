"""The two-stage GNN layer ``D = ReLU?(A @ (X @ W))``, and its variant
with a quantized backward."""

from __future__ import annotations

import torch

from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.ops.spmm import _edges, spmm
from sgracex1_tpu_torch.quant.affine import QuantConstants, dequantize, quantize


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


# the quantized backward: the cotangent rounds to ``go_c.qbits`` bits
# before the two gradient matmuls


class _GnnLayerQuantBackward(torch.autograd.Function):
    """out = A @ (X @ W) on the edge list; the backward contracts the
    quantize -> dequantize round trip of the cotangent:
    ``grad_W = X^T (A^T gq)``, ``grad_X = (A^T gq) W^T``. The edge values
    take no gradient."""

    @staticmethod
    def forward(ctx, n_rows, go_c, rows, cols, vals, X, W):
        ctx.go_c = go_c
        ctx.save_for_backward(rows, cols, vals, X, W)
        H = torch.matmul(X, W)
        out = torch.zeros((n_rows, H.shape[1]), dtype=H.dtype, device=H.device)
        return out.index_add_(0, rows, H.index_select(0, cols) * vals[:, None])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        rows, cols, vals, X, W = ctx.saved_tensors
        gq = dequantize(quantize(g, ctx.go_c), ctx.go_c)
        AtG = torch.zeros((X.shape[0], g.shape[1]), dtype=g.dtype, device=g.device)
        AtG.index_add_(0, cols, gq.index_select(0, rows) * vals[:, None])  # A^T @ gq
        return None, None, None, None, None, torch.matmul(AtG, W.T), torch.matmul(X.T, AtG)


def gnn_layer_quant_backward(
    A: SparseMatrix, X: torch.Tensor, W: torch.Tensor, go_c: QuantConstants, *,
    relu: bool = False,
) -> torch.Tensor:
    """GCN layer whose backward quantizes the output cotangent to
    ``go_c.qbits`` bits before the gradient matmuls (the reference's
    hardware-offloaded backward), as
    ``sgracex1_tpu.ops.fused_gnn.gnn_layer_quant_backward``. Runs on the
    edge list; no kernel."""
    rows, cols, vals = _edges(A, X.device)
    out = _GnnLayerQuantBackward.apply(
        A.n_rows, go_c, rows.long(), cols.long(), vals.to(X.dtype), X, W
    )
    return relu_hw(out) if relu else out
