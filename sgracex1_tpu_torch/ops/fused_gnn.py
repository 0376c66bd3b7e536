"""The two-stage GNN layer ``D = ReLU?(A @ (X @ W))``, its variant with a
quantized backward, and the edge-list GAT op and layer (as
``sgracex1_tpu.ops.fused_gnn``)."""

from __future__ import annotations

import torch

from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.ops.sddmm import edge_softmax, leaky_relu, sddmm
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


def gat_attention(
    A: SparseMatrix, Wh: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, *,
    alpha: float = 0.2, straight_through_scores: bool = True,
) -> tuple:
    """Per-edge GAT attention ``(e, s)``: the LeakyReLU logits and their
    row softmax over the edges with a positive value (the reference's E and
    S read-back buffers). With ``straight_through_scores`` the scores read
    ``Wh`` detached, so gradients reach ``a_src`` / ``a_dst`` but not
    ``Wh`` through the attention weights (the reference's backward)."""
    Wh_s = Wh.detach() if straight_through_scores else Wh
    e = leaky_relu(sddmm(A, Wh_s, a_src, a_dst), alpha)
    return e, edge_softmax(A, e)


def edges_to_dense(A: SparseMatrix, edge_vals: torch.Tensor) -> torch.Tensor:
    """Per-edge values ``[E_pad]`` summed into a dense ``[n_rows, n_cols]``
    matrix, the padding entries zeroed (``A.pad_mask()``)."""
    rows, cols, _ = _edges(A, edge_vals.device)
    keep = torch.as_tensor(A.pad_mask(), device=edge_vals.device)
    vals = torch.where(keep, edge_vals, torch.zeros_like(edge_vals))
    out = torch.zeros((A.n_rows, A.n_cols), dtype=edge_vals.dtype, device=edge_vals.device)
    return out.index_put_((rows.long(), cols.long()), vals, accumulate=True)


def gat_layer(
    A: SparseMatrix, X: torch.Tensor, W: torch.Tensor, attention: torch.Tensor, *,
    alpha: float = 0.2, relu: bool = False, accum_dtype=torch.float32,
) -> torch.Tensor:
    """One-head GAT layer on the edge list: ``Wh = X @ W`` aggregated with
    the attention weights of ``gat_attention``. ``attention`` is the
    reference's ``[2F, 1]`` vector: the first F entries score the source
    (row) node, the last F the destination (column) node."""
    F = W.shape[1]
    a = attention.reshape(-1)
    Wh = torch.matmul(X.to(accum_dtype), W.to(accum_dtype)).to(X.dtype)
    _, s = gat_attention(A, Wh, a[:F], a[F:], alpha=alpha)
    vals = _edges(A, X.device)[2]
    out = spmm(A.with_vals(s.to(vals.dtype)), Wh, accum_dtype=accum_dtype)
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
