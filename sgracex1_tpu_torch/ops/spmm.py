"""Sparse x dense products on the edge list: gather + scatter-add.

The always-correct spec of every aggregation backend (the ``xla`` kind),
as ``sgracex1_tpu.ops.spmm``: padding entries carry value 0 and add
nothing. ``A``'s arrays may be numpy (moved to H's device per call) or
torch tensors (``SparseMatrix.to``).
"""

from __future__ import annotations

import torch

from sgracex1_tpu_torch.graph.csr import SparseMatrix


def _edges(A: SparseMatrix, device):
    t = lambda x: torch.as_tensor(x, device=device)
    return t(A.rows), t(A.cols), t(A.vals)


def spmm(
    A: SparseMatrix, H: torch.Tensor, *, accum_dtype=torch.float32
) -> torch.Tensor:
    """out[i, :] = sum_j A[i, j] * H[j, :] (A @ H), accumulated in
    ``accum_dtype`` and returned in H's dtype."""
    out = torch.zeros(
        (A.n_rows, H.shape[1]), dtype=accum_dtype, device=H.device
    )
    return spmm_into(A, H, out, accum_dtype=accum_dtype).to(H.dtype)


def spmm_into(
    A: SparseMatrix, H: torch.Tensor, out: torch.Tensor, *,
    accum_dtype=torch.float32,
) -> torch.Tensor:
    """``out + A @ H``, scatter-added in ``accum_dtype`` and returned in
    out's dtype (in place when out already has ``accum_dtype``)."""
    rows, cols, vals = _edges(A, H.device)
    weighted = H.index_select(0, cols).to(accum_dtype) * vals.to(accum_dtype)[:, None]
    return out.to(accum_dtype).index_add_(0, rows, weighted).to(out.dtype)


def spmm_t(
    A: SparseMatrix, H: torch.Tensor, *, accum_dtype=torch.float32
) -> torch.Tensor:
    """out = A.T @ H without materializing the transpose."""
    return spmm(A.transpose(), H, accum_dtype=accum_dtype)


def spmm_dense_rhs(
    A: SparseMatrix, X_dense: torch.Tensor, W: torch.Tensor, *, accum_dtype=torch.float32
) -> torch.Tensor:
    """``A @ (X_dense @ W)``, the reference's dense-feature call: the
    matmul accumulates in ``accum_dtype`` and rounds to X's dtype before
    the aggregation."""
    H = torch.matmul(X_dense.to(accum_dtype), W.to(accum_dtype)).to(X_dense.dtype)
    return spmm(A, H, accum_dtype=accum_dtype)


def spmv(A: SparseMatrix, x: torch.Tensor) -> torch.Tensor:
    """Sparse matrix-vector product ``A @ x``."""
    return spmm(A, x[:, None])[:, 0]
