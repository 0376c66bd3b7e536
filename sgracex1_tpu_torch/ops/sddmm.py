"""SDDMM edge scores and the edge-masked softmax (GAT attention on the edge
list), as ``sgracex1_tpu.ops.sddmm``.

Scores exist only on edges: ``e[k] = s1[row_k] + s2[col_k]``, then a
softmax over each row's edges. Entries whose adjacency value is ``<= 0``
are masked out (the reference's ``adj_d > 0`` mask), which includes the
fill-0 self-loops and the padding. Logits may carry heads as a trailing
dimension (``[E_pad, H]``); one segment pass serves all heads.
"""

from __future__ import annotations

from typing import Optional

import torch

from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.ops.spmm import _edges

_NEG_INF = -9e15  # the reference's mask value


def sddmm(
    A: SparseMatrix, Wh: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor
) -> torch.Tensor:
    """Per-edge logits ``e[k] = (Wh @ a_src)[row_k] + (Wh @ a_dst)[col_k]``."""
    rows, cols, _ = _edges(A, Wh.device)
    s1 = torch.matmul(Wh.float(), a_src.float())
    s2 = torch.matmul(Wh.float(), a_dst.float())
    return s1.index_select(0, rows.long()) + s2.index_select(0, cols.long())


def leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * x)


def edge_softmax(
    A: SparseMatrix, logits: torch.Tensor, *, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Softmax of per-edge logits ``[E_pad]`` or ``[E_pad, H]`` within each
    row. ``mask`` (bool ``[E_pad]``) marks the edges that take part;
    default ``A.vals > 0``."""
    rows, _, vals = _edges(A, logits.device)
    rows = rows.long()
    if mask is None:
        mask = vals > 0
    if logits.dim() == 2 and mask.dim() == 1:
        mask = mask[:, None]
    masked = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    idx = rows.view(-1, *([1] * (logits.dim() - 1))).expand_as(logits)
    row_max = torch.full(
        (A.n_rows, *logits.shape[1:]), float("-inf"), dtype=logits.dtype,
        device=logits.device,
    ).scatter_reduce(0, idx, masked, reduce="amax")
    # rows with no entries at all keep -inf: guard the subtraction
    row_max = torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))
    ex = torch.where(
        mask, torch.exp(masked - row_max.index_select(0, rows)),
        torch.zeros_like(masked),
    )
    denom = torch.zeros_like(row_max).index_add_(0, rows, ex)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    return ex / denom.index_select(0, rows)
