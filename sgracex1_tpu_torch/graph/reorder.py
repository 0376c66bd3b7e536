"""Node reorderings that give the block-sparse backends dense tiles.

``degree_order`` packs hub edges of a power-law graph into the leading
rows and columns; ``rcm_order`` concentrates a banded graph's edges near
the diagonal; ``degree_balanced_order`` evens out the edges of contiguous
row shards (``parallel``). All return ``perm[new_id] = old_id`` for
``permute_graph``. ``bandwidth`` and ``shard_edge_counts`` measure a
numbering.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.runtime import native


def rcm_order(A: SparseMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee permutation, perm[new_id] = old_id: the
    native library's where it is available (``runtime/native``, the JAX
    package's fast path, so both packages give the same permutation),
    else scipy's. The two are different valid RCM orders."""
    r = np.asarray(A.rows[: A.nnz])
    c = np.asarray(A.cols[: A.nnz])
    n = max(A.n_rows, A.n_cols)
    perm = native.rcm_order(n, r, c)
    if perm is not None:
        return perm.astype(np.int64)
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m = sp.coo_matrix(
        (np.ones(A.nnz, np.float32), (r, c)), shape=(n, n)
    ).tocsr()
    return np.asarray(
        reverse_cuthill_mckee(m, symmetric_mode=False), dtype=np.int64
    )


def permute_graph(
    A: SparseMatrix, perm: np.ndarray, *, pad_to: int = 128
) -> Tuple[SparseMatrix, np.ndarray]:
    """``(P A P^T, inverse permutation)``. Features are gathered as
    ``x[perm]``; ``out[inv]`` maps new-order rows back to original ids."""
    n = max(A.n_rows, A.n_cols)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    r = inv[np.asarray(A.rows[: A.nnz])]
    c = inv[np.asarray(A.cols[: A.nnz])]
    v = np.asarray(A.vals[: A.nnz])
    return SparseMatrix.from_coo(r, c, v, A.shape, pad_to=pad_to), inv


def degree_order(A: SparseMatrix) -> np.ndarray:
    """Nodes in descending total degree (stable), perm[new_id] = old_id."""
    n = max(A.n_rows, A.n_cols)
    deg = np.zeros(n, np.int64)
    np.add.at(deg, np.asarray(A.rows[: A.nnz]), 1)
    np.add.at(deg, np.asarray(A.cols[: A.nnz]), 1)
    return np.argsort(-deg, kind="stable").astype(np.int64)


def bandwidth(A: SparseMatrix) -> int:
    """Max |row - col| over the nonzeros: the quantity RCM minimizes."""
    r = np.asarray(A.rows[: A.nnz]).astype(np.int64)
    c = np.asarray(A.cols[: A.nnz]).astype(np.int64)
    return int(np.abs(r - c).max()) if A.nnz else 0


def degree_balanced_order(A: SparseMatrix, n_shards: int) -> np.ndarray:
    """Permutation that balances the edge counts of equal-size contiguous
    row shards, perm[new_id] = old_id: longest-processing-time bin packing,
    nodes in descending row degree each to the lightest shard with node
    capacity left (ties to the lower shard id). A power-law graph's
    contiguous split otherwise gives one shard most of the edges, and the
    halo plan pads every shard to the largest."""
    import heapq

    n = max(A.n_rows, A.n_cols)
    deg = np.zeros(n, np.int64)
    np.add.at(deg, np.asarray(A.rows[: A.nnz]), 1)
    by_deg = np.argsort(-deg, kind="stable")
    cap = -(-n // n_shards)
    shards = [[] for _ in range(n_shards)]
    heap = [(0, s) for s in range(n_shards)]  # (edge load, shard)
    heapq.heapify(heap)
    degs = deg.tolist()
    for node in by_deg.tolist():
        load, s = heapq.heappop(heap)
        shards[s].append(node)
        if len(shards[s]) < cap:
            heapq.heappush(heap, (load + degs[node], s))
    return np.concatenate([np.asarray(s, np.int64) for s in shards])


def shard_edge_counts(A: SparseMatrix, n_shards: int) -> np.ndarray:
    """Edges owned by each contiguous row shard of ceil(n / n_shards) rows
    (the imbalance diagnostic)."""
    n = max(A.n_rows, A.n_cols)
    n_local = -(-n // n_shards)
    r = np.asarray(A.rows[: A.nnz]) // n_local
    return np.bincount(r, minlength=n_shards)
