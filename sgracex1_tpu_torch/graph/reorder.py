"""Node reorderings that give the block-sparse backends dense tiles.

``degree_order`` packs hub edges of a power-law graph into the leading
rows and columns; ``rcm_order`` concentrates a banded graph's edges near
the diagonal. Both return ``perm[new_id] = old_id`` for ``permute_graph``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from sgracex1_tpu_torch.graph.csr import SparseMatrix


def rcm_order(A: SparseMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (scipy), perm[new_id] = old_id."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    r = np.asarray(A.rows[: A.nnz])
    c = np.asarray(A.cols[: A.nnz])
    n = max(A.n_rows, A.n_cols)
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
