"""GCN adjacency normalization (host side, numpy).

``A_hat = D^{-1/2} (A + fill*I) D^{-1/2}``: add a self-loop with weight
``fill`` to every node that lacks one, then normalize symmetrically by the
row weight sums. ``rank1_factor`` detects the diagonal factorization
``v(r, c) = s_row[r] * s_col[c]`` that lets the block-sparse backends store
tiles as {0,1} masks. Same math and numpy order of operations as
``sgracex1_tpu.graph.normalize``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from sgracex1_tpu_torch.graph.csr import SparseMatrix, unique_sorted
from sgracex1_tpu_torch.runtime import native
from sgracex1_tpu_torch.utils.profiling import span


def add_self_loops(
    edge_index: np.ndarray,
    edge_weight: Optional[np.ndarray],
    num_nodes: int,
    fill: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Add a self-loop of weight ``fill`` to every node that lacks one;
    returns the edges sorted by (row, col)."""
    edge_index = np.asarray(edge_index, dtype=np.int64)
    if edge_weight is None:
        edge_weight = np.ones(edge_index.shape[1], dtype=np.float32)
    edge_weight = np.asarray(edge_weight, dtype=np.float32)

    has_loop = np.zeros(num_nodes, dtype=bool)
    loop_mask = edge_index[0] == edge_index[1]
    has_loop[edge_index[0, loop_mask]] = True
    missing = np.nonzero(~has_loop)[0]

    loops = np.stack([missing, missing]).astype(np.int64)
    loop_w = np.full(len(missing), fill, dtype=np.float32)
    edge_index = np.concatenate([edge_index, loops], axis=1)
    edge_weight = np.concatenate([edge_weight, loop_w])

    order = np.lexsort((edge_index[1], edge_index[0]))
    return edge_index[:, order], edge_weight[order]


def sym_norm_edges(
    edge_index: np.ndarray,
    num_nodes: int,
    edge_weight: Optional[np.ndarray] = None,
    fill: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Edge-list form: ``w'(i,j) = d_i^{-1/2} w(i,j) d_j^{-1/2}`` with
    ``d`` the weight sum per source row (float64, as the reference). The
    native library runs it where it is available (``runtime/native``);
    the numpy below is the spec."""
    fast = native.sym_norm_edges(
        np.asarray(edge_index, dtype=np.int64), num_nodes, edge_weight, fill
    )
    if fast is not None:
        return fast
    edge_index, edge_weight = add_self_loops(
        edge_index, edge_weight, num_nodes, fill
    )
    row, col = edge_index
    deg = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(deg, row, edge_weight)
    with np.errstate(divide="ignore"):
        dis = np.power(deg, -0.5)
    dis[~np.isfinite(dis)] = 0.0
    return edge_index, (dis[row] * edge_weight * dis[col]).astype(np.float32)


def rank1_factor(
    A: SparseMatrix, *, tol: float = 1e-5, iters: Optional[int] = None
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``(s_row, s_col)`` float32 with ``v(r, c) = s_row[r] * s_col[c]`` on
    every positive edge (zero-valued edges are exempt), 1.0 at nodes with
    no positive edge; None when no such factorization holds.

    A degree seed solves sym-normalized unweighted graphs in one pass;
    otherwise ``log s_r + log s_c = log v`` is solved exactly by
    level-vectorized propagation along a spanning forest of the bipartite
    (row, col) graph, at most ``iters`` sweeps, then verified per edge."""
    n_r, n_c = A.n_rows, A.n_cols
    r = np.asarray(A.rows[: A.nnz]).astype(np.int64)
    c = np.asarray(A.cols[: A.nnz]).astype(np.int64)
    v = np.asarray(A.vals[: A.nnz], dtype=np.float64)
    pos = v > 0.0
    if not pos.any() or (v < 0.0).any():
        return None
    r, c, v = r[pos], c[pos], v[pos]
    key = r * n_c + c
    if len(unique_sorted(key)) != len(key):
        return None  # duplicate edges sum in the matrix
    w = np.log(v)
    cnt_r = np.maximum(np.bincount(r, minlength=n_r), 1)

    def _verified(x_r, x_c) -> bool:
        return np.allclose(np.exp(x_r[r] + x_c[c]), v, rtol=tol, atol=0.0)

    if n_r == n_c:
        x0 = -0.5 * np.log(cnt_r.astype(np.float64))
        if _verified(x0, x0):
            s = np.exp(x0)
            s_r = np.where(np.bincount(r, minlength=n_r) == 0, 1.0, s)
            s_c = np.where(np.bincount(c, minlength=n_c) == 0, 1.0, s)
            return s_r.astype(np.float32), s_c.astype(np.float32)

    import scipy.sparse as _sp
    from scipy.sparse.csgraph import connected_components

    nb = n_r + n_c
    src = np.r_[r, c + n_r]
    dst = np.r_[c + n_r, r]
    ww = np.r_[w, w]
    adj = _sp.coo_matrix(
        (np.ones(len(src), np.int8), (src, dst)), shape=(nb, nb)
    ).tocsr()
    _, labels = connected_components(adj, directed=False)
    _, roots = np.unique(labels, return_index=True)
    x = np.zeros(nb)
    seen = np.zeros(nb, bool)
    seen[roots] = True
    max_sweeps = iters if iters is not None else max(64, int(4 * np.sqrt(nb)))
    for _ in range(max_sweeps):
        m = seen[src] & ~seen[dst]
        if not m.any():
            break
        d = dst[m]
        x[d] = ww[m] - x[src[m]]
        seen[d] = True
    else:
        if not seen.all():
            return None
    x_r, x_c = x[:n_r], x[n_r:]
    if not _verified(x_r, x_c):
        return None
    s_r = np.exp(x_r)
    s_c = np.exp(x_c)
    s_r[np.bincount(r, minlength=n_r) == 0] = 1.0
    s_c[np.bincount(c, minlength=n_c) == 0] = 1.0
    return s_r.astype(np.float32), s_c.astype(np.float32)


def sym_norm(
    edge_index: np.ndarray,
    num_nodes: int,
    edge_weight: Optional[np.ndarray] = None,
    fill: float = 0.0,
    *,
    pad_to: int = 128,
) -> SparseMatrix:
    """The normalized adjacency as a (host) SparseMatrix, in a
    ``sym_norm`` span that counts its nodes and edges."""
    with span("sym_norm", n=num_nodes) as s:
        ei, ew = sym_norm_edges(edge_index, num_nodes, edge_weight, fill)
        A = SparseMatrix.from_coo(
            ei[0], ei[1], ew, (num_nodes, num_nodes), pad_to=pad_to, sort=False
        )
        s.set(nnz=A.nnz)
    return A
