"""Sparse matrix container: row-sorted COO zero-padded to a fixed length.

The same layout as ``sgracex1_tpu.graph.csr.SparseMatrix``: padding entries
carry ``val == 0``, ``col == 0`` and ``row == n_rows - 1``, so rows stay
sorted through the padding and padding adds nothing to any product. Host
preprocessing builds numpy arrays; ``to(device)`` moves them into torch
tensors once, explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def unique_sorted(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` of a 1-D array by one sort: numpy 2.3 and later
    take a hash table for a plain ``np.unique``, several times slower than
    the sort on tens of millions of int64 keys."""
    a = np.sort(np.asarray(a).reshape(-1))
    return a[np.concatenate(([True], a[1:] != a[:-1]))] if len(a) else a


def _np(x) -> np.ndarray:
    """Host numpy view of a numpy array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class SparseMatrix:
    """A row-sorted, zero-padded COO sparse matrix.

    Attributes:
      rows: int32[E_pad] row index per nonzero.
      cols: int32[E_pad] column index per nonzero.
      vals: float[E_pad] values; padding entries are exactly 0.
      shape: (n_rows, n_cols).
      nnz: true number of nonzeros (<= E_pad).
      rows_sorted: rows are non-decreasing (the ``from_coo`` default).

    The arrays are numpy on the host or torch tensors after ``to``.
    """

    rows: object
    cols: object
    vals: object
    shape: Tuple[int, int]
    nnz: int
    rows_sorted: bool = False

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def e_pad(self) -> int:
        return int(self.vals.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    @staticmethod
    def from_coo(
        rows, cols, vals, shape: Tuple[int, int], *, pad_to: int = 128,
        sort: bool = True,
    ) -> "SparseMatrix":
        """Build from host COO arrays; sorts by (row, col) and zero-pads."""
        rows = np.asarray(rows, dtype=np.int32)
        cols = np.asarray(cols, dtype=np.int32)
        vals = np.asarray(vals)
        nnz = int(vals.shape[0])
        if sort and nnz:
            order = np.lexsort((cols, rows))
            rows, cols, vals = rows[order], cols[order], vals[order]
        e_pad = max(_round_up(max(nnz, 1), pad_to), pad_to)
        pr = np.full(e_pad, max(0, int(shape[0]) - 1), dtype=np.int32)
        pc = np.zeros(e_pad, dtype=np.int32)
        pv = np.zeros(e_pad, dtype=vals.dtype if vals.size else np.float32)
        pr[:nnz], pc[:nnz], pv[:nnz] = rows, cols, vals
        return SparseMatrix(
            rows=pr, cols=pc, vals=pv,
            shape=(int(shape[0]), int(shape[1])), nnz=nnz,
            rows_sorted=bool(np.all(np.diff(pr) >= 0)),
        )

    @staticmethod
    def from_dense(dense, *, pad_to: int = 128) -> "SparseMatrix":
        dense = _np(dense)
        rows, cols = np.nonzero(dense)
        return SparseMatrix.from_coo(
            rows, cols, dense[rows, cols], dense.shape, pad_to=pad_to
        )

    @staticmethod
    def from_scipy(mat, *, pad_to: int = 128) -> "SparseMatrix":
        coo = mat.tocoo()
        return SparseMatrix.from_coo(
            coo.row, coo.col, coo.data, coo.shape, pad_to=pad_to
        )

    @staticmethod
    def from_csr_arrays(
        rowptr, cols, vals, n_cols: int, *, pad_to: int = 128
    ) -> "SparseMatrix":
        """Build from classic CSR (the reference's on-disk format)."""
        rowptr = np.asarray(rowptr, dtype=np.int64)
        n_rows = len(rowptr) - 1
        rows = np.repeat(np.arange(n_rows, dtype=np.int32), np.diff(rowptr))
        return SparseMatrix.from_coo(
            rows, cols, vals, (n_rows, n_cols), pad_to=pad_to, sort=False
        )

    def to_dense(self) -> np.ndarray:
        """Densify on the host (numpy)."""
        r, c, v = (_np(x)[: self.nnz] for x in (self.rows, self.cols, self.vals))
        out = np.zeros(self.shape, dtype=v.dtype)
        np.add.at(out, (r, c), v)
        return out

    def to_scipy(self):
        import scipy.sparse as sp

        r, c, v = (_np(x)[: self.nnz] for x in (self.rows, self.cols, self.vals))
        return sp.coo_matrix((v, (r, c)), shape=self.shape).tocsr()

    def rowptr(self) -> np.ndarray:
        """Host CSR row pointer of the first ``nnz`` entries."""
        counts = np.bincount(_np(self.rows)[: self.nnz], minlength=self.n_rows)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    def transpose(self) -> "SparseMatrix":
        """Swap rows and cols. The result is not row-sorted."""
        return SparseMatrix(
            rows=self.cols, cols=self.rows, vals=self.vals,
            shape=(self.shape[1], self.shape[0]), nnz=self.nnz,
            rows_sorted=False,
        )

    def with_vals(self, vals) -> "SparseMatrix":
        if tuple(vals.shape) != tuple(self.vals.shape):
            raise ValueError(
                f"vals shape {tuple(vals.shape)} != {tuple(self.vals.shape)}"
            )
        return dataclasses.replace(self, vals=vals)

    def astype(self, dtype) -> "SparseMatrix":
        """The host values cast to the numpy ``dtype``."""
        return dataclasses.replace(self, vals=_np(self.vals).astype(dtype))

    def pad_edges_to(self, e_pad: int) -> "SparseMatrix":
        """Re-pad the host edge arrays to a larger length: row
        ``n_rows - 1``, col 0, val 0, as ``from_coo`` pads."""
        if e_pad < self.e_pad:
            raise ValueError(f"e_pad {e_pad} < {self.e_pad}")
        pad = e_pad - self.e_pad
        if pad == 0:
            return self
        fill = lambda a, v: np.concatenate([_np(a), np.full(pad, v, _np(a).dtype)])
        return dataclasses.replace(
            self, rows=fill(self.rows, max(0, self.n_rows - 1)),
            cols=fill(self.cols, 0), vals=fill(self.vals, 0),
        )

    def with_uniform_nnz(self) -> "SparseMatrix":
        """nnz set to ``e_pad``: the padding counts as edges of value 0,
        which changes no product; ``to_scipy`` / ``pad_mask`` / ``rowptr``
        then see it as real entries."""
        return dataclasses.replace(self, nnz=self.e_pad)

    def pad_mask(self) -> np.ndarray:
        """bool[E_pad]: True for real edges, False for padding."""
        return np.arange(self.e_pad) < self.nnz

    def density(self) -> float:
        return self.nnz / float(self.shape[0] * self.shape[1])

    def to(self, device) -> "SparseMatrix":
        """The same matrix with torch tensors on ``device``."""
        def mv(x):
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(x)
            )
            return t.to(device)

        return dataclasses.replace(
            self, rows=mv(self.rows), cols=mv(self.cols), vals=mv(self.vals)
        )
