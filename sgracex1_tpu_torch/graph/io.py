"""Loaders of the reference's on-disk dataset formats, as
``sgracex1_tpu.graph.io``.

- 3-line CSR text: line 1 rowPtr, line 2 colIdx, line 3 values, all
  comma-separated. Some files omit the values line or truncate it; the
  missing values are 1.0.
- Dense text: one comma-separated row per line, row-major; short rows
  are padded with zeros to the widest.

The native parser (``runtime/native``) runs first; the numpy parse below
is the fallback and the spec. Both give the same arrays.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.runtime import native

# the reference's dataset descriptors; the hidden width comes from the
# weights file itself
REFERENCE_DATASETS = {
    "mol": dict(N_adj=2273, M_fea=7, NNZ_adj=5028, NNZ_fea=6819),
    "cora": dict(N_adj=2708, M_fea=1433, NNZ_adj=13264, NNZ_fea=49216),
    "citeseer": dict(N_adj=3327, M_fea=3703, NNZ_adj=12431, NNZ_fea=105165),
    "pubmed": dict(N_adj=19717, M_fea=500, NNZ_adj=108365, NNZ_fea=988031),
}


def _parse_line(line: str, dtype) -> np.ndarray:
    line = line.strip().rstrip(",")
    if not line:
        return np.zeros(0, dtype=dtype)
    return np.array(line.split(","), dtype=dtype)


def load_csr_text(path: str, n_cols: Optional[int] = None, *, pad_to: int = 128) -> SparseMatrix:
    """The 3-line CSR text file as a (host) SparseMatrix; ``n_cols``
    defaults to the largest column index plus one."""
    parsed = native.load_csr_text(path) if os.path.exists(path) else None
    if parsed is not None:
        rowptr, cols, vals = parsed
    else:
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        if len(lines) < 2:
            raise ValueError(f"{path}: expected >=2 lines (rowPtr, colIdx[, values])")
        rowptr = _parse_line(lines[0], np.int64)
        nnz = int(rowptr[-1])
        cols = _parse_line(lines[1], np.int64)[:nnz]
        vals = _parse_line(lines[2], np.float32) if len(lines) >= 3 else np.zeros(0, np.float32)
        vals = np.concatenate([vals[:nnz], np.ones(max(nnz - len(vals), 0), np.float32)])
    if n_cols is None:
        n_cols = int(cols.max()) + 1 if len(cols) else 0
    return SparseMatrix.from_csr_arrays(rowptr, cols, vals, n_cols, pad_to=pad_to)


def load_dense_text(path: str) -> np.ndarray:
    """The dense text file as f32 [rows, widest row]."""
    parsed = native.load_dense_text(path) if os.path.exists(path) else None
    if parsed is not None:
        return parsed
    with open(path) as f:
        rows = [_parse_line(ln, np.float32) for ln in f if ln.strip()]
    out = np.zeros((len(rows), max(len(r) for r in rows)), dtype=np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def reference_data_dir() -> Optional[str]:
    """The reference dataset directory: ``SGRACE_DATA_DIR`` or the repo's
    ``data/matrices``, whichever exists first; None if neither does."""
    for cand in (
        os.environ.get("SGRACE_DATA_DIR"),
        os.path.join(os.path.dirname(__file__), "..", "..", "data", "matrices"),
    ):
        if cand and os.path.isdir(cand):
            return cand
    return None


def load_reference_dataset(
    name: str, data_dir: Optional[str] = None, *, pad_to: int = 128
) -> Tuple[SparseMatrix, SparseMatrix, np.ndarray]:
    """(adjacency N x N, features N x M, weights M x P) of a reference
    dataset: ``{name}_adj.txt`` and ``{name}_feat.txt`` (CSR text) and
    ``{name}_weights.txt`` (dense text) in ``data_dir``. Where the feature
    file is missing, binary features of the descriptor's shape and nonzero
    count are drawn from ``default_rng(0)``, as the JAX package does."""
    data_dir = data_dir or reference_data_dir()
    if data_dir is None:
        raise FileNotFoundError("reference dataset directory not found; set SGRACE_DATA_DIR")
    desc = REFERENCE_DATASETS[name]
    adj = load_csr_text(os.path.join(data_dir, f"{name}_adj.txt"), desc["N_adj"], pad_to=pad_to)
    feat_path = os.path.join(data_dir, f"{name}_feat.txt")
    if os.path.exists(feat_path):
        fea = load_csr_text(feat_path, desc["M_fea"], pad_to=pad_to)
    else:
        rng = np.random.default_rng(0)
        n, m, nnz = desc["N_adj"], desc["M_fea"], desc["NNZ_fea"]
        rows = rng.integers(0, n, nnz)
        cols = rng.integers(0, m, nnz)
        fea = SparseMatrix.from_coo(rows, cols, np.ones(nnz, np.float32), (n, m), pad_to=pad_to)
    w = load_dense_text(os.path.join(data_dir, f"{name}_weights.txt"))
    return adj, fea, w
