"""ctypes binding of the native host library (root ``csrc/sgrace_host.cpp``),
as ``sgracex1_tpu.runtime.native``.

The library parses the reference's text formats and runs the host prepare's
hot loops: the stable COO sort, the GCN symmetric normalization, the
``pallas`` kind's edge-tile plan, RCM and the nnz-balanced row partition.
Every binding has a numpy twin in the package (``graph/io``,
``graph/normalize``, ``graph/reorder``, ``ops/pallas_spmm``): the numpy
versions are the spec, the native ones the fast path, and each wrapper
returns ``None`` where the library is unavailable so its caller takes the
numpy path.

The library is built at first use, never at import, with ``g++ -O3
-std=c++17 -shared -fPIC`` into ``sgracex1_tpu_torch/_build/`` under a name
keyed by the hash of the source and flags: a temporary file renamed
atomically, under a file lock, so concurrent processes (test workers)
build it once. The build never writes next to the source, and no
prebuilt copy is loaded. ``SGRACE_NATIVE=0`` in the environment turns the
library off; ``disabled()`` does so for a block.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "csrc", "sgrace_host.cpp")
_BUILD = os.path.join(_PKG, "_build")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_off = False  # set by disabled()

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_f32 = ctypes.c_float
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def lib_path() -> str:
    """Where the library for the current source and flags is built."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD, f"libsgrace_host_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile into ``path`` unless another process already has: the
    check and the build hold an exclusive lock on ``_build/native.lock``."""
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, path)  # atomic: a reader sees no partial file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    h = ctypes.c_void_p
    lib.sg_csr_load.restype = h
    lib.sg_csr_load.argtypes = [ctypes.c_char_p]
    lib.sg_csr_nrows.restype = _i64
    lib.sg_csr_nrows.argtypes = [h]
    lib.sg_csr_nnz.restype = _i64
    lib.sg_csr_nnz.argtypes = [h]
    lib.sg_csr_copy.restype = None
    lib.sg_csr_copy.argtypes = [h, _p_i64, _p_i32, _p_f32]
    lib.sg_csr_free.restype = None
    lib.sg_csr_free.argtypes = [h]

    lib.sg_dense_load.restype = h
    lib.sg_dense_load.argtypes = [ctypes.c_char_p]
    lib.sg_dense_rows.restype = _i64
    lib.sg_dense_rows.argtypes = [h]
    lib.sg_dense_cols.restype = _i64
    lib.sg_dense_cols.argtypes = [h]
    lib.sg_dense_copy.restype = None
    lib.sg_dense_copy.argtypes = [h, _p_f32]
    lib.sg_dense_free.restype = None
    lib.sg_dense_free.argtypes = [h]

    lib.sg_coo_sort.restype = None
    lib.sg_coo_sort.argtypes = [_i64, _p_i32, _p_i32, _p_i64]

    lib.sg_sym_norm.restype = h
    lib.sg_sym_norm.argtypes = [_i64, _i64, _p_i64, _p_i64, ctypes.c_void_p, _f32]
    lib.sg_sym_nnz.restype = _i64
    lib.sg_sym_nnz.argtypes = [h]
    lib.sg_sym_copy.restype = None
    lib.sg_sym_copy.argtypes = [h, _p_i64, _p_i64, _p_f32]
    lib.sg_sym_free.restype = None
    lib.sg_sym_free.argtypes = [h]

    lib.sg_plan_build.restype = h
    lib.sg_plan_build.argtypes = [_i64, _p_i32, _p_i32, _p_f32, _i32, _i32, _i32]
    lib.sg_plan_num_groups.restype = _i64
    lib.sg_plan_num_groups.argtypes = [h]
    lib.sg_plan_copy.restype = None
    lib.sg_plan_copy.argtypes = [h, _p_i32, _p_i32, _p_f32, _p_i32, _p_i32, _p_i32]
    lib.sg_plan_free.restype = None
    lib.sg_plan_free.argtypes = [h]

    lib.sg_partition_balance.restype = None
    lib.sg_partition_balance.argtypes = [_i64, _p_i64, _i32, _p_i64]

    lib.sg_rcm_order.restype = None
    lib.sg_rcm_order.argtypes = [_i64, _i64, _p_i32, _p_i32, _p_i32]


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built at the first call; None when it is turned off or
    does not build (the reason goes to stderr once)."""
    global _lib, _tried
    if _off or os.environ.get("SGRACE_NATIVE", "1") == "0":
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = lib_path()
            _build(path)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
        except (OSError, subprocess.SubprocessError) as e:
            print(f"sgracex1_tpu_torch native library unavailable: {e}", file=sys.stderr)
        return _lib


def available() -> bool:
    return get_lib() is not None


@contextlib.contextmanager
def disabled():
    """Within the block every wrapper returns None, so callers take their
    numpy path (the spec)."""
    global _off
    saved, _off = _off, True
    try:
        yield
    finally:
        _off = saved


def _index32(x: np.ndarray, bound: int, what: str) -> np.ndarray:
    """``x`` as contiguous int32, each entry checked to lie in [0, bound):
    the library indexes its arrays with these without a check."""
    x = np.asarray(x)
    if x.size and (int(x.min()) < 0 or int(x.max()) >= bound):
        raise ValueError(f"{what} out of range [0, {bound})")
    return np.ascontiguousarray(x, np.int32)


# ------------------------------------------------------------------ wrappers


def load_csr_text(path: str) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(rowptr i64, cols i32, vals f32) of the 3-line CSR text file; None
    when the library is unavailable or the file does not parse."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.sg_csr_load(os.fsencode(path))
    if not h:
        return None
    try:
        n_rows, nnz = lib.sg_csr_nrows(h), lib.sg_csr_nnz(h)
        rowptr = np.empty(n_rows + 1, np.int64)
        cols = np.empty(nnz, np.int32)
        vals = np.empty(nnz, np.float32)
        lib.sg_csr_copy(h, rowptr, cols, vals)
        return rowptr, cols, vals
    finally:
        lib.sg_csr_free(h)


def load_dense_text(path: str) -> Optional[np.ndarray]:
    """The dense text file as f32 [rows, widest row], short rows padded
    with zeros; None when the library is unavailable or the file is
    unreadable."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.sg_dense_load(os.fsencode(path))
    if not h:
        return None
    try:
        r, c = lib.sg_dense_rows(h), lib.sg_dense_cols(h)
        out = np.empty(r * c, np.float32)
        lib.sg_dense_copy(h, out)
        return out.reshape(r, c)
    finally:
        lib.sg_dense_free(h)


def coo_sort_perm(rows: np.ndarray, cols: np.ndarray) -> Optional[np.ndarray]:
    """Stable (row, col) sort permutation, ``np.lexsort((cols, rows))``."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    if rows.shape != cols.shape:
        raise ValueError("rows and cols differ in length")
    perm = np.empty(rows.shape[0], np.int64)
    lib.sg_coo_sort(rows.shape[0], rows, cols, perm)
    return perm


def sym_norm_edges(
    edge_index: np.ndarray, num_nodes: int, edge_weight: Optional[np.ndarray], fill: float,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``graph/normalize.sym_norm_edges``: (edge_index [2, E'] i64 sorted by
    (row, col) with the missing self-loops of weight ``fill``, f32
    weights), or None."""
    lib = get_lib()
    if lib is None:
        return None
    edge_index = np.asarray(edge_index, np.int64)
    if edge_index.size and (int(edge_index.min()) < 0 or int(edge_index.max()) >= num_nodes):
        raise ValueError(f"edge_index out of range [0, {num_nodes})")
    row = np.ascontiguousarray(edge_index[0])
    col = np.ascontiguousarray(edge_index[1])
    w = None
    if edge_weight is not None:
        w = np.ascontiguousarray(edge_weight, np.float32)
        if w.shape != row.shape:
            raise ValueError("edge_weight and edge_index differ in length")
    h = lib.sg_sym_norm(num_nodes, row.shape[0], row, col,
                        None if w is None else w.ctypes.data_as(ctypes.c_void_p), fill)
    if not h:
        return None
    try:
        total = lib.sg_sym_nnz(h)
        ro = np.empty(total, np.int64)
        co = np.empty(total, np.int64)
        wo = np.empty(total, np.float32)
        lib.sg_sym_copy(h, ro, co, wo)
        return np.stack([ro, co]), wo
    finally:
        lib.sg_sym_free(h)


def plan_tiles(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, rb: int, cb: int, be: int,
) -> Optional[Tuple[np.ndarray, ...]]:
    """The ``plan_spmm`` edge-group schedule: (lrow, lcol, val, perm) each
    [G*be] linear, and (tile_rb, tile_cb) each [G]; or None."""
    lib = get_lib()
    if lib is None:
        return None
    if min(rb, cb, be) <= 0:
        raise ValueError(f"rb, cb and be must be positive, got {rb}, {cb}, {be}")
    limit = np.iinfo(np.int32).max
    rows = _index32(rows, limit, "rows")
    cols = _index32(cols, limit, "cols")
    vals = np.ascontiguousarray(vals, np.float32)
    if not rows.shape == cols.shape == vals.shape:
        raise ValueError("rows, cols and vals differ in length")
    h = lib.sg_plan_build(rows.shape[0], rows, cols, vals, rb, cb, be)
    if not h:
        return None
    try:
        g = lib.sg_plan_num_groups(h)
        lrow = np.empty(g * be, np.int32)
        lcol = np.empty(g * be, np.int32)
        val = np.empty(g * be, np.float32)
        perm = np.empty(g * be, np.int32)
        trb = np.empty(g, np.int32)
        tcb = np.empty(g, np.int32)
        lib.sg_plan_copy(h, lrow, lcol, val, perm, trb, tcb)
        return lrow, lcol, val, perm, trb, tcb
    finally:
        lib.sg_plan_free(h)


def rcm_order(n: int, rows: np.ndarray, cols: np.ndarray) -> Optional[np.ndarray]:
    """Reverse Cuthill-McKee over the symmetrized pattern, perm[new] = old
    (int32 [n]); or None."""
    lib = get_lib()
    if lib is None:
        return None
    rows = _index32(rows, n, "rows")
    cols = _index32(cols, n, "cols")
    if rows.shape != cols.shape:
        raise ValueError("rows and cols differ in length")
    perm = np.empty(n, np.int32)
    lib.sg_rcm_order(n, rows.shape[0], rows, cols, perm)
    return perm


def partition_balance(rowptr: np.ndarray, n_parts: int) -> Optional[np.ndarray]:
    """nnz-balanced contiguous row-range bounds [n_parts + 1]; or None."""
    lib = get_lib()
    if lib is None:
        return None
    if n_parts < 1:
        raise ValueError(f"n_parts must be positive, got {n_parts}")
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    bounds = np.empty(n_parts + 1, np.int64)
    lib.sg_partition_balance(rowptr.shape[0] - 1, rowptr, n_parts, bounds)
    return bounds
