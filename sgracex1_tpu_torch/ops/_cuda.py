"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ctypes. The build runs at first use,
never at import, into ``sgracex1_tpu_torch/_build/`` under a name keyed by
the hash of the sources and flags, so an edited source never loads a
stale library. Pointers and the stream go over as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc output of the last build (register and spill report)
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(_BUILD, f"libsgrace_cuda_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    global build_log, build_seconds
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [_nvcc(), *_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, path)  # atomic against a concurrent build


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sg_bsr_spmm.restype = i
    lib.sg_bsr_spmm.argtypes = [
        p, i, i, i, p, p, p, p,  # tiles, mode, tb, n_seg, seg_rb/lo/hi/part
        i, p, p, p,  # n_fin, fin_rb/p0/np
        p, p, i, i, i, i,  # tile_cb, H, h_bf16, n_cols, P, vec
        p, p, i, p,  # out, partial, n_rows, stream
    ]
    lib.sg_fused_agg.restype = i
    lib.sg_fused_agg.argtypes = [
        p, i, i, i, p, p, p, p,  # tiles, mode, tb, n_seg, seg_rb/lo/hi/part
        i, p, p, p,  # n_fin, fin_rb/p0/np
        p, p, p, p,  # step_cb/tile/chunk/kind
        p, p, p, i,  # lrow, slot_col, slot_scale, K
        p, p,  # colscale, rowscale
        p, i, i, i, i,  # H, h_bf16, n_cols, P, vec
        p, p, i, p,  # out, partial, n_rows, stream
    ]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from the package sources if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
