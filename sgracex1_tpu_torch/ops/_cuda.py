"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` for ``sm_90a``, all started
together, and one more ``nvcc`` links the objects into a shared library
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    tag = f"tmp{os.getpid()}"
    nvcc = _nvcc()
    objs = [
        os.path.join(_BUILD, os.path.basename(src)[:-3] + f".{tag}.o")
        for src in _sources()
    ]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(_sources(), objs)
    ]
    logs, failed = [], False
    for proc in procs:
        out, _ = proc.communicate(timeout=900)
        logs.append(out)
        failed |= proc.returncode != 0
    tmp = f"{path}.{tag}"
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp, *objs],
            capture_output=True, text=True, timeout=300,
        )
        logs.append(link.stdout + link.stderr)
        failed = link.returncode != 0
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    for obj in objs:
        if os.path.exists(obj):
            os.unlink(obj)
    if failed:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed:\n{build_log}")
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
    ring_args = [
        p, i, i, i, i, p, p, p, p,  # tiles, mode, tb, n_tiles, n_seg, seg_rb/lo/hi/part
        i, p, p, p,  # n_fin, fin_rb/p0/np
        p, p, p, p, i,  # step, lrow, slot_col, slot_scale, K
        p, p, i, i,  # rowscale, Hs, hs_rows, P
        p, p, i, i,  # out, partial, n_rows, n_sm
    ]
    lib.sg_bsr_spmm_ring.restype = i
    lib.sg_bsr_spmm_ring.argtypes = ring_args + [p]  # stream
    lib.sg_fused_agg_ring.restype = i
    lib.sg_fused_agg_ring.argtypes = ring_args + [i, i, p]  # slabs a stage, slab depth, stream
    lib.sg_bsr_spmm_cluster.restype = i
    lib.sg_bsr_spmm_cluster.argtypes = [
        p, i, i, i, i, i, p,  # tiles, mode, tb, n_tiles, cluster, n_clusters, cl_start
        p, p, p, p, p,  # item_rb/lo/hi/kind, step
        p, i, i, p, i, p,  # Hs, hs_rows, P, out, n_rows, stream
    ]
    lib.sg_bsr_spmm_cluster_occupancy.restype = i
    lib.sg_bsr_spmm_cluster_occupancy.argtypes = [i, i]  # mode, cluster
    lib.sg_stage_h.restype = i
    lib.sg_stage_h.argtypes = [p, i, i, p, p, i, i, p]  # H, h_bf16, n_valid, colscale, Hs, rows, P, stream
    lib.sg_bsr_spmm_int8.restype = i
    lib.sg_bsr_spmm_int8.argtypes = [
        p, i, i, p, p, p, p,  # tiles, tb, n_seg, seg_rb/lo/hi/part
        i, p, p, p,  # n_fin, fin_rb/p0/np
        p, p, i, i, i, i, i,  # tile_cb, Hq, n_h, n_ct, P, vec, vec4
        p, p, p, i, p,  # colsum, out, partial, n_out, stream
    ]
    lib.sg_fused_agg_int8.restype = i
    lib.sg_fused_agg_int8.argtypes = [
        p, i, i, p, p, p, p,  # tiles, tb, n_seg, seg_rb/lo/hi/part
        i, p, p, p,  # n_fin, fin_rb/p0/np
        p, p, p, p,  # step_cb/tile/chunk/kind
        p, p, p, i,  # lrow, slot_col, slot_scale (edge values), K
        p, i, i, i, i, i,  # Hq, n_h, n_ct, P, vec, vec4
        p, p, p, i, p,  # colsum, out, partial, n_out, stream
    ]
    lib.sg_flash_gat.restype = i
    lib.sg_flash_gat.argtypes = [
        p, i, i, i, p, p, p, p,  # tiles, mode, tb, n_seg, seg_rb/lo/hi/part
        i, p, p, p,  # n_fin, fin_rb/p0/np
        p,  # tile_cb (K3)
        p, p, p, p,  # step_cb/tile/chunk/kind (K6)
        p, p, i,  # lrow, slot_col, K
        p, i,  # pop, sb (K12)
        p, i, p, i,  # s1, n_s1, s2, n_s2
        p, i, i, i, ctypes.c_float,  # Wh (bf16), wvec, H, F, alpha
        p, i, p, p,  # out, n_rows, m_out, l_out
        p, p, p, i, p,  # pm, pl, pacc, flags, stream
    ]
    lib.sg_flash_gat_ring.restype = i
    lib.sg_flash_gat_ring.argtypes = [
        p, i, i, ctypes.c_long, i, p, p, p, p,  # tiles, mode, tb, n_tiles, n_seg, seg_rb/lo/hi/part
        i, p, p, p,  # n_fin, fin_rb/p0/np
        p, p, p, i,  # step, lrow, slot_col, K
        p, i, p, p, i, i, ctypes.c_float,  # s1, n_s1, s2p, Wh (bf16), n_wh, H, alpha
        p, i, p, p,  # out, n_rows, m_out, l_out
        p, p, p, p, i, i, i, p,  # pm, pl, pacc, pop, sb (K12), flags, n_sm, stream
    ]
    lib.sg_subskip_fold.restype = i
    lib.sg_subskip_fold.argtypes = [p, i, p, i, i, p, p]  # step, n_step, pop, tb, sb, out, stream
    lib.sg_flash_gat_bwd_ring.restype = i
    lib.sg_flash_gat_bwd_ring.argtypes = [
        i, p, i, i, ctypes.c_long, i, p, p, p, p,  # col, tiles, mode, tb, n_tiles, n_seg, seg_rb/lo/hi/part
        i, p, p, p,  # n_fin, fin_rb/p0/np
        p, p, p, ctypes.c_long, p,  # step, slab_stat, op (bf16), n_op, res (bf16)
        p, p, p, i, ctypes.c_float, i,  # s_own, m_own, l_own, H, alpha, fast_exp
        p, p, p, p, i, p,  # out, out2, part, part2, n_sm, stream
    ]
    lib.sg_plan_spmm_gather.restype = i
    lib.sg_plan_spmm_gather.argtypes = [
        p, i, p, p, p, p,  # slot_cv, n_seg, seg_row/lo/hi/part
        i, p, p, p,  # n_fin, fin_row/p0/np
        p, i, p, p, p,  # Hs (bf16), P, out, partial, stream
    ]
    plan_args = [
        p, i, p, p, p, p,  # slot_cv, n_seg, seg_row/lo/hi/part
        i, p, p, p,  # n_fin, fin_row/p0/np
    ]
    lib.sg_plan_gat_fwd.restype = i
    lib.sg_plan_gat_fwd.argtypes = plan_args + [
        p, p, p, i, i, ctypes.c_float, i,  # Whs (bf16), s1, s2, H, Fp, alpha, self_loops
        p, p, p, p, p, p, p,  # out, m, l, pacc, pm, pl, stream
    ]
    lib.sg_plan_gat_bwd_rows.restype = i
    lib.sg_plan_gat_bwd_rows.argtypes = plan_args + [
        p, p, p, p, p, p, i, i, ctypes.c_float, i,  # Whs, gOs (bf16), s1, s2, m, l, H, Fp, alpha, self_loops
        p, p, p,  # tuu, ptuu, stream
    ]
    lib.sg_plan_gat_bwd_cols.restype = i
    lib.sg_plan_gat_bwd_cols.argtypes = plan_args + [
        p, p, p, p, i, i, ctypes.c_float, i,  # Whs, gOs (bf16), st, s2, H, Fp, alpha, self_loops
        p, p, p, p, i, p,  # dwh, ds2, pdwh, pds2, stages, stream
    ]
    lib.sg_plan_gat_bwd_cols_occupancy.restype = i
    lib.sg_plan_gat_bwd_cols_occupancy.argtypes = [i, i, i, p]  # H, Fp, stages, out[4]
    lib.sg_stage_hqt.restype = i
    lib.sg_stage_hqt.argtypes = [p, i, i, p, i, p]  # Hq, n_valid, P, HqT, rows, stream
    lib.sg_fused_agg_int8_ring.restype = i
    lib.sg_fused_agg_int8_ring.argtypes = [
        p, i, i, ctypes.c_long, i, p, p, p, p,  # tiles, th, tw, n_pieces, n_seg, seg_rb/lo/hi/part
        i, p, p, p,  # n_fin, fin_rb/p0/np
        p, p, p, p, i,  # step, lrow, slot_col, slot_lv8, K
        p, i, p, i,  # HqT, n_pad, Hq, P
        p, p, i, i, p,  # out, partial, n_rows, n_sm, stream
    ]
    lib.sg_bsr_spmm_rowloop.restype = i
    lib.sg_bsr_spmm_rowloop.argtypes = [
        p, i, i, i, p, p,  # tiles, mode, tb, n_rt, row_start, tile_cb
        p, i, i, i, i,  # H, h_bf16, n_cols, P, vec
        p, i, p,  # out, n_rows, stream
    ]
    lib.sg_fused_agg_k.restype = i
    lib.sg_fused_agg_k.argtypes = [
        p, i, i, i, i, p, p, p, p,  # tiles, mode, tb, k_steps, n_seg, seg_rb/lo/hi/part
        i, p, p, p,  # n_fin, fin_rb/p0/np
        p, p, p, p,  # step_cb/tile/chunk/kind
        p, p, p, i,  # lrow, slot_col, slot_scale, K
        p, p,  # colscale, rowscale
        p, i, i, i, i,  # H, h_bf16, n_cols, P, vec
        p, p, i, p,  # out, partial, n_rows, stream
    ]
    lib.sg_flash_gat_bwd_row.restype = i
    lib.sg_flash_gat_bwd_row.argtypes = [
        p, i, i, i, p, p, p, p,  # tiles, mode, tb, n_seg, seg_rb/lo/hi/part
        i, p, p, p,  # n_fin, fin_rb/p0/np
        p,  # tile_cb
        p, p, p, p,  # s1, s2, m, l
        p, p, i, i, i, ctypes.c_float, i,  # Wh, gO (bf16), wvec, H, F, alpha, fast_exp
        p, i, p, p,  # tuu, n_rows_pad, partial, stream
    ]
    lib.sg_flash_gat_bwd_col.restype = i
    lib.sg_flash_gat_bwd_col.argtypes = [
        p, i, i, i, p, p, p, p,  # tiles, mode, tb, n_seg, seg_cb/lo/hi/part
        i, p, p, p,  # n_fin, fin_cb/p0/np
        p, p,  # col_perm, tile_rb
        p, p, p, p, p,  # s1, s2, m, l, t
        p, p, i, i, i, ctypes.c_float, i,  # Wh, gO (bf16), wvec, H, F, alpha, fast_exp
        p, p, i, p, p, p,  # dwh, ds2, n_cols_pad, pdwh, pds2, stream
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
