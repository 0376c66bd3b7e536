"""Drive the PyTorch port's GCN serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (so the run exits non-zero):

1. device: require CUDA; print the card's name and power limit
   (nvidia-smi), torch and CUDA versions; TF32 off.
2. build: compile the hand-written kernels (sgracex1_tpu_torch/csrc/*.cu)
   with nvcc for sm_90a.
3. kernels against their plain PyTorch versions on the card: K1
   (bsr_spmm) and K2 (bsr_spmm_fused) in the three tile forms, rank-1 and
   value mode, with and without a remainder, ragged n and P, f32 and bf16
   H; a small GCN forward against the f32 edge path.
4. the slice: 2^20-node power-law graph (avg degree 16, 100 features, 16
   classes, seed 0), sym_norm, degree order, hybrid prepare; both kernels
   timed against their plain versions at the slice's shapes; then a
   2-layer width-128 GCNModel (random weights from a numpy seed) answers 3
   forward requests through K2 and one through K1 (fuse=False view of the
   same prep), with launch counts, times, peak memory, and the logits held
   against a forward whose aggregations run the plain K2 on the card.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from sgracex1_tpu_torch import GCNModel, agg_matmul, prepare_adjacency, sym_norm
from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.graph.datasets import powerlaw_node_classification
from sgracex1_tpu_torch.graph.reorder import degree_order, permute_graph
from sgracex1_tpu_torch.ops import _cuda
from sgracex1_tpu_torch.ops import bsr as K1
from sgracex1_tpu_torch.ops import fused_agg as K2
from sgracex1_tpu_torch.ops.dispatch import split_by_tile_density

SLICE = dict(n=1 << 20, avg_degree=16, num_features=100, num_classes=16, seed=0)
HIDDEN = 128
REQUESTS = 3
K2_TOL = 2e-2  # both write bf16
K1_TOL = 1e-3  # identical bf16 operands, f32 sums in another order


def _log(msg: str) -> None:
    print(msg, flush=True)


def _cuda_ms(fn, reps: int = 10) -> float:
    """Median device milliseconds of ``fn`` over ``reps`` CUDA-event-timed
    calls, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _check(name: str, out, ref, tol: float) -> float:
    """Hold ``out`` against ``ref`` at rtol = atol = tol; max abs error."""
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: shape {tuple(out.shape)} vs {tuple(ref.shape)} or non-finite")
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol, msg=lambda m: f"{name}: {m}")
    return float((out.float() - ref.float()).abs().max())


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _log(smi)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log("allow_tf32: matmul=False cudnn=False")


def phase_build():
    t0 = time.perf_counter()
    _cuda.library()
    _log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_cuda.build_seconds:.1f} s)")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            _log("  " + line.strip())


def _random_graph(n, weighted, seed):
    """Random edges plus dense hub rows/cols: tiles past the threshold and
    a sparse remainder."""
    rng = np.random.default_rng(seed)
    h = np.stack([rng.integers(0, 200, 20 * n), rng.integers(0, n, 20 * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 4 * n)), h, h[::-1]], axis=1), axis=1)
    if not weighted:
        return sym_norm(ei, n)
    v = rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32)
    return SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))


def phase_kernels_small(device):
    """K1 and K2 against their plain versions over the forms and modes."""
    cases = [
        # name, n, P, weighted, method, tb, rest_thresh, H dtype
        ("int8-rank1-hybrid-ragged", 3001, 100, False, "hybrid", 128, 24, torch.float32),
        ("int8-rank1-hybrid-bf16H", 3001, 128, False, "hybrid", 256, 100, torch.bfloat16),
        ("packed-rank1-hybrid", 20000, 72, False, "hybrid", 1024, 250, torch.float32),
        ("bf16-values-hybrid", 2500, 128, True, "hybrid", 128, 24, torch.float32),
        ("int8-rank1-bsr", 4100, 40, False, "bsr", 128, None, torch.float32),
        ("bf16-values-bsr-P200", 2100, 200, True, "bsr", 256, None, torch.float32),
    ]
    gen = torch.Generator(device=device).manual_seed(0)
    for i, (name, n, P, weighted, method, tb, thr, hdt) in enumerate(cases):
        A = _random_graph(n, weighted, seed=i)
        prep = prepare_adjacency(
            A, method=method, tb=tb, rest_thresh=thr, build_transpose=False,
            device=device,
        )
        H = torch.randn(n, P, generator=gen, device=device).to(hdt)
        e2 = _check(f"K2 {name}", K2.bsr_spmm_fused(prep.fused, H),
                    K2.bsr_spmm_fused_plain(prep.fused, H), K2_TOL)
        e1 = _check(f"K1 {name}", K1.bsr_spmm(prep.bsr, H), K1.bsr_spmm_plain(prep.bsr, H), K1_TOL)
        rest = prep.rest.nnz if prep.rest is not None else 0
        _log(f"  {name}: T={prep.bsr.num_tiles} tiles {tuple(prep.bsr.tiles.shape[1:])} "
             f"{prep.bsr.tiles.dtype} rest={rest} chunks={prep.fused.num_rest_chunks} "
             f"segments={prep.fused.segments.n_seg} split_runs={prep.fused.segments.n_fin} "
             f"K2 err {e2:.3g} K1 err {e1:.3g}")

    # f32 value tiles and non-attached chunk steps (kind 1), built directly
    A = _random_graph(2600, True, seed=9)
    part, rest = split_by_tile_density(A, 256, 24)
    B = K1.bsr_from_sparse(part, tb=256, dtype=torch.float32, cover_rows=True,
                           cover_cols=True, device=device)
    plan = K2.build_fused_plan(B, rest, attach_chunks=False)
    assert (plan.step_kind == 1).any()
    H = torch.randn(2600, 64, generator=gen, device=device)
    e2 = _check("K2 f32-values-unattached", K2.bsr_spmm_fused(plan, H),
                K2.bsr_spmm_fused_plain(plan, H), K2_TOL)
    e1 = _check("K1 f32-values", K1.bsr_spmm(B, H), K1.bsr_spmm_plain(B, H), K1_TOL)
    _log(f"  f32-values-unattached: K2 err {e2:.3g} K1 err {e1:.3g}")

    # a small GCN forward through K2 against the f32 edge path
    A = _random_graph(3001, False, seed=11)
    net = GCNModel(32, 64, 7, generator=torch.Generator().manual_seed(0)).to(device).eval()
    x = torch.randn(3001, 32, generator=gen, device=device)
    with torch.no_grad():
        out = net(prepare_adjacency(A, method="hybrid", tb=128, rest_thresh=24,
                                    build_transpose=False, device=device), x)
        ref = net(prepare_adjacency(A, method="xla", device=device), x)
    e = _check("small GCN K2 vs edge path", out, ref, 5e-2)
    _log(f"  small GCN (3001 nodes) K2 route vs f32 edge path: max err {e:.3g}")


def _slice_weights(rng, F, hidden, C):
    """Xavier-uniform (gain 1.414) conv weights [in, out] and a linear head."""
    def xavier(fan_in, fan_out):
        a = 1.414 * np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-a, a, (fan_in, fan_out)).astype(np.float32)

    b = 1.0 / np.sqrt(hidden)
    return {
        "conv1.weight": xavier(F, hidden),
        "conv2.weight": xavier(hidden, hidden),
        "head.weight": rng.uniform(-b, b, (C, hidden)).astype(np.float32),
        "head.bias": rng.uniform(-b, b, C).astype(np.float32),
    }


def phase_slice_prepare(device, cfg=SLICE):
    t0 = time.perf_counter()
    data = powerlaw_node_classification(**cfg)
    A = sym_norm(data.edge_index, data.num_nodes)
    perm = degree_order(A)
    A, _ = permute_graph(A, perm)
    x = data.x[perm]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = prepare_adjacency(A, method="hybrid", build_transpose=False, device=device)
    prep_s = time.perf_counter() - t0
    f = prep.fused
    _log(f"slice graph: n={A.n_rows} nnz={A.nnz} (incl. zero-valued self-loops) "
         f"generate+sym_norm+degree-order {gen_s:.1f} s")
    _log(f"slice prepare: {prep_s:.1f} s kind={prep.kind} tb={prep.bsr.tb} "
         f"tiles={prep.bsr.num_tiles} form={prep.bsr.tiles.dtype}{list(prep.bsr.tiles.shape[1:])} "
         f"rank1={prep.r1_row is not None} rest_edges={prep.rest.nnz if prep.rest is not None else 0} "
         f"rest_chunks={f.num_rest_chunks} K={f.K} steps={f.num_steps} "
         f"segments={f.segments.n_seg} split_runs={f.segments.n_fin}")
    return A, x, prep


def phase_kernels_slice(prep, device):
    """Both kernels at the slice's shapes (P = 128): error and times."""
    gen = torch.Generator(device=device).manual_seed(1)
    H = torch.randn(prep.A.n_cols, HIDDEN, generator=gen, device=device)
    rec = {}
    for name, kern, plain, op, tol in (
        ("bsr_spmm_fused", K2.bsr_spmm_fused, K2.bsr_spmm_fused_plain, prep.fused, K2_TOL),
        ("bsr_spmm", K1.bsr_spmm, K1.bsr_spmm_plain, prep.bsr, K1_TOL),
    ):
        err = _check(f"{name} at slice shapes", kern(op, H), plain(op, H), tol)
        ms = _cuda_ms(lambda: kern(op, H))
        plain_ms = _cuda_ms(lambda: plain(op, H))
        rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        _log(f"{name} at slice shapes [n={prep.A.n_rows}, P={HIDDEN}]: kernel {ms:.4f} ms, "
             f"plain {plain_ms:.4f} ms, max abs err {err:.3g}")
    return rec


def _plain_forward(net, prep, x):
    """The model's forward with every aggregation on the plain K2."""
    h = x
    for i in range(net.num_layers):
        w = getattr(net, f"conv{i + 1}").weight
        h = K2.bsr_spmm_fused_plain(prep.fused, torch.matmul(h, w)).to(h.dtype)
        if i < net.num_layers - 1:
            h = torch.relu(h)
    return net.head(h)


def phase_slice_serve(A, x, prep, device, cfg=SLICE):
    F, C = cfg["num_features"], cfg["num_classes"]
    net = GCNModel(F, HIDDEN, C)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         _slice_weights(np.random.default_rng(0), F, HIDDEN, C).items()})
    net = net.to(device).eval()
    x = torch.from_numpy(x).to(device)
    prep_k1 = dataclasses.replace(prep, fused=None, fused_t=None)  # fuse=False view
    with torch.no_grad():
        net(prep, x)  # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K2.bsr_spmm_fused.launches = 0
        K1.bsr_spmm.launches = 0
        ms, per_request = [], []
        for _ in range(REQUESTS):
            before = K2.bsr_spmm_fused.launches
            t0 = time.perf_counter()
            logits = net(prep, x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            per_request.append(K2.bsr_spmm_fused.launches - before)
        t0 = time.perf_counter()
        logits_k1 = net(prep_k1, x)
        torch.cuda.synchronize()
        k1_ms = (time.perf_counter() - t0) * 1e3
        launches = {"bsr_spmm_fused": K2.bsr_spmm_fused.launches, "bsr_spmm": K1.bsr_spmm.launches}
        peak = torch.cuda.max_memory_allocated()
    _log("slice forwards (K2 route): " + ", ".join(f"{m:.3f}" for m in ms) + " ms")
    _log(f"slice forward (K1 route, fuse=False view): {k1_ms:.3f} ms")
    _log(f"launches in the serving run: {launches} (K2 per request: {per_request})")
    _log(f"peak device memory in the serving run: {peak / 2**30:.3f} GiB")
    if per_request != [2] * REQUESTS:
        raise AssertionError(f"K2 launches per request {per_request}, expected 2 each")
    if launches["bsr_spmm"] != 2:
        raise AssertionError(f"K1 launched {launches['bsr_spmm']} times, expected 2")

    with torch.no_grad():
        H1 = torch.matmul(x, net.conv1.weight)
        agg_ms = _cuda_ms(lambda: agg_matmul(prep, H1))
        ref = _plain_forward(net, prep, x)
    _log(f"slice aggregation (layer-1 input, K2): {agg_ms:.4f} ms, "
         f"{A.nnz / (agg_ms * 1e-3) / 1e6:.1f} M edges/s")
    if logits.shape != (A.n_rows, C):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    e2 = _check("slice logits K2 vs plain-K2 forward", logits, ref, K2_TOL)
    e1 = _check("slice logits K1 route vs plain-K2 forward", logits_k1, ref, K2_TOL)
    _log(f"slice logits: max abs err K2 {e2:.3g}, K1 route {e1:.3g} "
         f"(|logits| max {float(ref.abs().max()):.3g})")
    return launches


def main() -> None:
    phase_device()
    phase_build()
    device = torch.device("cuda")
    phase_kernels_small(device)
    A, x, prep = phase_slice_prepare(device)
    rec = phase_kernels_slice(prep, device)
    launches = phase_slice_serve(A, x, prep, device)
    sources = {
        "bsr_spmm_fused": ("sgracex1_tpu_torch/csrc/fused_agg.cu", "sgracex1_tpu/ops/fused_agg.py:622"),
        "bsr_spmm": ("sgracex1_tpu_torch/csrc/bsr_spmm.cu", "sgracex1_tpu/ops/bsr.py:589"),
    }
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name], **rec[name])
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
