"""Drive the PyTorch port's GCN and GAT serving paths once on one NVIDIA GPU.

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
5. the GAT slice on the same graph: for_gat prepare (hybrid attention
   split); K6 (flash_gat_hybrid_forward) on the plan and K3
   (flash_gat_forward) on its tile set timed against their plain versions
   at H=4, F=64; then GATModel(100, 64, 16, nheads=4) (random weights from
   a numpy seed) answers 3 requests through K6, with launch counts, times,
   peak memory, a profiler window, and the logits held against a forward
   whose attention runs the plain K6 on the card.
6. the small GAT path: the n=8192 power-law graph, full-cover flash tiles,
   3 requests through K3, held against the plain K3.

Phase 3 also holds K3 and K6 against their plain versions over the tile
forms, head counts, ragged widths, isolated rows, split runs and chunk
layouts, and a small GATModel through both against the edge path.

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

from sgracex1_tpu_torch import GATModel, GCNModel, agg_matmul, prepare_adjacency, sym_norm
from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.graph.datasets import powerlaw_node_classification
from sgracex1_tpu_torch.graph.reorder import degree_order, permute_graph
from sgracex1_tpu_torch.ops import _cuda
from sgracex1_tpu_torch.ops import bsr as K1
from sgracex1_tpu_torch.ops import fused_agg as K2
from sgracex1_tpu_torch.ops import flash_gat as FG
from sgracex1_tpu_torch.ops.fused_gnn import relu_hw
from sgracex1_tpu_torch.ops.dispatch import _drop_zero_val_edges, split_by_tile_density

SLICE = dict(n=1 << 20, avg_degree=16, num_features=100, num_classes=16, seed=0)
HIDDEN = 128
REQUESTS = 3
K2_TOL = 2e-2  # both write bf16
K1_TOL = 1e-3  # identical bf16 operands, f32 sums in another order
GAT_TOL = 2e-2  # bf16(p) rounds against each CTA segment's running max
GAT_HIDDEN, GAT_HEADS = 64, 4  # examples/ppi_gat.py: 4 heads x 64, then 1 x 64
GAT_SMALL = dict(SLICE, n=8192)


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


def _random_graph(n, weighted, seed, isolated=None):
    """Random edges plus dense hub rows/cols: tiles past the threshold and
    a sparse remainder. With ``isolated``, nodes i % isolated == 3 get no
    edge (sym_norm leaves them only a zero-valued self-loop)."""
    rng = np.random.default_rng(seed)
    h = np.stack([rng.integers(0, 200, 20 * n), rng.integers(0, n, 20 * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 4 * n)), h, h[::-1]], axis=1), axis=1)
    if isolated:
        ei = ei[:, (ei % isolated != 3).all(axis=0)]
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
    _gat_kernels_small(device, gen)


def _scores(n, H, F, gen, device):
    s1 = torch.randn(n, H, generator=gen, device=device) * 2
    s2 = torch.randn(n, H, generator=gen, device=device) * 2
    return s1, s2, torch.randn(n, H, F, generator=gen, device=device)


def _check_flash(name, res, ref) -> float:
    """(out, m, l) of a kernel against its plain version: out and l at
    GAT_TOL, m exactly (the same f32 operations)."""
    err = _check(name, res[0], ref[0], GAT_TOL)
    _check(name + " m", res[1], ref[1], 0.0)
    _check(name + " l", res[2], ref[2], GAT_TOL)
    return err


def _gat_kernels_small(device, gen):
    """K3 and K6 against their plain versions; a small GATModel through
    both against the edge path."""
    k3_cases = [
        # name, n, prepare keywords, H, F, stats
        ("int8-tb128-hub-H4-F64", 3001, dict(method="xla", gat_tb=128), 4, 64, True),
        ("int8-tb256-H1-F40", 3001, dict(method="xla"), 1, 40, False),
        ("packed-tb1024-H4-F16", 5000, dict(method="xla", gat_tb=1024), 4, 16, True),
        ("bf16-values-bsr-H4-F64-ragged", 2100, dict(method="bsr", rank1=False, tb=256), 4, 64, True),
        ("int8-tb256-H4-F8", 4099, dict(method="xla"), 4, 8, True),
        ("int8-tb128-H2-F100-two-feature-slices", 3001, dict(method="xla", gat_tb=128), 2, 100, True),
        ("int8-tb256-H3-F20-unaligned-rows", 3001, dict(method="xla"), 3, 20, False),
    ]
    for i, (name, n, kw, H, F, stats) in enumerate(k3_cases):
        A = _random_graph(n, "values" in name, seed=20 + i, isolated=7)
        prep = prepare_adjacency(A, for_gat=True, build_transpose=False, device=device, **kw)
        B = prep.flash_tiles
        s1, s2, Wh = _scores(n, H, F, gen, device)
        res = FG.flash_gat_forward(B, s1, s2, Wh, return_stats=stats)
        ref = FG.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=stats)
        if stats:
            err = _check_flash(f"K3 {name}", res, ref)
            out = res[0]
        else:
            err = _check(f"K3 {name}", res, ref, GAT_TOL)
            out = res
        has = torch.zeros(n, dtype=torch.bool, device=device)
        has[prep.A.rows[: A.nnz][prep.A.vals[: A.nnz] > 0].long()] = True
        if has.all() or (out[~has] != 0).any():
            raise AssertionError(f"K3 {name}: rows without an edge must come out exactly 0")
        _log(f"  K3 {name}: T={B.num_tiles} tiles {tuple(B.tiles.shape[1:])} {B.tiles.dtype} "
             f"segments={B.segments.n_seg} split_runs={B.segments.n_fin} "
             f"isolated_rows={int((~has).sum())} err {err:.3g}")
        if name.startswith("int8-tb128") and B.segments.n_fin == 0:
            raise AssertionError("the hub case must split a run (merge pass)")

    A = _random_graph(3001, False, seed=30)
    part, rest = split_by_tile_density(A, 128, 40)
    rest = _drop_zero_val_edges(rest)
    B = K1.bsr_mask_from_sparse(part, tb=128, cover_rows=True, cover_cols=True, device=device)
    for attach, H, stats in ((True, 4, True), (False, 4, False), (True, 1, True)):
        plan = K2.build_fused_plan(B, rest, attach_chunks=attach)
        s1, s2, Wh = _scores(3001, H, 64, gen, device)
        name = f"K6 {'attached' if attach else 'unattached'}-H{H}"
        res = FG.flash_gat_hybrid_forward(plan, s1, s2, Wh, return_stats=stats)
        ref = FG.flash_gat_hybrid_forward_plain(plan, s1, s2, Wh, return_stats=stats)
        err = _check_flash(name, res, ref) if stats else _check(name, res, ref, GAT_TOL)
        kinds = sorted(set(plan.step_kind.tolist()))
        _log(f"  {name}: T={B.num_tiles} chunks={plan.num_rest_chunks} kinds={kinds} "
             f"segments={plan.segments.n_seg} split_runs={plan.segments.n_fin} err {err:.3g}")

    A = _random_graph(3001, False, seed=31, isolated=11)
    net = GATModel(32, 16, 7, nheads=4, generator=torch.Generator().manual_seed(0)).to(device).eval()
    x = torch.randn(3001, 32, generator=gen, device=device)
    with torch.no_grad():
        ref = net(prepare_adjacency(A, method="xla", device=device), x)
        for kw, kern in ((dict(), FG.flash_gat_forward),
                         (dict(gat_tb=128, gat_rest_thresh=40), FG.flash_gat_hybrid_forward)):
            before = kern.launches
            out = net(prepare_adjacency(A, method="xla", for_gat=True, device=device, **kw), x)
            if kern.launches != before + 2:
                raise AssertionError(f"small GAT: {kern.__name__} launched {kern.launches - before} times")
            e = _check(f"small GAT {kern.__name__} vs edge path", out, ref, 5e-2)
            _log(f"  small GAT (3001 nodes) {kern.__name__} route vs f32 edge path: max err {e:.3g}")


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


def _slice_graph(cfg):
    """The power-law graph, sym_norm (fill-0 self-loops), degree order."""
    t0 = time.perf_counter()
    data = powerlaw_node_classification(**cfg)
    A = sym_norm(data.edge_index, data.num_nodes)
    perm = degree_order(A)
    A, _ = permute_graph(A, perm)
    return A, data.x[perm], time.perf_counter() - t0


def phase_slice_prepare(device, cfg=SLICE):
    A, x, gen_s = _slice_graph(cfg)
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


def _gat_weights(rng, F, hidden, H, C):
    """Xavier-uniform (gain 1.414) GAT weights [in, out] and attention
    vectors [2*out, 1], and a linear head."""
    def xavier(fan_in, fan_out):
        a = 1.414 * np.sqrt(6.0 / (fan_in + fan_out))
        return torch.from_numpy(rng.uniform(-a, a, (fan_in, fan_out)).astype(np.float32))

    b = 1.0 / np.sqrt(hidden)
    return {
        "conv1.weight": xavier(F, hidden * H),
        "conv1.attention": xavier(2 * hidden * H, 1),
        "conv2.weight": xavier(hidden * H, hidden),
        "conv2.attention": xavier(2 * hidden, 1),
        "head.weight": torch.from_numpy(rng.uniform(-b, b, (C, hidden)).astype(np.float32)),
        "head.bias": torch.from_numpy(rng.uniform(-b, b, C).astype(np.float32)),
    }


def phase_gat_prepare(A, device, label):
    """for_gat prepare (the port's fixed rule) and its layout."""
    t0 = time.perf_counter()
    prep = prepare_adjacency(A, method="xla", for_gat=True, device=device)
    prep_s = time.perf_counter() - t0
    B, plan = prep.flash_tiles, prep.gat_plan
    msg = (f"{label} GAT prepare: {prep_s:.1f} s tb={B.tb} tiles={B.num_tiles} "
           f"form={B.tiles.dtype}{list(B.tiles.shape[1:])}")
    if plan is not None:
        msg += (f" hybrid: rest_edges={prep.gat_rest.nnz} rest_chunks={plan.num_rest_chunks} "
                f"K={plan.K} steps={plan.num_steps} segments={plan.segments.n_seg} "
                f"split_runs={plan.segments.n_fin}")
    else:
        msg += f" full cover: segments={B.segments.n_seg} split_runs={B.segments.n_fin}"
    _log(msg)
    return prep


def phase_gat_kernels_slice(prep, device):
    """K6 on the slice's plan and K3 on its tile set at H=4, F=64: error
    and times against the plain versions."""
    gen = torch.Generator(device=device).manual_seed(2)
    s1, s2, Wh = _scores(prep.A.n_cols, GAT_HEADS, GAT_HIDDEN, gen, device)
    rec = {}
    plan = prep.gat_plan
    for name, kern, plain, op in (
        ("flash_gat_hybrid_forward", FG.flash_gat_hybrid_forward, FG.flash_gat_hybrid_forward_plain, plan),
        ("flash_gat_forward", FG.flash_gat_forward, FG.flash_gat_forward_plain, plan.B),
    ):
        err = _check(f"{name} at slice shapes", kern(op, s1, s2, Wh), plain(op, s1, s2, Wh), GAT_TOL)
        ms = _cuda_ms(lambda: kern(op, s1, s2, Wh))
        plain_ms = _cuda_ms(lambda: plain(op, s1, s2, Wh))
        rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        _log(f"{name} at slice shapes [n={prep.A.n_rows}, H={GAT_HEADS}, F={GAT_HIDDEN}]: "
             f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, max abs err {err:.3g}")
    return rec


def _plain_gat_forward(net, prep, x):
    """The GAT model's forward with its attention on the plain kernel of
    the prep's route (K6 with a hybrid plan, else K3)."""
    h = x
    for conv, relu in ((net.conv1, True), (net.conv2, False)):
        F, H = conv.out_features, conv.nheads
        Wh = torch.matmul(h, conv.weight).view(-1, H, F)
        a = conv.attention.view(-1)
        s1 = torch.einsum("nhf,hf->nh", Wh, a[: F * H].view(H, F))
        s2 = torch.einsum("nhf,hf->nh", Wh, a[F * H:].view(H, F))
        if prep.gat_plan is not None:
            h = FG.flash_gat_hybrid_forward_plain(prep.gat_plan, s1, s2, Wh)
        else:
            h = FG.flash_gat_forward_plain(prep.flash_tiles, s1, s2, Wh)
        h = h.reshape(-1, F * H)
        if relu:
            h = relu_hw(h)
    return net.head(h)


def _profile_forward(fn, label):
    """One forward under torch.profiler: wall ms, device-busy ms (kernel
    intervals on the one stream), idle share, and the kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    _log(f"{label} profiler window (1 forward): wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
         f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        _log(f"  {ms:9.4f} ms  {100 * ms / max(busy, 1e-9):5.1f}%  {name[:110]}")


def phase_gat_serve(A, x, prep, device, kern, label, cfg=SLICE):
    """GATModel answers REQUESTS forwards through ``kern``; launches, times,
    peak memory; logits against the plain-attention forward."""
    F, C = cfg["num_features"], cfg["num_classes"]
    net = GATModel(F, GAT_HIDDEN, C, nheads=GAT_HEADS)
    net.load_state_dict(_gat_weights(np.random.default_rng(0), F, GAT_HIDDEN, GAT_HEADS, C))
    net = net.to(device).eval()
    x = torch.from_numpy(x).to(device)
    kernels = (K1.bsr_spmm, K2.bsr_spmm_fused, FG.flash_gat_forward, FG.flash_gat_hybrid_forward)
    with torch.no_grad():
        net(prep, x)  # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        ms, per_request = [], []
        for _ in range(REQUESTS):
            before = kern.launches
            t0 = time.perf_counter()
            logits = net(prep, x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            per_request.append(kern.launches - before)
        launches = {k.__name__: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated()
    _log(f"{label} GAT forwards ({kern.__name__}): " + ", ".join(f"{m:.3f}" for m in ms) + " ms")
    _log(f"launches in the {label} GAT serving run: {launches} (per request: {per_request})")
    _log(f"peak device memory in the {label} GAT serving run: {peak / 2**30:.3f} GiB")
    if per_request != [2] * REQUESTS or sum(launches.values()) != 2 * REQUESTS:
        raise AssertionError(f"{kern.__name__} launches per request {per_request}, expected 2 each "
                             f"and no other kernel: {launches}")
    with torch.no_grad():
        _profile_forward(lambda: net(prep, x), f"{label} GAT")
        ref = _plain_gat_forward(net, prep, x)
    if logits.shape != (A.n_rows, C):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    e = _check(f"{label} GAT logits vs plain-attention forward", logits, ref, GAT_TOL)
    _log(f"{label} GAT logits: max abs err {e:.3g} (|logits| max {float(ref.abs().max()):.3g})")
    return launches[kern.__name__]


def phase_gat_small(device, cfg=GAT_SMALL):
    """The n=8192 graph: full-cover flash tiles, served through K3."""
    A, x, gen_s = _slice_graph(cfg)
    _log(f"small GAT graph: n={A.n_rows} nnz={A.nnz} generate {gen_s:.1f} s")
    prep = phase_gat_prepare(A, device, "small")
    if prep.gat_plan is not None:
        raise AssertionError("n=8192 must prepare full-cover flash tiles")
    return phase_gat_serve(A, x, prep, device, FG.flash_gat_forward, "small", cfg)


def main() -> None:
    phase_device()
    phase_build()
    device = torch.device("cuda")
    phase_kernels_small(device)
    A, x, prep = phase_slice_prepare(device)
    rec = phase_kernels_slice(prep, device)
    launches = phase_slice_serve(A, x, prep, device)
    del prep
    torch.cuda.empty_cache()
    gat_prep = phase_gat_prepare(A, device, "slice")
    rec.update(phase_gat_kernels_slice(gat_prep, device))
    launches["flash_gat_hybrid_forward"] = phase_gat_serve(
        A, x, gat_prep, device, FG.flash_gat_hybrid_forward, "slice")
    del gat_prep
    torch.cuda.empty_cache()
    launches["flash_gat_forward"] = phase_gat_small(device)
    sources = {
        "bsr_spmm_fused": ("sgracex1_tpu_torch/csrc/fused_agg.cu", "sgracex1_tpu/ops/fused_agg.py:622"),
        "bsr_spmm": ("sgracex1_tpu_torch/csrc/bsr_spmm.cu", "sgracex1_tpu/ops/bsr.py:589"),
        "flash_gat_forward": ("sgracex1_tpu_torch/csrc/flash_gat.cu", "sgracex1_tpu/ops/flash_gat.py:422"),
        "flash_gat_hybrid_forward": ("sgracex1_tpu_torch/csrc/flash_gat.cu",
                                     "sgracex1_tpu/ops/flash_gat.py:1139"),
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
