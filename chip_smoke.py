"""Drive the PyTorch port's GCN and GAT serving and training paths, its
full-integer int8 serving and its fake-quant (QAT) path once on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, each raising on failure (so the run exits non-zero):

1. device: require CUDA; print the card's name and power limit
   (nvidia-smi), torch and CUDA versions; TF32 off.
2. build: compile the hand-written kernels (sgracex1_tpu_torch/csrc/*.cu)
   with nvcc for sm_90a, one nvcc per source, all started together.
3. kernels against their plain PyTorch versions on the card at small
   sizes: K1 (bsr_spmm) and K2 (bsr_spmm_fused) in the three tile forms,
   rank-1 and value mode, with and without a remainder, ragged n and P,
   f32 and bf16 H, and on transposed plans; K3 and K6 over the tile forms,
   head counts, ragged widths, isolated rows, split runs and chunk layouts;
   K4 and K5 over the same forms and under merged hybrid stats; small GCN
   and GAT forwards and gradients through the kernels against the f32
   edge path. K7 (bsr_spmm_int8) and K8 (bsr_spmm_int8_fused) must equal
   their plain versions and a scipy integer product (tb 128 and 256, P in
   {8, 16, 100, 128}, a row block without a tile, dead chunk slots, split
   runs, both attach_chunks modes).
4. the GCN slice: 2^20-node power-law graph (avg degree 16, 100 features,
   16 classes, seed 0), sym_norm, degree order, one hybrid prepare with
   the transposed plans; K1 and K2 timed against their plain versions, with
   their bound and the library call (torch.sparse.mm on the CSR form)
   beside them; a 2-layer width-128 GCNModel (random weights from a numpy
   seed) answers 3 requests through K2 and one through K1, then trains for
   3 epochs (K2 on the plan and its transpose; one step through the K1
   view), each held against the plain-kernel versions.
5. the GAT slice on the same graph: K6, K3, K4 and K5 timed at H=4, F=64
   with their bounds; GATModel(100, 64, 16, nheads=4) answers 3 requests
   through K6 and trains for 3 epochs (K6, K4, K5).
6. the small GAT path (n=8192, full-cover tiles): 3 requests and 3
   training epochs through K3, K4 and K5.
7. K8 at full width: the slice's graph quantized to 8 bits,
   prepare_int8_hybrid (tb 256, threshold 64, K 128), Hq from a numpy
   seed; int8_hybrid_agg three times, equal to the plain version; K8, and
   K7 on the plan's dense part, timed.
8. fake-quant GCN at 2^20, width 128: calibrate() from one float forward
   with telemetry, the 8-bit GCNModel on a value-tile prep
   (prepare_from_config with fake_quantization), forwards held against the
   plain-K1 forward, then 3 training epochs (K1 on bsr and bsr_t).
9. int8 GCN serving (freeze_gcn2_sparse -> int8_gcn2_sparse_forward, 100
   -> 128 -> 16) at n=2^16 on a full int8 tile cover: 3 requests, K7 twice
   each, equal to the plain-K7 forward, on the slice's power-law generator
   (K7 timed at its shapes; the error against the float forward is
   printed) and on a bounded-degree banded graph, where the output must
   lie within 0.08 of the float forward.
10. one int8 GAT layer on K3 at n=8192 against the plain K3 and, on the
   rows whose degree the 255 grid resolves, the edge-list int8 layer.

Every main path is driven with the launch counts set to 0 just before it
and read just after. The last two lines are the kernels' JSON record
(name, route, source, the TPU kernel replaced, launches, error, kernel /
plain / bound / library milliseconds) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from sgracex1_tpu_torch import (
    GATModel, GCNModel, SGRACEConfig, agg_matmul, prepare_adjacency, prepare_from_config,
    sym_norm, train_node_classifier,
)
from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.graph.datasets import NodeClassificationData, powerlaw_node_classification
from sgracex1_tpu_torch.graph.reorder import degree_order, permute_graph
from sgracex1_tpu_torch.ops import _cuda
from sgracex1_tpu_torch.ops import bsr as K1
from sgracex1_tpu_torch.ops import fused_agg as K2
from sgracex1_tpu_torch.ops import flash_gat as FG
from sgracex1_tpu_torch.ops.fused_gnn import relu_hw
from sgracex1_tpu_torch.ops import dispatch as D
from sgracex1_tpu_torch.ops.dispatch import _drop_zero_val_edges, split_by_tile_density
from sgracex1_tpu_torch.quant import int8 as Q
from sgracex1_tpu_torch.quant.affine import QuantConstants, generate_constants
from sgracex1_tpu_torch.quant.autocal import calibrate
from sgracex1_tpu_torch.quant.calibration import CalibrationTable
from sgracex1_tpu_torch.train.loop import _masked_xent

SLICE = dict(n=1 << 20, avg_degree=16, num_features=100, num_classes=16, seed=0)
HIDDEN = 128
REQUESTS = 3
K2_TOL = 2e-2  # both write bf16
K1_TOL = 1e-3  # identical bf16 operands, f32 sums in another order
GAT_TOL = 2e-2  # bf16(p) rounds against each CTA segment's running max
GAT_HIDDEN, GAT_HEADS = 64, 4  # examples/ppi_gat.py: 4 heads x 64, then 1 x 64
GAT_SMALL = dict(SLICE, n=8192)
TRAIN_EPOCHS = 3
# one step's gradients against the plain-kernel step, relative to each
# gradient's largest entry: the same bf16 operands, but p rounds to bf16
# against each segment's running max and through the fast exp
GRAD_TOL = 2e-2
KERNELS = (K1.bsr_spmm, K2.bsr_spmm_fused, FG.flash_gat_forward, FG.flash_gat_bwd_row,
           FG.flash_gat_bwd_col, FG.flash_gat_hybrid_forward, K1.bsr_spmm_int8,
           K2.bsr_spmm_int8_fused)
INT8_GCN = dict(SLICE, n=1 << 16)  # full int8 tile cover: at most 256^2 tiles of 64 KiB
INT8_TB = 256
INT8_REL_TOL = 0.08  # int8 2-layer GCN against the float forward, of its largest output
INT8_GAT_TOL = 0.03  # int8 GAT on K3 against the edge-list int8 GAT, of its largest output
INT8_GAT_MAX_DEGREE = 32  # rows whose attention weights the edge-list layer's 255 grid resolves
QAT_TOL = 2e-2  # fake-quant logits against the plain-K1 forward, of the largest logit
# the card's published peaks: bytes/s of device memory, dense tensor-core
# operations/s by operand type
HBM_BYTES_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}


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


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations at
    the tensor cores' peak for ``kind``, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations")


def _seg_bytes(S) -> int:
    return _nbytes(*S.tensors().values())


def _plan_bytes(plan) -> int:
    """The schedule and chunk arrays a fused-plan kernel reads."""
    return _nbytes(plan.step_cb, plan.step_tile, plan.step_chunk, plan.step_kind, plan.lrow,
                   plan.slot_col, plan.slot_scale, plan.colscale, plan.rowscale) + _seg_bytes(plan.segments)


def _live_slots(plan) -> int:
    return int((plan.lrow < plan.B.tb).sum()) if plan.num_rest_chunks else 0


def _agg_bound(B, H, out, kind, plan=None) -> dict:
    """Bound of one aggregation (K1, K2, K7, K8) on this run's tiles and
    chunks: tile products 2*tb*tb*P each, one multiply-add per live slot
    and feature."""
    P = H.shape[1]
    nbytes = _nbytes(B.tiles, H, out) + (
        _plan_bytes(plan) if plan is not None else _nbytes(B.tile_cb) + _seg_bytes(B.segments))
    ops = 2.0 * B.num_tiles * B.tb * B.tb * P + (2.0 * _live_slots(plan) * P if plan is not None else 0.0)
    return _bound(nbytes, ops, kind)


def _flash_bound(B, tensors, H, F, products, plan=None) -> dict:
    """Bound of a flash-GAT pass: ``products`` tile products of
    2*tb*tb*F operations per tile and head, bf16 operands."""
    nbytes = _nbytes(B.tiles, *tensors) + (
        _plan_bytes(plan) if plan is not None else _nbytes(B.tile_cb) + _seg_bytes(B.segments))
    ops = products * 2.0 * B.num_tiles * B.tb * B.tb * H * F + (2.0 * _live_slots(plan) * H * F if plan is not None else 0.0)
    return _bound(nbytes, ops, "bf16")


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
    _bwd_kernels_small(device, gen)


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


def _check_bwd(name, B, s1, s2, m, l, Wh, gO) -> float:
    """K4 and K5 against their plain versions (K5 on the plain t)."""
    got = FG.flash_gat_bwd_row(B, s1, s2, m, l, Wh, gO)
    ref = FG.flash_gat_bwd_row_plain(B, s1, s2, m, l, Wh, gO)
    err = max(_check(f"K4 {name} {k}", g, r, GAT_TOL) for k, g, r in zip(("t", "u1", "u2"), got, ref))
    got = FG.flash_gat_bwd_col(B, s1, s2, m, l, ref[0], Wh, gO)
    plain = FG.flash_gat_bwd_col_plain(B, s1, s2, m, l, ref[0], Wh, gO)
    return max(err, *(_check(f"K5 {name} {k}", g, r, GAT_TOL) for k, g, r in zip(("dWh", "ds2"), got, plain)))


def _bwd_kernels_small(device, gen):
    """K4/K5 against their plain versions over the tile forms, split row
    and column runs and merged hybrid stats; K1/K2 on transposed plans;
    small GCN and GAT gradients through the kernels against the f32 edge
    path."""
    cases = [
        # name, n, prepare keywords, H, F
        ("int8-tb128-hub-H4-F64", 3001, dict(method="xla", gat_tb=128), 4, 64),
        ("packed-tb1024-H2-F16", 5000, dict(method="xla", gat_tb=1024), 2, 16),
        ("bf16-values-bsr-H1-F40", 2100, dict(method="bsr", rank1=False, tb=256), 1, 40),
        ("int8-tb128-H2-F100-two-feature-slices", 3001, dict(method="xla", gat_tb=128), 2, 100),
        ("int8-tb256-H3-F20-unaligned-rows", 3001, dict(method="xla"), 3, 20),
    ]
    for i, (name, n, kw, H, F) in enumerate(cases):
        A = _random_graph(n, "values" in name, seed=40 + i, isolated=7)
        B = prepare_adjacency(A, for_gat=True, build_transpose=False, device=device, **kw).flash_tiles
        s1, s2, Wh = _scores(n, H, F, gen, device)
        gO = _scores(n, H, F, gen, device)[2]
        _, m, l = FG.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=True)
        err = _check_bwd(name, B, s1, s2, m, l, Wh, gO)
        _log(f"  K4/K5 {name}: T={B.num_tiles} row segments={B.segments.n_seg} "
             f"split={B.segments.n_fin} col segments={B.col_segments.n_seg} "
             f"split={B.col_segments.n_fin} err {err:.3g}")
        if "hub" in name and not (B.segments.n_fin and B.col_segments.n_fin):
            raise AssertionError("the hub case must split a row run and a column run")

    A = _random_graph(3001, False, seed=50)
    part, rest = split_by_tile_density(A, 128, 40)
    B = K1.bsr_mask_from_sparse(part, tb=128, cover_rows=True, cover_cols=True, device=device)
    plan = K2.build_fused_plan(B, _drop_zero_val_edges(rest), attach_chunks=True)
    s1, s2, Wh = _scores(3001, 4, 64, gen, device)
    gO = _scores(3001, 4, 64, gen, device)[2]
    _, m, l = FG.flash_gat_hybrid_forward_plain(plan, s1, s2, Wh, return_stats=True)
    err = _check_bwd("hybrid-merged-stats", B, s1, s2, m, l, Wh, gO)
    _log(f"  K4/K5 under merged hybrid stats (H=4, F=64): err {err:.3g}")

    for i, weighted in enumerate((False, True)):
        A = _random_graph(2600, weighted, seed=60 + i)
        prep = prepare_adjacency(A, method="hybrid", tb=128, rest_thresh=40, device=device)
        g = torch.randn(A.n_rows, 64, generator=gen, device=device)
        gb = g.to(torch.bfloat16)  # the cotangent of K2's bf16 output
        e2 = _check("K2 on fused_t", K2.bsr_spmm_fused(prep.fused_t, gb),
                    K2.bsr_spmm_fused_plain(prep.fused_t, gb), K2_TOL)
        e1 = _check("K1 on bsr_t", K1.bsr_spmm(prep.bsr_t, g), K1.bsr_spmm_plain(prep.bsr_t, g), K1_TOL)
        _log(f"  transposed plans ({'values' if weighted else 'rank-1'}): K2 on fused_t err {e2:.3g}, "
             f"K1 on bsr_t err {e1:.3g}")

    A = _random_graph(3001, False, seed=70)
    x = torch.randn(3001, 32, generator=gen, device=device)
    edge = prepare_adjacency(A, method="xla", device=device)

    def grads(net, prep):
        net.zero_grad(set_to_none=True)
        net(prep, x).square().mean().backward()
        return {k: p.grad.clone() for k, p in net.named_parameters()}

    gcn = GCNModel(32, 64, 7, dropout=0.0, generator=torch.Generator().manual_seed(0)).to(device)
    gat = GATModel(32, 16, 7, nheads=4, dropout=0.0, generator=torch.Generator().manual_seed(0)).to(device)
    runs = [("GCN K2 + K2 on fused_t", gcn,
             prepare_adjacency(A, method="hybrid", tb=128, rest_thresh=40, device=device), K2.bsr_spmm_fused),
            ("GAT K3 + K4/K5", gat, prepare_adjacency(A, method="xla", for_gat=True, device=device),
             FG.flash_gat_bwd_col),
            ("GAT K6 + K4/K5", gat, prepare_adjacency(A, method="xla", for_gat=True, gat_tb=128,
                                                      gat_rest_thresh=40, device=device), FG.flash_gat_bwd_col)]
    for name, net, prep, kern in runs:
        ref = grads(net, edge)
        before = kern.launches
        got = grads(net, prep)
        if kern.launches == before:
            raise AssertionError(f"small {name}: {kern.__name__} was not launched")
        err = 0.0
        for k, r in ref.items():
            scale = float(r.abs().max())
            torch.testing.assert_close(got[k], r, rtol=5e-2, atol=5e-2 * scale,
                                       msg=lambda mm: f"small {name} {k}: {mm}")
            err = max(err, float((got[k] - r).abs().max()) / max(scale, 1e-30))
        _log(f"  small {name} (3001 nodes) gradients vs f32 edge path: max err / max |grad| {err:.3g}")


def _int8_graph(n, seed, empty_rb=None, tb=128):
    """Weighted edges in (0, 1] plus hub rows: dense tiles and a sparse
    remainder. With ``empty_rb`` that row block gets no edge at all."""
    rng = np.random.default_rng(seed)
    h = np.stack([rng.integers(0, 150, 12 * n), rng.integers(0, n, 12 * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 4 * n)), h, h[::-1]], axis=1), axis=1)
    if empty_rb is not None:
        ei = ei[:, ei[0] // tb != empty_rb]
    v = rng.uniform(0.01, 1.0, ei.shape[1]).astype(np.float32)
    return SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))


def _check_equal(name: str, out, ref) -> float:
    """int32 results must be identical; returns the max abs difference (0)."""
    torch.cuda.synchronize()
    if out.dtype != torch.int32 or out.shape != ref.shape or not torch.equal(out, ref):
        diff = (out.long() - ref.long()).abs().max().item() if out.shape == ref.shape else "shape"
        raise AssertionError(f"{name}: kernel differs from its plain version (max abs diff {diff})")
    return 0.0


def phase_int8_kernels_small(device):
    """K7 and K8 equal to their plain versions and to a scipy integer
    product made on the host: tb 128 and 256, P in {8, 16, 100, 128}, a
    row block with no tile, dead chunk slots, split runs, both
    attach_chunks modes."""
    import scipy.sparse as sp

    c_a = generate_constants(0.0, 1.0, 8, signed=False, w_qbits=8)
    cases = [(3001, 128, 8, 2), (3001, 256, 16, None), (2600, 128, 100, 5), (4100, 256, 128, 1)]
    split = False
    for i, (n, tb, P, empty_rb) in enumerate(cases):
        A = _int8_graph(n, 80 + i, empty_rb, tb)
        aq = Q._quantize_vals(A.vals[: A.nnz], c_a).astype(np.int64)
        Aq = sp.coo_matrix((aq, (A.rows[: A.nnz], A.cols[: A.nnz])), shape=A.shape).tocsr()
        Hq_np = np.random.default_rng(i).integers(-127, 128, (n, P)).astype(np.int8)
        host = torch.from_numpy((Aq @ Hq_np.astype(np.int64)).astype(np.int32)).to(device)
        Hq = torch.from_numpy(Hq_np).to(device)
        B = Q.bsr_int8_from_sparse(A, c_a, tb=tb, device=device)
        out = K1.bsr_spmm_int8(B, Hq)
        _check_equal(f"K7 n={n} tb={tb} P={P}", out, K1.bsr_spmm_int8_plain(B, Hq))
        _check_equal(f"K7 n={n} tb={tb} P={P} vs scipy", out[:n], host)
        if out.shape[0] != B.n_row_tiles * tb or (out[n:] != 0).any():
            raise AssertionError("K7 writes every row of every row block, zeros past n_rows")
        msg = (f"  K7/K8 n={n} tb={tb} P={P}: K7 tiles={B.num_tiles} segments={B.segments.n_seg} "
               f"split_runs={B.segments.n_fin} empty_rb={empty_rb};")
        part, rest = split_by_tile_density(A, tb, 40 * (tb // 128) ** 2)
        B8 = Q.bsr_int8_from_sparse(part, c_a, tb=tb, cover_cols=True, device=device)
        rest_q = rest.with_vals(Q._quantize_vals(rest.vals, c_a))
        for attach in (True, False):
            plan = K2.build_fused_plan(B8, rest_q, attach_chunks=attach)
            dead = int((plan.lrow == tb).sum())
            if not (plan.num_rest_chunks and dead):
                raise AssertionError("the K8 case needs chunks and dead slots")
            split |= plan.segments.n_fin > 0
            out = K2.bsr_spmm_int8_fused(plan, Hq)
            _check_equal(f"K8 n={n} tb={tb} P={P} attach={attach}", out,
                         K2.bsr_spmm_int8_fused_plain(plan, Hq))
            _check_equal(f"K8 n={n} tb={tb} P={P} attach={attach} vs scipy", out, host)
            msg += (f" K8 attach={attach}: tiles={B8.num_tiles} chunks={plan.num_rest_chunks} "
                    f"dead_slots={dead} kinds={sorted(set(plan.step_kind.tolist()))} "
                    f"split_runs={plan.segments.n_fin};")
        _log(msg + " equal")
    if not split:
        raise AssertionError("no K8 case split a run")
    # the dense integer products that serve X @ W and the score matvecs
    rng = np.random.default_rng(3)
    shapes = [(1000, 100, 12), (2000, 100, 32), (17, 8, 2), (3001, 128, 100)]
    for M, K, N in shapes:
        us = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(device)
        sq = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8)).to(device)
        got = Q.matmul_unsigned_x_signed(us, sq)
        ref = (us.cpu().long() + 128) @ sq.cpu().long()
        if got.dtype != torch.int32 or not torch.equal(got.cpu().long(), ref):
            raise AssertionError(f"matmul_unsigned_x_signed {M}x{K}x{N} differs from the host integer product")
    _log(f"  matmul_unsigned_x_signed equals the host integer product at [M, K, N] in {shapes}")


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
    """The power-law graph, sym_norm (fill-0 self-loops), degree order;
    the data (edges, x, y, masks) renumbered in the same order."""
    t0 = time.perf_counter()
    data = powerlaw_node_classification(**cfg)
    A = sym_norm(data.edge_index, data.num_nodes)
    perm = degree_order(A)
    A, inv = permute_graph(A, perm)
    data = NodeClassificationData(
        inv[data.edge_index], data.x[perm], data.y[perm], data.train_mask[perm],
        data.val_mask[perm], data.test_mask[perm],
    )
    return A, data, time.perf_counter() - t0


def phase_slice_prepare(device, cfg=SLICE):
    """One prepare for serving and training: serving reads the forward
    plans, training also the transposed ones."""
    A, data, gen_s = _slice_graph(cfg)
    t0 = time.perf_counter()
    prep = prepare_adjacency(A, method="hybrid", device=device)
    prep_s = time.perf_counter() - t0
    f, ft = prep.fused, prep.fused_t
    _log(f"slice graph: n={A.n_rows} nnz={A.nnz} (incl. zero-valued self-loops) "
         f"generate+sym_norm+degree-order {gen_s:.1f} s")
    _log(f"slice prepare (forward and transposed plans; the forward plans alone took 5.4 s in earlier runs): "
         f"{prep_s:.1f} s kind={prep.kind} tb={prep.bsr.tb} "
         f"tiles={prep.bsr.num_tiles} form={prep.bsr.tiles.dtype}{list(prep.bsr.tiles.shape[1:])} "
         f"rank1={prep.r1_row is not None} rest_edges={prep.rest.nnz if prep.rest is not None else 0} "
         f"rest_chunks={f.num_rest_chunks} K={f.K} steps={f.num_steps} "
         f"segments={f.segments.n_seg} split_runs={f.segments.n_fin}; "
         f"fused_t: steps={ft.num_steps} segments={ft.segments.n_seg} split_runs={ft.segments.n_fin}")
    return A, data, prep


def phase_kernels_slice(A, prep, device):
    """Both kernels at the slice's shapes (P = 128): error and times, the
    bound, and the library call beside them."""
    gen = torch.Generator(device=device).manual_seed(1)
    H = torch.randn(prep.A.n_cols, HIDDEN, generator=gen, device=device)
    lib_ms, lib = _sparse_mm_ms(A, H)
    e = _check("agg_matmul (K2) against torch.sparse.mm", agg_matmul(prep, H), lib, K2_TOL)
    _log(f"agg_matmul (K2, bf16) against the library product (f32): max abs err {e:.3g}")
    rec = {}
    for name, kern, plain, op, tol in (
        ("bsr_spmm_fused", K2.bsr_spmm_fused, K2.bsr_spmm_fused_plain, prep.fused, K2_TOL),
        ("bsr_spmm", K1.bsr_spmm, K1.bsr_spmm_plain, prep.bsr, K1_TOL),
    ):
        out = kern(op, H)
        err = _check(f"{name} at slice shapes", out, plain(op, H), tol)
        ms = _cuda_ms(lambda: kern(op, H))
        plain_ms = _cuda_ms(lambda: plain(op, H), reps=5)
        bound = _agg_bound(prep.bsr, H, out, "bf16", plan=op if op is prep.fused else None)
        rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound, library_ms=lib_ms)
        _log(f"{name} at slice shapes [n={prep.A.n_rows}, P={HIDDEN}]: kernel {ms:.4f} ms, "
             f"plain {plain_ms:.4f} ms (median of 5), bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}, "
             f"max abs err {err:.3g}")
    return rec


def _sparse_mm_ms(A, H) -> tuple:
    """The library yardstick of K1/K2: one ``torch.sparse.mm`` on the CSR
    form of the same normalised adjacency with the same H (float32). Timed
    here and used nowhere in the package. Returns (ms, the product)."""
    rows = A.rows[: A.nnz].astype(np.int64)
    crow = torch.from_numpy(np.searchsorted(rows, np.arange(A.n_rows + 1))).to(H.device)
    csr = torch.sparse_csr_tensor(
        crow, torch.from_numpy(A.cols[: A.nnz].astype(np.int64)).to(H.device),
        torch.from_numpy(A.vals[: A.nnz].astype(np.float32)).to(H.device), size=A.shape)
    ref = torch.sparse.mm(csr, H)
    ms = _cuda_ms(lambda: torch.sparse.mm(csr, H))
    _log(f"library call torch.sparse.mm (CSR, f32, nnz={A.nnz}) on [n={A.n_rows}, P={H.shape[1]}]: {ms:.4f} ms")
    return ms, ref


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
    C = cfg["num_classes"]
    net = _gcn_net(cfg).to(device).eval()
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
        out = kern(op, s1, s2, Wh)
        err = _check(f"{name} at slice shapes", out, plain(op, s1, s2, Wh), GAT_TOL)
        ms = _cuda_ms(lambda: kern(op, s1, s2, Wh))
        plain_ms = _cuda_ms(lambda: plain(op, s1, s2, Wh), reps=3)
        bound = _flash_bound(plan.B, (s1, s2, Wh, out), GAT_HEADS, GAT_HIDDEN, 1,
                             plan=plan if op is plan else None)
        rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound, library_ms=None)
        _log(f"{name} at slice shapes [n={prep.A.n_rows}, H={GAT_HEADS}, F={GAT_HIDDEN}]: "
             f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 3), bound {bound['bound_ms']:.4f} ms "
             f"by {bound['bound_by']}, max abs err {err:.3g}")
    # the backward passes on the plan's tiles under K6's merged stats
    _, m, l = FG.flash_gat_hybrid_forward(plan, s1, s2, Wh, return_stats=True)
    gO = torch.randn(Wh.shape, generator=gen, device=device)
    B = plan.B
    t = FG.flash_gat_bwd_row_plain(B, s1, s2, m, l, Wh, gO)[0]
    for name, kern, plain, args in (
        ("flash_gat_bwd_row", FG.flash_gat_bwd_row, FG.flash_gat_bwd_row_plain, (B, s1, s2, m, l, Wh, gO)),
        ("flash_gat_bwd_col", FG.flash_gat_bwd_col, FG.flash_gat_bwd_col_plain, (B, s1, s2, m, l, t, Wh, gO)),
    ):
        outs = kern(*args)
        err = max(_check(f"{name} at slice shapes", g, r, GAT_TOL) for g, r in zip(outs, plain(*args)))
        ms = _cuda_ms(lambda: kern(*args))
        plain_ms = _cuda_ms(lambda: plain(*args), reps=3)
        # K4: the q product; K5: the q product and p^T @ gO
        bound = _flash_bound(B, (*args[1:], *outs), GAT_HEADS, GAT_HIDDEN, 1 if name.endswith("row") else 2)
        rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound, library_ms=None)
        _log(f"{name} at slice shapes [n={prep.A.n_rows}, T={B.num_tiles}, H={GAT_HEADS}, F={GAT_HIDDEN}]: "
             f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 3), bound {bound['bound_ms']:.4f} ms "
             f"by {bound['bound_by']}, max abs err {err:.3g}")
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


def _profile_forward(fn, label, what="1 forward"):
    """One call of ``fn`` (a forward or a training step) under
    torch.profiler: wall ms, device-busy ms (kernel intervals on the one
    stream), idle share, and the kernels by time."""
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
    _log(f"{label} profiler window ({what}): wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
         f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        _log(f"  {ms:9.4f} ms  {100 * ms / max(busy, 1e-9):5.1f}%  {name[:110]}")


def phase_gat_serve(A, x, prep, device, kern, label, cfg=SLICE):
    """GATModel answers REQUESTS forwards through ``kern``; launches, times,
    peak memory; logits against the plain-attention forward."""
    C = cfg["num_classes"]
    net = _gat_net(cfg).to(device).eval()
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


@contextlib.contextmanager
def _plain_kernels():
    """Every kernel wrapper on the training path swapped for its plain
    version where the autograd Functions call it: the reference step."""
    swaps = [(D, "bsr_spmm_fused", K2.bsr_spmm_fused_plain), (D, "bsr_spmm", K1.bsr_spmm_plain),
             (FG, "flash_gat_forward", FG.flash_gat_forward_plain),
             (FG, "flash_gat_hybrid_forward", FG.flash_gat_hybrid_forward_plain),
             (FG, "flash_gat_bwd_row", FG.flash_gat_bwd_row_plain),
             (FG, "flash_gat_bwd_col", FG.flash_gat_bwd_col_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _step(net, prep, x, y, mask, opt=None, seed=0):
    """One training step as train_node_classifier takes it: train mode,
    dropout from a generator seeded with ``seed``, masked cross-entropy,
    backward, and the Adam update when ``opt`` is given."""
    net.train()
    net.zero_grad(set_to_none=True)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    loss = _masked_xent(net(prep, x, generator=gen), y, mask)
    loss.backward()
    if opt is not None:
        opt.step()
    return loss


def _counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def _reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def phase_train(data, prep, net, device, label, per_epoch, k1_view=False):
    """train_node_classifier for TRAIN_EPOCHS epochs on ``prep`` (the main
    path: counts reset just before, read just after, each kernel launched
    ``per_epoch[name]`` times an epoch); then timed steps, a profiler
    window over one step, optionally one step through the K1 view of the
    prep, and one step's gradients against the plain-kernel step."""
    x = torch.from_numpy(data.x).to(device)
    y = torch.from_numpy(data.y).to(device).long()
    mask = torch.from_numpy(data.train_mask).to(device).float()
    net = net.to(device)
    # warm-up: cuBLAS handles, the allocator, the first optimizer step of
    # the process and the evaluation's reductions (lr=0 leaves the weights)
    t0 = time.perf_counter()
    _step(net, prep, x, y, mask, torch.optim.Adam(net.parameters(), lr=0.0))
    with torch.no_grad():
        net.eval()(prep, x).argmax(dim=-1)
    torch.cuda.synchronize()
    _log(f"{label} warm-up step and evaluation: {(time.perf_counter() - t0) * 1e3:.3f} ms")
    torch.cuda.reset_peak_memory_stats()
    cfg = SGRACEConfig(num_epochs=TRAIN_EPOCHS, learning_rate=0.01)
    _reset_counts()
    t0 = time.perf_counter()
    state, hist = train_node_classifier(net, data, cfg, seed=0, prepare=prep, device=device)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    _log(f"{label} train_node_classifier: {TRAIN_EPOCHS} epochs in {total_ms:.3f} ms "
         f"({total_ms / TRAIN_EPOCHS:.3f} ms an epoch: step + evaluation); loss {hist.loss}, "
         f"train acc {hist.train_acc}, test acc {hist.test_acc}")
    _log(f"launches in the {label} training run: {launches}")
    _log(f"peak device memory in the {label} training run: {peak / 2**30:.3f} GiB")
    want = {k.__name__: TRAIN_EPOCHS * per_epoch.get(k.__name__, 0) for k in KERNELS}
    if launches != want:
        raise AssertionError(f"{label} training launches {launches}, expected {want}")
    if state.step != TRAIN_EPOCHS or not all(np.isfinite(hist.loss)):
        raise AssertionError(f"{label} training: step {state.step}, losses {hist.loss}")

    opt = state.optimizer
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        _step(net, prep, x, y, mask, opt)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    _log(f"{label} training steps (forward + backward + Adam): " + ", ".join(f"{m:.3f}" for m in ms) + " ms")
    _profile_forward(lambda: _step(net, prep, x, y, mask, opt), f"{label} train", "1 training step")
    if k1_view:
        view = dataclasses.replace(prep, fused=None, fused_t=None)  # fuse=False view
        _reset_counts()
        t0 = time.perf_counter()
        _step(net, view, x, y, mask)
        torch.cuda.synchronize()
        k1_ms = (time.perf_counter() - t0) * 1e3
        k1 = _counts()
        _log(f"{label} training step through the K1 view (fuse=False): {k1_ms:.3f} ms, launches {k1}")
        if k1["bsr_spmm"] != 4 or sum(k1.values()) != 4:
            raise AssertionError(f"K1 view step launches {k1}, expected bsr_spmm 4 and nothing else")
        launches["bsr_spmm"] += k1["bsr_spmm"]
        got = {k: p.grad.clone() for k, p in net.named_parameters()}
        with _plain_kernels():
            _step(net, view, x, y, mask)
        _check_grads(f"{label} K1 view", net, got)

    _step(net, prep, x, y, mask)
    got = {k: p.grad.clone() for k, p in net.named_parameters()}
    with _plain_kernels():
        _step(net, prep, x, y, mask)
    _check_grads(label, net, got)
    return launches


def _check_grads(label, net, got):
    """``got`` against the gradients the last step left on ``net``."""
    err = 0.0
    for k, p in net.named_parameters():
        r = p.grad
        scale = float(r.abs().max())
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f"{label} gradient {k} is not finite")
        torch.testing.assert_close(got[k], r, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   msg=lambda m: f"{label} gradient {k}: {m}")
        err = max(err, float((got[k] - r).abs().max()) / max(scale, 1e-30))
    _log(f"{label} one step's gradients vs the plain-kernel step: max err / max |grad| {err:.3g}")


def phase_gat_small(device, cfg=GAT_SMALL):
    """The n=8192 graph: full-cover flash tiles, served through K3, then
    trained through K3, K4 and K5."""
    A, data, gen_s = _slice_graph(cfg)
    _log(f"small GAT graph: n={A.n_rows} nnz={A.nnz} generate {gen_s:.1f} s")
    prep = phase_gat_prepare(A, device, "small")
    if prep.gat_plan is not None:
        raise AssertionError("n=8192 must prepare full-cover flash tiles")
    launches = {"flash_gat_forward": phase_gat_serve(A, data.x, prep, device, FG.flash_gat_forward, "small", cfg)}
    per_epoch = {"flash_gat_forward": 4, "flash_gat_bwd_row": 2, "flash_gat_bwd_col": 2}
    return _add(launches, phase_train(data, prep, _gat_net(cfg), device, "small GAT", per_epoch))


def _gat_net(cfg):
    F, C = cfg["num_features"], cfg["num_classes"]
    net = GATModel(F, GAT_HIDDEN, C, nheads=GAT_HEADS)
    net.load_state_dict(_gat_weights(np.random.default_rng(0), F, GAT_HIDDEN, GAT_HEADS, C))
    return net


def _gcn_net(cfg):
    F, C = cfg["num_features"], cfg["num_classes"]
    net = GCNModel(F, HIDDEN, C)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         _slice_weights(np.random.default_rng(0), F, HIDDEN, C).items()})
    return net


def _add(total: dict, more: dict) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_int8_hybrid_slice(A, device):
    """K8 at full width: the slice's graph quantized to 8 bits, the hybrid
    split (tb 256, threshold 64, K 128), Hq from a numpy seed. The main
    path is ``int8_hybrid_agg`` three times; then K8 and K7 (on the plan's
    dense part) are timed against their plain versions and must equal
    them."""
    c_a = QuantConstants(s_o=1.0, s=max(float(A.vals[: A.nnz].max()), 1e-8) / 255.0, z=0, qbits=8, signed=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = Q.prepare_int8_hybrid(A, c_a, tb=INT8_TB, rest_thresh=D.DEFAULT_REST_THRESH, K=K2.DEFAULT_K,
                                 device=device)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    B = plan.B
    _log(f"int8 hybrid prepare: {prep_s:.1f} s tb={B.tb} tiles={B.num_tiles} "
         f"({_nbytes(B.tiles) / 1e9:.3f} GB {B.tiles.dtype}) rest_edges={_live_slots(plan)} "
         f"rest_chunks={plan.num_rest_chunks} K={plan.K} steps={plan.num_steps} "
         f"segments={plan.segments.n_seg} split_runs={plan.segments.n_fin}")
    Hq = torch.from_numpy(np.random.default_rng(0).integers(-127, 127, (A.n_cols, HIDDEN)).astype(np.int8)).to(device)
    _reset_counts()
    for _ in range(REQUESTS):
        out = Q.int8_hybrid_agg(plan, Hq)
    torch.cuda.synchronize()
    launches = _counts()
    if launches["bsr_spmm_int8_fused"] != REQUESTS or sum(launches.values()) != REQUESTS:
        raise AssertionError(f"int8 hybrid aggregation launches {launches}, expected K8 x{REQUESTS} only")
    if out.shape != (A.n_rows, HIDDEN):
        raise AssertionError(f"int8 hybrid aggregation shape {tuple(out.shape)}")
    rec = {}
    err = _check_equal("K8 at slice shapes", out, K2.bsr_spmm_int8_fused_plain(plan, Hq))
    ms = _cuda_ms(lambda: K2.bsr_spmm_int8_fused(plan, Hq))
    plain_ms = _cuda_ms(lambda: K2.bsr_spmm_int8_fused_plain(plan, Hq), reps=5)
    bound = _agg_bound(B, Hq, out, "int8", plan=plan)
    rec["bsr_spmm_int8_fused"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound, library_ms=None)
    _log(f"bsr_spmm_int8_fused at slice shapes [n={A.n_rows}, P={HIDDEN}]: kernel {ms:.4f} ms "
         f"({A.nnz / (ms * 1e-3) / 1e6:.1f} M edges/s), plain {plain_ms:.4f} ms (median of 5), "
         f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}, equal to the plain version")
    out7 = K1.bsr_spmm_int8(B, Hq)
    _check_equal("K7 on the hybrid plan's dense part", out7, K1.bsr_spmm_int8_plain(B, Hq))
    ms7 = _cuda_ms(lambda: K1.bsr_spmm_int8(B, Hq))
    plain7 = _cuda_ms(lambda: K1.bsr_spmm_int8_plain(B, Hq), reps=5)
    b7 = _agg_bound(B, Hq, out7, "int8")
    _log(f"bsr_spmm_int8 on the same dense part [T={B.num_tiles}, P={HIDDEN}]: kernel {ms7:.4f} ms, "
         f"plain {plain7:.4f} ms (median of 5), bound {b7['bound_ms']:.4f} ms by {b7['bound_by']}, equal")
    _log(f"peak device memory in the int8 hybrid phase: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return rec, launches


def _banded_graph(n, extra, seed):
    """Sym-normalised banded + random graph (bands +-1 and +-2, ``extra``
    random edges): bounded degrees, the shape the int8 accuracy limit is
    defined on."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for d in (-2, -1, 1, 2):
        i = np.arange(max(0, -d), min(n, n - d))
        rows.append(i)
        cols.append(i + d)
    rows.append(rng.integers(0, n, extra))
    cols.append(rng.integers(0, n, extra))
    k = np.unique(np.concatenate(rows).astype(np.int64) * n + np.concatenate(cols))
    return sym_norm(np.stack([k // n, k % n]), n)


def _int8_gcn_serve(A, label, device, cfg, rel_limit):
    """Freeze the 100 -> 128 -> 16 net on ``A`` (weights uniform +-0.5 and
    features uniform [0, 1] from a numpy seed, a_max from the adjacency,
    activation ranges from one float forward on the host), answer REQUESTS
    requests through K7, hold the output against the same forward on the
    plain K7 (equal) and the float forward (``rel_limit`` of its largest
    output, where given). Returns (net, launches)."""
    n, F, C = A.n_rows, cfg["num_features"], cfg["num_classes"]
    T = len(K1.bsr_tile_keys(A, INT8_TB, cover_rows=True))
    _log(f"int8 GCN {label}: n={n} nnz={A.nnz}; full cover at tb={INT8_TB}: {T} tiles, "
         f"{T * INT8_TB * INT8_TB / 1e9:.3f} GB int8")
    rng = np.random.default_rng(0)
    W1 = rng.uniform(-0.5, 0.5, (F, HIDDEN)).astype(np.float32)
    W2 = rng.uniform(-0.5, 0.5, (HIDDEN, C)).astype(np.float32)
    X = rng.uniform(0.0, 1.0, (n, F)).astype(np.float32)
    a_max = float(A.vals[: A.nnz].max()) or 1.0
    cal = CalibrationTable.for_qbits(8, dict(w_min=-0.5, w_max=0.5, w_min2=-0.5, w_max2=0.5,
                                             f_min=0.0, f_max=1.0, a_min=0.0, a_max=a_max))
    amax = Q.collect_amax_gcn2_sparse(A, X, W1, W2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = Q.freeze_gcn2_sparse(W1, W2, A, cal, tb=INT8_TB, device=device, **amax)
    torch.cuda.synchronize()
    _log(f"freeze_gcn2_sparse ({label}): {time.perf_counter() - t0:.1f} s tiles={net.a_bsr.num_tiles} "
         f"segments={net.a_bsr.segments.n_seg} split_runs={net.a_bsr.segments.n_fin} amax={amax}")
    xs = Q.quantize_unsigned_shifted(torch.from_numpy(X).to(device), cal.features)
    Q.int8_gcn2_sparse_forward(net, xs)  # warm-up: cuBLASLt handles, allocator
    torch.cuda.synchronize()
    _reset_counts()
    ms, per_request = [], []
    for _ in range(REQUESTS):
        before = _counts()["bsr_spmm_int8"]
        t0 = time.perf_counter()
        out = Q.int8_gcn2_sparse_forward(net, xs)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        per_request.append(_counts()["bsr_spmm_int8"] - before)
    launches = _counts()
    _log(f"int8 GCN requests ({label}, K7 route): " + ", ".join(f"{m:.3f}" for m in ms) + " ms")
    _log(f"launches in the int8 GCN serving run ({label}): {launches} (K7 per request: {per_request})")
    if per_request != [2] * REQUESTS or sum(launches.values()) != 2 * REQUESTS:
        raise AssertionError(f"K7 launches per request {per_request}, expected 2 each and no other kernel")
    if out.shape != (n, C) or not torch.isfinite(out).all():
        raise AssertionError(f"int8 GCN output shape {tuple(out.shape)} or non-finite")
    kern = Q.bsr_spmm_int8
    Q.bsr_spmm_int8 = K1.bsr_spmm_int8_plain
    try:
        ref = Q.int8_gcn2_sparse_forward(net, xs)
    finally:
        Q.bsr_spmm_int8 = kern
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("int8 GCN output differs from the same forward on the plain K7")
    mat = A.to_scipy()
    flt = mat @ (np.maximum(mat @ (X @ W1), 0.0) @ W2)
    rel = float(np.abs(out.cpu().numpy() - flt).max() / (np.abs(flt).max() + 1e-9))
    _log(f"int8 GCN output ({label}): equal to the plain-K7 forward; relative error against the float forward "
         f"{rel:.4f}" + (f" (limit {rel_limit})" if rel_limit else " (reported, no limit: see the docstring)"))
    if rel_limit and rel >= rel_limit:
        raise AssertionError(f"int8 GCN relative error {rel} against the float forward")
    return net, launches


def phase_int8_gcn(device, cfg=INT8_GCN):
    """Full-integer GCN serving (100 -> 128 -> 16) on a full int8 tile
    cover at tb 256: ``freeze_gcn2_sparse`` -> ``int8_gcn2_sparse_forward``,
    K7 twice a request. The full cover is what limits the size: at most
    (n / 256)^2 tiles of 64 KiB.

    Two graphs of n nodes go through the same entry points. The slice's
    power-law generator is the main path (launch counts, equality with the
    plain-K7 forward, K7's times at its shapes); its error against the
    float forward is printed without a limit, because one 8-bit grid per
    tensor cannot hold a hub row's range (the hub's layer-1 output sets
    ``x2_absmax`` some 60 times above an ordinary node's, whose values then
    round to a few levels; the reference's int8 design has the same
    limit). The accuracy limit of 0.08 is held on the bounded-degree banded
    graph on which the reference defines it."""
    A, _, gen_s = _slice_graph(cfg)
    n, C = A.n_rows, cfg["num_classes"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    net, launches = _int8_gcn_serve(A, "power-law", device, cfg, None)
    # K7 at the path's layer-1 shape (P = 128), and its layer-2 shape beside it
    rng = np.random.default_rng(1)
    rec = {}
    for P in (HIDDEN, C):
        Hq = torch.from_numpy(rng.integers(-127, 128, (n, P)).astype(np.int8)).to(device)
        o = K1.bsr_spmm_int8(net.a_bsr, Hq)
        err = _check_equal(f"K7 at the int8 GCN's shapes P={P}", o, K1.bsr_spmm_int8_plain(net.a_bsr, Hq))
        k_ms = _cuda_ms(lambda: K1.bsr_spmm_int8(net.a_bsr, Hq))
        p_ms = _cuda_ms(lambda: K1.bsr_spmm_int8_plain(net.a_bsr, Hq), reps=3)
        bound = _agg_bound(net.a_bsr, Hq, o, "int8")
        _log(f"bsr_spmm_int8 at the int8 GCN's shapes [n={n}, T={net.a_bsr.num_tiles}, P={P}]: kernel {k_ms:.4f} ms, "
             f"plain {p_ms:.4f} ms (median of 3), bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}, equal")
        if P == HIDDEN:
            rec["bsr_spmm_int8"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, **bound, library_ms=None)
    del net
    torch.cuda.empty_cache()
    _, more = _int8_gcn_serve(_banded_graph(n, n // 4, 0), "banded", device, cfg, INT8_REL_TOL)
    _log(f"peak device memory in the int8 GCN phase: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return rec, _add(launches, more)


def phase_int8_gat(device, cfg=GAT_SMALL):
    """One int8 GAT layer (100 -> 64, one head) on K3 over full-cover mask
    tiles at n=8192, against the same layer on the edge list."""
    A, _, _ = _slice_graph(cfg)
    n, F = A.n_rows, cfg["num_features"]
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 1.0, (n, F)).astype(np.float32)
    W = rng.uniform(-0.5, 0.5, (F, GAT_HIDDEN)).astype(np.float32)
    att = rng.uniform(-0.5, 0.5, (2 * GAT_HIDDEN, 1)).astype(np.float32)
    c_x = QuantConstants(s_o=1.0, s=1.0 / 255.0, z=0, qbits=8, signed=False)
    c_w = QuantConstants(s_o=1.0, s=0.5 / 127.0, z=0, qbits=8, signed=True)
    layer = Q.freeze_gat_layer(W, att, c_x, c_w, h_absmax=float(np.abs(X @ W).max()), device=device)
    xs = Q.quantize_unsigned_shifted(torch.from_numpy(X).to(device), c_x)
    B = K1.bsr_mask_from_sparse(A, tb=256, device=device)
    Ad = A.to(device)
    Q.int8_gat_layer_flash(layer, B, xs)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    acc_f, sc_f = Q.int8_gat_layer_flash(layer, B, xs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    if launches["flash_gat_forward"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"int8 GAT layer launches {launches}, expected K3 once")
    if acc_f.shape != (n, GAT_HIDDEN) or not torch.isfinite(acc_f).all():
        raise AssertionError(f"int8 GAT layer on K3: shape {tuple(acc_f.shape)} or non-finite")
    kern = Q.flash_gat_forward
    Q.flash_gat_forward = FG.flash_gat_forward_plain
    try:
        ref = Q.int8_gat_layer_flash(layer, B, xs)[0]
    finally:
        Q.flash_gat_forward = kern
    # h_q reaches +-127, so bf16(p) is held relative to the largest output
    err = float((acc_f - ref).abs().max())
    if err > GAT_TOL * float(ref.abs().max()):
        raise AssertionError(f"int8 GAT layer on K3 differs from the plain K3 by {err}")
    # the edge-list layer rounds each attention weight to the 255 grid, which
    # cannot resolve a hub row's weights (1/degree < 1/510 rounds to 0): it is
    # the yardstick on the rows whose degree the grid resolves
    acc_e, sc_e = Q.int8_gat_layer(layer, Ad.rows, Ad.cols, Ad.vals > 0, n, xs)
    deg = torch.zeros(n, device=device).index_add_(0, Ad.rows.long(), (Ad.vals > 0).float())
    rows = deg <= INT8_GAT_MAX_DEGREE
    out_f = acc_f.double()[rows] * sc_f
    out_e = acc_e.double()[rows] * sc_e
    rel = float((out_f - out_e).abs().max() / (out_e.abs().max() + 1e-9))
    _log(f"int8 GAT layer on K3 [n={n}, {F} -> {GAT_HIDDEN}, T={B.num_tiles}]: {ms:.3f} ms, launches {launches}; "
         f"max abs err {err:.3g} against the plain K3; against the edge-list int8 layer {rel:.4f} of its largest "
         f"output on the {int(rows.sum())} rows of degree <= {INT8_GAT_MAX_DEGREE} (limit {INT8_GAT_TOL})")
    if rel >= INT8_GAT_TOL:
        raise AssertionError(f"int8 GAT layer on K3: relative error {rel} against the edge-list layer")
    return launches


def phase_fake_quant(A, data, device, cfg=SLICE):
    """Fake-quant (QAT) GCN at 2^20, width 128: calibrate from one float
    forward, the 8-bit model on a value-tile prep (``prepare_from_config``
    with ``fake_quantization``), one forward against the same forward on
    the plain K1, then three training epochs (K1 on ``bsr`` and ``bsr_t``;
    ``map_adjacency_vals`` rewrites both tile sets every layer call)."""
    qcfg = SGRACEConfig(fake_quantization=True, num_epochs=TRAIN_EPOCHS, learning_rate=0.01)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prep = prepare_from_config(A, qcfg, device=device)
    torch.cuda.synchronize()
    _log(f"fake-quant prepare (value tiles, no rank-1 masks): {time.perf_counter() - t0:.1f} s kind={prep.kind} "
         f"tiles={prep.bsr.num_tiles} form={prep.bsr.tiles.dtype}{list(prep.bsr.tiles.shape[1:])} "
         f"({_nbytes(prep.bsr.tiles) / 1e9:.3f} GB a direction) rest_edges={prep.rest.nnz}")
    if prep.r1_row is not None or prep.bsr.tiles.dtype != torch.bfloat16:
        raise AssertionError("a fake_quantization prep must hold value tiles")
    x = torch.from_numpy(data.x).to(device)
    flt = _gcn_net(cfg).to(device).eval()
    t0 = time.perf_counter()
    cal = calibrate(flt, prep, x, qbits=8)
    torch.cuda.synchronize()
    _log(f"calibrate (one float forward with telemetry): {(time.perf_counter() - t0) * 1e3:.1f} ms "
         f"f_max={cal.raw['f_max']:.4g} f_max2={cal.raw['f_max2']:.4g} "
         f"w_max={cal.raw['w_max']:.4g} w_max2={cal.raw['w_max2']:.4g}")
    net = GCNModel(cfg["num_features"], HIDDEN, cfg["num_classes"], calibration=cal)
    net.load_state_dict(flt.state_dict())
    net = net.to(device).eval()
    with torch.no_grad():
        net(prep, x)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        ms = []
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            logits = net(prep, x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = _counts()
        if launches["bsr_spmm"] != 2 * REQUESTS or sum(launches.values()) != 2 * REQUESTS:
            raise AssertionError(f"fake-quant forward launches {launches}, expected K1 x2 a forward only")
        _profile_forward(lambda: net(prep, x), "fake-quant GCN")
        with _plain_kernels():
            ref = net(prep, x)
    _log("fake-quant GCN forwards (K1 on remapped value tiles): " + ", ".join(f"{m:.3f}" for m in ms) + " ms")
    scale = float(ref.abs().max())
    torch.cuda.synchronize()
    if logits.shape != (A.n_rows, cfg["num_classes"]) or not torch.isfinite(logits).all():
        raise AssertionError(f"fake-quant logits shape {tuple(logits.shape)} or non-finite")
    err = float((logits - ref).abs().max())
    _log(f"fake-quant logits against the plain-K1 forward: max abs err {err:.3g} of |logits| max {scale:.3g}")
    if err > QAT_TOL * scale:
        raise AssertionError(f"fake-quant logits differ from the plain-K1 forward by {err} (max {scale})")
    net.train()
    _reset_counts()
    t0 = time.perf_counter()
    state, hist = train_node_classifier(net, data, qcfg, seed=0, prepare=prep, device=device)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    train_launches = _counts()
    _log(f"fake-quant train_node_classifier: {TRAIN_EPOCHS} epochs in {total_ms:.3f} ms "
         f"({total_ms / TRAIN_EPOCHS:.3f} ms an epoch: step + evaluation); loss {hist.loss}, "
         f"train acc {hist.train_acc}, test acc {hist.test_acc}")
    _log(f"launches in the fake-quant training run: {train_launches}")
    # a step: K1 on bsr twice forward, on bsr_t twice backward; an evaluation: K1 twice
    if train_launches["bsr_spmm"] != 6 * TRAIN_EPOCHS or sum(train_launches.values()) != 6 * TRAIN_EPOCHS:
        raise AssertionError(f"fake-quant training launches {train_launches}, expected K1 x{6 * TRAIN_EPOCHS} only")
    if state.step != TRAIN_EPOCHS or not all(np.isfinite(hist.loss)):
        raise AssertionError(f"fake-quant training: step {state.step}, losses {hist.loss}")
    _log(f"peak device memory in the fake-quant phase: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return _add(launches, train_launches)



def main() -> None:
    phase_device()
    phase_build()
    device = torch.device("cuda")
    phase_kernels_small(device)
    phase_int8_kernels_small(device)
    A, data, prep = phase_slice_prepare(device)
    rec = phase_kernels_slice(A, prep, device)
    launches = phase_slice_serve(A, data.x, prep, device)
    _add(launches, phase_train(data, prep, _gcn_net(SLICE), device, "GCN slice",
                               {"bsr_spmm_fused": 6}, k1_view=True))
    del prep
    torch.cuda.empty_cache()
    gat_prep = phase_gat_prepare(A, device, "slice")
    rec.update(phase_gat_kernels_slice(gat_prep, device))
    _add(launches, {"flash_gat_hybrid_forward": phase_gat_serve(
        A, data.x, gat_prep, device, FG.flash_gat_hybrid_forward, "slice")})
    per_epoch = {"flash_gat_hybrid_forward": 4, "flash_gat_bwd_row": 2, "flash_gat_bwd_col": 2}
    _add(launches, phase_train(data, gat_prep, _gat_net(SLICE), device, "GAT slice", per_epoch))
    del gat_prep
    torch.cuda.empty_cache()
    _add(launches, phase_gat_small(device))
    rec8, more = phase_int8_hybrid_slice(A, device)
    rec.update(rec8)
    _add(launches, more)
    torch.cuda.empty_cache()
    _add(launches, phase_fake_quant(A, data, device))
    del A, data
    torch.cuda.empty_cache()
    rec7, more = phase_int8_gcn(device)
    rec.update(rec7)
    _add(launches, more)
    torch.cuda.empty_cache()
    _add(launches, phase_int8_gat(device))
    sources = {
        "bsr_spmm_fused": ("sgracex1_tpu_torch/csrc/fused_agg.cu", "sgracex1_tpu/ops/fused_agg.py:622"),
        "bsr_spmm": ("sgracex1_tpu_torch/csrc/bsr_spmm.cu", "sgracex1_tpu/ops/bsr.py:589"),
        "flash_gat_forward": ("sgracex1_tpu_torch/csrc/flash_gat.cu", "sgracex1_tpu/ops/flash_gat.py:422"),
        "flash_gat_bwd_row": ("sgracex1_tpu_torch/csrc/flash_gat_bwd.cu", "sgracex1_tpu/ops/flash_gat.py:762"),
        "flash_gat_bwd_col": ("sgracex1_tpu_torch/csrc/flash_gat_bwd.cu", "sgracex1_tpu/ops/flash_gat.py:847"),
        "flash_gat_hybrid_forward": ("sgracex1_tpu_torch/csrc/flash_gat.cu",
                                     "sgracex1_tpu/ops/flash_gat.py:1139"),
        "bsr_spmm_int8": ("sgracex1_tpu_torch/csrc/bsr_spmm_int8.cu", "sgracex1_tpu/ops/bsr.py:773"),
        "bsr_spmm_int8_fused": ("sgracex1_tpu_torch/csrc/fused_agg_int8.cu",
                                "sgracex1_tpu/ops/fused_agg.py:1054"),
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
