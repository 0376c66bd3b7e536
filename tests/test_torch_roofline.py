"""The port's ``utils/roofline`` against the JAX module's arithmetic, and
its counts of the port's kernels' work against counts written out here
over the preps' live tiles, schedules, chunks and live slots."""

import dataclasses

import pytest
import torch

from sgracex1_tpu.utils import roofline as jr
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.utils import roofline as tr
from tests._torch_common import graph

torch.set_num_threads(1)

SOL = {"HBM": "memory", "VPU+MXU": "elementwise+operations", "VPU": "elementwise", "MXU": "operations"}
BOUND = {"HBM": "memory", "MXU": "operations", "VPU": "elementwise"}


@pytest.mark.parametrize("flops,nbytes,vpu,tr_ops,sec", [
    (2e12, 1e9, 0.0, 0.0, 1e-2), (1e9, 5e10, 1e8, 1e7, 3e-2), (5e12, 1e8, 4e12, 5e11, 0.8),
    (1e12, 1e9, 1e12, 1e10, 0.5), (0.0, 3e9, 0.0, 0.0, 1e-3),
])
def test_roofline_arithmetic_matches_jax(flops, nbytes, vpu, tr_ops, sec):
    peaks = tr.Peaks(card="test", memory_bytes_s=819e9, operations={"bf16": 197e12}, elementwise_s=5.5e12,
                     exp_s=4.9e11, copy_bytes_s=1.0)
    want = jr.CostModel(flops, nbytes, vpu_ops=vpu, transcendentals=tr_ops).roofline(
        sec, peak_flops=197e12, peak_bytes=819e9, peak_vpu=5.5e12, peak_transc=4.9e11)
    got = tr.CostModel({"bf16": flops}, nbytes, elementwise=vpu, transcendentals=tr_ops).roofline(sec, peaks)
    assert (got["tflops"], got["gb_s"]) == (want["tflops"], want["gb_s"])
    assert (got["pct_memory"], got["pct_operations"], got["pct_elementwise"]) == (
        want["pct_hbm"], want["pct_mxu"], want["pct_vpu"])
    assert got["bound"] == BOUND[want["bound"]] and got["pct_roofline"] == want["pct_roofline"]
    assert got["pct_sol"] == want["pct_sol"] and got["sol_bound"] == SOL[want["sol_bound"]]


@pytest.mark.parametrize("n,P,nnz", [(1024, 128, 5000), (19717, 64, 108365), (8, 3, 0)])
def test_dense_and_edge_costs_match_jax(n, P, nnz):
    for got, want in ((tr.cost_dense(n, P), jr.cost_dense(n, P)), (tr.cost_dense(n, P, 4), jr.cost_dense(n, P, 4)),
                      (tr.cost_xla_edges(nnz, n, P), jr.cost_xla_edges(nnz, n, P))):
        assert got.total_flops == want.flops and got.bytes == want.hbm_bytes


def test_bound_is_bytes_or_operations_at_the_published_peaks():
    c = tr.CostModel({"int8": 4e9}, 6.7e9)
    b = c.bound()
    assert b == dict(bound_ms=max(6.7e9 / 3.35e12, 4e9 / 1979e12) * 1e3, bound_by="bytes")
    assert tr.CostModel({"f32": 67e12}, 1.0).bound() == dict(bound_ms=1e3, bound_by="operations")


def _sched(L):
    return 4 * L.step.numel() + sum(4 * t.numel() for t in L.segments.tensors().values())


@pytest.mark.parametrize("kind,rank1", [("hybrid", True), ("hybrid", False), ("bsr", True), ("bsr", False)])
def test_cost_for_prep_counts_the_live_tiles_chunks_and_slots(kind, rank1):
    _, T = graph("symnorm" if rank1 else "weighted")
    prep = pt.prepare_adjacency(T, method=kind, tb=128, rest_thresh=64 if kind == "hybrid" else None,
                                build_transpose=False, device="cpu")
    plan, B, P = prep.fused, prep.fused.B, 32
    live = int(B.live.sum())
    elt = B.tiles.element_size()
    slots = int((plan.lrow < B.tb).sum()) if plan.num_rest_chunks else 0
    assert (slots > 0) == (kind == "hybrid")
    chunk = sum(t.numel() * t.element_size() for t in (plan.lrow, plan.slot_col, plan.slot_scale, plan.colscale,
                                                       plan.rowscale) if t is not None)
    io = T.n_cols * P * 4 + B.n_row_tiles * B.tb * P * 2
    c = tr.cost_for_prep(prep, P)
    assert c.bytes == live * B.tb * B.tb * elt + chunk + _sched(plan.ring) + io
    assert c.flops == {"bf16": 2.0 * live * B.tb * B.tb * P + 2.0 * slots * P}
    unfused = dataclasses.replace(prep, fused=None)
    u = tr.cost_for_prep(unfused, P)
    rest = prep.rest.nnz if prep.rest is not None else 0
    assert u.bytes == (live * B.tb * B.tb * elt + _sched(B.ring) + T.n_cols * P * 4 + B.n_row_tiles * B.tb * P * 4
                       + (rest * 12 + rest * P * 12 if rest else 0))


def test_cost_for_prep_pallas_dense_and_edges():
    _, T = graph("weighted")
    P = 16
    pp = pt.prepare_adjacency(T, method="pallas", device="cpu")
    plan = pp.plan
    live = plan.slot_idx.numel()
    c = tr.cost_for_prep(pp, P)
    assert live == T.nnz and c.flops == {"f32": 2.0 * live * P}
    assert c.bytes == (8 * live + sum(4 * t.numel() for t in plan.segments.tensors().values())
                       + T.n_cols * P * 4 + T.n_rows * P * 4)
    d = pt.prepare_adjacency(T, method="dense", device="cpu")
    assert tr.cost_for_prep(d, P).bytes == tr.cost_dense(T.n_rows, P).bytes
    x = pt.prepare_adjacency(T, method="xla", device="cpu")
    assert tr.cost_for_prep(x, P).bytes == tr.cost_xla_edges(T.nnz, T.n_rows, P).bytes


@pytest.mark.parametrize("layout", ["full", "hybrid"])
def test_flash_costs_count_the_live_tiles_and_slots(layout):
    _, T = graph("symnorm", n=1024)
    kw = dict(gat_tb=128) if layout == "full" else dict(gat_tb=128, gat_rest_thresh=64)
    prep = pt.prepare_adjacency(T, method="xla", for_gat=True, device="cpu", **kw)
    B, plan, H, F = prep.gat_bsr, prep.gat_plan, 4, 64
    live = int(B.live.sum())
    slots = int((plan.lrow < B.tb).sum()) if plan is not None else 0
    assert (slots > 0) == (layout == "hybrid")
    io = 12345
    c = tr.cost_flash_gat(B, H, F, io, plan=plan)
    sched = (_sched(plan.ring) + 4 * plan.lrow.numel() + 4 * plan.slot_col.numel()) if plan is not None else _sched(B.ring)
    assert c.bytes == live * B.tb * B.tb + io + sched
    assert c.flops == {"bf16": 2.0 * live * B.tb * B.tb * H * F + 2.0 * slots * H * F}
    assert c.transcendentals == H * (live * B.tb * B.tb + slots)
    bwd = tr.cost_flash_gat_bwd(B, H, F, 100, 200)
    Bt = B.live_t
    assert bwd.bytes == live * B.tb * B.tb + _sched(B.ring) + 100 + int(Bt.live.sum()) * B.tb * B.tb + _sched(Bt.ring) + 200
    assert bwd.flops == {"bf16": 3 * 2.0 * live * B.tb * B.tb * H * F}
