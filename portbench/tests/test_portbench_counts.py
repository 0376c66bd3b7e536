"""The count of work against small cases worked by hand."""

import json
import os

import pytest

from portbench import counts as C
from portbench.families import gcn
from portbench.tests.conftest import ROOT


def test_gemm():
    o = C.gemm("g", 2, 3, 4)
    assert o.flops == 48  # 2 * 2 * 3 * 4
    assert o.bytes == 4 * (6 + 12 + 8)
    assert o.kind == "torch"


def test_aggregate_reads_csr_and_bf16_h_writes_f32():
    o = C.aggregate("a", 4, 6, 2)
    assert o.flops == 24  # 2 * nnz * p
    # rowptr 5 x 4 B, 6 x (4 B column + 4 B value), H 4 x 2 x 2 B, out 4 x 2 x 4 B
    assert o.bytes == 20 + 48 + 16 + 32
    assert o.kind == "kernel"


def test_least_time_takes_the_larger_bound_per_op_and_sums():
    ops = [C.Op("x", C.PEAK_FLOPS, 0.0), C.Op("y", 0.0, 2 * C.PEAK_BYTES, "kernel"),
           C.Op("z", C.PEAK_FLOPS, C.PEAK_BYTES / 2)]
    assert C.least_time(ops) == pytest.approx(4.0)
    assert C.least_time(ops, "kernel") == pytest.approx(2.0)


def test_adam_and_cross_entropy():
    assert C.adam("a", 10).bytes == 10 * 28
    assert C.cross_entropy("x", 3, 5, backward=False).bytes == 3 * (20 + 8 + 4) + 4
    assert C.cross_entropy("x", 3, 5, backward=True).bytes == 3 * (20 + 8 + 4) + 60


def _cfg(name):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_gcn_epoch_has_nine_aggregations_and_every_gemm():
    cfg = _cfg("gcn-products")
    ops = gcn.epoch_ops(cfg, 10, 50, 40, 100)
    assert sum(o.kind == "kernel" for o in ops) == 9  # 3 train, 3 transposed, 3 evaluation
    gemm_flops = sum(o.flops for o in ops if ".gemm" in o.name)
    # forward twice (train, evaluation): 2 n (100 x 256 + 256 x 256 x 2 + 256 x 47)
    assert gemm_flops == 2 * 2 * 10 * (100 * 256 + 2 * 256 * 256 + 256 * 47)
    assert sum(o.kind == "kernel" for o in gcn.request_ops(cfg, 10, 50, 40, 100)) == 3
