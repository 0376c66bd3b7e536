"""The reduction of a profiled stretch by the port's spans
(``portbench/spans.py``) on an event list built by hand, and a small CPU
run with the recorder open (``portbench/spanrun.py``): device time by span
plus outside sums to the stretch's, the idle split sums to its idle, the
set-up's span metrics read the plans. A run of ``portbench.run`` opens no
recorder, with ``--trace`` 0 or 1."""

from types import SimpleNamespace

import pytest
import torch

from portbench import spans
from portbench.spans import Event
from portbench.tests.conftest import QUICK, SMALL, bench
from portbench.trace import MARK


def _small_run(cell: str, trace: bool) -> dict:
    """``conftest.small_run`` with the profiled stretch on or off."""
    from portbench import run as R

    b = bench()
    c = {w["name"]: w for w in b["workloads"]}[cell]
    return R.run_cell(b, c, 3, 0.1, trace, torch.device("cpu"), overrides=dict(num_nodes=SMALL), traffic=QUICK)


OFF = 5_000_000  # the recorder's clock against the profiler's


def _span(name, sid, parent, start, end, jitter=0):
    return SimpleNamespace(name=name, id=sid, parent=parent, trace=1, start_ns=start - OFF + jitter,
                           end_ns=end - OFF, attrs={}, seconds=(end - start) * 1e-9)


def _stretch():
    """Thread 1 opened the stretch and the spans epoch > agg, epoch >
    loop.backward; thread 2 (the autograd engine's) holds agg.backward."""
    ev = [
        Event(MARK, "mark", 0, 1000, 1, 1, 0),
        Event("sg.loop.epoch", "span", 10, 900, 1, 2, 0),
        Event("sg.agg", "span", 100, 200, 1, 3, 0),
        Event("sg.loop.backward", "span", 300, 600, 1, 4, 0),
        Event("sg.agg.backward", "span", 350, 450, 2, 5, 0),
        Event("aten::mm", "host", 700, 710, 1, 7, 0),
        Event("Activity Buffer Request", "tracer", 600, 650, 1, 0, 0),
        Event("cudaLaunchKernel", "launch", 150, 155, 1, 101, 3),
        Event("cudaLaunchKernel", "launch", 400, 405, 2, 102, 5),
        Event("cudaLaunchKernel", "launch", 460, 465, 2, 103, 0),  # no span open on thread 2
        Event("cudaLaunchKernel", "launch", 950, 955, 1, 104, 0),  # outside every span
        Event("k1", "device", 160, 300, 7, 101, 3),
        Event("k2", "device", 400, 500, 7, 102, 5),
        Event("k3", "device", 500, 520, 7, 103, 0),
        Event("k4", "device", 950, 980, 7, 104, 0),
        Event("k5", "device", 710, 720, 7, 999, 7),  # no launch event: its linked frontend op
    ]
    rec = [_span("loop.epoch", 1, None, 10, 900), _span("agg", 2, 1, 100, 200, jitter=3),
           _span("loop.backward", 3, 1, 300, 600), _span("agg.backward", 4, 3, 350, 450)]
    return ev, rec


def test_device_time_by_span_plus_outside_is_the_stretchs():
    ev, rec = _stretch()
    red = spans.reduce(ev, rec)
    assert red["device_ns"] == {2: 140, 4: 100, 3: 20, 1: 10}
    assert red["outside_device_ns"] == 30
    assert sum(red["device_ns"].values()) + red["outside_device_ns"] == red["device_total_ns"] == 300
    assert red["unlinked"] == 0 and red["n_device_ops"] == 5


def test_idle_by_span_plus_tracer_plus_rest_is_the_stretchs():
    ev, rec = _stretch()
    red = spans.reduce(ev, rec)
    assert red["idle_ns"] == {1: 330, 2: 60, 3: 130, 4: 50}
    assert red["tracer_idle_ns"] == 50 and red["outside_idle_ns"] == 80
    total = sum(red["idle_ns"].values()) + red["tracer_idle_ns"] + red["outside_idle_ns"]
    assert total == red["idle_total_ns"] == 1000 - 300


def test_table_self_time_and_clock_residual():
    ev, rec = _stretch()
    red = spans.reduce(ev, rec)
    t = red["table"]
    assert t["loop.epoch"]["count"] == 1 and t["loop.epoch"]["host_ms"] == pytest.approx(890e-6)
    assert t["loop.epoch"]["self_ms"] == pytest.approx((890 - 97 - 300) * 1e-6)  # agg's start read 3 ns late
    assert t["loop.backward"]["self_ms"] == pytest.approx((300 - 100) * 1e-6)  # its child on thread 2
    assert t["agg.backward"]["device_ms"] == pytest.approx(100e-6) and t["agg"]["idle_ms"] == pytest.approx(60e-6)
    assert red["residual_ns"] == 3
    assert "outside" in spans.format_table(red, 1) and "tracer" in spans.format_table(red, 1)


def test_span_metrics_per_unit():
    ev, rec = _stretch()
    run = SimpleNamespace(span_stretch=spans.reduce(ev, rec), traffic={"kind": "train"}, trace_units=2,
                          setup_spans=[])
    assert spans.device_ms_under(run, "train", ("agg", "agg.backward")) == pytest.approx(240e-6 / 2)
    assert spans.device_ms_under(run, "train", ("loop.backward",)) == pytest.approx(120e-6 / 2)
    assert spans.device_ms_under(run, "infer", ("agg",)) is None
    assert spans.program_idle_ms(run, "train") == pytest.approx(570e-6 / 2)
    assert spans.program_idle_ms(run, "train", "loop.backward") == pytest.approx(180e-6 / 2)
    assert set(spans.metrics(run)) == {"agg_ms.train", "program_idle_ms.train"}  # no loop.eval span here


def test_mismatched_spans_are_reported():
    ev, rec = _stretch()
    assert spans.reduce(ev, rec)["unmatched"] == {}
    red = spans.reduce(ev, rec[:-1])
    assert red["unmatched"] == {"agg.backward": (1, 0)}
    assert red["device_ns"][3] == 20 + 100  # its launch falls to the main thread's loop.backward


def test_device_copies_of_annotations_are_dropped():
    ev, rec = _stretch()
    ev += [Event("Optimizer.step#Adam.step", "host", 600, 700, 1, 55, 0),
           Event("Optimizer.step#Adam.step", "device", 600, 700, 7, 55, 0)]
    red = spans.reduce(spans.drop_annotations(ev), rec)
    assert red["device_total_ns"] == 300 and red["unlinked"] == 0


def test_launches_and_annotations_are_told_apart():
    assert spans._kind("sg.agg", True, None) is None and spans._kind(MARK, True, None) is None
    assert spans._kind("void k<1>(int)", True, None) == "device"
    assert spans._kind("sg.agg", False, None) == "span" and spans._kind(MARK, False, None) == "mark"
    assert spans._kind("Activity Buffer Request", False, None) == "tracer"
    assert spans._kind("cudaLaunchKernel", False, None) == "launch"
    assert spans._kind("cuLaunchKernel", False, "cuda_driver") == "launch"
    assert spans._kind("aten::mm", False, "cpu_op") == "host"


@pytest.mark.parametrize("cell", ["gcn-products.train", "gcn-products.infer"])
def test_a_small_run_with_the_recorder(cell):
    from portbench import spanrun

    with spanrun.patched() as runs:
        out = _small_run(cell, True)
    run = runs[-1]
    assert out["correct"], out["checks"]
    m, c = out["spans"]["metrics"], out["spans"]["checks"]
    assert m["prepare_plan_s"] > 0 and m["prepare_cost_s"] > 0
    assert m["plan_live_share"] == pytest.approx(c["plan_live_share_from_plans"])
    assert not any(k.startswith(("agg_ms", "eval_ms", "program_idle")) for k in m)  # no device here
    assert c["idle_by_span_tracer_rest_ms"] == pytest.approx(c["idle_total_ms"])
    names = {s.name for s in run.span_stretch["spans"]}
    assert {"model.forward", "agg"} <= names
    if cell.endswith("train"):
        assert {"loop.epoch", "loop.step", "loop.eval", "agg.backward"} <= names
    assert {s.name for s in run.setup_spans} >= {"sym_norm", "prepare", "prepare.plan", "plan.tiles"}


@pytest.mark.parametrize("trace", [False, True])
def test_the_benchmark_itself_opens_no_recorder(monkeypatch, trace):
    from sgracex1_tpu_torch.utils import profiling

    def refuse():
        raise AssertionError("a recorder was opened")

    monkeypatch.setattr(profiling, "recording", refuse)
    out = _small_run("gcn-products.infer", trace)
    assert out["correct"] and "spans" not in out
