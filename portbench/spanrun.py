"""A traced run of a cell with the port's span recorder open, and the
cost of that recorder.

    python3 -m portbench.spanrun --workload gcn-products.train --seed 7 --seconds 20 [--dump out.json.gz]
    python3 -m portbench.spanrun --cost --seed 7

The first is ``python3 -m portbench.run ... --trace 1`` with the port's
recorder (``sgracex1_tpu_torch.utils.profiling.recording``) open around
set-up and around the profiled stretch, never around the window. Its
result line adds ``spans``: the span metrics (``spans.metrics``), the
clock residual and the sums that check the reduction; standard error
carries the span table of the stretch and set-up's spans by stage.
``--dump`` writes the stretch's events and spans as gzipped JSON.
``portbench.run`` itself opens no recorder.

The second sets up the train cell's graph, prepare and model once (no
recorder), then times the windows' work with the recorder closed and open
in turns: ms an epoch (``train_node_classifier`` calls on the prepared
adjacency) and ms a request (``eval()`` forwards), and ns a span, off and
on. It prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import statistics
import sys
import time

from portbench import run as R
from portbench import spans, trace
from portbench.drivers import common


def _stages(rec_spans) -> dict:
    """Set-up's host seconds by span name."""
    out: dict = {}
    for s in rec_spans:
        out[s.name] = out.get(s.name, 0.0) + s.seconds
    return {k: round(v, 4) for k, v in out.items()}


def _checks(run) -> dict:
    """What the reduction can be held to: its device and idle sums against
    ``trace.reduce``'s, the port's own kernels' ms a unit beside
    ``agg_ms``, the plans' live share from the plans themselves."""
    red, t, u = run.span_stretch, run.traced, run.trace_units
    dev = sum(red["device_ns"].values()) + red["outside_device_ns"]
    idle = sum(red["idle_ns"].values()) + red["tracer_idle_ns"] + red["outside_idle_ns"]
    return dict(
        residual_us=red["residual_ns"] * 1e-3,
        device_by_span_plus_outside_ms=dev * 1e-6, device_s_ms=t["device_s"] * 1e3,
        idle_by_span_tracer_rest_ms=idle * 1e-6, idle_total_ms=red["idle_total_ns"] * 1e-6,
        window_less_busy_ms=(t["window_s"] - t["busy_s"]) * 1e3, tracer_idle_ms=red["tracer_idle_ns"] * 1e-6,
        outside_idle_ms=red["outside_idle_ns"] * 1e-6, own_kernels_ms_a_unit=t["own_s"] * 1e3 / u,
        plan_live_share_from_plans=getattr(run, "plan_share", None), n_device_ops=red["n_device_ops"],
        unlinked_device_ops=red["unlinked"], unmatched=red["unmatched"],
    )


@contextlib.contextmanager
def patched(dump: str = None):
    """``portbench.run`` with the recorder open around set-up and the
    profiled stretch, and ``spans`` added to its result line."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from sgracex1_tpu_torch.utils import profiling

    runs = []
    setup, traced, run_cell = R.setup, common.traced, R.run_cell

    def recorded_setup(run):
        runs.append(run)
        with profiling.recording() as rec:
            setup(run)
        run.setup_spans = rec.spans
        plans = [p for p in (getattr(run.prep, "plan", None), getattr(run.prep, "plan_t", None)) if p is not None]
        if plans:
            run.plan_share = 100.0 * sum(p.nnz for p in plans) / sum(p.num_groups * p.be for p in plans)

    def recorded_traced(run, fn):
        common.sync(run.device)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            with record_function(trace.MARK), profiling.recording() as rec:
                fn()
                common.sync(run.device)
            wall = time.perf_counter() - t0
        evs = spans.events(prof)
        if dump:
            _dump(dump, evs, rec.spans)
        run.span_stretch = spans.reduce(evs, rec.spans)
        return trace.reduce(spans.WithoutAnnotations(prof), run.own_kernels, wall)

    def with_spans(*a, **k):
        out = run_cell(*a, **k)
        run = runs[-1]
        R.log("set-up by span (host s): " + json.dumps(_stages(run.setup_spans)))
        if getattr(run, "span_stretch", None) is not None:
            R.log("traced stretch by span:\n" + spans.format_table(run.span_stretch, run.trace_units))
            out["spans"] = dict(metrics=spans.metrics(run), checks=_checks(run))
        else:
            out["spans"] = dict(metrics=spans.metrics(run))
        R.log("spans: " + json.dumps(out["spans"]))
        return out

    R.setup, common.traced, R.run_cell = recorded_setup, recorded_traced, with_spans
    try:
        yield runs
    finally:
        R.setup, common.traced, R.run_cell = setup, traced, run_cell


def _dump(path: str, evs, rec_spans) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump(dict(
            events=[list(e) for e in evs],
            spans=[dict(name=s.name, id=s.id, parent=s.parent, trace=s.trace, thread=s.thread,
                        start_ns=s.start_ns, end_ns=s.end_ns, attrs=s.attrs) for s in rec_spans],
        ), f)


def _per_span_ns(n: int) -> float:
    from sgracex1_tpu_torch.utils import profiling

    t0 = time.perf_counter_ns()
    for _ in range(n):
        with profiling.span("agg", kind="pallas", nnz=1, P=256):
            pass
    return (time.perf_counter_ns() - t0) / n


def cost(seed: int, rounds: int, epochs: int, requests: int) -> dict:
    """The recorder's cost on the train cell's set-up: the windows' work
    with it closed and open in turns, and a span's ns off and on."""
    import torch

    from sgracex1_tpu_torch.config import SGRACEConfig
    from sgracex1_tpu_torch.graph.datasets import NodeClassificationData
    from sgracex1_tpu_torch.train.loop import train_node_classifier
    from sgracex1_tpu_torch.utils import profiling

    bench = R._json(os.path.join(R.ROOT, "BENCHMARK.json"))
    cell = {c["name"]: c for c in bench["workloads"]}["gcn-products.train"]
    run = R.Run(cell, seed, 0.0, False, torch.device("cuda"))
    R.setup(run)
    g, dev = run.graph, run.device
    data = NodeClassificationData(run.edges_host, g.x, g.y, g.train_mask, g.val_mask, g.test_mask)
    base = SGRACEConfig(learning_rate=run.cfg["lr"])

    def epoch_ms(k: int) -> float:
        common.sync(dev)
        t0 = time.perf_counter()
        train_node_classifier(run.model, data, base.replace(num_epochs=k), seed=seed, prepare=run.prep, device=dev)
        common.sync(dev)
        return 1e3 * (time.perf_counter() - t0) / k

    def request_ms(k: int) -> float:
        model, tot = run.model.eval(), 0.0
        for _ in range(k):
            common.sync(dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                model(run.prep, g.x)
            common.sync(dev)
            tot += time.perf_counter() - t0
        return 1e3 * tot / k

    def arm(on: bool, fn, k: int) -> float:
        if not on:
            return fn(k)
        with profiling.recording():
            return fn(k)

    epoch_ms(1), request_ms(2)  # the first calls build and warm up
    got = {m: {"closed": [], "open": []} for m in ("epoch_ms", "request_ms")}
    for r in range(rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            got["epoch_ms"]["open" if on else "closed"].append(arm(on, epoch_ms, epochs))
            got["request_ms"]["open" if on else "closed"].append(arm(on, request_ms, requests))
    off_ns = _per_span_ns(1_000_000)
    with profiling.recording():
        on_ns = _per_span_ns(100_000)
    out = dict(card=R._card(), epochs=epochs, requests=requests, rounds=rounds, off_span_ns=off_ns, on_span_ns=on_ns)
    for m, v in got.items():
        out[m] = {k: dict(median=statistics.median(x), runs=x) for k, x in v.items()}
        out[m]["open_over_closed"] = out[m]["open"]["median"] / out[m]["closed"]["median"] - 1.0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--dump")
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--rounds", type=int, default=4)
    a = ap.parse_args(argv)
    if a.cost:
        import torch

        if not torch.cuda.is_available():
            R.log("needs a CUDA device")
            return 2
        print(json.dumps(cost(a.seed, a.rounds, epochs=10, requests=40)), flush=True)
        return 0
    with patched(a.dump):
        return R.main(["--workload", a.workload, "--seed", str(a.seed), "--seconds", str(a.seconds), "--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
