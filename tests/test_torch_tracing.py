"""The port's span recorder (``utils/profiling``) and the spans at its
layer boundaries, on the CPU: off records nothing, nesting and the ids,
the spans of a training loop, an inference forward and a prepare, and the
same nesting on ``torch.profiler``'s timeline."""

import contextlib
import dataclasses
import threading

import numpy as np
import pytest
import torch

from sgracex1_tpu_torch.config import SGRACEConfig
from sgracex1_tpu_torch.graph.datasets import NodeClassificationData
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.nn.models import GCNModel
from sgracex1_tpu_torch.ops.dispatch import agg_matmul, agg_matmul_with_vals, prepare_from_config
from sgracex1_tpu_torch.ops.pallas_spmm import recut_rows
from sgracex1_tpu_torch.train.loop import train_node_classifier
from sgracex1_tpu_torch.utils import profiling

N, F, C = 300, 8, 3


def _data(seed=0) -> NodeClassificationData:
    rng = np.random.default_rng(seed)
    e = rng.integers(0, N, size=(2, 4 * N))
    e = np.unique(np.concatenate([e, e[::-1]], axis=1), axis=1)
    e = e[:, e[0] != e[1]]
    split = rng.random(N)
    return NodeClassificationData(
        e, rng.standard_normal((N, F)).astype(np.float32), rng.integers(0, C, N),
        split < 0.5, (split >= 0.5) & (split < 0.7), split >= 0.7,
    )


@pytest.fixture(scope="module")
def pallas_prep():
    d = _data()
    A = sym_norm(d.edge_index, N)
    return d, A, prepare_from_config(A, SGRACEConfig(use_pallas=True), device="cpu")


def _model(layers=3):
    torch.manual_seed(0)
    return GCNModel(F, 16, C, num_layers=layers)


def _children(rec, s, name=None):
    return [c for c in rec.spans if c.parent == s.id and (name is None or c.name == name)]


def test_off_records_nothing_reads_no_clock_and_enters_no_record_function(monkeypatch, pallas_prep):
    d, _, prep = pallas_prep
    assert profiling.span("a") is profiling.span("b", n=1)  # one shared object
    assert not profiling.span("a")

    def refuse(*a, **k):
        raise AssertionError("called while no recorder is open")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", refuse)
    with profiling.span("a", n=1) as s:
        s.set(m=2)
    with torch.no_grad():
        _model().eval()(prep, torch.as_tensor(d.x))  # every span of a forward
    train_node_classifier(_model(), d, SGRACEConfig(num_epochs=1), prepare=prep, device="cpu")
    with profiling.recording() as rec:  # the program's spans are there when one is open
        monkeypatch.undo()
        with torch.no_grad():
            _model().eval()(prep, torch.as_tensor(d.x))
    assert [s.name for s in rec.spans][:2] == ["model.forward", "agg"]


@pytest.mark.parametrize("profiled", [False, True])
def test_record_function_only_under_a_profiler(monkeypatch, profiled):
    from torch.profiler import ProfilerActivity, profile

    names, real = [], torch.profiler.record_function

    def counted(name, *a, **k):
        names.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
        with profiling.recording() as rec:
            with profiling.span("a"):
                with profiling.span("b"):
                    pass
    assert [s.name for s in rec.spans] == ["a", "b"]
    assert names == (["sg.a", "sg.b"] if profiled else [])


def test_nesting_ids_and_trace_ids():
    with profiling.recording() as rec:
        with profiling.span("a", n=1) as a:
            with profiling.span("b") as b:
                b.set(k=3)
            with profiling.span("c"):
                pass
        with profiling.span("d") as d:
            pass
    assert [s.name for s in rec.spans] == ["a", "b", "c", "d"]
    a, b, c, d = rec.spans
    assert a.parent is None and b.parent == a.id and c.parent == a.id and d.parent is None
    assert a.trace == b.trace == c.trace == a.id and d.trace == d.id != a.trace
    assert len({s.id for s in rec.spans}) == 4
    assert a.attrs == {"n": 1} and b.attrs == {"k": 3}
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns <= c.end_ns <= a.end_ns <= d.start_ns
    assert a.seconds == (a.end_ns - a.start_ns) * 1e-9


def test_span_closes_on_an_exception():
    with profiling.recording() as rec:
        with pytest.raises(ValueError):
            with profiling.span("a"):
                raise ValueError("x")
        with profiling.span("b"):
            pass
    a, b = rec.spans
    assert a.end_ns >= a.start_ns and b.parent is None


def test_one_recording_at_a_time():
    with profiling.recording():
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    assert not profiling.span("x")  # closed again


@pytest.mark.parametrize("caller_open", [True, False])
def test_another_thread_takes_the_recording_threads_open_span(caller_open):
    def work():
        with profiling.span("worker"):
            with profiling.span("inner"):
                pass

    with profiling.recording() as rec:
        if caller_open:
            with profiling.span("wait") as w:
                t = threading.Thread(target=work)
                t.start()
                t.join(timeout=30)
        else:
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    spans = {s.name: s for s in rec.spans}
    worker, inner = spans["worker"], spans["inner"]
    assert worker.thread != rec.thread and inner.parent == worker.id
    if caller_open:
        assert worker.parent == w.id and worker.trace == inner.trace == w.trace
    else:
        assert worker.parent is None and worker.trace == inner.trace == worker.id


def test_threads_lose_no_span():
    """More threads than cores open spans at once, switching often: every
    span is kept once, with a unique id and its own thread's parent."""
    import os
    import sys

    n_threads, n_spans = 2 * (os.cpu_count() or 4), 200

    def work():
        for _ in range(n_spans):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.spans) == 2 * n_threads * n_spans == len({s.id for s in rec.spans})
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name == "inner":
            assert by_id[s.parent].name == "outer" and by_id[s.parent].thread == s.thread
        else:
            assert s.parent is None and s.trace == s.id


def test_training_loop_spans(pallas_prep):
    d, _, prep = pallas_prep
    assert prep.kind == "pallas"  # its aggregations go through _Agg
    with profiling.recording() as rec:
        train_node_classifier(_model(3), d, SGRACEConfig(num_epochs=2), prepare=prep, device="cpu")
    epochs = [s for s in rec.spans if s.name == "loop.epoch"]
    assert [e.attrs["epoch"] for e in epochs] == [0, 1]
    assert [e.parent for e in epochs] == [None, None] and len({e.trace for e in epochs}) == 2
    for e in epochs:
        assert [c.name for c in _children(rec, e)] == ["loop.step", "loop.eval", "loop.end_epoch"]
        step, ev, end = _children(rec, e)
        assert [c.name for c in _children(rec, step)] == [
            "loop.optimizer", "loop.forward", "loop.backward", "loop.optimizer"]
        _, fwd, bwd, _ = _children(rec, step)
        under = [s for s in rec.spans if e.start_ns <= s.start_ns <= e.end_ns]
        assert len(under) == 19 and all(s.trace == e.trace for s in under)
        (mf,) = _children(rec, fwd, "model.forward")
        assert len(_children(rec, mf, "agg")) == 3
        assert len(_children(rec, bwd, "agg.backward")) == 3
        (mf_eval,) = _children(rec, ev, "model.forward")
        assert len(_children(rec, mf_eval, "agg")) == 3
        assert sum(s.name == "model.forward" for s in under) == 2
        assert end.attrs["best_copy"] in (0, 1)
        for a in [s for s in under if s.name in ("agg", "agg.backward")]:
            assert a.attrs["kind"] == "pallas" and a.attrs["nnz"] == prep.A.nnz and a.attrs["P"] == 16
    assert epochs[0].end_ns <= epochs[1].start_ns


def test_agg_spans_count_k9s_split_rows(pallas_prep):
    """On the pallas kind each aggregation span carries the split rows and
    their partials of the plan K9 runs on: the plan's in ``agg`` (both entry
    points), the transposed plan's in ``agg.backward``."""
    d, _, prep = pallas_prep
    cut = dataclasses.replace(prep, plan=recut_rows(prep.plan, 4), plan_t=recut_rows(prep.plan_t, 3))
    S, St = cut.plan.segments, cut.plan_t.segments
    assert S.n_fin > 0 and St.n_fin > 0 and (S.n_fin, S.n_part) != (St.n_fin, St.n_part)
    x = torch.as_tensor(d.x).requires_grad_(True)
    vals = torch.rand(prep.A.vals.shape[0], generator=torch.Generator().manual_seed(0))
    with profiling.recording() as rec:
        agg_matmul(cut, x).sum().backward()
        agg_matmul_with_vals(cut, vals, x).sum().backward()
    for name, seg in (("agg", S), ("agg.backward", St)):
        spans = [s for s in rec.spans if s.name == name]
        assert len(spans) == 2
        for s in spans:
            assert (s.attrs["split_rows"], s.attrs["partials"]) == (seg.n_fin, seg.n_part)
            assert s.attrs["kind"] == "pallas" and s.attrs["nnz"] == prep.A.nnz and s.attrs["P"] == F


def test_best_copy_counts_the_copies(pallas_prep):
    d, _, prep = pallas_prep
    with profiling.recording() as rec:
        _, hist = train_node_classifier(_model(2), d, SGRACEConfig(num_epochs=4), prepare=prep, device="cpu")
    copies = [s.attrs["best_copy"] for s in rec.spans if s.name == "loop.end_epoch"]
    best = 0.0
    for te, c in zip(hist.test_acc, copies):
        assert c == int(te > best)
        best = max(best, te)


def test_prepare_spans_count_the_plans(pallas_prep):
    d, A, _ = pallas_prep
    with profiling.recording() as rec:
        A2 = sym_norm(d.edge_index, N)
        prep = prepare_from_config(A2, SGRACEConfig(use_pallas=True), device="cpu")
    (sn,) = [s for s in rec.spans if s.name == "sym_norm"]
    assert sn.attrs == {"n": N, "nnz": A.nnz}
    (pr,) = [s for s in rec.spans if s.name == "prepare"]
    assert pr.attrs["kind"] == "pallas" and pr.parent is None
    plans = _children(rec, pr, "prepare.plan")
    assert [p.attrs["transposed"] for p in plans] == [0, 1]
    for p, plan in zip(plans, (prep.plan, prep.plan_t)):
        assert p.attrs["groups"] == plan.num_groups
        assert p.attrs["slots"] == plan.num_groups * plan.be == plan.val.numel()
        assert p.attrs["live_slots"] == plan.nnz == A.nnz == int((plan.perm >= 0).sum())
        assert [c.name for c in _children(rec, p)] == ["plan.tiles", "plan.schedule", "plan.segments", "plan.upload"]
    assert [c.name for c in _children(rec, pr)] == ["prepare.upload", "prepare.plan", "prepare.plan"]


def test_auto_prepare_spans_the_rank1_factor_and_the_cost_model(pallas_prep):
    _, A, _ = pallas_prep
    with profiling.recording() as rec:
        prep = prepare_from_config(A, SGRACEConfig(), device="cpu")
    (pr,) = [s for s in rec.spans if s.name == "prepare"]
    names = [c.name for c in _children(rec, pr)]
    assert names[:3] == ["prepare.rank1", "prepare.cost_model", "prepare.upload"]
    assert pr.attrs["kind"] == prep.kind


def test_inference_forward_spans(pallas_prep):
    d, _, prep = pallas_prep
    model = _model(3).eval()
    with profiling.recording() as rec, torch.no_grad():
        for _ in range(2):
            model(prep, torch.as_tensor(d.x))
    fwds = [s for s in rec.spans if s.name == "model.forward"]
    assert len(fwds) == 2 and all(f.parent is None for f in fwds) and fwds[0].trace != fwds[1].trace
    for f in fwds:
        assert [c.name for c in _children(rec, f)] == ["agg"] * 3


@pytest.mark.parametrize("kind", ["dense", "xla"])
def test_kinds_on_torch_autograd_have_no_agg_backward(kind, pallas_prep):
    d, A, _ = pallas_prep
    prep = prepare_from_config(A, SGRACEConfig(), method=kind, device="cpu")
    with profiling.recording() as rec:
        train_node_classifier(_model(2), d, SGRACEConfig(num_epochs=1), prepare=prep, device="cpu")
    names = [s.name for s in rec.spans]
    assert names.count("agg") == 4 and "agg.backward" not in names


def test_spans_nest_on_the_profilers_timeline(pallas_prep):
    d, _, prep = pallas_prep
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            train_node_classifier(_model(3), d, SGRACEConfig(num_epochs=1), prepare=prep, device="cpu")
    ev = sorted((e for e in prof.profiler.kineto_results.events() if e.name().startswith("sg.")),
                key=lambda e: e.start_ns())
    assert [e.name() for e in ev] == ["sg." + s.name for s in sorted(rec.spans, key=lambda s: s.start_ns)]
    # the profiler's nesting: each event's innermost enclosing sg.* event on
    # its thread is its span's parent (on the CPU the backward runs on the
    # caller's thread)
    by_start = sorted(rec.spans, key=lambda s: s.start_ns)
    ids = {id(e): s for e, s in zip(ev, by_start)}
    for e, s in zip(ev, by_start):
        outer = [o for o in ev if o is not e and o.start_thread_id() == e.start_thread_id()
                 and o.start_ns() <= e.start_ns() and e.start_ns() + e.duration_ns() <= o.start_ns() + o.duration_ns()]
        parent = max(outer, key=lambda o: o.start_ns()) if outer else None
        assert (ids[id(parent)].id if parent else None) == s.parent, s.name

