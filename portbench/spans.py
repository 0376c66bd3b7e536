"""Reduction of a profiled stretch by the port's own spans, and the span
metrics.

The port records spans at its layer boundaries while a recorder is open
(``sgracex1_tpu_torch.utils.profiling.recording``); each span also enters
``record_function("sg." + name)``, so in a ``torch.profiler`` stretch it
lies on the profiler's clock and thread timeline. ``reduce`` matches the
recorder's spans to those events (by name, in order of start; a name
whose counts differ is reported in ``unmatched`` and matched as far as
both go), then:

- attributes each device operation to the innermost span around the host
  call that launched it: the launch (the CUDA runtime or driver call with
  the device operation's correlation id; else the frontend operation it
  is linked to), and the innermost ``sg.*`` event on the launch's thread
  around it, or, on a thread with none (the autograd engine's device
  thread), the innermost one on the thread that opened the stretch;
- splits each idle gap of the device (the stretch less the union of its
  device operations) by what covers it on the host: the profiler's own
  events (the tracer's idle, not the program's), else the innermost span,
  else nothing of the program (``outside``: the harness);
- gives each span name's count, host ms, self host ms (its duration less
  what its children cover), device ms launched and idle ms, and the clock
  residual: the recorder's starts anchored to the profiler's at the first
  span, the largest difference left over all spans.

Device-side copies of the annotations (``gpu_user_annotation``: the
``sg.*`` spans', the stretch's mark, the optimizer's) are not device
operations and are left out. ``events`` reads a ``torch.profiler``
object into plain ``Event`` tuples; ``reduce`` takes such a list, so the
tests build one by hand.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

from portbench import trace

PREFIX = "sg."
# the profiler's own host events, named with spaces or underscores
TRACER = {"Activity_Buffer_Request", "Record_Window_End", "Collecting_Trace", "Profiler_Overhead"}
LAUNCH_TYPES = {"cuda_runtime", "cuda_driver"}


class Event(NamedTuple):
    """One profiler event, times in ns on the profiler's clock. ``kind`` is
    ``span`` (an ``sg.*`` host event), ``launch`` (a CUDA runtime or driver
    call), ``tracer`` (the profiler's own), ``host`` (any other host
    operation), ``device`` (a kernel, copy or set) or ``mark`` (the
    stretch's range)."""

    name: str
    kind: str
    start: int
    end: int
    thread: int
    corr: int
    linked: int


def _kind(name: str, on_device: bool, activity: Optional[str]) -> Optional[str]:
    annotation = name.startswith(PREFIX) or name == trace.MARK or activity == "gpu_user_annotation"
    if on_device:
        return None if annotation else "device"
    if name == trace.MARK:
        return "mark"
    if name.startswith(PREFIX):
        return "span"
    if name.replace(" ", "_") in TRACER or activity == "overhead":
        return "tracer"
    if activity in LAUNCH_TYPES or (activity is None and (name.startswith("cuda") or name[:3] in ("cuL", "cuM"))):
        return "launch"
    return "host"


def events(prof) -> List[Event]:
    """The profiled stretch's events as ``Event`` tuples."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        activity = e.activity_type() if hasattr(e, "activity_type") else None
        activity = activity if isinstance(activity, str) else None
        k = _kind(e.name(), e.device_type() == DeviceType.CUDA, activity)
        if k is not None:
            s = e.start_ns()
            end = e.end_ns() if hasattr(e, "end_ns") else s + e.duration_ns()
            out.append(Event(e.name(), k, s, end, e.start_thread_id(), e.correlation_id(), e.linked_correlation_id()))
    return drop_annotations(out)


def drop_annotations(evs: List[Event]) -> List[Event]:
    """``evs`` less the device-side copies of host annotations (such as
    ``Optimizer.step#Adam.step``): a device event with the name and the
    correlation id of a host event."""
    host = {(e.name, e.corr) for e in evs if e.kind != "device"}
    return [e for e in evs if not (e.kind == "device" and (e.name, e.corr) in host)]


class WithoutAnnotations:
    """A profiler whose ``events()`` leave out the device-side copies of
    the ``sg.*`` annotations, which ``trace.reduce`` would count as device
    operations."""

    def __init__(self, prof):
        self._prof = prof

    def events(self):
        from torch.autograd import DeviceType

        return [e for e in self._prof.events()
                if not (e.device_type == DeviceType.CUDA and e.name.startswith(PREFIX))]


def _innermost(spans: List[Event], t: int) -> Optional[int]:
    """Index of the latest-starting span of ``spans`` around ``t``."""
    best = None
    for i, s in enumerate(spans):
        if s.start <= t <= s.end and (best is None or s.start >= spans[best].start):
            best = i
    return best


def _covered(iv, lo, hi) -> int:
    """ns of [lo, hi] covered by the union of ``iv``."""
    tot = 0
    for s, e in trace._merge([(max(s, lo), min(e, hi)) for s, e in iv if e > lo and s < hi]):
        tot += e - s
    return tot


def reduce(evs: List[Event], spans) -> Dict:
    """The stretch ``evs`` reduced by the recorder's ``spans`` (the spans
    opened in it: objects with ``name``, ``id``, ``parent``, ``start_ns``,
    ``end_ns``, ``attrs``). Device and idle ns by span id, outside any span
    and (idle) the tracer's; the table by name; the clock residual."""
    host = [e for e in evs if e.kind == "span"]
    dev = [e for e in evs if e.kind == "device"]
    tracer = [e for e in evs if e.kind == "tracer"]
    marks = [e for e in evs if e.kind == "mark"]
    # the recorder's spans, matched to their events name by name in order of start
    by_name: Dict[str, list] = {}
    for e in sorted(host, key=lambda e: e.start):
        by_name.setdefault(e.name[len(PREFIX):], []).append(e)
    rec_by_name: Dict[str, list] = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        rec_by_name.setdefault(s.name, []).append(s)
    unmatched = {k: (len(by_name.get(k, [])), len(rec_by_name.get(k, [])))
                 for k in set(by_name) | set(rec_by_name) if len(by_name.get(k, [])) != len(rec_by_name.get(k, []))}
    pairs = [(e, s) for k in by_name for e, s in zip(by_name[k], rec_by_name.get(k, []))]
    pairs.sort(key=lambda p: p[0].start)
    ev_spans = [e for e, _ in pairs]
    rec_of = [s for _, s in pairs]
    residual = 0
    if pairs:
        off = pairs[0][0].start - pairs[0][1].start_ns
        residual = max(abs(e.start - s.start_ns - off) for e, s in pairs)
    main = marks[0].thread if marks else (max(ev_spans, key=lambda e: e.end - e.start).thread if ev_spans else 0)
    on_thread: Dict[int, List[int]] = {}
    for i, e in enumerate(ev_spans):
        on_thread.setdefault(e.thread, []).append(i)

    def span_at(thread: int, t: int) -> Optional[int]:
        for th in (thread, main):
            idx = on_thread.get(th, [])
            j = _innermost([ev_spans[i] for i in idx], t)
            if j is not None:
                return idx[j]
        return None

    launches = {e.corr: e for e in evs if e.kind == "launch"}
    frontend = {e.corr: e for e in evs if e.kind in ("host", "span")}
    device_ns: Dict[int, int] = {}
    outside_device = unlinked = 0
    for d in dev:
        call = launches.get(d.corr) or frontend.get(d.linked)
        i = span_at(call.thread, call.start) if call else None
        unlinked += call is None
        if i is None:
            outside_device += d.end - d.start
        else:
            sid = rec_of[i].id
            device_ns[sid] = device_ns.get(sid, 0) + d.end - d.start
    # idle: the stretch less the union of device operations, split by what covers it
    if marks:
        lo, hi = marks[0].start, marks[0].end
    else:
        lo, hi = (min(d.start for d in dev), max(d.end for d in dev)) if dev else (0, 0)
    busy = trace._merge([(max(d.start, lo), min(d.end, hi)) for d in dev if d.end > lo and d.start < hi])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    idle_ns: Dict[int, int] = {}
    tracer_idle = outside_idle = 0
    for s, e in gaps:
        over_t = [t for t in tracer if t.end > s and t.start < e]
        over_s = [i for i, x in enumerate(ev_spans) if x.end > s and x.start < e]
        cuts = sorted({s, e} | {x for t in over_t for x in (t.start, t.end) if s < x < e}
                      | {x for i in over_s for x in (ev_spans[i].start, ev_spans[i].end) if s < x < e})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) // 2
            if any(t.start <= mid <= t.end for t in over_t):
                tracer_idle += b - a
                continue
            inner = [i for i in over_s if ev_spans[i].start <= mid <= ev_spans[i].end]
            if inner:
                sid = rec_of[max(inner, key=lambda i: ev_spans[i].start)].id
                idle_ns[sid] = idle_ns.get(sid, 0) + b - a
            else:
                outside_idle += b - a
    # the table by name, on the recorder's clock
    children: Dict[int, list] = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    table: Dict[str, Dict[str, float]] = {}
    for s in spans:
        row = table.setdefault(s.name, dict(count=0, host_ms=0.0, self_ms=0.0, device_ms=0.0, idle_ms=0.0))
        dur = s.end_ns - s.start_ns
        kids = [(c.start_ns, c.end_ns) for c in children.get(s.id, [])]
        row["count"] += 1
        row["host_ms"] += dur * 1e-6
        row["self_ms"] += (dur - _covered(kids, s.start_ns, s.end_ns)) * 1e-6
        row["device_ms"] += device_ns.get(s.id, 0) * 1e-6
        row["idle_ms"] += idle_ns.get(s.id, 0) * 1e-6
    return dict(
        device_ns=device_ns, outside_device_ns=outside_device, device_total_ns=sum(d.end - d.start for d in dev),
        idle_ns=idle_ns, tracer_idle_ns=tracer_idle, outside_idle_ns=outside_idle,
        idle_total_ns=sum(e - s for s, e in gaps), table=table, residual_ns=residual,
        n_device_ops=len(dev), unlinked=unlinked, unmatched=unmatched, spans=list(spans),
    )


def format_table(red: Dict, units: int) -> str:
    """The table by span name, a line a name, per unit (epoch or request)
    where ``units``; then what lies outside any span."""
    lines = [f"{'span':<18}{'count':>7}{'host ms':>12}{'self ms':>12}{'device ms':>12}{'idle ms':>10}  (per unit of {units})"]
    for name, r in sorted(red["table"].items(), key=lambda kv: -kv[1]["device_ms"]):
        lines.append(f"{name:<18}{r['count'] / units:>7.2f}{r['host_ms'] / units:>12.4f}{r['self_ms'] / units:>12.4f}"
                     f"{r['device_ms'] / units:>12.4f}{r['idle_ms'] / units:>10.4f}")
    lines.append(f"{'outside':<18}{'':>7}{'':>12}{'':>12}{red['outside_device_ns'] * 1e-6 / units:>12.4f}"
                 f"{red['outside_idle_ns'] * 1e-6 / units:>10.4f}")
    lines.append(f"{'tracer':<18}{'':>7}{'':>12}{'':>12}{'':>12}{red['tracer_idle_ns'] * 1e-6 / units:>10.4f}")
    return "\n".join(lines)


# ---------------------------------------------------------------- metrics
# Each reads ``run.setup_spans`` (the recorder's spans of set-up) or
# ``run.span_stretch`` (``reduce`` of the profiled stretch) and gives None
# where the run has nothing for it.


def _setup(run, name: str) -> list:
    return [s for s in getattr(run, "setup_spans", None) or [] if s.name == name]


def seconds_in(run, name: str) -> Optional[float]:
    """Host seconds of the set-up's spans of ``name`` (``prepare_plan_s``:
    ``prepare.plan``; ``prepare_cost_s``: ``prepare.cost_model``)."""
    got = _setup(run, name)
    return sum(s.seconds for s in got) if got else None


def plan_live_share(run) -> Optional[float]:
    """100 x the live slots over the slots of the set-up's K9 plans."""
    got = _setup(run, "prepare.plan")
    slots = sum(s.attrs["slots"] for s in got)
    return 100.0 * sum(s.attrs["live_slots"] for s in got) / slots if slots else None


def _stretch(run, kind: str):
    red = getattr(run, "span_stretch", None)
    ok = red is not None and red["n_device_ops"] and run.traffic["kind"] == kind and run.trace_units
    return red if ok else None


def _ancestors(red) -> Dict[int, set]:
    """Each span id's names of itself and its ancestors."""
    by_id = {s.id: s for s in red["spans"]}
    out = {}
    for s in red["spans"]:
        names, p = {s.name}, s
        while p.parent is not None and p.parent in by_id:
            p = by_id[p.parent]
            names.add(p.name)
        out[s.id] = names
    return out


def device_ms_under(run, kind: str, names) -> Optional[float]:
    """Device ms a unit launched inside spans named in ``names`` (their
    children's launches included)."""
    red = _stretch(run, kind)
    if red is None:
        return None
    anc = _ancestors(red)
    hit = [sid for sid, a in anc.items() if a & set(names)]
    if not hit:
        return None
    return 1e-6 * sum(red["device_ns"].get(sid, 0) for sid in hit) / run.trace_units


def program_idle_ms(run, kind: str, under: Optional[str] = None) -> Optional[float]:
    """Idle device ms a unit under the program's spans (under ``under`` and
    its children where given), the tracer's left out."""
    red = _stretch(run, kind)
    if red is None or not red["spans"]:
        return None
    anc = _ancestors(red)
    ns = sum(v for sid, v in red["idle_ns"].items() if under is None or under in anc.get(sid, ()))
    return 1e-6 * ns / run.trace_units


def metrics(run) -> Dict[str, float]:
    """The span metrics this run has: ``prepare_plan_s``, ``prepare_cost_s``,
    ``plan_live_share``, ``agg_ms.<kind>``, ``eval_ms.train``,
    ``program_idle_ms.<kind>``."""
    got = {
        "prepare_plan_s": seconds_in(run, "prepare.plan"),
        "prepare_cost_s": seconds_in(run, "prepare.cost_model"),
        "plan_live_share": plan_live_share(run),
        "agg_ms.train": device_ms_under(run, "train", ("agg", "agg.backward")),
        "agg_ms.infer": device_ms_under(run, "infer", ("agg",)),
        "eval_ms.train": device_ms_under(run, "train", ("loop.eval",)),
        "program_idle_ms.train": program_idle_ms(run, "train"),
        "program_idle_ms.infer": program_idle_ms(run, "infer", "model.forward"),
    }
    return {k: v for k, v in got.items() if v is not None}
