"""What the metric readers share: each reader in ``metrics/`` is
``read(run)``, giving its number or None where the run has nothing for it
(the harness then leaves the metric out of the line)."""

from __future__ import annotations

import math


def per_unit_ms(run, kind: str):
    """Window milliseconds an epoch or a request, in a cell of ``kind``."""
    if run.traffic["kind"] != kind or not run.units:
        return None
    return 1e3 * run.window_s / run.units


def p95_ms(run):
    lat = sorted(run.latencies)
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]


def mfu(run, kind: str):
    """Least time of an epoch or request's work at the peaks over its
    measured time in the window, in percent."""
    ms = per_unit_ms(run, kind)
    return None if ms is None else 100.0 * run.least() * 1e3 / ms


def kernel_roofline(run, kind: str):
    """Least time of the aggregation work in the traced
    stretch over the device time of the port's own kernels there."""
    t = run.traced
    if run.traffic["kind"] != kind or not t or t["own_s"] <= 0:
        return None
    return 100.0 * run.least("kernel") * run.trace_units / t["own_s"]


def torch_ops_ms(run, kind: str):
    t = run.traced
    if run.traffic["kind"] != kind or not t:
        return None
    return 1e3 * t["other_s"] / run.trace_units


def device_idle(run, kind: str):
    t = run.traced
    if run.traffic["kind"] != kind or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - min(t["busy_s"], t["window_s"]) / t["window_s"])
