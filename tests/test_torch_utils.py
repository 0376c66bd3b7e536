"""The port's ``utils`` (profiling, power, watchdog) against the JAX
package's where one computes the same thing, on the CPU: no test sleeps
for its result (the recorder runs on a fake sampler and a fake clock)."""

import itertools
import os
import threading

import pytest
import torch

from sgracex1_tpu.utils import power as jpower
from sgracex1_tpu_torch.utils import power, profiling, watchdog


def _fake_clock(step=0.5):
    ticks = itertools.count()
    return lambda: step * next(ticks)


def _sampler(watts):
    """A constant sampler, and an event set at its first call (the block
    waits for the recorder's thread to take a sample, not for a time)."""
    first = threading.Event()

    def sample():
        first.set()
        return watts

    return sample, first


def test_power_recorder_integrates_on_a_fake_clock():
    sample, first = _sampler(120.0)
    rec = power.PowerRecorder(sample, clock=_fake_clock())
    with rec.record(interval_s=0.001):
        assert first.wait(10.0)
    assert len(rec.frame) >= 2 and rec.duration_s > 0
    assert rec.mean_w == 120.0 and rec.energy_j == pytest.approx(120.0 * (rec.duration_s - rec.frame[0][0]))
    # a failing sample is kept as NaN and left out of the mean and the integral
    calls = itertools.count()
    flaky = lambda: 60.0 if next(calls) % 2 else (_ for _ in ()).throw(OSError("sensor"))
    rec = power.PowerRecorder(flaky, clock=_fake_clock())
    with rec.record(interval_s=0.001):
        pass
    vals = [w for _, w in rec.frame]
    assert rec.mean_w in (0.0, 60.0) and all(w != w or w == 60.0 for w in vals)


@pytest.mark.parametrize("sec,u", [(0.5, 0.0), (2.0, 0.37), (1e-3, 1.0), (3.0, 1.7), (1.0, -0.2)])
def test_energy_estimate_matches_jax(sec, u):
    got = power.energy_estimate(sec, u, idle_w=80.0, busy_w=700.0)
    want = jpower.energy_estimate(sec, u, idle_w=80.0, busy_w=700.0)
    assert {k: got[k] for k in ("watts", "joules", "utilization")} == {
        k: want[k] for k in ("watts", "joules", "utilization")}


def test_energy_for_cost_reads_the_roofline():
    from sgracex1_tpu_torch.utils.roofline import CostModel, H100_PEAKS

    c = CostModel({"bf16": 0.0}, H100_PEAKS.memory_bytes_s * 1e-3)  # 1 ms of bytes at the peak
    e = power.energy_for_cost(c, 2e-3, idle_w=100.0, busy_w=700.0)
    assert e["bound"] == "memory" and e["utilization"] == 0.5 and e["watts"] == 400.0


def test_gpu_power_w_raises_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvidia-smi"):
        power.gpu_power_w()


def test_run_with_deadline_returns_and_raises():
    assert watchdog.run_with_deadline(lambda: 7, 5.0) == 7
    with pytest.raises(ValueError, match="inner"):
        watchdog.run_with_deadline(lambda: (_ for _ in ()).throw(ValueError("inner")), 5.0)
    release = threading.Event()
    try:
        with pytest.raises(watchdog.DeviceTimeout):
            watchdog.run_with_deadline(lambda: release.wait(30.0), 0.05)
    finally:
        release.set()
    assert issubclass(watchdog.DeviceTimeout, TimeoutError)


def test_device_alive_is_false_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert watchdog.device_alive(5.0) is False
    assert watchdog.device_alive_retry(attempts=2, seconds=5.0, backoff_s=0.0) is False


def test_timer_and_profiler_trace(tmp_path):
    with profiling.Timer(sync=False) as t:
        sum(range(1000))
    assert t.elapsed > 0
    with profiling.profiler_trace(None) as prof:
        assert prof is None
    with profiling.profiler_trace(str(tmp_path)) as prof:
        torch.ones(4).sum()
    assert prof is not None and os.listdir(tmp_path)
