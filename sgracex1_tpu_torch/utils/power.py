"""Power and energy recording, as ``sgracex1_tpu.utils.power``.

The reference samples a board power rail during training with a pynq
``DataRecorder`` (``recorder.record(0.2)``, results in ``recorder.frame``).
``PowerRecorder`` keeps that API over any sampler callable and integrates
W to J; ``gpu_power_w`` is such a sampler for an NVIDIA card (the board
draw ``nvidia-smi`` reports). ``energy_estimate`` is the model-based
estimate where no sensor is read: the wall time times a power interpolated
between an idle and a busy draw by the roofline utilization. The JAX
module defaults that envelope to a nominal TPU's; here the caller gives it
(for example the card's measured idle draw and its power limit).
"""

from __future__ import annotations

import contextlib
import shutil
import subprocess
import threading
import time
from typing import Callable, List, Optional, Tuple


class PowerRecorder:
    """Sample a power sensor while a block runs; integrate to energy.

    ``sampler`` is a zero-argument callable returning watts, ``clock`` the
    seconds clock the samples are stamped with. ``record()`` is a context
    manager around the work; ``frame`` holds ``(t_rel_s, watts)``, a failed
    sample as NaN."""

    def __init__(self, sampler: Callable[[], float], clock: Callable[[], float] = time.time):
        self.sampler = sampler
        self.clock = clock
        self.frame: List[Tuple[float, float]] = []
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    @contextlib.contextmanager
    def record(self, interval_s: float = 0.2):
        self.frame = []
        self._stop = threading.Event()
        t0 = self.clock()

        def loop():
            while not self._stop.is_set():
                try:
                    w = float(self.sampler())
                except Exception:  # a sensor glitch: keep the slot as NaN
                    w = float("nan")
                self.frame.append((self.clock() - t0, w))
                self._stop.wait(interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        try:
            yield self
        finally:
            self._stop.set()
            self._thread.join(timeout=5.0)
            # a closing sample, so the last interval integrates
            try:
                self.frame.append((self.clock() - t0, float(self.sampler())))
            except Exception:
                pass

    @property
    def duration_s(self) -> float:
        return self.frame[-1][0] if self.frame else 0.0

    @property
    def mean_w(self) -> float:
        vals = [w for _, w in self.frame if w == w]  # drop NaNs
        return sum(vals) / len(vals) if vals else 0.0

    @property
    def energy_j(self) -> float:
        """Trapezoidal integral of the recorded (t, W) samples."""
        pts = [(t, w) for t, w in self.frame if w == w]
        return sum(0.5 * (w0 + w1) * (t1 - t0) for (t0, w0), (t1, w1) in zip(pts, pts[1:]))


def _smi(query: str, index: int) -> float:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi is not on the PATH: no power reading")
    out = subprocess.run(
        [exe, f"--query-gpu={query}", "--format=csv,noheader,nounits", "-i", str(index)],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip()
    return float(out.splitlines()[0])


def gpu_power_w(index: int = 0) -> float:
    """The board power draw of card ``index`` in watts, as ``nvidia-smi
    --query-gpu=power.draw`` reports it. Raises where there is no
    ``nvidia-smi`` or it reports no number; never returns a made-up 0."""
    return _smi("power.draw", index)


def gpu_power_limit_w(index: int = 0) -> float:
    """The power limit of card ``index`` in watts (``power.limit``)."""
    return _smi("power.limit", index)


def energy_estimate(sec: float, utilization: float, *, idle_w: float, busy_w: float) -> dict:
    """Energy of ``sec`` seconds at ``utilization`` (the achieved fraction
    of the binding resource's peak, ``CostModel.roofline(sec)
    ["pct_roofline"] / 100``): power linear between ``idle_w`` and
    ``busy_w``, the first-order activity-proportional model."""
    u = min(max(utilization, 0.0), 1.0)
    watts = idle_w + (busy_w - idle_w) * u
    return dict(
        watts=round(watts, 1),
        joules=round(watts * sec, 4),
        utilization=round(u, 3),
        model=f"linear idle={idle_w}W busy={busy_w}W",
    )


def energy_for_cost(cost, sec: float, *, idle_w: float, busy_w: float, **roofline_kw) -> dict:
    """``energy_estimate`` of one kernel call from its roofline cost model
    (``utils.roofline.CostModel``) and measured seconds."""
    r = cost.roofline(sec, **roofline_kw)
    out = energy_estimate(sec, r["pct_roofline"] / 100.0, idle_w=idle_w, busy_w=busy_w)
    out["bound"] = r["bound"]
    return out
