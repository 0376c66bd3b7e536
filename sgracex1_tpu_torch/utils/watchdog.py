"""Deadline watchdog for device work, as ``sgracex1_tpu.utils.watchdog``.

The reference spin-polls the accelerator's done flag with no timeout and
hangs if it stalls. ``run_with_deadline`` runs a callable in a daemon
thread and raises ``DeviceTimeout`` if it does not finish in time; it
cannot cancel the stuck call, but the process can report and exit instead
of hanging its caller. ``device_alive`` probes the CUDA card with a small
op and ``torch.cuda.synchronize``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable


class DeviceTimeout(TimeoutError):
    """A device operation exceeded its deadline."""


def run_with_deadline(fn: Callable[[], Any], seconds: float) -> Any:
    """Run ``fn()`` with a wall-clock deadline; raise ``DeviceTimeout`` on
    a miss, re-raise what ``fn`` raised, else return its result."""
    result: list = []
    error: list = []

    def worker():
        try:
            result.append(fn())
        except BaseException as e:  # noqa: BLE001 -- re-raised in the caller
            error.append(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        raise DeviceTimeout(f"device operation exceeded its {seconds:.0f} s deadline")
    if error:
        raise error[0]
    return result[0]


def device_alive(seconds: float = 30.0) -> bool:
    """Liveness probe: a sum on the CUDA card, synchronised, must come back
    right within ``seconds``. False without a card."""

    def probe():
        import torch

        if not torch.cuda.is_available():
            return False
        s = float(torch.ones((8, 8), device="cuda").sum())
        torch.cuda.synchronize()
        return s == 64.0

    try:
        return bool(run_with_deadline(probe, seconds))
    except (DeviceTimeout, RuntimeError):
        return False


def device_alive_retry(attempts: int = 3, seconds: float = 60.0, backoff_s: float = 5.0) -> bool:
    """``device_alive`` up to ``attempts`` times, sleeping ``backoff_s``
    times the attempt number between them."""
    for i in range(attempts):
        if device_alive(seconds):
            return True
        if i + 1 < attempts:
            time.sleep(backoff_s * (i + 1))
    return False
