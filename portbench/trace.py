"""Reduction of a ``torch.profiler`` trace of a stretch of the window to
device time, idle share, the port's own kernels' time and the breakdown.

A device operation is a kernel, copy or set on the card. The port's own
kernels are those whose name is a ``__global__`` function of the port's
``csrc/`` sources, found when the run starts, so a kernel added later is
counted without an edit here. Busy time is the union of the device
operations' intervals; idle is the rest of the stretch's wall time.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Tuple

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?([A-Za-z_]\w*)\s*[(<]"
)
MARK = "portbench.stretch"


def own_kernels(csrc: str) -> set:
    """Names of the ``__global__`` functions in the ``.cu``/``.cuh`` files of ``csrc``."""
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu*")):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return names


def base_name(kernel: str) -> str:
    """The function's own name in a profiler kernel name such as
    ``void ns::name<1, 4>(Args)``."""
    head = kernel.split("(")[0].split("<")[0].strip()
    return head.split()[-1].split("::")[-1] if head else kernel


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(prof, own: set, wall_s: float) -> Dict:
    """Busy and window seconds, device seconds in the port's own kernels and
    in the rest, and the breakdown (ten longest device operations by total
    time, ten longest idle gaps named by the innermost host operation
    running at their middle)."""
    from torch.autograd import DeviceType

    dev, cpu, mark = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.name == MARK:  # the stretch's range, also annotated on the device
            if e.device_type != DeviceType.CUDA:
                mark = (tr.start, tr.end)
        elif e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        else:
            cpu.append((tr.start, tr.end, e.name))
    by_name: Dict[str, float] = {}
    own_us = 0.0
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if base_name(name) in own:
            own_us += e - s
    busy = _merge([(s, e) for s, e, _ in dev])
    lo, hi = mark if mark else ((busy[0][0], busy[-1][1]) if busy else (0.0, 0.0))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (s + e)
        over = [c for c in cpu if c[0] <= mid <= c[1]]
        named.append([max(over, key=lambda c: c[0])[2] if over else "host", (e - s) * 1e-6])
    total_us = sum(by_name.values())
    return dict(
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        window_s=wall_s,
        device_s=total_us * 1e-6,
        own_s=own_us * 1e-6,
        other_s=(total_us - own_us) * 1e-6,
        device_ops=[[n, t * 1e-6] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=named,
        n_device_ops=len(dev),
    )
