"""``infer``: one closed-loop client of full-graph forward requests
(``eval()``, ``torch.no_grad()``) on the prepared adjacency.

Before each request the harness overwrites ``refresh_share`` of the
nodes' features, drawn from the request's seed, and synchronises; the
request's latency runs from there to the synchronise after the forward.
The refresh is the harness's, so the window's time is the sum of the
requests' latencies. ``warm_requests`` in set-up; then as many as fill
``--seconds`` at the warm requests' least latency (at least
``min_requests``). ``checked_requests`` of the window's, drawn from the
seed with the last one among them, are held to the reference, and each
of ``run.variants`` (the control) is held to it on the same requests.
"""

from __future__ import annotations

import math
import random
import time

import torch

from portbench import compare, gen
from portbench.drivers import common
from portbench.reference.common import EXACT, Adjacency

TRACE_REQUESTS = 10
setup = common.full_graph


def unit_ops(run):
    return run.fam.request_ops(run.cfg, run.graph.num_nodes, run.nnz, run.n_edges, run.n_params)


def drive(run) -> None:
    dev, mix, g = run.device, run.traffic, run.graph
    share = mix["refresh_share"]
    x0 = g.x.detach().to("cpu", copy=True)
    x = g.x
    model = run.model.eval()
    lat, kept = [], {}
    k = 0

    def request(keep: bool = False) -> None:
        nonlocal k
        gen.refresh(x, share, run.seed_of(f"request{k}"))
        common.sync(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(run.prep, x)
        common.sync(dev)
        lat.append(time.perf_counter() - t0)
        if keep:
            kept[k] = out
        k += 1

    for _ in range(mix["warm_requests"]):
        request()
    run.parts["warm_up"] = sum(lat)
    n_req = max(mix["min_requests"], math.ceil(run.seconds / min(lat)))
    rng = random.Random(run.seed_of("checked"))
    first = k
    pick = set(rng.sample(range(first, first + n_req - 1), mix["checked_requests"] - 1))
    pick.add(first + n_req - 1)
    lat.clear()
    run.start_window()
    for _ in range(n_req):
        request(keep=k in pick)
    run.window_s = sum(lat)
    run.units, run.latencies = n_req, list(lat)
    run.read_memory()
    if run.trace:
        run.trace_units = TRACE_REQUESTS
        run.traced = common.traced(run, lambda: [request() for _ in range(TRACE_REQUESTS)])
    outs = [kept[i] for i in sorted(kept)]
    common.free_program(run)

    adj = Adjacency(torch.as_tensor(run.edges_host, device=dev), g.num_nodes)
    precs = dict(reference=EXACT, **{name: v["prec"] for name, v in run.variants.items()})
    got = {name: [] for name in precs}
    xr = x0.to(dev, copy=True)
    with torch.no_grad():
        for i in range(max(kept) + 1):
            gen.refresh(xr, share, run.seed_of(f"request{i}"))
            if i in kept:
                for name, prec in precs.items():
                    with prec.gemms():
                        got[name].append(run.fam.reference.forward(run.cfg, adj, run.theta0, xr, None, prec))
    refs = got.pop("reference")
    run.numbers = compare.infer_numbers(outs, refs)
    for name, alts in got.items():
        run.variant_numbers[name] = compare.infer_numbers(alts, refs)
