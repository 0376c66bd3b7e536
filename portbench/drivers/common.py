"""What the drivers share: the full-graph set-up through the port's
``sym_norm`` and ``prepare_from_config``, the model from the seed's
weights, the profiled stretch and the release of the program's state."""

from __future__ import annotations

import gc
import json
import time

import torch

from portbench import gen, trace


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(run, part: str, fn):
    """``fn()``, its seconds (to the device's end) kept as a set-up part."""
    t0 = time.perf_counter()
    out = fn()
    sync(run.device)
    run.parts[part] = time.perf_counter() - t0
    return out


def full_graph(run) -> None:
    """The port's normalized, prepared adjacency of the whole graph (the
    cost model's kind, at the configuration's ``prepare`` settings of
    ``SGRACEConfig``) and the model with the seed's weights."""
    from sgracex1_tpu_torch.config import SGRACEConfig
    from sgracex1_tpu_torch.graph.normalize import sym_norm
    from sgracex1_tpu_torch.ops.dispatch import prepare_from_config

    cfg, n = run.cfg, run.graph.num_nodes
    A = timed(run, "sym_norm", lambda: sym_norm(run.edges_host, n))
    run.nnz = A.nnz
    run.prep = timed(run, "prepare", lambda: prepare_from_config(
        A, SGRACEConfig(**cfg.get("prepare", {})), for_gat=run.fam.uses_attention, device=run.device
    ))
    del A
    run.model = timed(run, "model", lambda: model(run))
    run.log(f"prepare: kind {run.prep.kind}, choice " + json.dumps(dict(run.prep.choice or {}), default=str))


def model(run):
    """The family's port model with every leaf from the seed."""
    m = run.fam.program_model(run.cfg).to(run.device)
    run.theta0 = gen.weights(run.fam.reference.leaves(run.cfg), run.seed_of("weights"), run.device)
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(run.theta0[name])
    run.n_params = sum(p.numel() for p in m.parameters())
    return m


def traced(run, fn):
    """``fn()`` under the profiler, reduced by ``trace.reduce`` with its
    wall time on the host clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync(run.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(trace.MARK):
            fn()
            sync(run.device)
        wall = time.perf_counter() - t0
    return trace.reduce(prof, run.own_kernels, wall)


def free_program(run) -> None:
    """Drop the system under test before the reference runs on the card."""
    run.model = run.prep = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
