"""``train``: closed-loop full-graph training through the port's
``train_node_classifier`` on the prepared adjacency.

Set-up calls the loop ``first_calls`` times (``[1, 2]``: one epoch, then
two; each call starts a fresh Adam and dropout generator), and these are
the steps the reference follows. A further call of ``estimate_epochs``
sets the window's length: its time less the second call's, over the
epochs between them, is an epoch's time without a call's fixed cost, so
every run's window is one call of nearly the same count of epochs
(``--seconds`` over that time, at least ``min_epochs``).

``run.variants`` (empty in the benchmark's runs; ``portbench/control.py``
sets them) puts the reference in the program's place: at lower precision
(the control), with half of the batch left out, or with steps that leave
the state unchanged (a learning rate of 0); their numbers against the
reference land in ``run.variant_numbers``.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from portbench import compare
from portbench.drivers import common
from portbench.reference.common import EXACT, Adjacency, train_steps

TRACE_EPOCHS = 3
setup = common.full_graph


def unit_ops(run):
    return run.fam.epoch_ops(run.cfg, run.graph.num_nodes, run.nnz, run.n_edges, run.n_params)


def drive(run) -> None:
    from sgracex1_tpu_torch.config import SGRACEConfig
    from sgracex1_tpu_torch.graph.datasets import NodeClassificationData
    from sgracex1_tpu_torch.train.loop import train_node_classifier

    g, dev, mix = run.graph, run.device, run.traffic
    data = NodeClassificationData(run.edges_host, g.x, g.y, g.train_mask, g.val_mask, g.test_mask)
    base = SGRACEConfig(learning_rate=run.cfg["lr"])

    def call(epochs: int, seed: int):
        return train_node_classifier(
            run.model, data, base.replace(num_epochs=epochs), seed=seed, prepare=run.prep, device=dev
        )

    def timed_call(epochs: int, seed: int):
        t0 = time.perf_counter()
        out = call(epochs, seed)
        common.sync(dev)
        return out, time.perf_counter() - t0

    calls = [dict(seed=run.seed_of(f"call{i}"), epochs=k) for i, k in enumerate(mix["first_calls"])]
    names = [n for n, _ in run.model.named_parameters()]
    losses, grad_norms = [], None
    for i, c in enumerate(calls):
        (state, hist), dt = timed_call(c["epochs"], c["seed"])
        run.parts["first_step" if i == 0 else f"warm_up{i}"] = dt
        losses += hist.loss
        if grad_norms is None:  # after one Adam step, exp_avg = (1 - beta1) * g
            st = state.optimizer.state
            grad_norms = compare.norms({
                n: st[p]["exp_avg"] / 0.1 if p in st else torch.zeros_like(p)
                for n, p in zip(names, state.model.parameters())
            })
    with torch.no_grad():
        change = compare.norms({n: p - run.theta0[n] for n, p in run.model.named_parameters()})
    prog = dict(losses=losses, grad_norms=grad_norms, change_norms=change)
    del state, hist
    k = mix["estimate_epochs"]
    _, dk = timed_call(k, run.seed_of("estimate"))
    run.parts["estimate"] = dk
    epoch_s = (dk - dt) / (k - calls[-1]["epochs"])

    n_epochs = max(mix["min_epochs"], round(run.seconds / epoch_s))
    run.start_window()
    t0 = time.perf_counter()
    call(n_epochs, run.seed_of("window"))
    common.sync(dev)
    run.window_s = time.perf_counter() - t0
    run.units = n_epochs
    run.read_memory()
    if run.trace:
        run.trace_units = TRACE_EPOCHS
        run.traced = common.traced(run, lambda: call(TRACE_EPOCHS, run.seed_of("trace")))
    common.free_program(run)

    adj = Adjacency(torch.as_tensor(run.edges_host, device=dev), g.num_nodes)
    fwd = lambda th, x, keep, prec: run.fam.reference.forward(run.cfg, adj, th, x, keep, prec)
    hidden = run.fam.reference.hidden_shape(run.cfg, g.num_nodes)

    def reference(prec, data=g, lr=run.cfg["lr"]):
        return train_steps(fwd, run.theta0, data, calls, lr, run.cfg["dropout"], hidden, prec)

    ref = reference(EXACT)
    run.numbers = compare.train_numbers(prog, ref, run.theta0)
    for name, v in run.variants.items():
        data = g
        if v.get("half"):  # half of the batch left out, the mean over the rest
            half = g.train_mask & (torch.arange(g.num_nodes, device=dev) % 2 == 0)
            data = SimpleNamespace(x=g.x, y=g.y, train_mask=half)
        alt = reference(v["prec"], data, 0.0 if v.get("frozen") else run.cfg["lr"])
        run.variant_numbers[name] = compare.train_numbers(compare.as_program(alt, run.theta0), ref, run.theta0)
