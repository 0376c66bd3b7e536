"""PyTorch Geometric's products GAT through the port (``GATSkipModel`` on
``prepare_from_config``'s ``pallas`` adjacency, the plan attention) against
the benchmark's plain reference (``portbench/reference/gat.py``) on seeded
weights, the ``gat`` family's count of work, and a run of the
``gat-products.train`` cell on the CPU with its timed path broken.

Small sizes on the CPU: 4096 nodes of the cell's graph, where the cost
model takes the ``pallas`` kind as on the card at 2^20, 4 heads of 32 hidden
features where the cell has 128. The model's self-loops run on the plan
attention whatever layout the prep priced cheaper: ``gat_self_loops``
builds no mask tile, and the harness's prepare, which does not pass it,
builds a full-cover flash layout at this size that the layer leaves
unused."""

import json
import os

import pytest
import torch

from portbench import counts as C
from portbench import gen
from portbench.families import gat as fam
from portbench.reference import gat as ref_gat
from portbench.reference.common import EXACT, Adjacency, dropout_mask, masked_xent

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096
HIDDEN = 32


def _cfg(**kw):
    with open(os.path.join(ROOT, "portbench", "configs", "gat-products.json")) as f:
        return dict(json.load(f), num_nodes=N, **kw)


@pytest.fixture(scope="module")
def setting():
    from sgracex1_tpu_torch.config import SGRACEConfig
    from sgracex1_tpu_torch.graph.normalize import sym_norm
    from sgracex1_tpu_torch.ops.dispatch import prepare_from_config

    c = _cfg(hidden_channels=HIDDEN)
    g = gen.graph(c, 6, "cpu")
    A = sym_norm(g.edges.numpy(), N)
    prep = prepare_from_config(A, SGRACEConfig(**c["prepare"]), for_gat=True, gat_self_loops=True, device="cpu")
    # the kind and the attention layout the cell's prepare takes on the card
    assert prep.kind == "pallas" and prep.gat_on_plan and prep.gat_bsr is None
    return c, g, prep, Adjacency(g.edges, N)


def _model(c, theta):
    m = fam.program_model(c)
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(theta[k])
    return m


def test_parameters_are_the_references_leaves():
    c = _cfg()
    m = fam.program_model(c)
    want = {name: shape for name, shape, _ in ref_gat.leaves(c)}
    assert {k: tuple(p.shape) for k, p in m.named_parameters()} == want
    assert want["conv1.weight"] == (100, 512) and want["conv3.weight"] == (512, 188)
    assert want["conv3.bias"] == (47,) and want["skip3.weight"] == (47, 512)


def test_logits_match_the_reference(setting):
    c, g, prep, adj = setting
    theta = gen.weights(ref_gat.leaves(c), 11, "cpu")
    m = _model(c, theta)
    with torch.no_grad():
        out = m.eval()(prep, g.x)
        want = ref_gat.forward(c, adj, theta, g.x, None, EXACT)
    # bf16 rows of Wh in the port's attention, f32 everywhere in the reference
    assert float((out - want).abs().max() / want.abs().max()) < 5e-3


def test_a_training_step_matches_the_reference(setting):
    """A step in training mode: the same dropout masks (one draw of the
    loop's generator), the loss and every leaf's gradient."""
    c, g, prep, adj = setting
    theta = gen.weights(ref_gat.leaves(c), 12, "cpu")
    m = _model(c, theta).train()
    loss = masked_xent(m(prep, g.x, generator=torch.Generator().manual_seed(5)), g.y, g.train_mask)
    loss.backward()
    keep = dropout_mask(ref_gat.hidden_shape(c, N), 5, 0, c["dropout"], "cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
    want = masked_xent(ref_gat.forward(c, adj, leaves, g.x, keep, EXACT), g.y, g.train_mask)
    grads = dict(zip(leaves, torch.autograd.grad(want, list(leaves.values()))))
    assert abs(float(loss.detach()) - float(want.detach())) / float(want.detach()) < 1e-4
    for k, p in m.named_parameters():
        gap = float((p.grad - grads[k]).norm() / grads[k].norm())
        assert gap < 2e-2, (k, gap)


def test_attention_count_against_a_hand_worked_case():
    # 3 rows, 7 slots, 2 heads of 8: a slot 2 x (2 x 8 + 6) flops, reads 32 B
    # of Wh, 8 B of its pair and 8 B of s2; a row 2 x 4 (s1) + 2 x 32 (out)
    # + 2 x 8 (m, l)
    o = fam.attention("a", 3, 7, 2, 8)
    assert o.flops == 7 * 2 * 22 and o.kind == "kernel"
    assert o.bytes == 7 * (32 + 8 + 8) + 3 * (8 + 64 + 16)
    r = fam.attention_bwd_rows("r", 3, 7, 2, 8)
    assert r.bytes == 7 * 48 + 3 * (32 + 48)  # gO row (bf16) and s1, m, l, t, u1, u2
    k = fam.attention_bwd_cols("k", 3, 7, 2, 8)
    assert k.flops == 7 * 2 * 42
    assert k.bytes == 7 * (32 + 8 + 32) + 3 * (32 + 64 + 16)  # Wh, dWh, s2 and ds2 a column


def test_epoch_count_has_every_attention_pass_and_gemm():
    c = _cfg()
    ops = fam.epoch_ops(c, 10, 60, 50, 100)
    kernels = [o.name for o in ops if o.kind == "kernel"]
    # 3 layers: the training forward, the row and column passes, the evaluation forward
    assert sorted(kernels) == sorted(
        [f"conv{k}.att" for k in (1, 2, 3)] * 2 + [f"conv{k}.att.bwd_{p}" for k in (1, 2, 3) for p in ("rows", "cols")]
    )
    fwd = sum(o.flops for o in ops if o.name.endswith((".gemm", ".scores")))
    # twice (training, evaluation): 2 n (100 x 512 + 512 x 8 + 512 x 512 + 512 x 8 + 512 x 188 + 188 x 8)
    # for the convolutions and the scores, 2 n (100 x 512 + 512 x 512 + 512 x 47) for the skips
    per = 100 * 512 + 512 * 8 + 512 * 512 + 512 * 8 + 512 * 188 + 188 * 8 + 100 * 512 + 512 * 512 + 512 * 47
    assert fwd == 2 * 2 * 10 * per
    assert C.least_time(ops, "kernel") > 0


def test_a_frozen_step_reads_not_correct(monkeypatch):
    """The cell's run on the CPU with each training step leaving the state
    unchanged comes out not correct: the parameters' change reads 1."""
    from portbench import run as R
    from portbench.tests.conftest import QUICK, bench
    from sgracex1_tpu_torch.train import loop

    def frozen(state, loss_fn):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        state.step += 1
        return loss

    b = bench()
    cell = {w["name"]: w for w in b["workloads"]}["gat-products.train"]
    kw = dict(overrides=dict(num_nodes=N, hidden_channels=16), traffic=QUICK)
    sound = R.run_cell(b, cell, 3, 0.1, False, torch.device("cpu"), **kw)
    monkeypatch.setattr(loop, "_train_step", frozen)
    out = R.run_cell(b, cell, 3, 0.1, False, torch.device("cpu"), **kw)
    assert not out["correct"]
    assert out["checks"]["step_gap"]["value"] == pytest.approx(1.0)
    assert sound["checks"]["step_gap"]["value"] < 0.1


def test_the_loops_prepare_takes_the_plan_attention_for_the_model(setting):
    """The training loops' prepare passes the model's ``attention_self_loops``
    on: ``auto`` prepares the pallas kind with the plan attention and no mask
    tile, without pricing the flash layouts."""
    from sgracex1_tpu_torch.config import SGRACEConfig
    from sgracex1_tpu_torch.graph.normalize import sym_norm
    from sgracex1_tpu_torch.train.loop import _prepare_backend

    c, g, _, _ = setting
    A = sym_norm(g.edges.numpy(), N)
    prep = _prepare_backend(A, SGRACEConfig(**c["prepare"]), fam.program_model(c), "auto", "cpu")
    assert prep.kind == "pallas" and prep.gat_on_plan and prep.gat_bsr is None
    assert set(prep.choice["gat_costs"]) == {"plan"}
