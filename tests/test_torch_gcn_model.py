"""The serving slice at small size: power-law graph -> sym_norm -> degree
order -> hybrid prepare -> 2-layer GCNModel, with the JAX model's
parameters converted by params_from_jax. Plus the package boundary: no
jax import, gradients through the aggregation, unported options raise."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sgracex1_tpu.graph import datasets as j_ds
from sgracex1_tpu.graph import normalize as j_norm
from sgracex1_tpu.graph import reorder as j_reorder
from sgracex1_tpu.nn.models import GCNModel as JGCN
from sgracex1_tpu.ops import dispatch as jdis
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.graph import datasets as t_ds
from sgracex1_tpu_torch.graph import reorder as t_reorder
from sgracex1_tpu_torch.nn import GCNConv, ReluHW, params_from_jax

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _slice(n=2048, F=32, hidden=64, C=16, tb=128):
    """Both packages' slice inputs; the JAX hybrid threshold at this tb is
    passed to the port so both split the same edges."""
    d = j_ds.powerlaw_node_classification(n=n, num_features=F, num_classes=C, seed=0)
    A = j_norm.sym_norm(d.edge_index, n)
    perm = j_reorder.degree_order(A)
    A, _ = j_reorder.permute_graph(A, perm)
    jp = jdis.prepare_adjacency(A, method="hybrid", tb=tb, build_transpose=False)
    thresh = int(np.ceil(
        jdis._tile_cost_s(tb, jdis._tile_itemsize(tb, True, 2))
        / (jdis._REST_SLOT_S + jdis._REST_CHUNK_S / jdis._REST_K)
    ))

    e = t_ds.powerlaw_node_classification(n=n, num_features=F, num_classes=C, seed=0)
    T = pt.sym_norm(e.edge_index, n)
    tperm = t_reorder.degree_order(T)
    T, _ = t_reorder.permute_graph(T, tperm)
    tp = pt.prepare_adjacency(
        T, method="hybrid", tb=tb, rest_thresh=thresh, build_transpose=False, device="cpu"
    )
    x = d.x[perm]
    model = JGCN(num_features=F, hidden_channels=hidden, num_classes=C)
    variables = model.init(jax.random.PRNGKey(0), jp, jnp.asarray(x))
    return model, variables, jp, tp, x, e.x[tperm]


def test_slice_logits_match_jax():
    model, variables, jp, tp, x, tx = _slice()
    np.testing.assert_array_equal(x, tx)
    assert tp.kind == "hybrid" and tp.fused is not None and tp.r1_row is not None
    assert tp.rest is not None and tp.fused.num_rest_chunks > 0
    logits_j = np.asarray(model.apply(variables, jp, jnp.asarray(x)))
    net = pt.GCNModel(32, 64, 16)
    net.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    net.eval()
    with torch.no_grad():
        logits_t = net(tp, torch.from_numpy(tx))
    assert logits_t.shape == (2048, 16) and torch.isfinite(logits_t).all()
    # two bf16-rounded aggregations
    np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=2e-2, atol=2e-2)
    # the fused K2 route against the f32 edge path (the always-correct spec)
    with torch.no_grad():
        ref = net(pt.prepare_adjacency(tp.A, method="xla", device="cpu"), torch.from_numpy(tx))
    np.testing.assert_allclose(logits_t.numpy(), ref.numpy(), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("blocks", [(1024, 1024, 1024), (128, 128, 2048)])
def test_slice_logits_on_the_pallas_kind_match_jax(blocks):
    """The same slice through prepare_from_config(use_pallas=True) in both
    packages: K9's roundings are the Pallas kernel's, so 1e-4 (relative to
    the logits' size) where the K2 route needs 2e-2."""
    from sgracex1_tpu.config import SGRACEConfig as JConfig

    model, variables, jp, tp, x, tx = _slice(n=1024)
    kw = dict(use_pallas=True, row_block=blocks[0], col_block=blocks[1], edge_block=blocks[2])
    jpp = jdis.prepare_from_config(jp.A, JConfig(**kw))
    tpp = pt.prepare_from_config(tp.A, pt.SGRACEConfig(**kw), device="cpu")
    assert tpp.kind == jpp.kind == "pallas" and tpp.plan.be == blocks[2]
    logits_j = np.asarray(model.apply(variables, jpp, jnp.asarray(x)))
    net = pt.GCNModel(32, 64, 16)
    net.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    net.eval()
    with torch.no_grad():
        logits_t = net(tpp, torch.from_numpy(tx))
    assert logits_t.shape == (1024, 16) and torch.isfinite(logits_t).all()
    scale = float(np.abs(logits_j).max())
    np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=1e-4, atol=1e-4 * max(scale, 1.0))
    with torch.no_grad():
        ref = net(pt.prepare_adjacency(tp.A, method="xla", device="cpu"), torch.from_numpy(tx))
    np.testing.assert_allclose(logits_t.numpy(), ref.numpy(), rtol=5e-2, atol=5e-2)


def test_params_from_jax_layout():
    model = JGCN(num_features=8, hidden_channels=4, num_classes=3, num_layers=3)
    A = j_norm.sym_norm(np.array([[0, 1], [1, 0]]), 2)
    variables = model.init(jax.random.PRNGKey(1), A, jnp.ones((2, 8)))
    assert "telemetry" in variables
    sd = params_from_jax(variables)
    assert list(sd) == ["conv1.weight", "conv2.weight", "conv3.weight", "head.weight", "head.bias"]
    np.testing.assert_array_equal(sd["conv1.weight"].numpy(), np.asarray(variables["params"]["conv1"]["weight"]))
    np.testing.assert_array_equal(sd["head.weight"].numpy(), np.asarray(variables["params"]["Dense_0"]["kernel"]).T)
    net = pt.GCNModel(8, 4, 3, num_layers=3)
    net.load_state_dict(sd)


def test_import_leaves_jax_out():
    code = (
        "import sys, sgracex1_tpu_torch, sgracex1_tpu_torch.nn, "
        "sgracex1_tpu_torch.ops.fused_agg, sgracex1_tpu_torch.graph.datasets, "
        "sgracex1_tpu_torch.graph.reorder, sgracex1_tpu_torch.ops.flash_gat, "
        "sgracex1_tpu_torch.ops.pallas_spmm, "
        "sgracex1_tpu_torch.ops.sddmm, sgracex1_tpu_torch.nn.models, "
        "sgracex1_tpu_torch.config, sgracex1_tpu_torch.train, "
        "sgracex1_tpu_torch.train.loop, sgracex1_tpu_torch.train.checkpoint; "
        "from sgracex1_tpu_torch import GATModel; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'sgracex1_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_model_boundaries():
    # quant= and telemetry= are ported: a telemetry layer records its ranges
    conv = GCNConv(4, 4, telemetry=True, generator=torch.Generator().manual_seed(0))
    A3 = pt.sym_norm(np.array([[0, 1, 2], [1, 2, 0]]), 3)
    conv(A3, torch.full((3, 4), 0.5))
    assert set(conv.telemetry_stats) == {"x_amax", "w_absmax", "wh_absmax"}
    assert float(conv.telemetry_stats["x_amax"]) == 0.5
    assert GCNConv(4, 4).telemetry_stats == {}
    x = torch.tensor([-1.0, 0.0, 2.0])
    assert ReluHW()(x).tolist() == [0.0, 0.0, 2.0]
    # same seed -> same weights; training-mode dropout draws from the generator
    a = pt.GCNModel(8, 4, 3, generator=torch.Generator().manual_seed(3))
    b = pt.GCNModel(8, 4, 3, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a.conv1.weight, b.conv1.weight)
    A = pt.prepare_adjacency(pt.sym_norm(np.array([[0, 1, 2], [1, 2, 0]]), 3), method="xla", device="cpu")
    a.train()
    with torch.no_grad():
        o1 = a(A, torch.ones(3, 8), generator=torch.Generator().manual_seed(0))
        o2 = a(A, torch.ones(3, 8), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(o1, o2)
    # parameters take gradients through agg_matmul
    a(A, torch.ones(3, 8), generator=torch.Generator().manual_seed(0)).sum().backward()
    for name, p in a.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert a.conv1.weight.grad.abs().sum() > 0
