"""The plain reference against the port's CPU path (plain kernels,
``device="cpu"``) at a small size: the normalized adjacency, the logits
and one training step's loss and gradients, on the kind and tiling the
cell prepares. The port is imported here, in the test only."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import gen
from portbench.reference import gcn as ref_gcn
from portbench.reference.common import EXACT, Adjacency, masked_xent
from portbench.tests.conftest import ROOT

N = 4096


def _cfg(name):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def setting():
    from sgracex1_tpu_torch.config import SGRACEConfig
    from sgracex1_tpu_torch.graph.normalize import sym_norm
    from sgracex1_tpu_torch.ops.dispatch import prepare_from_config

    c = dict(_cfg("gcn-products"), num_nodes=N)
    g = gen.graph(c, 4, "cpu")
    A = sym_norm(g.edges.numpy(), N)
    prep = prepare_from_config(A, SGRACEConfig(**c["prepare"]), device="cpu")
    assert prep.kind == "pallas"  # the kind the cell's prepare takes on the card
    return g, A, prep, Adjacency(g.edges, N)


def test_adjacency_values_equal_the_ports_sym_norm(setting):
    g, A, _, adj = setting
    nz = A.vals[: A.nnz] != 0  # the port adds zero-valued self-loops
    port = {(int(r), int(c)): float(v) for r, c, v in zip(A.rows[: A.nnz][nz], A.cols[: A.nnz][nz], A.vals[: A.nnz][nz])}
    A_ref = adj.A.to_dense()
    r, c = np.nonzero(A_ref.numpy())
    assert len(r) == len(port) == g.edges.shape[1]
    assert all(abs(port[(int(i), int(j))] - float(A_ref[i, j])) < 1e-6 for i, j in zip(r[:2000], c[:2000]))
    assert torch.equal(adj.At.to_dense(), A_ref.T)


def _model(theta):
    from sgracex1_tpu_torch.nn.models import GCNModel

    c = _cfg("gcn-products")
    m = GCNModel(100, c["hidden_channels"], 47, num_layers=c["num_layers"])
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(theta[k])
    return m, c


def test_logits_match_the_port(setting):
    g, _, prep, adj = setting
    theta = gen.weights(ref_gcn.leaves(_cfg("gcn-products")), 11, "cpu")
    m, c = _model(theta)
    with torch.no_grad():
        out = m.eval()(prep, g.x)
        want = ref_gcn.forward(c, adj, theta, g.x, None, EXACT)
    # bf16 operands in the port's kernels, f32 everywhere in the reference
    assert float((out - want).abs().max() / want.abs().max()) < 5e-3


def test_loss_and_gradients_match_the_port(setting):
    g, _, prep, adj = setting
    theta = gen.weights(ref_gcn.leaves(_cfg("gcn-products")), 12, "cpu")
    m, c = _model(theta)
    m.dropout = 0.0
    m.train()
    loss = masked_xent(m(prep, g.x), g.y, g.train_mask)
    loss.backward()
    leaves = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
    want = masked_xent(ref_gcn.forward(c, adj, leaves, g.x, None, EXACT), g.y, g.train_mask)
    grads = torch.autograd.grad(want, list(leaves.values()))
    assert abs(float(loss) - float(want)) / float(want) < 1e-4
    for (k, p), gr in zip(m.named_parameters(), grads):
        gap = float((p.grad - gr).norm() / gr.norm())
        assert gap < 2e-2, (k, gap)
