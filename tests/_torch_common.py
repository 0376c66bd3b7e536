"""Shared inputs of the training-slice parity tests (test_torch_grads.py,
test_torch_train.py): graphs and prepared layouts in both packages, and
both models at the JAX loop's initial parameters. Holds no test itself."""

import numpy as np
import jax
import jax.numpy as jnp

from sgracex1_tpu.graph import datasets as j_ds
from sgracex1_tpu.graph import normalize as j_norm
from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.nn.models import GATModel as JGAT
from sgracex1_tpu.nn.models import GCNModel as JGCN
from sgracex1_tpu.ops import dispatch as jdis
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.graph import datasets as t_ds
from sgracex1_tpu_torch.nn import params_from_jax
from sgracex1_tpu_torch.ops import dispatch as tdis


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_jax(T):
    return JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)


def graph(kind, n=1024):
    """Random edges plus a hub block: dense tiles and a sparse remainder."""
    rng = np.random.default_rng(21)
    hub = np.stack([rng.integers(0, 128, 3000), rng.integers(0, n, 3000)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 2 * n)), hub, hub[::-1]], axis=1), axis=1)
    if kind == "symnorm":  # rank-1: mask tiles and scalings
        T = pt.sym_norm(ei, n)
    else:
        v = rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32)
        T = pt.SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))
    return to_jax(T), T


def jax_thresh(tb, rank1):
    """The remainder threshold JAX's hybrid prepare derives at this tb."""
    item = jdis._tile_itemsize(tb, rank1, 2)
    per_edge = jdis._REST_SLOT_S + jdis._REST_CHUNK_S / jdis._REST_K
    return int(np.ceil(jdis._tile_cost_s(tb, item) / per_edge))


def model_pair(kind, n=512, F=16, C=4, hidden=16, H=2, monkeypatch=None):
    """Both packages' data, prepared layouts and models with the JAX
    loop's initial parameters (``PRNGKey(seed)`` split once)."""
    d = j_ds.powerlaw_node_classification(n=n, num_features=F, num_classes=C, seed=0)
    e = t_ds.powerlaw_node_classification(n=n, num_features=F, num_classes=C, seed=0)
    J = j_norm.sym_norm(d.edge_index, n)
    T = pt.sym_norm(e.edge_index, n)
    if kind == "gcn":
        jp = jdis.prepare_adjacency(J, method="hybrid", tb=128)
        tp = tdis.prepare_adjacency(T, method="hybrid", tb=128, rest_thresh=jax_thresh(128, True), device="cpu")
        assert tp.fused_t is not None and tp.rest is not None
        model = JGCN(num_features=F, hidden_channels=hidden, num_classes=C, dropout=0.0)
        net = pt.GCNModel(F, hidden, C, dropout=0.0)
    else:
        forced, kw = {"gat-full": (None, {}), "gat-hybrid": ((64, False, 3), dict(gat_tb=64, gat_rest_thresh=3))}[kind]
        if forced is not None:
            monkeypatch.setattr(jdis, "_choose_flash_plan", lambda A, n, hybrid=True, train=True: forced)
        jp = jdis.prepare_adjacency(J, method="xla", for_gat=True)
        tp = tdis.prepare_adjacency(T, method="xla", for_gat=True, **kw, device="cpu")
        assert (tp.gat_plan is not None) == (kind == "gat-hybrid")
        model = JGAT(num_features=F, hidden_channels=hidden, num_classes=C, nheads=H, dropout=0.0)
        net = pt.GATModel(F, hidden, C, nheads=H, dropout=0.0)
    _, init_rng = jax.random.split(jax.random.PRNGKey(12345))
    variables = model.init(init_rng, jp, jnp.asarray(d.x))
    net.load_state_dict(params_from_jax(np_tree(variables)))
    return d, e, jp, tp, model, variables, net
