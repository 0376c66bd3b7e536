"""Shared inputs of the training-slice parity tests (test_torch_grads.py,
test_torch_train.py): graphs and prepared layouts in both packages, and
both models at the JAX loop's initial parameters; and of the distributed
ones (test_torch_halo.py, test_torch_halo_fused.py, test_torch_parallel.py):
both packages' halo plans and the JAX mesh. Holds no test itself."""

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


def jax_cost_table():
    """The port's ``CostTable`` holding the JAX package's constants (its
    v5e calibration), read from the JAX modules: with it, the port's cost
    model must give the JAX numbers and choices."""
    import inspect

    from sgracex1_tpu.ops import flash_gat as jfg
    from sgracex1_tpu.parallel import halo_fused as jhf

    default = lambda fn, name: inspect.signature(fn).parameters[name].default
    return tdis.CostTable(
        card="the JAX package's constants", hbm_bps=jdis._HBM_BPS, step_s=jdis._STEP_S,
        mxu_flops=jdis._MXU_FLOPS, vpu_ops=jdis._VPU_OPS, tile_s={},
        tbs=default(jdis._estimate_backend_costs, "tbs"), rest_chunk_s=jdis._REST_CHUNK_S,
        rest_slot_s=jdis._REST_SLOT_S, rest_k=jdis._REST_K, chunk_s={}, dense_bps=jdis._HBM_BPS,
        xla_edge_s=jdis._XLA_EDGE_S, pallas_group_s=jdis._PALLAS_GROUP_S, pallas_edge_s=0.0,
        pallas_block=1024, row_s={}, call_s={}, flash_tile_s=dict(jdis._FLASH_TILE_S),
        flash_run_s=dict(jdis._FLASH_RUN_S), flash_elt_s=jdis._FLASH_ELT_S,
        flash_run_elt_s=3.8e-9,  # the literal of the JAX _flash_run_s
        flash_packed_mult=jdis._FLASH_PACKED_MULT, flash_tile_budget=jdis._FLASH_TILE_BUDGET,
        flash_chunk_k=jdis._FLASH_CHUNK_K, flash_chunk_res_s=jdis._FLASH_CHUNK_RES_S,
        flash_chunk_stream_s=jdis._FLASH_CHUNK_STREAM_S, flash_payload_f=jdis._FLASH_PAYLOAD_F,
        flash_resident_budget=jfg._RESIDENT_CHUNK_BUDGET, flash_heads=1,
        flash_train_passes=jdis._FLASH_TRAIN_PASSES, flash_edge_bwd_s=jdis._FLASH_EDGE_BWD_S,
        flash_bwd_fixed_s=jdis._FLASH_BWD_FIXED_S, flash_hybrid_fixed_s=jdis._FLASH_HYBRID_FIXED_S,
        # the literals of the JAX _choose_flash_plan's loops and size rule
        flash_tbs=(256, 512, 1024), flash_packed_tbs=(1024,),
        flash_threshs=(2, 8, 32, 96, 256, 768, 1536, 3072), flash_full_cover_n=8192,
        shard_tbs=default(jhf._choose_shard_tb, "tbs"),
    )


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
    if kind == "gcn-pallas":
        jp = jdis.prepare_adjacency(J, method="pallas", rb=256, cb=256)
        tp = tdis.prepare_adjacency(T, method="pallas", rb=256, cb=256, device="cpu")
        assert tp.plan_t is not None
        model = JGCN(num_features=F, hidden_channels=hidden, num_classes=C, dropout=0.0)
        net = pt.GCNModel(F, hidden, C, dropout=0.0)
    elif kind == "gcn":
        jp = jdis.prepare_adjacency(J, method="hybrid", tb=128)
        tp = tdis.prepare_adjacency(T, method="hybrid", tb=128, rest_thresh=jax_thresh(128, True), device="cpu")
        assert tp.fused_t is not None and tp.rest is not None
        model = JGCN(num_features=F, hidden_channels=hidden, num_classes=C, dropout=0.0)
        net = pt.GCNModel(F, hidden, C, dropout=0.0)
    else:
        forced = {"gat-full": None, "gat-hybrid": (64, False, 3)}[kind]
        if forced is not None:  # both choosers forced (a small graph takes full cover)
            monkeypatch.setattr(jdis, "_choose_flash_plan", lambda A, n, hybrid=True, train=True: forced)
            monkeypatch.setattr(tdis, "_choose_flash_plan", lambda A, n, **kw: forced)
        jp = jdis.prepare_adjacency(J, method="xla", for_gat=True)
        tp = tdis.prepare_adjacency(T, method="xla", for_gat=True, device="cpu")
        assert (tp.gat_plan is not None) == (kind == "gat-hybrid")
        model = JGAT(num_features=F, hidden_channels=hidden, num_classes=C, nheads=H, dropout=0.0)
        net = pt.GATModel(F, hidden, C, nheads=H, dropout=0.0)
    _, init_rng = jax.random.split(jax.random.PRNGKey(12345))
    variables = model.init(init_rng, jp, jnp.asarray(d.x))
    net.load_state_dict(params_from_jax(np_tree(variables)))
    return d, e, jp, tp, model, variables, net


# ---------------------------------------------- the distributed layers


def jax_mesh_put(S, *trees):
    """The JAX package's mesh of ``S`` virtual CPU devices and ``trees``
    placed row-sharded on it (numpy arrays or halo / partition plans)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from sgracex1_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(S)
    sh = NamedSharding(mesh, P("graph"))
    return (mesh, *(jax.device_put(t, sh) for t in trees))


def dist_graph(n, seed, S, weighted=False):
    """Both packages' adjacency of a random directed graph (sym_norm, or
    random weights) and its halo plans on ``S`` shards (the port's on the
    CPU): (JAX A, port A, JAX HaloGraph (host), port HaloGraph)."""
    from sgracex1_tpu.parallel.halo import build_halo as j_build_halo
    from sgracex1_tpu_torch.parallel.halo import build_halo
    from tests.conftest import make_random_graph

    rng = np.random.default_rng(seed)
    ei = make_random_graph(rng, n, avg_degree=6)
    if weighted:
        v = rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32)
        T = pt.SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))
    else:
        T = pt.sym_norm(ei, n)
    J = to_jax(T)
    return J, T, j_build_halo(J, S)[0], build_halo(T, S, device="cpu")[0]


def leaf(a):
    """A float32 CPU leaf tensor that takes a gradient, converted as the
    distributed layers' JAX parameters are (``dist_params_from_jax``)."""
    from sgracex1_tpu_torch.nn.convert import dist_params_from_jax

    return dist_params_from_jax({"a": a})["a"].requires_grad_()


def grads_of(loss, *leaves):
    loss.backward()
    return [np.asarray(x.grad) for x in leaves]
