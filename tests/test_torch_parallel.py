"""The port's partition, reorderings, replicated-H layers, communication
model, mesh and distributed dry run against sgracex1_tpu on the same numpy
inputs, the JAX side on the conftest's virtual CPU mesh.

Tolerances: host arrays and byte counts exact; the f32 edge paths 1e-5
(outputs and gradients 1e-4, as tests/test_parallel.py holds them); the
dry run's step, whose tile and flash layers run the plain kernels here and
the Pallas ones in interpret mode there: the loss 1e-5, each gradient 1e-3
of its largest entry, the updated parameters 1e-3 of the learning rate."""

import numpy as np
import pytest
import scipy.sparse as sp
import jax
import jax.numpy as jnp
import optax
import torch

from sgracex1_tpu.config import SGRACEConfig as JConfig
from sgracex1_tpu.graph import reorder as jr
from sgracex1_tpu.parallel import comm_model as jcm
from sgracex1_tpu.parallel import partition as jp
from sgracex1_tpu.parallel import spmm_dist as jsd
from sgracex1_tpu_torch import SGRACEConfig
from sgracex1_tpu_torch.graph import reorder as tr
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.graph.datasets import powerlaw_node_classification
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.parallel import comm_model as tcm
from sgracex1_tpu_torch.parallel import dryrun as tdr
from sgracex1_tpu_torch.parallel import global_mesh, make_mesh, pad_nodes, partition_graph
from sgracex1_tpu_torch.parallel import spmm_dist as tsd
from tests._torch_common import dist_graph, grads_of, jax_mesh_put, leaf, to_jax

torch.set_num_threads(1)

EDGE = 1e-5


def _graph(n=100):
    mat = sp.random(n, n, density=0.08, format="csr", random_state=17)
    mat.setdiag(0.5)
    T = TSparse.from_scipy(mat)
    return to_jax(T), T


@pytest.mark.parametrize("S", [2, 4, 8])
def test_reorder_identical(S):
    """degree_balanced_order's permutation, shard_edge_counts and bandwidth
    equal the JAX package's on a power-law graph."""
    d = powerlaw_node_classification(n=1000, avg_degree=8, seed=S)
    T = sym_norm(d.edge_index, d.num_nodes)
    J = to_jax(T)
    perm = tr.degree_balanced_order(T, S)
    np.testing.assert_array_equal(perm, jr.degree_balanced_order(J, S))
    np.testing.assert_array_equal(tr.shard_edge_counts(T, S), jr.shard_edge_counts(J, S))
    Tp, _ = tr.permute_graph(T, perm)
    np.testing.assert_array_equal(tr.shard_edge_counts(Tp, S), jr.shard_edge_counts(jr.permute_graph(J, perm)[0], S))
    assert tr.bandwidth(T) == jr.bandwidth(J) and tr.bandwidth(Tp) == jr.bandwidth(to_jax(Tp))
    counts = tr.shard_edge_counts(Tp, S)
    assert counts.max() / counts.mean() < tr.shard_edge_counts(T, S).max() / counts.mean()


@pytest.mark.parametrize("S", [2, 4, 8])
def test_partition_identical(S):
    J, T = _graph()
    JG, jn = jp.partition_graph(J, S)
    TG, tn = partition_graph(T, S, device="cpu")
    assert tn == jn and (TG.n_shards, TG.n_local, TG.n_pad, TG.e_shard) == (JG.n_shards, JG.n_local, JG.n_pad,
                                                                          JG.e_shard)
    for f in ("rows_local", "cols", "vals"):
        np.testing.assert_array_equal(getattr(TG, f).numpy(), np.asarray(getattr(JG, f)), err_msg=f)
    x = np.arange(300, dtype=np.float32).reshape(100, 3)
    np.testing.assert_array_equal(pad_nodes(x, tn), jp.pad_nodes(x, jn))


@pytest.mark.parametrize("S", [2, 4, 8])
def test_dist_layers_allgather(S):
    """dist_spmm, dist_gnn_layer and dist_gat_layer: outputs and the
    gradients of x, W (and the attention vector) against jax.grad through
    shard_map."""
    J, T = _graph()
    JG, n_pad = jp.partition_graph(J, S)
    TG, _ = partition_graph(T, S, device="cpu")
    rng = np.random.default_rng(S)
    H = pad_nodes(rng.standard_normal((100, 16)).astype(np.float32), n_pad)
    X = pad_nodes(rng.standard_normal((100, 12)).astype(np.float32), n_pad)
    W = rng.standard_normal((12, 8)).astype(np.float32)
    att = rng.standard_normal((16, 1)).astype(np.float32)
    jm, JGd, Hd, Xd = jax_mesh_put(S, JG, H, X)
    mesh = make_mesh(S, device="cpu")
    np.testing.assert_allclose(tsd.dist_spmm(mesh, TG, torch.from_numpy(H)).numpy(),
                               np.asarray(jsd.dist_spmm(jm, JGd, Hd)), rtol=EDGE, atol=EDGE)
    cases = (
        (lambda x, w: jsd.dist_gnn_layer(jm, JGd, x, w, relu=True),
         lambda x, w: tsd.dist_gnn_layer(mesh, TG, x, w, relu=True), (X, W)),
        (lambda x, w, a: jsd.dist_gat_layer(jm, JGd, x, w, a, relu=True),
         lambda x, w, a: tsd.dist_gat_layer(mesh, TG, x, w, a, relu=True), (X, W, att)),
    )
    for jf, tf, args in cases:
        jout = np.asarray(jax.jit(jf)(Xd, *args[1:]))
        jg = jax.jit(jax.grad(lambda *a: jnp.sum(jf(*a) ** 2), argnums=tuple(range(len(args)))))(
            Xd, *map(jnp.asarray, args[1:]))
        leaves = [leaf(a) for a in args]
        out = tf(*leaves)
        np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-4, atol=2e-4)
        for g, want in zip(grads_of(torch.sum(out ** 2), *leaves), jg):
            want = np.asarray(want)
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_comm_model_numbers():
    """Byte counts and predictions equal the JAX model's at the same link
    rate (the port states none of its own)."""
    J, T, JG, TG = dist_graph(512, 1, 8)
    link = 123e9
    for bwd in (False, True):
        a, b = tcm.halo_comm(TG, 64, backward=bwd), jcm.halo_comm(JG, 64, backward=bwd)
        assert (a.bytes_out, a.note) == (b.bytes_out, b.note)
        a, b = tcm.allgather_comm(TG.n_pad, 64, 8, backward=bwd), jcm.allgather_comm(JG.n_pad, 64, 8, backward=bwd)
        assert (a.bytes_out, a.note) == (b.bytes_out, b.note)
        assert a.seconds(link) == b.seconds(link)
    comms_t = {s: tcm.halo_comm(TG, 64) + tcm.allgather_comm(TG.n_pad, 16, s) for s in (2, 4, 8)}
    comms_j = {s: jcm.halo_comm(JG, 64) + jcm.allgather_comm(JG.n_pad, 16, s) for s in (2, 4, 8)}
    for ov in (0.0, 0.5):
        assert tcm.scaling_table(3e-3, comms_t, link_bytes_s=link, overlap=ov) == jcm.scaling_table(
            3e-3, comms_j, ici_bytes_s=link, overlap=ov)
    assert TG.n_shards * TG.halo_len < TG.n_pad  # the halo moves less than all of H
    with pytest.raises(TypeError):
        tcm.predicted_efficiency(1e-3, 2, comms_t[2])  # no built-in link rate


def test_config_mesh_fields():
    assert (SGRACEConfig().mesh_axis, SGRACEConfig().num_shards) == (JConfig().mesh_axis, JConfig().num_shards)
    cfg = SGRACEConfig(num_shards=4)
    mesh = make_mesh(cfg.num_shards, cfg.mesh_axis, device="cpu")
    assert (mesh.n_shards, mesh.axis_name, mesh.local_shards) == (4, "graph", [0, 1, 2, 3])
    assert make_mesh(device="cpu").n_shards == 1


def test_mesh_never_falls_back():
    """No card: make_mesh() raises as resolve_device does; without a
    process group global_mesh raises (it never becomes in-process)."""
    if torch.cuda.is_available():
        pytest.skip("the machine has a CUDA card: make_mesh() takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="process group"):
        global_mesh()
    with pytest.raises(ValueError):
        make_mesh(4, device="cpu").split(torch.zeros(10, 2))


def _jax_dryrun(S):
    """One step of the JAX package's dry run (__graft_entry__.
    dryrun_multichip's body): loss, gradients and updated parameters."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sgracex1_tpu.graph.datasets import sbm_node_classification
    from sgracex1_tpu.graph.normalize import sym_norm as j_sym_norm
    from sgracex1_tpu.parallel import halo as jh
    from sgracex1_tpu.parallel.halo_fused import build_halo_fused, dist_gnn_layer_halo_fused
    from sgracex1_tpu.parallel.mesh import make_mesh as j_make_mesh
    from sgracex1_tpu.quant.affine import fake_quant_signed, fake_quant_unsigned, ste
    from sgracex1_tpu.quant.calibration import CalibrationTable

    mesh = j_make_mesh(S)
    data = sbm_node_classification(n=S * 24, num_classes=3, num_features=16, seed=0)
    A = j_sym_norm(data.edge_index, data.num_nodes)
    G, n_pad = jp.partition_graph(A, S)
    HG, _ = jh.build_halo(A, S)
    BP = jh.build_halo_bsr(HG, tb=8, dtype=jnp.float32)
    FPL = build_halo_fused(HG, tb=8, K=128)
    sh = NamedSharding(mesh, P("graph"))
    x = jax.device_put(jp.pad_nodes(data.x, n_pad), sh)
    y = jax.device_put(jp.pad_nodes(data.y.astype(np.int32), n_pad), sh)
    m = jax.device_put(jp.pad_nodes(data.train_mask.astype(np.float32), n_pad), sh)
    G, HG, BP = (jax.device_put(t, sh) for t in (G, HG, BP))
    params = {k: jnp.asarray(v) for k, v in tdr.init_params().items()}
    q = CalibrationTable.for_qbits(8).layer_params(0)

    def loss_fn(p):
        hdn = jsd.dist_gat_layer(mesh, G, x, p["W1"], p["att1"], relu=True)
        hdn = jh.dist_gnn_layer_halo(mesh, HG, hdn, p["W2"], relu=True)
        hdn = jh.dist_gnn_layer_halo_bsr(mesh, HG, BP, hdn, p["W3"], relu=True)
        hdn = jh.dist_gat_layer_halo_flash(mesh, HG, BP, hdn, p["W4"], p["att4"], relu=True)
        hdn = dist_gnn_layer_halo_fused(mesh, HG, FPL, hdn, p["W6"], relu=True)
        xq = fake_quant_unsigned(hdn, q.features, q.w_qbits)
        Wq = fake_quant_signed(p["W5"], q.weights, q.w_qbits)
        hdn = jh.dist_gnn_layer_halo(mesh, HG, xq, Wq, relu=False)
        hdn = ste(hdn, hdn * q.deq_o)
        ls = -jax.nn.log_softmax(hdn @ p["Wo"])[jnp.arange(n_pad), y]
        return jnp.sum(ls * m) / jnp.sum(m)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    opt = optax.adam(0.01)
    updates, _ = opt.update(grads, opt.init(params))
    return float(loss), grads, optax.apply_updates(params, updates)


@pytest.mark.parametrize("S", [2, 4])
def test_dryrun_multichip_twin(S):
    """The twin's loss, every gradient and every updated parameter against
    the same step built from the JAX functions."""
    jl, jg, jparams = _jax_dryrun(S)
    loss, params, grads = tdr.dryrun_multichip(S, device="cpu")
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    assert set(grads) == set(jg) == set(tdr.PARAM_NAMES)
    for k in tdr.PARAM_NAMES:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=1e-3, atol=1e-3 * np.abs(want).max(), err_msg=k)
        # Adam's first step lr * g / (|g| + eps) amplifies a gradient's
        # rounding where |g| nears eps: 1e-3 of the learning rate
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-3 * 0.01, err_msg=k)
