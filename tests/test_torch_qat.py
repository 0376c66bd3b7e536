"""The fake-quant (QAT emulation) datapath of the port against the flax
layers and models on the same numpy inputs and parameters.

Tolerances: on the edge path (float32 throughout) forwards agree at 1e-5
and ``jax.grad`` at 1e-4: with ``quant`` set, x and W are small dyadic
numbers, so ``X @ W`` is exact in float32 in any summation order, every
quantizer sees the same bits, and only the aggregation's sums differ in
their order. On tile and dense backends the aggregation rounds through
bf16 in both packages (2e-2, as the float tests of those backends)."""

import dataclasses
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sgracex1_tpu.config import SGRACEConfig as JConfig
from sgracex1_tpu.nn.layers import GATConv as JGATConv
from sgracex1_tpu.nn.layers import GCNConv as JGCNConv
from sgracex1_tpu.nn.models import GATModel as JGAT
from sgracex1_tpu.nn.models import GCNModel as JGCN
from sgracex1_tpu.ops import dispatch as jdis
from sgracex1_tpu.ops import fused_gnn as jfg
from sgracex1_tpu.quant import affine as ja
from sgracex1_tpu.quant import autocal as jauto
from sgracex1_tpu.quant.calibration import CalibrationTable as JCal
from sgracex1_tpu.train import loop as jloop
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.nn import GATConv, GCNConv, params_from_jax
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.ops import fused_gnn as tfg
from sgracex1_tpu_torch.quant import affine as ta
from sgracex1_tpu_torch.quant import autocal as tauto
from sgracex1_tpu_torch.quant.calibration import CalibrationTable as TCal
from sgracex1_tpu_torch.train import loop as tloop

from _torch_common import graph, jax_thresh, np_tree

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
QBITS = [8, 4, 2, 1]


def _tables(qbits, T=None):
    """The default tables; with ``T`` the adjacency range follows its
    values, as a calibrated deployment's does."""
    ov = dict(a_max=float(np.max(T.vals))) if T is not None else None
    return JCal.for_qbits(qbits, ov), TCal.for_qbits(qbits, ov)


def _inputs(T, F, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (T.n_rows, F)).astype(np.float32)
    R = rng.standard_normal((T.n_rows, 8)).astype(np.float32)
    return x, R


def _layer_pair(jconv, tconv, J, x, key=0):
    variables = jconv.init(jax.random.PRNGKey(key), J, jnp.asarray(x))
    p = variables["params"]
    tconv.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    return {"params": p}


def _compare_layer(jconv, tconv, J, T, x, R, relu=True, fwd=FWD, grad=GRAD):
    variables = _layer_pair(jconv, tconv, J, x)

    def loss(params, xx):
        return jnp.vdot(jconv.apply({"params": params}, J, xx, relu=relu), jnp.asarray(R))

    out_j = jconv.apply(variables, J, jnp.asarray(x), relu=relu)
    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = tconv(T, xt, relu=relu)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **fwd)
    (out_t * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **grad)
    for k, p in tconv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[k]), err_msg=k, **grad)
    return out_t


@pytest.mark.parametrize("qbits", QBITS)
def test_gcnconv_quant_matches_flax(qbits):
    J, T = graph("symnorm", n=384)
    calj, calt = _tables(qbits, T)
    x, R = _inputs(T, 16)
    out = _compare_layer(
        JGCNConv(16, 8, quant=calj.layer_params(0)), GCNConv(16, 8, quant=calt.layer_params(0)), J, T, x, R)
    # the forward is scaled by deq_o, the gradient is not: quantization acts
    plain = GCNConv(16, 8)
    assert not torch.allclose(out.detach(), plain(T, torch.from_numpy(x), relu=True).detach())


@pytest.mark.parametrize("qbits", QBITS)
def test_gatconv_quant_matches_flax(qbits):
    J, T = graph("weighted", n=384)
    calj, calt = _tables(qbits, T)
    x, R = _inputs(T, 16)
    R = np.concatenate([R, R], axis=1)  # 2 heads x 8
    _compare_layer(
        JGATConv(16, 8, nheads=2, quant=calj.layer_params(1)),
        GATConv(16, 8, nheads=2, quant=calt.layer_params(1)), J, T, x, R)


def test_gatconv_quant_on_flash_tiles():
    J, T = graph("symnorm", n=512)
    calj, calt = _tables(8, T)
    x, R = _inputs(T, 16)
    jp = jdis.prepare_adjacency(J, method="xla", for_gat=True)
    tp = tdis.prepare_adjacency(T, method="xla", for_gat=True, device="cpu")
    # bf16(p) and bf16 Wh in the flash kernels of both packages
    _compare_layer(JGATConv(16, 8, quant=calj.layer_params(0)), GATConv(16, 8, quant=calt.layer_params(0)),
                   jp, tp, x, R, fwd=BF16, grad=BF16)


def test_gcnconv_go_quant_matches_flax():
    J, T = graph("weighted", n=384)
    calj, calt = _tables(8)
    x, R = _inputs(T, 16)
    for quant in (None, 0):
        qj = None if quant is None else calj.layer_params(quant)
        qt = None if quant is None else calt.layer_params(quant)
        _compare_layer(JGCNConv(16, 8, quant=qj, go_quant=calj.grad_out, use_bias=True),
                       GCNConv(16, 8, quant=qt, go_quant=calt.grad_out, use_bias=True), J, T, x, R)
    # the function itself, and that the cotangent really rounds to 8 bits
    W = np.random.default_rng(4).uniform(-0.5, 0.5, (16, 8)).astype(np.float32)
    R = R * 0.05  # inside the gradient-output range, so the grid shows
    gj = jax.grad(lambda w: jnp.vdot(jfg.gnn_layer_quant_backward(J, jnp.asarray(x), w, calj.grad_out),
                                     jnp.asarray(R)))(jnp.asarray(W))
    Wt = torch.from_numpy(W).requires_grad_(True)
    (tfg.gnn_layer_quant_backward(T, torch.from_numpy(x), Wt, calt.grad_out) * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(Wt.grad.numpy(), np.asarray(gj), **GRAD)
    exact = x.T @ (T.to_scipy().T @ R)
    assert np.abs(Wt.grad.numpy() - exact).max() > 1e-3


KINDS = ["dense", "bsr", "hybrid", "xla", "pallas"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("qbits", [8, 2])
def test_map_adjacency_vals_matches_jax(kind, qbits):
    J, T = graph("weighted", n=512)
    calj, calt = _tables(qbits, T)
    jp = jdis.prepare_adjacency(J, method=kind, tb=128, rank1=False)
    thresh = jax_thresh(128, False) if kind == "hybrid" else None
    tp = tdis.prepare_adjacency(T, method=kind, tb=128, rest_thresh=thresh, rank1=False, device="cpu")
    mj = jdis.map_adjacency_vals(jp, lambda v: ja.fake_quant_unsigned(v, calj.adjacency, qbits))
    mt = tdis.map_adjacency_vals(tp, lambda v: ta.fake_quant_unsigned(v, calt.adjacency, qbits))
    assert mt.kind == mj.kind == kind and mt.fused is None and mt.fused_t is None
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    np.testing.assert_array_equal(mt.A.vals.numpy(), f32(mj.A.vals))
    if kind == "dense":
        assert mt.dense.dtype == torch.bfloat16
        np.testing.assert_array_equal(mt.dense.float().numpy(), f32(mj.dense))
    if kind in ("bsr", "hybrid"):
        # the quantizer ran on the bf16 tiles in bf16, as in the JAX package
        assert mt.bsr.tiles.dtype == torch.bfloat16 and tp.fused is not None
        np.testing.assert_array_equal(mt.bsr.tiles.float().numpy(), f32(mj.bsr.tiles))
        np.testing.assert_array_equal(mt.bsr_t.tiles.float().numpy(), f32(mj.bsr_t.tiles))
    if kind == "hybrid":
        assert mt.rest.nnz == mj.rest.nnz > 0
        np.testing.assert_array_equal(mt.rest.vals.numpy(), f32(mj.rest.vals))
    if kind == "pallas":
        for p, q in ((mt.plan, mj.plan), (mt.plan_t, mj.plan_t)):
            np.testing.assert_array_equal(p.val.numpy(), f32(q.val).reshape(-1, q.be))
    # a quantized layer on the mapped backend against flax on the same backend
    x, R = _inputs(T, 16)
    tol = FWD if kind == "xla" else BF16
    gtol = GRAD if kind == "xla" else BF16
    _compare_layer(JGCNConv(16, 8, quant=calj.layer_params(0)), GCNConv(16, 8, quant=calt.layer_params(0)),
                   jp, tp, x, R, fwd=tol, grad=gtol)


@pytest.mark.parametrize("case", ["gcn-forward", "gcn-forward-backward", "gat-forward"])
def test_map_adjacency_vals_remaps_only_what_is_read(case, monkeypatch):
    """Eager PyTorch runs every remap it is told to, so the port remaps a
    representation at its first read: a GCN forward the forward tiles and
    the remainder, its backward the transposed tiles too, a GAT layer on
    flash tiles the edge values alone. Calls of the quantizer are counted
    per representation; outputs and gradients against the flax layer."""
    from sgracex1_tpu_torch.nn import layers as tlayers

    gat = case.startswith("gat")
    J, T = graph("weighted", n=512)
    calj, calt = _tables(8, T)
    jp = jdis.prepare_adjacency(J, method="hybrid", tb=128, rank1=False, for_gat=gat)
    tp = tdis.prepare_adjacency(T, method="hybrid", tb=128, rest_thresh=jax_thresh(128, False),
                                rank1=False, for_gat=gat, device="cpu")
    ptr = lambda v: torch.as_tensor(v).data_ptr()
    owner = {ptr(tp.A.vals): "A", ptr(tp.bsr.tiles): "bsr", ptr(tp.bsr_t.tiles): "bsr_t",
             ptr(tp.rest.vals): "rest"}
    calls = []

    def counting(prep, fn):
        def counted(v):
            calls.append(owner[ptr(v)])
            return fn(v)
        return tdis.map_adjacency_vals(prep, counted)

    monkeypatch.setattr(tlayers, "map_adjacency_vals", counting)
    x, R = _inputs(T, 16)
    if gat:
        R = np.concatenate([R, R], axis=1)
        jconv = JGATConv(16, 8, nheads=2, quant=calj.layer_params(1))
        tconv = GATConv(16, 8, nheads=2, quant=calt.layer_params(1))
    else:
        jconv = JGCNConv(16, 8, quant=calj.layer_params(0))
        tconv = GCNConv(16, 8, quant=calt.layer_params(0))
    variables = _layer_pair(jconv, tconv, jp, x)
    out_j = jconv.apply(variables, jp, jnp.asarray(x), relu=True)
    xt = torch.from_numpy(x).requires_grad_(case.endswith("backward"))
    with torch.set_grad_enabled(case.endswith("backward")):
        out_t = tconv(tp, xt, relu=True)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **BF16)
    if gat:
        # the flash kernels read the mask tiles; only the edge list is asked for
        assert sorted(calls) == ["A"]
        return
    assert sorted(calls) == ["bsr", "rest"]
    if case.endswith("backward"):
        gx = jax.grad(lambda xx: jnp.vdot(jconv.apply(variables, jp, xx, relu=True), jnp.asarray(R)))(jnp.asarray(x))
        (out_t * torch.from_numpy(R)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **BF16)
        assert sorted(calls) == ["bsr", "bsr_t", "rest"]


def test_map_adjacency_vals_is_lazy_and_keeps_what_it_made():
    """Nothing is remapped until it is read; a second read returns the
    same object; a map of a map stays lazy."""
    _, T = graph("weighted", n=512)
    _, calt = _tables(8, T)
    tp = tdis.prepare_adjacency(T, method="hybrid", tb=128, rest_thresh=jax_thresh(128, False),
                                rank1=False, device="cpu")
    calls = []

    def fn(v):
        calls.append(tuple(v.shape))
        return ta.fake_quant_unsigned(v, calt.adjacency, 8)

    mt = tdis.map_adjacency_vals(tdis.map_adjacency_vals(tp, fn), fn)
    assert isinstance(mt, tdis.PreparedAdjacency) and calls == []
    assert mt.kind == "hybrid" and mt.fused is None and mt.dense is None and calls == []
    tiles = mt.bsr_t.tiles
    assert calls == [tuple(tp.bsr_t.tiles.shape)] * 2  # both maps, this tile set only
    assert mt.bsr_t.tiles is tiles and len(calls) == 2
    once = tdis.map_adjacency_vals(tp, fn)
    torch.testing.assert_close(tiles, fn(once.bsr_t.tiles), rtol=0, atol=0)
    assert mt.bsr_t.live is tp.bsr_t.live and mt.bsr_t.ring is tp.bsr_t.ring  # fn(0) == 0 keeps the flags


def test_map_adjacency_vals_rank1_warns_and_degrades():
    J, T = graph("symnorm", n=512)
    calj, calt = _tables(8, T)
    tp = tdis.prepare_adjacency(T, method="hybrid", tb=128, rest_thresh=jax_thresh(128, True),
                                for_gat=True, device="cpu")
    assert tp.r1_row is not None
    with pytest.warns(UserWarning, match="rank-1 mask-tile backend"):
        mt = tdis.map_adjacency_vals(tp, lambda v: ta.fake_quant_unsigned(v, calt.adjacency, 8))
    assert mt.kind == "xla" and mt.bsr is None and mt.rest is None and mt.r1_row is None and mt.fused is None
    assert mt.gat_bsr is tp.gat_bsr  # mask tiles survive any 0 -> 0 quantizer
    jp = jdis.prepare_adjacency(J, method="hybrid", tb=128)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mj = jdis.map_adjacency_vals(jp, lambda v: ja.fake_quant_unsigned(v, calj.adjacency, 8))
    np.testing.assert_array_equal(mt.A.vals.numpy(), np.asarray(mj.A.vals))
    H = torch.from_numpy(_inputs(T, 8)[0])
    np.testing.assert_allclose(tdis.agg_matmul(mt, H).numpy(), np.asarray(jdis.agg_matmul(mj, jnp.asarray(H.numpy()))), **FWD)


def _model_pair(kind, T, J, x, calj, calt, **kw):
    if kind == "gcn":
        model = JGCN(num_features=x.shape[1], hidden_channels=8, num_classes=4, calibration=calj, dropout=0.0, **kw)
        net = pt.GCNModel(x.shape[1], 8, 4, calibration=calt, dropout=0.0, **kw)
    else:
        model = JGAT(num_features=x.shape[1], hidden_channels=8, num_classes=4, nheads=2, calibration=calj, dropout=0.0)
        net = pt.GATModel(x.shape[1], 8, 4, nheads=2, calibration=calt, dropout=0.0)
    variables = model.init(jax.random.PRNGKey(5), J, jnp.asarray(x))
    net.load_state_dict(params_from_jax(np_tree(variables)))
    return model, {"params": variables["params"]}, net


@pytest.mark.parametrize("kind,qbits,layers", [("gcn", 8, 2), ("gcn", 4, 3), ("gcn", 1, 2), ("gat", 8, 2), ("gat", 2, 2)])
def test_quantized_models_match_flax(kind, qbits, layers):
    J, T = graph("weighted", n=384)
    calj, calt = _tables(qbits, T)
    x, _ = _inputs(T, 16)
    kw = dict(num_layers=layers) if kind == "gcn" else {}
    model, variables, net = _model_pair(kind, T, J, x, calj, calt, **kw)
    if kind == "gcn":  # layer 1 table for conv1, layer 2 table for every later conv
        assert net.conv1.quant == calt.layer_params(0)
        assert getattr(net, f"conv{layers}").quant == calt.layer_params(1)
    y = np.random.default_rng(6).integers(0, 4, T.n_rows)
    logits_j = model.apply(variables, J, jnp.asarray(x))

    def loss(params):
        lg = model.apply({"params": params}, J, jnp.asarray(x))
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(len(y)), y])

    gj = params_from_jax(np_tree({"params": jax.grad(loss)(variables["params"])}))
    logits_t = net.eval()(T, torch.from_numpy(x))
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), **FWD)
    torch.nn.functional.cross_entropy(logits_t, torch.from_numpy(y)).backward()
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gj[k].numpy(), err_msg=k, **GRAD)


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_telemetry_and_calibrate_match_jax(kind):
    J, T = graph("weighted", n=384)
    x, _ = _inputs(T, 16)
    x *= 0.7
    model, variables, net = _model_pair(kind, T, J, x, None, None)
    tel_j = jauto.harvest_telemetry(model, variables, J, jnp.asarray(x))
    tel_t = tauto.harvest_telemetry(net.eval(), T, torch.from_numpy(x))
    assert list(tel_t) == list(tel_j) == ["conv1", "conv2"]
    for layer in tel_j:
        assert set(tel_t[layer]) == {"x_amax", "w_absmax", "wh_absmax"}
        for k, v in tel_j[layer].items():
            np.testing.assert_allclose(tel_t[layer][k], v, rtol=1e-6, err_msg=f"{layer}.{k}")
    assert tel_t["conv1"]["x_amax"] == float(x.max())
    assert not net.conv1.telemetry  # the flag is put back
    for qbits in (8, 2):
        cj = jauto.calibrate(model, variables, J, jnp.asarray(x), qbits=qbits)
        ct = tauto.calibrate(net, T, torch.from_numpy(x), qbits=qbits)
        dj, dt = dataclasses.asdict(cj), dataclasses.asdict(ct)
        # f_max2 is an activation maximum, a sum in another order (1e-6)
        flat = lambda d: jax.tree_util.tree_leaves(d)
        np.testing.assert_allclose(flat(dt), flat(dj), rtol=1e-6)
        assert dt["weights"] == dj["weights"] and dt["features"] == dj["features"]
    base = TCal.for_qbits(8, dict(a_max=0.5))
    assert tauto.calibrate(net, T, torch.from_numpy(x), base=base).raw["a_max"] == 0.5


def test_fake_quant_training_tracks_jax():
    """5 epochs of 8-bit fake-quant train_node_classifier on a hybrid value-
    tile prep (what prepare_from_config builds for fake_quantization) from
    the JAX loop's initial parameters."""
    from sgracex1_tpu.graph import datasets as j_ds
    from sgracex1_tpu.graph import normalize as j_norm
    from sgracex1_tpu_torch.graph import datasets as t_ds

    n, F, C = 512, 16, 4
    d = j_ds.powerlaw_node_classification(n=n, num_features=F, num_classes=C, seed=0)
    e = t_ds.powerlaw_node_classification(n=n, num_features=F, num_classes=C, seed=0)
    J, T = j_norm.sym_norm(d.edge_index, n), pt.sym_norm(e.edge_index, n)
    calj, calt = _tables(8, T)
    jp = jdis.prepare_adjacency(J, method="hybrid", tb=128, rank1=False)
    cfg = dict(num_epochs=5, learning_rate=0.01, fake_quantization=True)
    tp = tdis.prepare_from_config(T, pt.SGRACEConfig(**cfg), method="hybrid", device="cpu")
    assert tp.r1_row is None and tp.kind == "hybrid"
    tp = tdis.prepare_adjacency(T, method="hybrid", tb=128, rest_thresh=jax_thresh(128, False),
                                rank1=False, device="cpu")
    assert tp.rest.nnz == jp.rest.nnz > 0
    model = JGCN(num_features=F, hidden_channels=16, num_classes=C, calibration=calj, dropout=0.0)
    net = pt.GCNModel(F, 16, C, calibration=calt, dropout=0.0)
    _, init_rng = jax.random.split(jax.random.PRNGKey(12345))
    net.load_state_dict(params_from_jax(np_tree(model.init(init_rng, jp, jnp.asarray(d.x)))))
    _, hj = jloop.train_node_classifier(model, d, JConfig(**cfg), prepare=jp)
    before = pt.ops.bsr.bsr_spmm.launches
    state, ht = tloop.train_node_classifier(net, e, pt.SGRACEConfig(**cfg), prepare=tp, device="cpu")
    assert pt.ops.bsr.bsr_spmm.launches == before  # CPU tensors: plain K1
    assert state.step == 5
    # bf16 tile aggregations in both packages; Adam steps amplify the last bits
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(ht.train_acc, hj.train_acc, atol=0.02)
    np.testing.assert_allclose(ht.test_acc, hj.test_acc, atol=0.03)
    assert ht.loss[-1] < ht.loss[0]
