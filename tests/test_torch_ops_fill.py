"""The op fill-ins of the port against the JAX package on the same numpy
inputs: ``ops/spmm.spmm_dense_rhs`` / ``spmv``, ``ops/fused_gnn``'s
``gat_attention`` (and its gradient), ``edges_to_dense`` and
``gat_layer``, ``ops/flash_gat.gat_attention_agg`` (K3 forward, the edge
backward), ``prepare_adjacency``'s ``dense_dtype`` and ``gat_train``, the
models' ``remat`` and ``calibrate`` on ``MoleculeGCN``.

Tolerances: float32 on the edge path throughout, so forwards agree at
1e-5 and gradients at 1e-4 (sums in another order); the plain K3 against
the Pallas K3 in interpret mode at 1e-3 (identical bf16 operands). The
remat models must give bit-identical logits and gradients to the same
model without remat (the same ops on the same inputs)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.sparse as sp
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.nn.models import GATModel as JGAT
from sgracex1_tpu.nn.models import GCNModel as JGCN
from sgracex1_tpu.nn.models import MoleculeGCN as JMol
from sgracex1_tpu.ops import bsr as jb
from sgracex1_tpu.ops import dispatch as jdis
from sgracex1_tpu.ops import flash_gat as jfg
from sgracex1_tpu.ops import fused_gnn as jfn
from sgracex1_tpu.ops.spmm import spmm_dense_rhs as j_spmm_dense_rhs, spmv as j_spmv
from sgracex1_tpu.quant import autocal as jauto
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch import ops as tops
from sgracex1_tpu_torch.nn import layers as tlayers
from sgracex1_tpu_torch.nn import params_from_jax
from sgracex1_tpu_torch.ops import bsr as tb_
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.ops import flash_gat as tfg
from sgracex1_tpu_torch.ops import fused_gnn as tfn
from sgracex1_tpu_torch.quant import autocal as tauto
from sgracex1_tpu_torch.quant.calibration import CalibrationTable as TCal

from _torch_common import graph, np_tree, to_jax

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _weighted(n, seed, density=0.03):
    """A random weighted graph with positive self-loops and a few zero
    values (masked out of every softmax): (port A, JAX A)."""
    mat = sp.random(n, n, density=density, format="csr", random_state=seed).astype(np.float32)
    mat.setdiag(0.9)
    mat = mat.tocoo()
    v = mat.data.copy()
    v[(mat.row != mat.col) & (np.arange(mat.nnz) % 17 == 0)] = 0.0
    T = pt.SparseMatrix.from_coo(mat.row, mat.col, v, (n, n))
    return T, to_jax(T)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ ops/spmm


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_spmm_dense_rhs_and_spmv_match_jax(dtype):
    T, J = _weighted(300, seed=1)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((300, 24)).astype(np.float32)
    W = rng.standard_normal((24, 16)).astype(np.float32)
    if dtype == "bfloat16":
        Xt, Xj, tol = torch.from_numpy(X).bfloat16(), jnp.asarray(X, jnp.bfloat16), dict(rtol=2e-2, atol=2e-2)
    else:
        Xt, Xj, tol = torch.from_numpy(X), jnp.asarray(X), FWD
    got = tops.spmm_dense_rhs(T, Xt, torch.from_numpy(W))
    want = j_spmm_dense_rhs(J, Xj, jnp.asarray(W))
    assert got.dtype == Xt.dtype and got.shape == (300, 16)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    x = rng.standard_normal(300).astype(np.float32)
    sv = tops.spmv(T, torch.from_numpy(x))
    assert sv.shape == (300,)
    np.testing.assert_allclose(sv.numpy(), np.asarray(j_spmv(J, jnp.asarray(x))), **FWD)
    np.testing.assert_allclose(sv.numpy(), T.to_scipy() @ x, **FWD)


# ------------------------------------------------------ ops/fused_gnn


@pytest.mark.parametrize("straight", [True, False])
def test_gat_attention_and_its_gradient_match_jax(straight):
    T, J = _weighted(260, seed=3)
    rng = np.random.default_rng(4)
    Wh = rng.standard_normal((260, 12)).astype(np.float32)
    a1, a2 = (rng.standard_normal(12).astype(np.float32) for _ in range(2))
    v = rng.standard_normal(T.e_pad).astype(np.float32)
    x = [torch.from_numpy(a).requires_grad_(True) for a in (Wh, a1, a2)]
    e, s = tfn.gat_attention(T, *x, alpha=0.2, straight_through_scores=straight)
    ej, sj = jfn.gat_attention(J, *(jnp.asarray(a) for a in (Wh, a1, a2)), alpha=0.2,
                               straight_through_scores=straight)
    np.testing.assert_allclose(_np(e), np.asarray(ej), **FWD)
    np.testing.assert_allclose(_np(s), np.asarray(sj), **FWD)
    assert float(s.detach()[T.nnz:].abs().max()) == 0.0  # padding takes no probability
    (s * torch.from_numpy(v)).sum().backward()
    loss = lambda w, b, c: jnp.vdot(jfn.gat_attention(J, w, b, c, straight_through_scores=straight)[1], v)
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (Wh, a1, a2)))
    if straight:
        assert x[0].grad is None  # Wh takes no gradient through the scores
    else:
        np.testing.assert_allclose(_np(x[0].grad), np.asarray(want[0]), **GRAD)
    for got, w in zip(x[1:], want[1:]):
        np.testing.assert_allclose(_np(got.grad), np.asarray(w), **GRAD)


def test_edges_to_dense_matches_jax():
    rng = np.random.default_rng(5)
    r, c = rng.integers(0, 50, 300), rng.integers(0, 40, 300)  # duplicates sum
    T = pt.SparseMatrix.from_coo(r, c, np.ones(300, np.float32), (50, 40))
    vals = rng.standard_normal(T.e_pad).astype(np.float32)  # padding entries carry garbage
    assert T.e_pad > T.nnz
    got = tfn.edges_to_dense(T, torch.from_numpy(vals))
    want = jfn.edges_to_dense(to_jax(T), jnp.asarray(vals))
    assert got.shape == (50, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    dense = np.zeros((50, 40), np.float32)
    np.add.at(dense, (r[np.lexsort((c, r))], c[np.lexsort((c, r))]), vals[:300])
    np.testing.assert_allclose(got.numpy(), dense, **FWD)


@pytest.mark.parametrize("relu", [False, True])
def test_gat_layer_matches_jax(relu):
    T, J = _weighted(300, seed=6)
    rng = np.random.default_rng(7)
    X = rng.standard_normal((300, 20)).astype(np.float32)
    W = (rng.standard_normal((20, 8)) * 0.3).astype(np.float32)
    att = rng.standard_normal((16, 1)).astype(np.float32)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (X, W, att)]
    out = tfn.gat_layer(T, *xs, relu=relu)
    want = jfn.gat_layer(J, *(jnp.asarray(a) for a in (X, W, att)), relu=relu)
    np.testing.assert_allclose(_np(out), np.asarray(want), **FWD)
    v = rng.standard_normal(out.shape).astype(np.float32)
    (out * torch.from_numpy(v)).sum().backward()
    loss = lambda a, b, c: jnp.vdot(jfn.gat_layer(J, a, b, c, relu=relu), v)
    for got, w in zip(xs, jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (X, W, att)))):
        np.testing.assert_allclose(_np(got.grad), np.asarray(w), **GRAD)


# ----------------------------------------- ops/flash_gat.gat_attention_agg


@pytest.mark.parametrize("n,F,tb", [(260, 16, 128), (520, 32, 128), (300, 64, 256)])
def test_gat_attention_agg_matches_jax(n, F, tb):
    """K3 forward (plain here, the Pallas kernel in interpret mode there)
    and the edge backward against ``jax.grad`` of the JAX op, run as
    ``tests/test_flash_gat.py`` runs it."""
    T, J = _weighted(n, seed=n + F)
    Bj = jb.bsr_from_sparse(J, tb=tb, dtype=jnp.float32)
    Bt = tb_.bsr_from_sparse(T, tb=tb, dtype=torch.float32)
    rng = np.random.default_rng(n)
    s1, s2 = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    Wh = rng.standard_normal((n, F)).astype(np.float32)
    v = rng.standard_normal((n, F)).astype(np.float32)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (s1, s2, Wh)]
    out = tfg.gat_attention_agg(T, Bt, *xs)
    with torch.no_grad():
        assert torch.equal(out, tfg.flash_gat_forward(Bt, *xs))  # the forward is K3
        ref = tfg.gat_attention_agg_ref(T, *xs)
    np.testing.assert_allclose(_np(out), np.asarray(jfg.flash_gat_forward(Bj, *(jnp.asarray(a) for a in (s1, s2, Wh)))),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-2, atol=2e-2)  # bf16 products
    (out * torch.from_numpy(v)).sum().backward()
    loss = lambda a, b, c: jnp.vdot(jfg.gat_attention_agg(J, Bj, a, b, c), jnp.asarray(v))
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (s1, s2, Wh)))
    for name, got, w in zip(("ds1", "ds2", "dWh"), xs, want):
        assert got.grad.shape == w.shape, name
        np.testing.assert_allclose(_np(got.grad), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)


def test_gat_attention_agg_backward_is_the_edge_jacobian():
    """The edge backward is the exact gradient of the f32 edge-path spec
    (its forward differs from K3 by bf16 rounding only)."""
    T, _ = _weighted(300, seed=11)
    Bt = tb_.bsr_mask_from_sparse(T, tb=128)
    rng = np.random.default_rng(12)
    ops = [rng.standard_normal(300).astype(np.float32) * 2, rng.standard_normal(300).astype(np.float32) * 2,
           rng.standard_normal((300, 8)).astype(np.float32)]
    v = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    grads = []
    for fn in (lambda a, b, c: tfg.gat_attention_agg(T, Bt, a, b, c), lambda a, b, c: tfg.gat_attention_agg_ref(T, a, b, c)):
        xs = [torch.from_numpy(a).requires_grad_(True) for a in ops]
        (fn(*xs) * v).sum().backward()
        grads.append([x.grad for x in xs])
    for g, r in zip(*grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **GRAD)


# --------------------------------------- prepare_adjacency: dense_dtype


def test_dense_dtype_float32_matches_jax():
    T, J = _weighted(300, seed=13)
    jp = jdis.prepare_adjacency(J, method="dense", dense_dtype=jnp.float32)
    tp = tdis.prepare_adjacency(T, method="dense", dense_dtype=torch.float32, device="cpu")
    assert tp.dense.dtype == torch.float32 and jp.dense.dtype == jnp.float32
    np.testing.assert_array_equal(tp.dense.numpy(), np.asarray(jp.dense))
    H = np.random.default_rng(14).standard_normal((300, 16)).astype(np.float32)
    got = tdis.agg_matmul(tp, torch.from_numpy(H))
    np.testing.assert_allclose(got.numpy(), np.asarray(jdis.agg_matmul(jp, jnp.asarray(H))), **FWD)
    np.testing.assert_allclose(got.numpy(), T.to_scipy() @ H, **FWD)  # H is not rounded to bf16
    bf = tdis.agg_matmul(tdis.prepare_adjacency(T, method="dense", device="cpu"), torch.from_numpy(H))
    assert not torch.allclose(bf, got, rtol=1e-4, atol=1e-4)


def test_dense_dtype_sets_the_auto_budget_and_gat_train_is_kept():
    T, _ = _weighted(300, seed=15)
    budget = 300 * 300 * 3  # holds the bf16 matrix, not the f32 one
    for dtype, fits in ((torch.bfloat16, True), (torch.float32, False)):
        p = tdis.prepare_adjacency(T, dense_max_bytes=budget, dense_dtype=dtype, device="cpu")
        est = p.choice["costs"]
        assert ("dense" in est) == fits and p.kind == min(est, key=est.get)
    # gat_train reaches the layout chooser: below its size rule both take
    # full cover at tb 256; past it the chooser prices training and serving
    p = tdis.prepare_adjacency(T, method="xla", for_gat=True, gat_train=False, device="cpu")
    q = tdis.prepare_adjacency(T, method="xla", for_gat=True, device="cpu")
    assert p.choice["flash"] == q.choice["flash"] == (256, False, None)
    for k in ("tiles", "tile_rb", "tile_cb"):
        assert torch.equal(getattr(p.flash_tiles, k), getattr(q.flash_tiles, k)), k
    seen = []
    big = dataclasses.replace(tdis.H100_COSTS, flash_full_cover_n=0)
    real = tdis._flash_layout_costs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdis, "_flash_layout_costs", lambda A, **kw: seen.append(kw["train"]) or real(A, **kw))
        for train in (False, True):
            r = tdis.prepare_adjacency(T, method="xla", for_gat=True, gat_train=train, costs=big, device="cpu")
            est = real(T, train=train, costs=big)
            assert r.choice["flash"] == min(est, key=est.get)
    assert seen == [False, True]


# ---------------------------------------------------------------- remat


def _spies(monkeypatch, names):
    """Count the calls of kernel wrappers where the autograd Functions
    call them (the plain versions run on the CPU)."""
    calls = dict.fromkeys(names, 0)
    for mod, name in ((tdis, "bsr_spmm_fused"), (tfg, "flash_gat_hybrid_forward"), (tfg, "flash_gat_bwd_row"),
                      (tfg, "flash_gat_bwd_col")):
        if name in names:
            fn = getattr(mod, name)

            def spy(*a, _fn=fn, _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, name, spy)
    return calls


def _step(net, *inputs):
    net.zero_grad(set_to_none=True)
    out = net(*inputs)
    out.square().sum().backward()
    return out.detach(), {k: p.grad.clone() for k, p in net.named_parameters()}


def _twins(cls, *args, **kw):
    torch.manual_seed(0)
    a = cls(*args, dropout=0.0, **kw)
    b = cls(*args, dropout=0.0, remat=True, **kw)
    b.load_state_dict(a.state_dict())
    return a, b


@pytest.mark.parametrize("kind,want", [("gcn", {"bsr_spmm_fused": (4, 5)}),
                                       ("gat", {"flash_gat_hybrid_forward": (2, 4), "flash_gat_bwd_row": (2, 2),
                                                "flash_gat_bwd_col": (2, 2)})])
def test_remat_equals_the_plain_model_on_kernel_preps(monkeypatch, kind, want):
    """Logits and gradients bit-identical; the checkpoint recomputes the
    convolutions whose output the backward reads (both GAT layers: K6's
    stats; the ReLU layer of the GCN), and stops early in the last GCN
    layer, whose aggregation the backward does not read."""
    T = pt.sym_norm(*(lambda d: (d.edge_index, d.num_nodes))(pt.graph.datasets.powerlaw_node_classification(
        n=1024, num_features=16, num_classes=4, seed=1)))
    if kind == "gcn":
        prep = tdis.prepare_adjacency(T, method="hybrid", tb=128, device="cpu")
        nets = _twins(pt.GCNModel, 16, 8, 4)
    else:
        prep = tdis.prepare_adjacency(T, method="xla", for_gat=True, gat_tb=64, gat_rest_thresh=3, device="cpu")
        assert prep.gat_plan is not None
        nets = _twins(pt.GATModel, 16, 8, 4, nheads=2)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1024, 16)).astype(np.float32))
    calls = _spies(monkeypatch, want)
    res = []
    for net in nets:
        for k in calls:
            calls[k] = 0
        res.append(_step(net, prep, x) + (dict(calls),))
    (o0, g0, c0), (o1, g1, c1) = res
    assert torch.equal(o0, o1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert c0 == {k: v[0] for k, v in want.items()} and c1 == {k: v[1] for k, v in want.items()}
    with torch.no_grad():  # no checkpoint without grad
        for k in calls:
            calls[k] = 0
        nets[1](prep, x)
    assert sum(calls.values()) == {"gcn": 2, "gat": 2}[kind]


def _flax_pair(kind, n=200, F=12, C=3, hidden=8):
    """A flax model with ``remat=True`` and the port's twins (without and
    with remat) at its initial parameters, on the edge path (f32)."""
    d = pt.graph.datasets.sbm_node_classification(n=n, num_classes=C, num_features=F, seed=9)
    T = pt.sym_norm(d.edge_index, n)
    J = to_jax(T)
    kw = dict(num_features=F, hidden_channels=hidden, num_classes=C, dropout=0.0, remat=True)
    if kind == "gcn":
        model, cls, extra = JGCN(**kw), pt.GCNModel, {}
    else:
        model, cls, extra = JGAT(**kw, nheads=2), pt.GATModel, dict(nheads=2)
    variables = model.init(jax.random.PRNGKey(0), J, jnp.asarray(d.x))
    nets = _twins(cls, F, hidden, C, **extra)
    for net in nets:
        net.load_state_dict(params_from_jax(np_tree(variables)))
    return T, J, d.x, model, variables, nets


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_remat_matches_flax_remat(kind):
    """As ``tests/test_training.py::test_remat_model_matches``: the loss
    ``sum(logits ** 2)`` and its gradients, port remat against flax
    ``remat=True``, and bit-identical to the port without remat."""
    T, J, x, model, variables, nets = _flax_pair(kind)
    l0, g0 = jax.value_and_grad(lambda p: jnp.sum(model.apply(p, J, jnp.asarray(x)) ** 2))(variables)
    gj = params_from_jax(np_tree(g0))
    res = [_step(net, T, torch.from_numpy(x)) for net in nets]
    assert torch.equal(res[0][0], res[1][0])
    np.testing.assert_allclose(float(res[1][0].square().sum()), float(l0), rtol=1e-5)
    for k, g in res[1][1].items():
        assert torch.equal(g, res[0][1][k]), k
        np.testing.assert_allclose(g.numpy(), gj[k].numpy(), err_msg=k, **GRAD)


def test_remat_molecule_gcn_matches_flax_remat():
    gs = pt.graph.datasets.synthetic_molecules(num_graphs=20, seed=4)
    b = pt.graph.make_batches(gs, 20, pad_to=64)[0]
    model = JMol(num_features=7, hidden_channels=8, num_classes=2, dropout=0.0, remat=True)
    args = (jnp.asarray(b.x), jnp.asarray(b.graph_ids), b.num_graphs)
    J = to_jax(b.A)
    variables = model.init(jax.random.PRNGKey(1), J, *args)
    l0, g0 = jax.value_and_grad(lambda p: jnp.sum(model.apply(p, J, *args) ** 2))(variables)
    gj = params_from_jax(np_tree(g0))
    nets = _twins(pt.MoleculeGCN, 7, 8, 2)
    res = []
    for net in nets:
        net.load_state_dict(params_from_jax(np_tree(variables)))
        res.append(_step(net, b.A, torch.from_numpy(b.x), torch.from_numpy(b.graph_ids).long(), b.num_graphs))
    assert torch.equal(res[0][0], res[1][0])
    np.testing.assert_allclose(float(res[1][0].square().sum()), float(l0), rtol=1e-5)
    for k, g in res[1][1].items():
        assert torch.equal(g, res[0][1][k]), k
        np.testing.assert_allclose(g.numpy(), gj[k].numpy(), err_msg=k, **GRAD)


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_remat_records_telemetry_once_and_quantizes_the_adjacency_once(monkeypatch, kind):
    """Under remat a training step records each layer's telemetry once (the
    recompute records none) and quantizes each layer's adjacency once (the
    model quantizes it outside the checkpoint), with results identical to
    the quantized model without remat."""
    _, T = graph("weighted", n=384)
    prep = tdis.prepare_adjacency(T, method="hybrid", tb=128, rank1=False, device="cpu")
    cal = TCal.for_qbits(8, dict(a_max=float(np.max(T.vals))))
    cls, kw = (pt.GCNModel, {}) if kind == "gcn" else (pt.GATModel, dict(nheads=2))
    nets = _twins(cls, 16, 8, 4, calibration=cal, **kw)
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (384, 16)).astype(np.float32))
    records, quantized = [], []
    record = tlayers._AmaxMixin._record_amax

    def counting_record(self, *a):
        before = self.telemetry_stats
        record(self, *a)
        if self.telemetry_stats is not before:
            records.append(self)
    quantize = tlayers._quantize_adj
    monkeypatch.setattr(tlayers._AmaxMixin, "_record_amax", counting_record)
    monkeypatch.setattr(tlayers, "_quantize_adj", lambda A, q: quantized.append(q) or quantize(A, q))
    res = []
    for net in nets:
        for conv in (net.conv1, net.conv2):
            conv.telemetry = True
        records.clear()
        quantized.clear()
        res.append(_step(net, prep, x))
        assert records == [net.conv1, net.conv2]
        assert len(quantized) == 2
        assert net.conv1.telemetry and net.conv2.telemetry  # switched back on after the recompute
    assert torch.equal(res[0][0], res[1][0])
    for k in res[0][1]:
        assert torch.equal(res[0][1][k], res[1][1][k]), k


def test_remat_keeps_parameter_names():
    for cls, args in ((pt.GCNModel, (8, 4, 2)), (pt.GATModel, (8, 4, 2)), (pt.MoleculeGCN, (7, 4, 2))):
        assert list(cls(*args).state_dict()) == list(cls(*args, remat=True).state_dict())


# ------------------------------------------------- calibrate(MoleculeGCN)


def test_calibrate_molecule_gcn_matches_jax():
    """``calibrate`` on a MoleculeGCN batch, taken as the JAX package
    takes it (adjacency, features, graph ids, graph count of one batch):
    the same table."""
    gs = pt.graph.datasets.synthetic_molecules(num_graphs=24, seed=4)
    b = pt.graph.make_batches(gs, 12, rng=np.random.default_rng(0), pad_to=64)[0]
    J = to_jax(b.A)
    model = JMol(num_features=7, hidden_channels=16, num_classes=2, dropout=0.0)
    args = (jnp.asarray(b.x), jnp.asarray(b.graph_ids), b.num_graphs)
    variables = model.init(jax.random.PRNGKey(2), J, *args)
    net = pt.MoleculeGCN(7, 16, 2, dropout=0.0)
    net.load_state_dict(params_from_jax(np_tree(variables)))
    targs = (torch.from_numpy(b.x), torch.from_numpy(b.graph_ids).long(), b.num_graphs)
    tel_j = jauto.harvest_telemetry(model, variables, J, *args)
    tel_t = tauto.harvest_telemetry(net.eval(), b.A, *targs)
    assert list(tel_t) == list(tel_j) == ["conv1", "conv2"]
    for qbits in (8, 4):
        cj = jauto.calibrate(model, variables, J, *args, qbits=qbits)
        ct = tauto.calibrate(net, b.A, *targs, qbits=qbits)
        dj, dt = dataclasses.asdict(cj), dataclasses.asdict(ct)
        np.testing.assert_allclose(jax.tree_util.tree_leaves(dt), jax.tree_util.tree_leaves(dj), rtol=1e-6)
        assert dt["weights"] == dj["weights"] and dt["features"] == dj["features"]
    q = pt.MoleculeGCN(7, 16, 2, dropout=0.0, calibration=ct)
    assert q.conv1.quant == ct.layer_params(0) and q.conv2.quant == ct.layer_params(1)
