"""train_node_classifier against the JAX loop from the same initial
parameters and prepared layouts, dropout from one seed, checkpoints, the
preload rule and prepare_from_config."""

import numpy as np
import pytest
import torch

from sgracex1_tpu.config import SGRACEConfig as JConfig
from sgracex1_tpu.ops import dispatch as jdis
from sgracex1_tpu.train import loop as jloop
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.graph import datasets as t_ds
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.train import checkpoint as tck
from sgracex1_tpu_torch.train import loop as tloop

from _torch_common import graph, model_pair

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["gcn", "gat-full", "gcn-pallas"])
def test_train_node_classifier_tracks_jax(kind, monkeypatch):
    d, e, jp, tp, model, variables, net = model_pair(kind, monkeypatch=monkeypatch)
    cfg = dict(num_epochs=5, learning_rate=0.01)
    _, hj = jloop.train_node_classifier(model, d, JConfig(**cfg), prepare=jp)
    state, ht = tloop.train_node_classifier(net, e, pt.SGRACEConfig(**cfg), prepare=tp, device="cpu")
    assert state.step == 5 and len(ht.loss) == 5
    # bf16 aggregations in both packages; Adam steps amplify the last bits
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-2, atol=1e-2)
    # an argmax flip of a node or two out of ~100 is allowed
    np.testing.assert_allclose(ht.train_acc, hj.train_acc, atol=0.02)
    np.testing.assert_allclose(ht.test_acc, hj.test_acc, atol=0.03)
    assert ht.loss[-1] < ht.loss[0]
    assert set(ht.best_params) == set(net.state_dict())
    assert all(v.device.type == "cpu" for v in ht.best_params.values())


def test_dropout_runs_repeat_from_one_seed():
    data = t_ds.sbm_node_classification(n=200, num_classes=3, seed=4)
    cfg = pt.SGRACEConfig(num_epochs=4, learning_rate=0.01)
    init = pt.GCNModel(data.num_features, 16, 3).state_dict()

    def run(seed):
        net = pt.GCNModel(data.num_features, 16, 3, dropout=0.5)
        net.load_state_dict(init)
        return tloop.train_node_classifier(net, data, cfg, seed=seed, prepare="xla", device="cpu")[1]

    a, b = run(7), run(7)
    assert a.loss == b.loss and a.train_acc == b.train_acc and a.test_acc == b.test_acc
    assert run(8).loss != a.loss  # another seed draws other masks


def test_checkpoints_and_preload_rule(tmp_path):
    data = t_ds.sbm_node_classification(n=150, num_classes=2, seed=5)
    cfg = pt.SGRACEConfig(num_epochs=3, learning_rate=0.01)
    net = pt.GATModel(data.num_features, 8, 2, nheads=2, generator=torch.Generator().manual_seed(2))
    state, hist = tloop.train_node_classifier(net, data, cfg, prepare="auto", device="cpu")
    path = str(tmp_path / "ck" / "best.pt")
    tck.save_checkpoint(path, hist.best_params)
    sd = tck.load_checkpoint(path, net.state_dict())
    for k, v in hist.best_params.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    with pytest.raises(KeyError):
        tck.load_checkpoint(path, {"other": torch.zeros(1)})
    # the full state: model, optimizer moments and step
    spath = str(tmp_path / "state.pt")
    tck.save_train_state(spath, state)
    fresh = tloop.TrainState(
        model=pt.GATModel(data.num_features, 8, 2, nheads=2),
        optimizer=None, step=0,
    )
    fresh.optimizer = torch.optim.Adam(fresh.model.parameters(), lr=0.01)
    tck.load_train_state(spath, fresh)
    assert fresh.step == 3
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[k], v, rtol=0, atol=0)
    m0 = next(iter(state.optimizer.state.values()))["exp_avg"]
    torch.testing.assert_close(next(iter(fresh.optimizer.state.values()))["exp_avg"], m0)
    # preload: fine-tuning starts from the checkpoint at the "very low" rate
    ft = pt.SGRACEConfig(num_epochs=1, preload=path)
    assert ft.resolved_learning_rate() == 1e-4
    assert ft.replace(learning_rate=0.5).resolved_learning_rate() == 0.5
    assert pt.SGRACEConfig(w_qbits=2).resolved_learning_rate() == 0.1
    net2 = pt.GATModel(data.num_features, 8, 2, nheads=2, generator=torch.Generator().manual_seed(9))
    st2, h2 = tloop.train_node_classifier(net2, data, ft.replace(num_epochs=0), prepare="auto", device="cpu")
    for k, v in hist.best_params.items():
        torch.testing.assert_close(st2.model.state_dict()[k], v, rtol=0, atol=0)
    assert st2.optimizer.param_groups[0]["lr"] == 1e-4


def test_prepare_from_config_rule():
    _, T = graph("symnorm", n=256)
    cfg = pt.SGRACEConfig()
    auto = tdis.prepare_from_config(T, cfg, device="cpu")  # the cost model's cheapest kind
    assert "dense" in auto.choice["costs"] and auto.kind == min(auto.choice["costs"], key=auto.choice["costs"].get)
    p = tdis.prepare_from_config(T, cfg, method="hybrid", for_gat=True, device="cpu")
    assert p.kind == "hybrid" and p.r1_row is not None and p.fused_t is not None
    assert p.flash_tiles is not None
    # use_pallas selects the pallas kind at the config's tiling, as in the JAX package
    pp = tdis.prepare_from_config(T, cfg.replace(use_pallas=True), device="cpu")
    assert pp.kind == "pallas" and pp.plan is not None and pp.plan_t is not None
    assert (pp.plan.rb, pp.plan.cb, pp.plan.be) == (128, 128, 2048)
    assert tdis.prepare_from_config(T, cfg.replace(use_pallas=True), method="xla", device="cpu").kind == "xla"
    # QAT remaps the adjacency values per call: value tiles, no rank-1 masks
    qp = tdis.prepare_from_config(T, cfg.replace(fake_quantization=True), method="hybrid", device="cpu")
    assert qp.r1_row is None and qp.bsr.tiles.dtype == torch.bfloat16 and qp.fused.colscale is None
    # model settings are the model's arguments, not config fields
    for field in (dict(dropout=0.1), dict(profiling=True), dict(track_amax=False)):
        with pytest.raises(TypeError):
            pt.SGRACEConfig(**field)
    assert tloop._uses_attention(pt.GATModel(4, 4, 2)) and not tloop._uses_attention(pt.GCNModel(4, 4, 2))


@pytest.mark.parametrize(
    "blocks,want",
    [((128, 128, 2048), (128, 128, 2048)), ((4, 64, 100), (8, 128, 1024)),
     ((1024, 1024, 1025), (1024, 1024, 2048)), ((256, 512, 3000), (256, 512, 3072))],
)
def test_prepare_from_config_clamps_the_tiling(blocks, want):
    """row_block >= 8, col_block >= 128, edge_block >= 1024 and rounded up
    to a multiple of 1024: the plans of both packages are identical."""
    J, T = graph("symnorm", n=300)
    kw = dict(use_pallas=True, row_block=blocks[0], col_block=blocks[1], edge_block=blocks[2])
    tp = tdis.prepare_from_config(T, pt.SGRACEConfig(**kw), device="cpu")
    jp = jdis.prepare_from_config(J, JConfig(**kw))
    assert tp.kind == jp.kind == "pallas"
    for p, q in ((tp.plan, jp.plan), (tp.plan_t, jp.plan_t)):
        assert (p.rb, p.cb, p.be) == (q.rb, q.cb, q.be) == want
        np.testing.assert_array_equal(p.perm.numpy(), np.asarray(q.perm).reshape(-1, q.be))
    # the defaults are the JAX package's
    assert (pt.SGRACEConfig().row_block, pt.SGRACEConfig().col_block, pt.SGRACEConfig().edge_block) == (
        JConfig().row_block, JConfig().col_block, JConfig().edge_block)


def test_use_pallas_trains_through_k9(monkeypatch):
    """SGRACEConfig(use_pallas=True) and prepare="pallas" both reach the
    plan kernel: two aggregations forward, two backward (on plan_t), two
    in the evaluation, every epoch."""
    calls = []
    kernel = tdis.spmm_plan
    monkeypatch.setattr(tdis, "spmm_plan", lambda plan, H: (calls.append(plan), kernel(plan, H))[1])
    data = t_ds.sbm_node_classification(n=200, num_classes=3, seed=6)
    for cfg, prepare in ((pt.SGRACEConfig(num_epochs=2, use_pallas=True), "auto"),
                         (pt.SGRACEConfig(num_epochs=2), "pallas")):
        calls.clear()
        net = pt.GCNModel(data.num_features, 8, 3, generator=torch.Generator().manual_seed(3))
        state, hist = tloop.train_node_classifier(net, data, cfg, prepare=prepare, device="cpu")
        assert state.step == 2 and np.isfinite(hist.loss).all()
        assert len(calls) == 12
        plans = {id(p) for p in calls}
        assert len(plans) == 2  # plan forward, plan_t backward
