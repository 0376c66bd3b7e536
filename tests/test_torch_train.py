"""train_node_classifier against the JAX loop from the same initial
parameters and prepared layouts, dropout from one seed, checkpoints, the
preload rule and prepare_from_config."""

import numpy as np
import pytest
import torch

from sgracex1_tpu.config import SGRACEConfig as JConfig
from sgracex1_tpu.train import loop as jloop
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.graph import datasets as t_ds
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.train import checkpoint as tck
from sgracex1_tpu_torch.train import loop as tloop

from _torch_common import graph, model_pair

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["gcn", "gat-full"])
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
    assert tdis.prepare_from_config(T, cfg, device="cpu").kind == "dense"
    p = tdis.prepare_from_config(T, cfg, method="hybrid", for_gat=True, device="cpu")
    assert p.kind == "hybrid" and p.r1_row is not None and p.fused_t is not None
    assert p.flash_tiles is not None
    with pytest.raises(NotImplementedError, match="item 14"):
        tdis.prepare_from_config(T, cfg.replace(use_pallas=True), device="cpu")
    # QAT remaps the adjacency values per call: value tiles, no rank-1 masks
    qp = tdis.prepare_from_config(T, cfg.replace(fake_quantization=True), method="hybrid", device="cpu")
    assert qp.r1_row is None and qp.bsr.tiles.dtype == torch.bfloat16 and qp.fused.colscale is None
    # model settings are the model's arguments, not config fields
    with pytest.raises(TypeError):
        pt.SGRACEConfig(dropout=0.1)
    assert tloop._uses_attention(pt.GATModel(4, 4, 2)) and not tloop._uses_attention(pt.GCNModel(4, 4, 2))
