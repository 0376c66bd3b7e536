"""The sharded train-state pair (``train/checkpoint.save_train_state_sharded``
/ ``load_train_state_sharded``, on ``torch.distributed.checkpoint``) against
the JAX package's orbax pair: the same ``directory/step_{step}`` layout, and
a trained GCNModel's parameters and Adam state round-trip, from the same
initial parameters as the JAX loop's."""

import os

import jax
import numpy as np
import pytest
import torch

from sgracex1_tpu.config import SGRACEConfig as JConfig
from sgracex1_tpu.train import checkpoint as jck
from sgracex1_tpu.train import loop as jloop
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.nn import params_from_jax
from sgracex1_tpu_torch.train import checkpoint as tck
from sgracex1_tpu_torch.train import loop as tloop

from _torch_common import model_pair, np_tree

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _fresh(net_like, lr=0.01):
    """A TrainState of a new model of the same shape, with Adam state from
    one step of its own (other values than the trained state's)."""
    net = pt.GCNModel(16, 16, 4, dropout=0.0, generator=torch.Generator().manual_seed(9))
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    state = tloop.TrainState(model=net, optimizer=opt)
    tloop._train_step(state, lambda: sum(p.square().sum() for p in net.parameters()))
    return state


@pytest.mark.filterwarnings("ignore:torch.distributed is disabled")
def test_sharded_train_state_round_trips_like_orbax(tmp_path):
    d, e, jp, tp, model, variables, net = model_pair("gcn")
    cfg = dict(num_epochs=3, learning_rate=0.01)
    jstate, _ = jloop.train_node_classifier(model, d, JConfig(**cfg), prepare=jp)
    state, _ = tloop.train_node_classifier(net, e, pt.SGRACEConfig(**cfg), prepare=tp, device="cpu")
    assert state.step == 3
    jck.save_train_state_orbax(str(tmp_path / "jax"), jstate.params, step=3)
    tck.save_train_state_sharded(str(tmp_path / "torch"), state, 3)
    assert os.path.isdir(tmp_path / "jax" / "step_3") and os.path.isdir(tmp_path / "torch" / "step_3")

    restored_j = jck.load_train_state_orbax(str(tmp_path / "jax"), jax.device_get(jstate.params), step=3)
    other = _fresh(net)
    back = tck.load_train_state_sharded(str(tmp_path / "torch"), other, 3)
    assert back is other and back.step == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    saved, got = state.optimizer.state_dict(), back.optimizer.state_dict()
    assert saved["param_groups"] == got["param_groups"]
    for i, st in saved["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(got["state"][i][k]), torch.as_tensor(v)), (i, k)
    # both packages restore what they trained, from the same initial parameters
    want = params_from_jax(np_tree(restored_j))
    for k, v in back.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=5e-2, atol=5e-2, err_msg=k)
    # the restored optimizer takes the same next step as the saved one
    x = torch.from_numpy(e.x)
    loss = lambda s: s.model(tp, x).square().mean()
    tloop._train_step(state, lambda: loss(state))
    tloop._train_step(back, lambda: loss(back))
    for k, v in state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k


@pytest.mark.filterwarnings("ignore:torch.distributed is disabled")
def test_sharded_train_state_steps_apart(tmp_path):
    """Two steps' checkpoints sit side by side; each loads its own."""
    states = []
    for seed in (1, 2):
        s = _fresh(None)
        with torch.no_grad():
            for p in s.model.parameters():
                p.add_(seed)
        s.step = seed
        tck.save_train_state_sharded(str(tmp_path), s, seed)
        states.append(s)
    for seed, s in zip((1, 2), states):
        back = tck.load_train_state_sharded(str(tmp_path), _fresh(None), seed)
        assert back.step == seed
        for k, v in s.model.state_dict().items():
            assert torch.equal(back.model.state_dict()[k], v)
