"""A run of a cell on the CPU, past the harness's look for a card, with the
timed path broken underneath: ``correct`` comes out false for each fault a
cell can have (a step that leaves its state unchanged; half of the batch
left out, the mean over the rest; an answer altered where it is produced;
half of the answers left out). No cell spans chips, so no exchange
between chips can be left out. Also the harness's own refusals: no card,
JAX or the JAX package loaded."""

import sys
import types

import pytest
import torch

from portbench import run as R
from portbench.tests.conftest import small_run


@pytest.mark.parametrize("cell", ["gcn-products.train", "gcn-products.infer"])
def test_a_sound_run_is_correct(cell):
    out = small_run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


def test_step_that_leaves_state_unchanged(monkeypatch):
    from sgracex1_tpu_torch.train import loop

    def frozen(state, loss_fn):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        state.step += 1
        return loss

    monkeypatch.setattr(loop, "_train_step", frozen)
    out = small_run("gcn-products.train")
    assert not out["correct"]
    assert out["checks"]["step_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(monkeypatch):
    from sgracex1_tpu_torch.train import loop

    orig = loop._masked_xent

    def half(logits, y, mask):
        keep = mask * (torch.arange(mask.shape[0]) % 2 == 0)
        return orig(logits, y, keep)

    monkeypatch.setattr(loop, "_masked_xent", half)
    out = small_run("gcn-products.train")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["one_answer", "half_answers"])
def test_answers_altered_where_produced(monkeypatch, fault):
    from sgracex1_tpu_torch.nn import models

    cls = models.GCNModel
    orig = cls.forward

    def broken(self, A, x, **kw):
        out = orig(self, A, x, **kw).clone()
        if fault == "one_answer":
            out[17] += 1.0
        else:
            out[out.shape[0] // 2:] = 0.0
        return out

    monkeypatch.setattr(cls, "forward", broken)
    out = small_run("gcn-products.infer")
    assert not out["correct"], out["checks"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal where there is none")
    assert R.main(["--workload", "gcn-products.train", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sgracex1_tpu_torch_extra", types.ModuleType("x"))
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sgracex1_tpu.ops", types.ModuleType("y"))
    assert R.forbidden_modules() == ["sgracex1_tpu"]
