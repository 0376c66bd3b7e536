"""The driver entry twin (``sgracex1_tpu_torch.graft_entry``) and the
example programs (``sgracex1_tpu_torch.examples``) on the CPU at tiny
sizes: ``entry()``'s logits against the JAX ``__graft_entry__.entry()``
forward on the same parameters at the GAT model tests' 2e-2, each
example's ``main`` to its end, ``molecule_gcn`` on a MUTAG-format file
written here and its exit message without one."""

import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from sgracex1_tpu_torch import graft_entry
from sgracex1_tpu_torch.examples import distributed_training, molecule_gcn, ppi_gat, quantization_pipeline
from sgracex1_tpu_torch.nn import params_from_jax

torch.set_num_threads(1)


def test_entry_logits_match_jax_entry():
    jfn, (params, A, x) = jentry.entry()
    want = np.asarray(jax.jit(jfn)(params, A, x))
    fn, (model, prep, xt) = graft_entry.entry(device="cpu")
    assert prep.flash_tiles is not None and prep.choice["flash"] == (256, False, None)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    got = fn(model, prep, xt)
    assert got.shape == want.shape == (512, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_graft_entry_main_runs_entry_and_dry_run(capsys):
    graft_entry.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "entry ok: (512, 5)" in out and "dryrun_multichip ok: 4 shards on cpu" in out


def test_quantization_pipeline_main():
    acc = quantization_pipeline.main(["--epochs", "2", "--nodes", "200", "--device", "cpu"])
    assert set(acc) == {"float", "qat", "int8", "int8_sparse"} and all(0.0 <= a <= 1.0 for a in acc.values())
    assert acc["int8"] == acc["int8_sparse"]  # the tile form is the same integer pipeline


def test_ppi_gat_main():
    _, hist = ppi_gat.main(["--epochs", "1", "--graphs", "6", "--nodes", "120", "--device", "cpu"])
    assert len(hist.loss) > 0 and np.isfinite(hist.loss).all()


def test_distributed_training_main_two_shards():
    losses = distributed_training.main(["--shards", "2", "--epochs", "3", "--nodes", "256", "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all() and losses[-1] < losses[0]


def _write_mutag(root, graphs=170, seed=3):
    """MUTAG in the TU format: small molecules, 7 node labels, +-1 labels."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(5, 12, graphs)
    gid = np.repeat(np.arange(graphs), sizes)
    lo = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    edges = []
    for s, n in zip(lo, sizes):
        for i in range(n - 1):  # a chain and a few extra bonds
            edges += [(s + i + 1, s + i + 2), (s + i + 2, s + i + 1)]
        a, b = rng.integers(0, n, (2, 2))
        edges += [(s + i + 1, s + j + 1) for i, j in zip(a, b) if i != j]
    d = os.path.join(root, "MUTAG", "raw")
    os.makedirs(d)
    pre = os.path.join(d, "MUTAG")
    np.savetxt(pre + "_A.txt", np.array(edges), fmt="%d", delimiter=", ")
    np.savetxt(pre + "_graph_indicator.txt", gid + 1, fmt="%d")
    np.savetxt(pre + "_graph_labels.txt", rng.choice([-1, 1], graphs), fmt="%d")
    np.savetxt(pre + "_node_labels.txt", rng.integers(0, 7, len(gid)), fmt="%d")


def test_molecule_gcn_main_on_a_written_file_and_without_one(tmp_path, monkeypatch):
    _write_mutag(str(tmp_path))
    hist = molecule_gcn.main(["--data-root", str(tmp_path), "--epochs", "2", "--device", "cpu"])
    assert len(hist.test_acc) == 2 and 0.0 <= hist.best_test_acc <= 1.0
    monkeypatch.delenv("MUTAG_ROOT", raising=False)
    with pytest.raises(SystemExit, match="MUTAG data not found; pass --data-root or set MUTAG_ROOT"):
        molecule_gcn.main(["--device", "cpu"])
