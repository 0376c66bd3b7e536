"""Inductive multi-label training (PPI) against the JAX package:
synthetic_ppi, micro_f1 and _pad_multilabel_graph identical, the flash
tiles of a padded graph identical, and five epochs of
train_multilabel_inductive against the JAX loop from the same initial
parameters, with the model chosen on validation F1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgracex1_tpu.config import SGRACEConfig as JConfig
from sgracex1_tpu.graph import datasets as j_ds
from sgracex1_tpu.nn.models import GATModel as JGAT
from sgracex1_tpu.ops import dispatch as jdis
from sgracex1_tpu.train import loop as jloop
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.graph import datasets as t_ds
from sgracex1_tpu_torch.nn import params_from_jax
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.train import loop as tloop

from _torch_common import np_tree

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

PPI = dict(num_graphs=5, n_per=160, num_features=24, num_labels=8, splits=(1, 1), seed=7)


def test_synthetic_ppi_identical():
    sj, st = j_ds.synthetic_ppi(**PPI), t_ds.synthetic_ppi(**PPI)
    assert [len(s) for s in st] == [3, 1, 1]
    for a, b in zip(sum(sj, []), sum(st, [])):
        for k in ("edge_index", "x", "y"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        assert (b.num_nodes, b.num_features, b.num_labels) == (160, 24, 8)


def test_micro_f1_identical():
    rng = np.random.default_rng(2)
    for shape in ((7, 3), (50, 12)):
        p, t = rng.random(shape) < 0.4, rng.random(shape) < 0.3
        assert tloop.micro_f1(p, t) == jloop.micro_f1(p, t)
    pred = np.array([[1, 0], [1, 1]], bool)
    tgt = np.array([[1, 1], [0, 1]], bool)
    assert tloop.micro_f1(pred, tgt) == pytest.approx(4 / 6)
    assert tloop.micro_f1(np.zeros((2, 2), bool), np.zeros((2, 2), bool)) == 0.0


@pytest.mark.parametrize("fill", [1.0, 0.5])
def test_pad_multilabel_graph_identical(fill):
    """The padded graph, then its edges padded to a larger e_pad with
    nnz == e_pad (the loop's shared edge count), identical."""
    g_j, g_t = j_ds.synthetic_ppi(**PPI)[0][1], t_ds.synthetic_ppi(**PPI)[0][1]
    aj, at = jloop._pad_multilabel_graph(g_j, 256, fill), tloop._pad_multilabel_graph(g_t, 256, fill)
    for x, y in zip(aj[1:], at[1:]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for Mj, Mt in ((aj[0], at[0]),
                   (aj[0].pad_edges_to(aj[0].e_pad + 384).with_uniform_nnz(),
                    at[0].pad_edges_to(at[0].e_pad + 384).with_uniform_nnz())):
        for k in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(np.asarray(getattr(Mj, k)), getattr(Mt, k), err_msg=k)
        assert (Mj.shape, Mj.nnz, Mj.e_pad, Mj.rows_sorted) == (Mt.shape, Mt.nnz, Mt.e_pad, Mt.rows_sorted)


def test_padded_graph_flash_tiles_identical(monkeypatch):
    """Full-cover flash tiles at tb 256 of a graph whose padding edges (row
    n_pad - 1, col 0, value 0) count as real: identical to the JAX
    package's, and the padding row holds no entry (the mask builder drops
    zero-valued edges; the full-cover layout does not drop them first)."""
    monkeypatch.setattr(jdis, "_choose_flash_plan", lambda A, n, hybrid=True, train=True: (256, False, None))
    g_j, g_t = j_ds.synthetic_ppi(**PPI)[0][0], t_ds.synthetic_ppi(**PPI)[0][0]
    Aj = jloop._pad_multilabel_graph(g_j, 384, 1.0)[0]
    At = tloop._pad_multilabel_graph(g_t, 384, 1.0)[0]
    Aj, At = (A.pad_edges_to(A.e_pad + 512).with_uniform_nnz() for A in (Aj, At))
    jp = jdis.prepare_adjacency(Aj, method="xla", for_gat=True)
    tp = tdis.prepare_from_config(At, pt.SGRACEConfig(), method="xla", for_gat=True, device="cpu")
    assert tp.gat_plan is None
    # the config's auto prepare takes the model's cheapest kind (dense fits)
    auto = tdis.prepare_from_config(At, pt.SGRACEConfig(), device="cpu")
    est = auto.choice["costs"]
    assert "dense" in est and auto.kind == min(est, key=est.get)
    Bj, Bt = jp.flash_tiles, tp.flash_tiles
    assert Bt.tb == 256 and Bt.tiles.dtype == torch.int8
    for k in ("tiles", "tile_rb", "tile_cb"):
        np.testing.assert_array_equal(np.asarray(getattr(Bj, k)), getattr(Bt, k).numpy(), err_msg=k)
    dense = np.zeros((512, 512), np.int8)
    for t, r, c in zip(Bt.tiles.numpy(), Bt.tile_rb.numpy(), Bt.tile_cb.numpy()):
        dense[r * 256:(r + 1) * 256, c * 256:(c + 1) * 256] = t
    n = g_t.num_nodes
    want = np.zeros((512, 512), np.int8)
    want[:n, :n] = At.to_dense()[:n, :n] > 0
    assert At.to_dense()[383, 0] == 0 and At.nnz > (want != 0).sum()
    np.testing.assert_array_equal(dense, want)


def _ppi_pair(seed=12345):
    """Both packages' graphs and GATModel with the JAX loop's initial
    parameters (``PRNGKey(seed)`` split once)."""
    sj, st = j_ds.synthetic_ppi(**PPI), t_ds.synthetic_ppi(**PPI)
    model = JGAT(num_features=24, hidden_channels=32, num_classes=8, nheads=2, dropout=0.0)
    A0, x0, _, _ = jloop._pad_multilabel_graph(sj[0][0], 256, 1.0)
    _, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    variables = model.init(init_rng, jdis.prepare_adjacency(A0, method="xla", for_gat=True), jnp.asarray(x0))
    net = pt.GATModel(24, 32, 8, nheads=2, dropout=0.0)
    net.load_state_dict(params_from_jax(np_tree(variables)))
    return sj, st, model, net


def test_multilabel_loop_tracks_jax():
    """Five epochs on for_gat preps (the plain K3 forward, K4/K5 backward
    here; Pallas interpret mode in the JAX loop). The model kept is the
    one of the best validation F1: its parameters give that F1 again."""
    sj, st, model, net = _ppi_pair()
    _, hj = jloop.train_multilabel_inductive(model, *sj, JConfig(num_epochs=5, learning_rate=0.01))
    state, ht = tloop.train_multilabel_inductive(
        net, *st, pt.SGRACEConfig(num_epochs=5, learning_rate=0.01), device="cpu")
    assert state.step == 15 and len(ht.loss) == 5
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(ht.train_acc, hj.train_acc, atol=0.02)
    np.testing.assert_allclose(ht.test_acc, hj.test_acc, atol=0.03)
    np.testing.assert_allclose(ht.best_test_acc, hj.best_test_acc, atol=0.03)
    assert ht.loss[-1] < ht.loss[0]
    # the kept parameters reproduce the best validation F1
    net.load_state_dict(ht.best_params)
    A, x, y, m = tloop._pad_multilabel_graph(st[1][0], 256, 1.0)
    tp = tdis.prepare_from_config(A, pt.SGRACEConfig(), for_gat=True, device="cpu")
    net.eval()
    with torch.no_grad():
        pred = (net(tp, torch.from_numpy(x)) > 0).numpy()[m > 0]
    assert tloop.micro_f1(pred, y[m > 0]) == pytest.approx(ht.best_test_acc, abs=1e-6)


def test_multilabel_loop_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = t_ds.synthetic_ppi(**PPI)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tloop.train_multilabel_inductive(pt.GATModel(24, 8, 8), *st, pt.SGRACEConfig(num_epochs=1))
