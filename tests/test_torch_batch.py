"""sgracex1_tpu_torch.graph.batch, global_mean_pool, MoleculeGCN and
train_graph_classifier against the JAX package: identical molecule sets
and block-diagonal batches from one seed, pooled means and logits against
flax, and five epochs against the JAX loop from the same initial
parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgracex1_tpu.config import SGRACEConfig as JConfig
from sgracex1_tpu.graph import batch as j_batch
from sgracex1_tpu.graph import datasets as j_ds
from sgracex1_tpu.nn.models import MoleculeGCN as JMol
from sgracex1_tpu.nn.models import global_mean_pool as j_pool
from sgracex1_tpu.ops import dispatch as jdis
from sgracex1_tpu.train import loop as jloop
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.graph import batch as t_batch
from sgracex1_tpu_torch.graph import datasets as t_ds
from sgracex1_tpu_torch.nn import global_mean_pool, params_from_jax
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.train import loop as tloop

from _torch_common import np_tree

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _assert_same_batch(a, b):
    for k in ("rows", "cols", "vals"):
        x, y = np.asarray(getattr(a.A, k)), np.asarray(getattr(b.A, k))
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert (a.A.shape, a.A.nnz, a.A.e_pad, a.A.rows_sorted) == (b.A.shape, b.A.nnz, b.A.e_pad, b.A.rows_sorted)
    for k in ("x", "graph_ids", "y", "label_mask"):
        x, y = np.asarray(getattr(a, k)), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.num_graphs == b.num_graphs and isinstance(b.num_graphs, int)


def test_synthetic_molecules_identical():
    gj = j_ds.synthetic_molecules(num_graphs=40, seed=4)
    gt = t_ds.synthetic_molecules(num_graphs=40, seed=4)
    assert len(gj) == len(gt) == 40 and {g.y for g in gt} == {0, 1}
    for a, b in zip(gj, gt):
        assert a.y == b.y and a.num_nodes == b.num_nodes
        for k in ("edge_index", "x"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("normalize", [True, False])
def test_batch_graphs_identical(normalize):
    gj = j_ds.synthetic_molecules(num_graphs=6, seed=1)
    gt = t_ds.synthetic_molecules(num_graphs=6, seed=1)
    kw = dict(n_pad=192, g_pad=8, normalize=normalize, pad_to=64)
    _assert_same_batch(j_batch.batch_graphs(gj, **kw), t_batch.batch_graphs(gt, **kw))
    with pytest.raises(ValueError):
        t_batch.batch_graphs(gt, n_pad=192, g_pad=6)
    with pytest.raises(ValueError):
        t_batch.batch_graphs(gt, n_pad=64, g_pad=8)


@pytest.mark.parametrize("pad_to", [64, 128])
def test_make_batches_identical(pad_to):
    """Shuffled and in order; one n_pad, one e_pad and nnz == e_pad over
    every batch, as in the JAX package."""
    gj = j_ds.synthetic_molecules(num_graphs=70, seed=2)
    gt = t_ds.synthetic_molecules(num_graphs=70, seed=2)
    for rng in (True, False):
        bj = j_batch.make_batches(gj, 16, rng=np.random.default_rng(0) if rng else None, pad_to=pad_to)
        bt = t_batch.make_batches(gt, 16, rng=np.random.default_rng(0) if rng else None, pad_to=pad_to)
        assert len(bj) == len(bt) == 5
        for a, b in zip(bj, bt):
            _assert_same_batch(a, b)
        assert len({(b.x.shape, b.A.e_pad, b.A.nnz) for b in bt}) == 1 and bt[0].A.nnz == bt[0].A.e_pad


def test_global_mean_pool_matches_jax():
    """Per-graph means; an empty slot gives zeros; bf16 rows are counted
    in float32 (a bf16 count stops at 256 and rounds past it)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((700, 12)).astype(np.float32)
    gid = np.sort(rng.integers(0, 5, 700)).astype(np.int32)
    gid[-300:] = 6  # one slot of 300 rows; slot 5 stays empty
    ref = np.asarray(j_pool(jnp.asarray(x), jnp.asarray(gid), 8))
    out = global_mean_pool(torch.from_numpy(x), torch.from_numpy(gid), 8)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert not out[5].any() and not out[7].any()
    xb = torch.ones(700, 4, dtype=torch.bfloat16)
    pooled = global_mean_pool(xb, torch.from_numpy(gid), 8)
    assert pooled.dtype == torch.bfloat16 and torch.equal(pooled[6], torch.ones(4, dtype=torch.bfloat16))


def _mol_pair(n_graphs=60, hidden=16, seed=12345):
    """Batches in both packages and MoleculeGCN with the JAX loop's initial
    parameters (``PRNGKey(seed)`` split once)."""
    gj = j_ds.synthetic_molecules(num_graphs=n_graphs, seed=4)
    gt = t_ds.synthetic_molecules(num_graphs=n_graphs, seed=4)
    n_tr = n_graphs * 4 // 5
    bj = (j_batch.make_batches(gj[:n_tr], 16, rng=np.random.default_rng(0), pad_to=64),
          j_batch.make_batches(gj[n_tr:], 16, pad_to=64))
    bt = (t_batch.make_batches(gt[:n_tr], 16, rng=np.random.default_rng(0), pad_to=64),
          t_batch.make_batches(gt[n_tr:], 16, pad_to=64))
    model = JMol(num_features=7, hidden_channels=hidden, num_classes=2, dropout=0.0)
    _, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    b0 = bj[0][0]
    variables = model.init(init_rng, b0.A, jnp.asarray(b0.x), jnp.asarray(b0.graph_ids), b0.num_graphs)
    net = pt.MoleculeGCN(7, hidden, 2, dropout=0.0)
    net.load_state_dict(params_from_jax(np_tree(variables)))
    return bj, bt, model, variables, net


def test_molecule_gcn_logits_match_flax():
    bj, bt, model, variables, net = _mol_pair()
    assert set(net.state_dict()) == {"conv1.weight", "conv2.weight", "head.weight", "head.bias"}
    net.eval()
    for a, b in zip(bj[0] + bj[1], bt[0] + bt[1]):
        jp = jdis.prepare_adjacency(a.A, method="xla")
        ref = np.asarray(model.apply(variables, jp, jnp.asarray(a.x), jnp.asarray(a.graph_ids), a.num_graphs))
        tp = tdis.prepare_adjacency(b.A, method="xla", device="cpu")
        with torch.no_grad():
            out = net(tp, torch.from_numpy(b.x), torch.from_numpy(b.graph_ids), b.num_graphs)
        assert out.shape == (17, 2)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prepare", ["xla", "bsr"])
def test_graph_classifier_tracks_jax(prepare):
    """Five epochs from the same parameters; on ``bsr`` both packages run
    their fused tile kernels (K2's plain version here) on the
    block-diagonal batches, bf16 in and out."""
    bj, bt, model, _, net = _mol_pair()
    cfg = dict(num_epochs=5, learning_rate=0.01)
    _, hj = jloop.train_graph_classifier(model, *bj, JConfig(**cfg), prepare=prepare)
    state, ht = tloop.train_graph_classifier(net, *bt, pt.SGRACEConfig(**cfg), prepare=prepare, device="cpu")
    assert state.step == 5 * len(bt[0]) and len(ht.loss) == 5
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(ht.train_acc, hj.train_acc, atol=0.02)
    np.testing.assert_allclose(ht.test_acc, hj.test_acc, atol=0.03)
    assert ht.best_test_acc == max(ht.test_acc) and set(ht.best_params) == set(net.state_dict())


def test_graph_classifier_runs_k2_on_bsr(monkeypatch):
    """prepare="bsr": every batch prepared once before the first epoch;
    each step runs K2 twice forward and twice on fused_t, each batch's
    evaluation twice."""
    calls = []
    kernel = tdis.bsr_spmm_fused
    monkeypatch.setattr(tdis, "bsr_spmm_fused", lambda plan, H: (calls.append(plan), kernel(plan, H))[1])
    _, bt, _, _, net = _mol_pair()
    cfg = pt.SGRACEConfig(num_epochs=2, learning_rate=0.01)
    state, hist = tloop.train_graph_classifier(net, *bt, cfg, prepare="bsr", device="cpu")
    n_tr, n_te = len(bt[0]), len(bt[1])
    assert len(calls) == 2 * (4 * n_tr + 2 * (n_tr + n_te))
    # fused and fused_t of each training batch, fused of each test batch
    assert len({id(p) for p in calls}) == 2 * n_tr + n_te


def test_graph_classifier_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, bt, _, _, net = _mol_pair(n_graphs=20)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tloop.train_graph_classifier(net, *bt, pt.SGRACEConfig(num_epochs=1))
