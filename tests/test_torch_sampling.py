"""sgracex1_tpu_torch.graph.sampling and train_node_classifier_sampled
against the JAX package: identical sampled batches from one numpy seed,
the hybrid layouts of a padded sampled batch, and five sampled epochs
against the JAX loop from the same initial parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgracex1_tpu.config import SGRACEConfig as JConfig
from sgracex1_tpu.graph import datasets as j_ds
from sgracex1_tpu.graph import sampling as j_smp
from sgracex1_tpu.nn.models import GCNModel as JGCN
from sgracex1_tpu.ops import dispatch as jdis
from sgracex1_tpu.train import loop as jloop
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.graph import datasets as t_ds
from sgracex1_tpu_torch.graph import sampling as t_smp
from sgracex1_tpu_torch.nn import params_from_jax
from sgracex1_tpu_torch.ops import bsr as tb_
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.ops import fused_agg as tf
from sgracex1_tpu_torch.train import loop as tloop

from _torch_common import jax_thresh, np_tree
from test_torch_fused_agg import _ring_flow

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _assert_same_matrix(a, b):
    for k in ("rows", "cols", "vals"):
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert (a.shape, a.nnz, a.rows_sorted) == (b.shape, b.nnz, b.rows_sorted)


@pytest.mark.parametrize("fanouts", [(5, 5), (3, 8, 2)])
def test_sampler_identical(fanouts):
    d = t_ds.powerlaw_node_classification(n=600, num_features=8, num_classes=3, seed=1)
    js = j_smp.NeighborSampler(d.edge_index, d.num_nodes)
    ts = t_smp.NeighborSampler(d.edge_index, d.num_nodes)
    np.testing.assert_array_equal(js.rowptr, ts.rowptr)
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    for seeds in (np.array([0, 5, 17, 200]), np.arange(300, 340)):
        (ei_j, ids_j), (ei_t, ids_t) = js.sample(seeds, fanouts, ra), ts.sample(seeds, fanouts, rb)
        np.testing.assert_array_equal(ei_j, ei_t)
        np.testing.assert_array_equal(ids_j, ids_t)
        np.testing.assert_array_equal(ids_t[: len(seeds)], seeds)
    assert ra.random() == rb.random()  # both drew the same stream


def test_neighbor_batches_identical_with_pad_floors():
    """Every field of every batch, over two epochs where the second keeps
    the first's pad floors (and a third with floors above what it samples)."""
    d = t_ds.sbm_node_classification(n=300, num_classes=3, seed=1)
    train = np.nonzero(d.train_mask)[0]
    ra, rb = np.random.default_rng(0), np.random.default_rng(0)
    floors = dict(n_pad=0, e_pad=0)
    for epoch in range(3):
        kw = dict(batch_size=32, fanouts=(4, 4), **floors)
        if epoch == 2:
            kw.update(n_pad=floors["n_pad"] + 256, e_pad=floors["e_pad"] + 1000)
        bj = j_smp.make_neighbor_batches(d.edge_index, d.x, d.y, train, rng=ra, **kw)
        bt = t_smp.make_neighbor_batches(d.edge_index, d.x, d.y, train, rng=rb, **kw)
        assert len(bj) == len(bt) > 2
        for a, b in zip(bj, bt):
            _assert_same_matrix(a.A, b.A)
            assert b.A.nnz == b.A.e_pad
            for k in ("x", "y", "seed_mask", "node_ids"):
                x, y = getattr(a, k), getattr(b, k)
                assert x.dtype == y.dtype, k
                np.testing.assert_array_equal(x, y, err_msg=k)
        assert {(b.x.shape, b.A.e_pad) for b in bt} == {(bt[0].x.shape, bt[0].A.e_pad)}
        if epoch == 2:
            assert bt[0].x.shape[0] == kw["n_pad"] and bt[0].A.e_pad >= kw["e_pad"]
        floors = dict(n_pad=bt[0].x.shape[0], e_pad=bt[0].A.e_pad)


def _sampled_batch(n=8192, batch_size=512):
    """A padded sampled batch in both packages (the same numpy stream)."""
    d = t_ds.powerlaw_node_classification(n=n, num_features=8, num_classes=3, seed=2)
    train = np.nonzero(d.train_mask)[0]
    kw = dict(batch_size=batch_size, fanouts=(10, 10))
    bj = j_smp.make_neighbor_batches(d.edge_index, d.x, d.y, train, rng=np.random.default_rng(1), **kw)
    bt = t_smp.make_neighbor_batches(d.edge_index, d.x, d.y, train, rng=np.random.default_rng(1), **kw)
    return bj, bt


def test_sampled_hybrid_layout_and_ring_schedule():
    """A sampled batch (n_pad a multiple of 128, its padding edges counted
    as real by with_uniform_nnz) prepared hybrid at tb 256: the tiles and
    both fused plans identical to the JAX package's; the tile the padding
    fills past the threshold is a dead tile no ring walks; the ring's data
    flow (chunk-only work items included) equals the plain K2, forward and
    on fused_t; and the ring kernels take the shapes. n_pad is 4.5 row
    blocks of the port's default tb 256, so the last one is partial."""
    bj, bt = _sampled_batch()
    tb, thresh = 256, jax_thresh(256, True)
    seen_pad_tile = chunk_only = False
    for a, b in list(zip(bj, bt))[-2:]:
        jp = jdis.prepare_adjacency(a.A, method="hybrid", tb=tb)
        tp = tdis.prepare_adjacency(b.A, method="hybrid", tb=tb, rest_thresh=thresh, device="cpu")
        assert jp.kind == tp.kind == "hybrid" and tp.r1_row is not None
        n_pad = b.A.n_rows
        assert n_pad % 128 == 0 and n_pad % 256 and tp.bsr.n_row_tiles * tb == n_pad + 128
        for jb_, tb2 in ((jp.bsr, tp.bsr), (jp.bsr_t, tp.bsr_t)):
            np.testing.assert_array_equal(np.asarray(jb_.tiles), tb2.tiles.numpy())
            np.testing.assert_array_equal(np.asarray(jb_.tile_rb), tb2.tile_rb.numpy())
            np.testing.assert_array_equal(np.asarray(jb_.tile_cb), tb2.tile_cb.numpy())
        for pj, p in ((jp.fused, tp.fused), (jp.fused_t, tp.fused_t)):
            for k in ("step_rb", "step_cb", "step_tile", "step_chunk", "step_kind", "slot_col", "slot_scale"):
                np.testing.assert_array_equal(np.asarray(getattr(pj, k)), getattr(p, k).numpy(), err_msg=k)
            np.testing.assert_array_equal(np.asarray(pj.lrow)[:, 0, :], p.lrow.numpy())
        # the padding edges sit at (n_pad - 1, 0): their tile may pass the
        # threshold on edge count alone, but it holds no live entry
        n_padding = b.A.e_pad - int((np.asarray(b.A.vals) != 0).sum())
        B = tp.bsr
        pad_tile = np.flatnonzero((B.tile_rb.numpy() == B.n_row_tiles - 1) & (B.tile_cb.numpy() == 0))
        real = (b.A.rows // tb == B.n_row_tiles - 1) & (b.A.cols < tb) & (b.A.vals != 0)
        if len(pad_tile) and not real.any():
            seen_pad_tile = seen_pad_tile or n_padding >= thresh
            assert not B.live[pad_tile[0]]
            assert pad_tile[0] not in tp.fused.ring.step[:, 0].tolist()
            assert pad_tile[0] not in B.ring.step[:, 0].tolist()
        H = torch.from_numpy(np.random.default_rng(4).standard_normal((n_pad, 64)).astype(np.float32))
        for plan in (tp.fused, tp.fused_t):
            assert tb_.ring_shape_ok(tb_._tile_mode(plan.B.tiles, tb), tb, 64, plan.K)
            chunk_only |= bool(((plan.ring.step[:, 0] < 0) & (plan.ring.step[:, 2] >= 0)).any())
            ref = tf.bsr_spmm_fused_plain(plan, H)
            for seg_steps in (4, 64):
                out, _ = _ring_flow(plan, H, seg_steps)
                torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2 * float(ref.abs().max()))
    assert seen_pad_tile and chunk_only


def _loop_pair(prepare, n=300):
    """Both packages' data and models at the JAX loop's initial parameters
    (``PRNGKey(seed)`` split once)."""
    d = j_ds.sbm_node_classification(n=n, num_classes=3, seed=2)
    e = t_ds.sbm_node_classification(n=n, num_classes=3, seed=2)
    model = JGCN(num_features=d.num_features, hidden_channels=16, num_classes=3, dropout=0.0)
    _, init_rng = jax.random.split(jax.random.PRNGKey(12345))
    from sgracex1_tpu.graph.normalize import sym_norm as jsym

    variables = model.init(init_rng, jsym(d.edge_index, n), jnp.asarray(d.x))
    net = pt.GCNModel(d.num_features, 16, 3, dropout=0.0)
    net.load_state_dict(params_from_jax(np_tree(variables)))
    return d, e, model, net


@pytest.mark.parametrize("prepare", ["xla", "dense"])
def test_sampled_loop_tracks_jax(prepare):
    d, e, model, net = _loop_pair(prepare)
    cfg = dict(num_epochs=5, learning_rate=0.01)
    kw = dict(batch_size=64, fanouts=(8, 8), prepare=prepare)
    _, hj = jloop.train_node_classifier_sampled(model, d, JConfig(**cfg), **kw)
    state, ht = tloop.train_node_classifier_sampled(net, e, pt.SGRACEConfig(**cfg), device="cpu", **kw)
    n_batches = -(-int(e.train_mask.sum()) // 64)
    assert state.step == 5 * n_batches and len(ht.loss) == 5
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(ht.train_acc, hj.train_acc, atol=0.02)
    np.testing.assert_allclose(ht.test_acc, hj.test_acc, atol=0.03)
    assert ht.best_test_acc == max(ht.test_acc) and set(ht.best_params) == set(net.state_dict())


def test_sampled_loop_hybrid_tracks_xla(monkeypatch):
    """Port only: every batch and the full graph prepared hybrid (the plain
    K2 on the CPU, bf16 in and out) track the port's own edge-path run."""
    kinds = []
    prepare = tloop._prepare_backend
    monkeypatch.setattr(tloop, "_prepare_backend",
                        lambda *a: (lambda p: (kinds.append(getattr(p, "kind", None)), p)[1])(prepare(*a)))
    runs = {}
    for method in ("xla", "hybrid"):
        _, e, _, net = _loop_pair(method)
        cfg = pt.SGRACEConfig(num_epochs=5, learning_rate=0.01)
        runs[method] = tloop.train_node_classifier_sampled(
            net, e, cfg, batch_size=64, fanouts=(8, 8), prepare=method, device="cpu")[1]
    assert kinds.count("hybrid") == kinds.count("xla") == 1 + 5 * 3
    hx, hh = runs["xla"], runs["hybrid"]
    np.testing.assert_allclose(hh.loss, hx.loss, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(hh.train_acc, hx.train_acc, atol=0.02)
    np.testing.assert_allclose(hh.test_acc, hx.test_acc, atol=0.03)


def test_sampled_loop_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = t_ds.sbm_node_classification(n=100, num_classes=2, seed=1)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tloop.train_node_classifier_sampled(pt.GCNModel(e.num_features, 8, 2), e, pt.SGRACEConfig(num_epochs=1))


@pytest.mark.parametrize("loop", ["sampled", "graph", "multilabel"])
def test_batch_loops_refuse_one_prep(loop):
    """A loop that prepares every batch takes a method name, not one prep
    for all its batches."""
    e = t_ds.sbm_node_classification(n=100, num_classes=2, seed=1)
    A = pt.graph.sym_norm(e.edge_index, e.num_nodes)
    prep = tdis.prepare_from_config(A, pt.SGRACEConfig(), method="dense", device="cpu")
    cfg, net = pt.SGRACEConfig(num_epochs=1), pt.GCNModel(e.num_features, 8, 2)
    run = {
        "sampled": lambda: tloop.train_node_classifier_sampled(net, e, cfg, prepare=prep, device="cpu"),
        "graph": lambda: tloop.train_graph_classifier(net, [], [], cfg, prepare=prep, device="cpu"),
        "multilabel": lambda: tloop.train_multilabel_inductive(net, [], [], [], cfg, prepare=prep, device="cpu"),
    }[loop]
    with pytest.raises(ValueError, match="method name"):
        run()
