"""Sticky shape padding of re-prepared batches against the JAX package:
``ops/fused_agg.pad_fused_plan`` and ``train/loop._pad_prep_tiles`` give
identical arrays and sticky targets; a padded plan aggregates exactly as
the unpadded one, and its live schedules (what the ring kernels walk) are
the unpadded plan's."""

import numpy as np
import pytest
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import dispatch as jdis
from sgracex1_tpu.ops import fused_agg as jf
from sgracex1_tpu.train import loop as jloop
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.ops import fused_agg as tf
from sgracex1_tpu_torch.train import loop as tloop

from _torch_common import jax_cost_table, jax_thresh

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

PLAN_FIELDS = ("step_rb", "step_cb", "step_tile", "step_chunk", "step_kind", "slot_col", "slot_scale")


def _skewed(seed, n=4096, tb=128, hub=600, e_pad=None):
    """The JAX package's skewed rank-1 test graph (tests/test_fused_agg.py):
    a self-loop band plus ``hub`` scattered edges in row block 3, so the
    hybrid split leaves several chunks there; both packages' matrices."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), rng.integers(3 * tb, 4 * tb, hub)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), rng.integers(0, n, hub)])
    ei = np.unique(np.stack([rows, cols]), axis=1)
    T = pt.sym_norm(ei, n, fill=1.0)
    if e_pad is not None:
        T = T.pad_edges_to(e_pad).with_uniform_nnz()
    J = JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)
    return J, T


def _preps(J, T, tb=128):
    """Both packages' hybrid preps at tb with the JAX threshold, the port's
    chunk widths chosen on the JAX constants: identical fused plans."""
    jp = jdis.prepare_adjacency(J, method="hybrid", tb=tb)
    tp = tdis.prepare_adjacency(T, method="hybrid", tb=tb, rest_thresh=jax_thresh(tb, True),
                                costs=jax_cost_table(), device="cpu")
    return jp, tp


def _same_plan(pj, p):
    for k in PLAN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(pj, k)), getattr(p, k).numpy(), err_msg=k)
    np.testing.assert_array_equal(np.asarray(pj.lrow)[:, 0, :], p.lrow.numpy())
    np.testing.assert_array_equal(np.asarray(pj.B.tiles), p.B.tiles.numpy())
    np.testing.assert_array_equal(np.asarray(pj.B.tile_rb), p.B.tile_rb.numpy())
    np.testing.assert_array_equal(np.asarray(pj.B.tile_cb), p.B.tile_cb.numpy())
    assert pj.K == p.K and pj.num_steps == p.num_steps


def _same_schedule(a, b):
    assert torch.equal(a.step, b.step) and torch.equal(a.rb, b.rb)
    for k, v in a.segments.tensors().items():
        assert torch.equal(v, getattr(b.segments, k)), k


def _H(n, P=64, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, P)).astype(np.float32))


@pytest.mark.parametrize("pad", [(7, 5, 2, 2), (0, 0, 1, 1), (3, 0, 1, 1), (0, 4, 0, 1), (0, 0, 0, 4)])
def test_pad_fused_plan_matches_jax(pad):
    """The JAX test's paddings (tests/test_fused_agg.py: S+7, T+5, R+2, 2K;
    R-only) and the steps-, tiles- and K-only ones: identical arrays, the
    plain K2 output unchanged bit for bit, the ring schedule unchanged."""
    J, T = _skewed(0)
    jp, tp = _preps(J, T)
    _same_plan(jp.fused, tp.fused)
    plan, pj = tp.fused, jp.fused
    dS, dT, dR, kmul = pad
    if dS and not dR:
        pytest.skip("padding steps need a dead chunk: R grows with S")  # never asked by _pad_prep_tiles
    tgt = dict(S=plan.num_steps + dS, T=plan.B.num_tiles + dT, R=plan.num_chunks + dR, K=plan.K * kmul)
    padded, jpadded = tf.pad_fused_plan(plan, **tgt), jf.pad_fused_plan(pj, **tgt)
    _same_plan(jpadded, padded)
    assert (padded.num_steps, padded.B.num_tiles, padded.num_chunks, padded.K) == tuple(tgt.values())
    assert padded.num_rest_chunks == plan.num_rest_chunks
    H = _H(T.n_cols)
    assert torch.equal(tf.bsr_spmm_fused_plain(padded, H), tf.bsr_spmm_fused_plain(plan, H))
    assert padded.ring is plan.ring
    # rebuilt from the padded arrays, the ring schedule is the same: padding
    # steps hold no live slot and pad tiles are dead
    rebuilt = tf.build_fused_plan(plan.B, tdis._drop_zero_val_edges(tp.rest), K=plan.K, attach_chunks=True,
                                  r1_row=tp.r1_row.numpy(), r1_col=tp.r1_col.numpy())
    _same_schedule(rebuilt.ring, padded.ring)


def test_pad_fused_plan_refuses():
    J, T = _skewed(1)
    _, tp = _preps(J, T)
    plan = tp.fused
    S, Tn, R, K = plan.num_steps, plan.B.num_tiles, plan.num_chunks, plan.K
    assert tf.pad_fused_plan(plan, S=S, T=Tn, R=R, K=K) is plan
    for bad in (dict(S=S - 1, T=Tn, R=R + 1, K=K), dict(S=S, T=Tn - 1, R=R, K=K), dict(S=S, T=Tn, R=R, K=K // 2)):
        with pytest.raises(ValueError, match="dominate"):
            tf.pad_fused_plan(plan, **bad)
    kplan = tf.build_fused_plan(plan.B, tdis._drop_zero_val_edges(tp.rest), k_steps=2,
                                r1_row=tp.r1_row.numpy(), r1_col=tp.r1_col.numpy())
    with pytest.raises(ValueError, match="k_steps"):
        tf.pad_fused_plan(kplan, S=kplan.num_steps + 2, T=Tn, R=kplan.num_chunks + 1, K=K)


def test_pad_fused_plan_rebuilds_slot_lv8():
    """A plan with the int8 ring's slab bytes keeps them in step with its
    padded slots."""
    from sgracex1_tpu_torch.quant import int8 as tq
    from sgracex1_tpu_torch.quant.affine import QuantConstants

    J, T = _skewed(2)
    c_a = QuantConstants(s_o=1.0, s=float(np.asarray(T.vals).max()) / 255.0, z=0, qbits=8, signed=False)
    plan = tq.prepare_int8_hybrid(T, c_a, tb=128, rest_thresh=jax_thresh(128, True), device="cpu")
    assert plan.K == tf.DEFAULT_K and plan.slot_lv8 is not None
    padded = tf.pad_fused_plan(plan, S=plan.num_steps + 3, T=plan.B.num_tiles, R=plan.num_chunks + 1, K=2 * plan.K)
    want = tf._slot_lv8(padded.lrow.numpy(), padded.slot_scale.numpy())
    assert torch.equal(padded.slot_lv8, torch.from_numpy(want)) and padded.edge_ring is plan.edge_ring
    Hq = torch.from_numpy(np.random.default_rng(4).integers(-128, 128, (T.n_cols, 32)).astype(np.int8))
    assert torch.equal(tf.bsr_spmm_int8_fused_plain(padded, Hq), tf.bsr_spmm_int8_fused_plain(plan, Hq))


def _check_prep_pair(jp, tp):
    """A padded prep of each package: identical tiles and plans, ``rest``
    dropped, the same aggregation."""
    for f in ("bsr", "bsr_t"):
        a, b = getattr(jp, f), getattr(tp, f)
        np.testing.assert_array_equal(np.asarray(a.tiles), b.tiles.numpy())
        np.testing.assert_array_equal(np.asarray(a.tile_rb), b.tile_rb.numpy())
    _same_plan(jp.fused, tp.fused)
    _same_plan(jp.fused_t, tp.fused_t)
    assert jp.rest is None and tp.rest is None


def test_pad_prep_tiles_sequence_matches_jax():
    """The JAX test's sequence (tests/test_fused_agg.py): two sampled-shaped
    preps of different sizes through the sticky padding, then the first
    re-padded: identical sticky targets and arrays in both packages, one
    shape for both preps, and the live schedules and the aggregation of
    each padded prep those of its unpadded prep."""
    jsticky, tsticky = {}, {}
    pairs = []
    for seed, hub in ((0, 500), (1, 900)):
        J, T = _skewed(seed, hub=hub, e_pad=16384)
        jp, tp = _preps(J, T)
        pairs.append([jp, tp, jloop._pad_prep_tiles(jp, jsticky), tloop._pad_prep_tiles(tp, tsticky), T])
    pairs[0][2] = jloop._pad_prep_tiles(pairs[0][2], jsticky)
    pairs[0][3] = tloop._pad_prep_tiles(pairs[0][3], tsticky)
    assert jsticky == tsticky
    shapes = set()
    for jp, tp, jpad, tpad, T in pairs:
        _check_prep_pair(jpad, tpad)
        shapes.add((tpad.bsr.num_tiles, tpad.fused.num_steps, tpad.fused.num_chunks, tpad.fused.K,
                    tpad.fused_t.num_steps, tpad.fused_t.num_chunks))
        for f in ("fused", "fused_t"):
            _same_schedule(getattr(tp, f).ring, getattr(tpad, f).ring)
        for f in ("bsr", "bsr_t"):
            _same_schedule(getattr(tp, f).ring, getattr(tpad, f).ring)
        # a plan's tiles are its tile set's padded tiles, not a second copy
        assert tpad.fused.B is tpad.bsr and tpad.fused_t.B is tpad.bsr_t
        H = _H(T.n_cols, seed=6)
        assert torch.equal(tdis.agg_matmul(tpad, H), tdis.agg_matmul(tp, H))
        g = torch.from_numpy(np.random.default_rng(7).standard_normal((T.n_rows, 64)).astype(np.float32))
        assert torch.equal(tf.bsr_spmm_fused_plain(tpad.fused_t, g), tf.bsr_spmm_fused_plain(tp.fused_t, g))
    assert len(shapes) == 1


def test_pad_prep_tiles_last_chunk_live():
    """Where a plan's chunks reach the sticky chunk target and its last
    chunk is live, the target moves one further, so the padding steps read
    a dead chunk (JAX keeps the target, and its padding steps would read
    that live chunk)."""
    J, T = _skewed(3, hub=700)
    _, tp = _preps(J, T)
    f = tp.fused
    assert f.num_rest_chunks == f.num_chunks > 0
    sticky = {("fused", 128): (f.num_steps + 4, f.B.num_tiles, f.num_chunks, f.K),
              ("fused_t", 128): (tp.fused_t.num_steps, tp.fused_t.B.num_tiles, tp.fused_t.num_chunks + 1, f.K)}
    pad = tloop._pad_prep_tiles(tp, sticky)
    assert pad.fused.num_chunks == f.num_chunks + 1 and sticky[("fused", 128)][2] == f.num_chunks + 1
    H = _H(T.n_cols, seed=8)
    assert torch.equal(tf.bsr_spmm_fused_plain(pad.fused, H), tf.bsr_spmm_fused_plain(f, H))


def test_pad_prep_tiles_gat_rest_matches_jax(monkeypatch):
    """A for_gat prep with the hybrid attention split: ``gat_bsr`` padded,
    ``gat_rest`` padded to the sticky edge count with nnz == e_pad, as JAX."""
    J, T = _skewed(4, n=2048)
    monkeypatch.setattr(jdis, "_choose_flash_plan", lambda A, n, hybrid=True, train=True: (128, False, 4))
    jp = jdis.prepare_adjacency(J, method="xla", for_gat=True)
    tp = tdis.prepare_adjacency(T, method="xla", for_gat=True, gat_tb=128, gat_rest_thresh=4, device="cpu")
    assert jp.gat_rest is not None and tp.gat_rest is not None
    jsticky = {("gat_bsr", 128): jp.gat_bsr.num_tiles + 3, "gat_rest_pad": jp.gat_rest.e_pad + 256}
    tsticky = dict(jsticky)
    jpad, tpad = jloop._pad_prep_tiles(jp, jsticky), tloop._pad_prep_tiles(tp, tsticky)
    assert jsticky == tsticky
    for k in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(np.asarray(getattr(jpad.gat_rest, k)), getattr(tpad.gat_rest, k).numpy())
    assert tpad.gat_rest.nnz == jpad.gat_rest.nnz == tpad.gat_rest.e_pad
    np.testing.assert_array_equal(np.asarray(jpad.gat_bsr.tiles), tpad.gat_bsr.tiles.numpy())
    _same_schedule(tp.gat_bsr.ring, tpad.gat_bsr.ring)
    # the padded prep gives the same attention layer, forward and backward
    net = pt.GATModel(16, 8, 3, nheads=2, dropout=0.0, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2048, 16)).astype(np.float32))
    outs = []
    for prep in (tp, tpad):
        net.zero_grad()
        y = net(prep, x)
        y.square().sum().backward()
        outs.append((y.detach(), [p.grad.clone() for p in net.parameters()]))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(outs[1][1], outs[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_batch_loops_pad_every_prep(monkeypatch):
    """The three batch loops pad each batch's prep where the JAX loops do:
    the sampled loop once a batch, the staging loops once a batch and once
    more at the final maxima."""
    calls = []
    pad = tloop._pad_prep_tiles
    monkeypatch.setattr(tloop, "_pad_prep_tiles", lambda p, s: (calls.append(p), pad(p, s))[1])
    from sgracex1_tpu_torch.graph import batch as t_batch, datasets as t_ds

    e = t_ds.sbm_node_classification(n=300, num_classes=3, seed=2)
    cfg = pt.SGRACEConfig(num_epochs=2, learning_rate=0.01)
    net = pt.GCNModel(e.num_features, 8, 3, dropout=0.0)
    tloop.train_node_classifier_sampled(net, e, cfg, batch_size=128, fanouts=(4, 4), prepare="hybrid", device="cpu")
    n_batches = -(-int(e.train_mask.sum()) // 128)
    assert len(calls) == 2 * n_batches
    calls.clear()
    mols = t_ds.synthetic_molecules(num_graphs=40, seed=1)
    bt = t_batch.make_batches(mols[:32], 16, rng=np.random.default_rng(0), pad_to=64)
    tt = t_batch.make_batches(mols[32:], 16, pad_to=64)
    mnet = pt.MoleculeGCN(7, 16, 2)
    tloop.train_graph_classifier(mnet, bt, tt, cfg, prepare="bsr", device="cpu")
    assert len(calls) == 2 * (len(bt) + len(tt))
    # the second pass takes the first pass's preps to the final maxima: one shape
    final = [pad(p, {}) for p in calls[len(bt) + len(tt):]]
    assert len({(p.bsr.num_tiles, p.fused.num_steps, p.fused.num_chunks, p.fused.K) for p in final}) == 1
    calls.clear()
    tr, va, te = t_ds.synthetic_ppi(num_graphs=4, n_per=60, num_features=8, num_labels=3, splits=(1, 1))
    gnet = pt.GATModel(8, 8, 3, nheads=2, dropout=0.0)
    tloop.train_multilabel_inductive(gnet, tr, va, te, cfg, device="cpu")
    assert len(calls) == 2 * 4 and all(p.flash_tiles is not None for p in calls)
