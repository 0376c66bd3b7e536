"""The port's cost model (``ops/dispatch``: ``_estimate_backend_costs``,
``_choose_flash_plan``, the hybrid and int8 thresholds;
``parallel/halo_fused._choose_shard_tb``) against the JAX package's on the
same graphs. Fed a table of the JAX constants (``jax_cost_table``, read
from the JAX modules), it must give the JAX costs (rel 1e-12) and choices,
and ``prepare_adjacency(method="auto")`` / ``for_gat`` the JAX prepare's
kind, tile size, threshold and layout (tile keys ``array_equal``). With
the card's ``H100_COSTS``, ``auto`` takes ``min(costs)`` of the port's own
model, can take ``pallas``, and ``gat_train`` changes the layout's price."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgracex1_tpu.graph import datasets as j_ds
from sgracex1_tpu.ops import dispatch as jdis
from sgracex1_tpu.parallel import halo_fused as jhf
from sgracex1_tpu.quant import int8 as jq
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.parallel import halo_fused as thf
from tests._torch_common import jax_cost_table, to_jax

torch.set_num_threads(1)

JT = jax_cost_table()


def _banded(n, extra, seed):
    """The banded + random graph of tests/test_int8.py, sym-normalized."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for d in (-2, -1, 1, 2):
        i = np.arange(max(0, -d), min(n, n - d))
        rows.append(i)
        cols.append(i + d)
    rows.append(rng.integers(0, n, extra))
    cols.append(rng.integers(0, n, extra))
    ei = np.unique(np.stack([np.concatenate(rows), np.concatenate(cols)]), axis=1)
    return pt.sym_norm(ei, n)


def _graph(name):
    """Port SparseMatrix of each test graph (numpy inputs from a seed)."""
    if name == "sbm512":
        d = j_ds.sbm_node_classification(n=512, num_classes=5, num_features=8, seed=0)
        return pt.sym_norm(d.edge_index, d.num_nodes)
    if name in ("powerlaw4096", "powerlaw16384"):
        n = 4096 if name == "powerlaw4096" else 1 << 14
        d = j_ds.powerlaw_node_classification(n=n, num_features=4, num_classes=3, seed=0)
        return pt.sym_norm(d.edge_index, n)
    if name == "banded":
        return _banded(3000, 2000, 0)
    if name == "pubmed":  # pubmed's descriptor: N 19 717, 108 365 edges, random positions and values
        rng = np.random.default_rng(11)
        n, m = 19717, 108365
        k = np.unique(rng.integers(0, n * n, 2 * m))[:m]
        return pt.SparseMatrix.from_coo(k // n, k % n, rng.uniform(0.05, 1.0, len(k)).astype(np.float32), (n, n))
    assert name == "empty"
    return pt.SparseMatrix.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32), (700, 700))


GRAPHS = ("sbm512", "powerlaw4096", "powerlaw16384", "banded", "pubmed", "empty")


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("rank1", [True, False])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_backend_costs_equal_jax(name, rank1, dtype):
    T = _graph(name)
    J = to_jax(T)
    jt, tt = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}[dtype]
    jc, jtb, jhy = jdis._estimate_backend_costs(J, jt, rank1=rank1)
    tc, ttb, thy = tdis._estimate_backend_costs(T, tt, rank1=rank1, costs=JT)
    assert set(jc) == set(tc) and (jtb, jhy) == (ttb, thy)
    for k in jc:
        assert tc[k] == pytest.approx(jc[k], rel=1e-12, abs=0), k


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("hybrid", [True, False])
def test_flash_plan_equals_jax(name, train, hybrid):
    T = _graph(name)
    n = max(T.n_rows, T.n_cols)
    want = jdis._choose_flash_plan(to_jax(T), n, hybrid=hybrid, train=train)
    assert tdis._choose_flash_plan(T, n, hybrid=hybrid, train=train, costs=JT) == want
    if not hybrid:
        assert tdis._choose_flash_tb(T, n, costs=JT) == jdis._choose_flash_tb(to_jax(T), n)


def test_flash_plan_equals_jax_past_the_full_cover_size():
    """The same graphs with the size rule lowered (both packages), so
    that every graph's hybrid ladder is priced: the JAX rule is patched to
    the port table's."""
    import dataclasses

    jt = dataclasses.replace(JT, flash_full_cover_n=0)
    for name in GRAPHS[:-1]:
        T = _graph(name)
        n = max(T.n_rows, T.n_cols)
        for train in (True, False):
            got = tdis._choose_flash_plan(T, n + 8192, train=train, costs=jt)
            want = jdis._choose_flash_plan(to_jax(T), n + 8192, train=train)
            assert got == want, (name, train)


def _shards(T, S):
    n = T.n_rows // S
    out = []
    r, c, v = (np.asarray(x)[: T.nnz] for x in (T.rows, T.cols, T.vals))
    for s in range(S):
        keep = (r // n == s) & (c // n == s)
        out.append(pt.SparseMatrix.from_coo(r[keep] - s * n, c[keep] - s * n, v[keep], (n, n)))
    return out


@pytest.mark.parametrize("name", ["powerlaw4096", "powerlaw16384", "banded", "sbm512"])
@pytest.mark.parametrize("rank1", [True, False])
def test_shard_tb_and_int8_threshold_equal_jax(name, rank1):
    T = _graph(name)
    A_ls = _shards(T, 4)
    assert thf._choose_shard_tb(A_ls, rank1, costs=JT) == jhf._choose_shard_tb([to_jax(A) for A in A_ls], rank1)
    from sgracex1_tpu_torch.quant.affine import QuantConstants as TConst
    from sgracex1_tpu.quant.affine import QuantConstants as JConst

    for tb in (128, 256):
        c = dict(s_o=1.0, s=1.0 / 255.0, z=0, qbits=8, signed=False)
        jp = jq.prepare_int8_hybrid(to_jax(T), JConst(**c), tb=tb, K=128)
        tp = pt.quant.int8.prepare_int8_hybrid(T, TConst(**c), tb=tb, costs=JT, device="cpu")
        assert tp.num_rest_chunks == jp.num_rest_chunks
        np.testing.assert_array_equal(tp.step_tile.numpy(), np.asarray(jp.step_tile))


def _tile_keys(B):
    return np.asarray(B.tile_rb, np.int64) << 32 | np.asarray(B.tile_cb, np.int64)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("rank1", [True, False])
def test_auto_and_for_gat_prepare_like_jax(name, rank1):
    """``method="auto"`` with ``for_gat``: the JAX kind, tile size,
    threshold (the remainder's edges) and flash layout (tile keys)."""
    T = _graph(name)
    J = to_jax(T)
    jp = jdis.prepare_adjacency(J, rank1=rank1, for_gat=True, build_transpose=False)
    tp = tdis.prepare_adjacency(T, rank1=rank1, for_gat=True, build_transpose=False, costs=JT, device="cpu")
    assert tp.kind == jp.kind
    assert tp.kind == min(tp.choice["costs"], key=tp.choice["costs"].get)
    if jp.bsr is not None:
        assert tp.bsr.tb == jp.bsr.tb
        np.testing.assert_array_equal(_tile_keys(tp.bsr), _tile_keys(jp.bsr))
        assert (0 if tp.rest is None else tp.rest.nnz) == (0 if jp.rest is None else jp.rest.nnz)
    jb, tb = jp.flash_tiles, tp.flash_tiles
    assert (jb is None) == (tb is None) and (jp.gat_plan is None) == (tp.gat_plan is None)
    if tb is not None:
        assert (tb.tb, tb.packed) == (jb.tb, jb.tiles.shape[-1] != jb.tb)
        np.testing.assert_array_equal(_tile_keys(tb), _tile_keys(jb))


@pytest.mark.parametrize("name", ["powerlaw16384", "pubmed"])
def test_hybrid_without_tb_and_for_gat_past_the_size_rule_like_jax(name, monkeypatch):
    """``method="hybrid"`` without ``tb``: the model's split; with ``tb``:
    the model's threshold at it. The flash layout past the size rule (both
    packages' rule lowered), training and serving."""
    import dataclasses

    T = _graph(name)
    J = to_jax(T)
    jp = jdis.prepare_adjacency(J, method="hybrid", build_transpose=False)
    tp = tdis.prepare_adjacency(T, method="hybrid", build_transpose=False, costs=JT, device="cpu")
    assert tp.bsr.tb == jp.bsr.tb and tp.choice["split"][0] == tp.bsr.tb
    np.testing.assert_array_equal(_tile_keys(tp.bsr), _tile_keys(jp.bsr))
    jp = jdis.prepare_adjacency(J, method="hybrid", tb=128, build_transpose=False)
    tp = tdis.prepare_adjacency(T, method="hybrid", tb=128, build_transpose=False, costs=JT, device="cpu")
    np.testing.assert_array_equal(_tile_keys(tp.bsr), _tile_keys(jp.bsr))
    jt = dataclasses.replace(JT, flash_full_cover_n=0)
    real = jdis._choose_flash_plan
    monkeypatch.setattr(jdis, "_choose_flash_plan", lambda A, n, hybrid=True, train=True: real(A, n + 8192,
                                                                                              hybrid=hybrid,
                                                                                              train=train))
    for train in (True, False):
        jp = jdis.prepare_adjacency(J, method="xla", for_gat=True, gat_train=train)
        tp = tdis.prepare_adjacency(T, method="xla", for_gat=True, gat_train=train, costs=jt, device="cpu")
        assert (tp.gat_plan is None) == (jp.gat_plan is None)
        assert tp.gat_bsr.tb == jp.gat_bsr.tb
        np.testing.assert_array_equal(_tile_keys(tp.gat_bsr), _tile_keys(jp.gat_bsr))
        if tp.gat_plan is not None:
            assert tp.gat_rest.nnz == jp.gat_rest.nnz


@pytest.mark.parametrize("name", ["sbm512", "powerlaw16384", "pubmed"])
def test_card_table_auto_takes_its_own_min(name):
    T = _graph(name)
    p = tdis.prepare_adjacency(T, build_transpose=False, device="cpu")
    rank1 = pt.graph.normalize.rank1_factor(T) is not None
    want, _, _ = tdis._estimate_backend_costs(T, torch.bfloat16, rank1=rank1)
    n = max(T.n_rows, T.n_cols)
    if n * n * 2 > tdis.DENSE_MAX_BYTES:
        want.pop("dense")
    est = p.choice["costs"]
    assert est == pytest.approx(want, rel=1e-12) and p.kind == min(est, key=est.get)
    assert p.choice["seconds"] > 0


@pytest.mark.parametrize("name", ["powerlaw16384", "pubmed"])
def test_card_table_can_pick_pallas_and_gat_train_changes_the_price(name):
    """With H100_COSTS, ``auto`` prices ``pallas`` beside the tile routes
    and takes it on the pubmed-descriptor graph (uniform positions: no
    dense tile, and K9's edges cost less than K2's chunks); every flash
    layout costs more to train than to serve, and the chooser takes the
    cheapest of each."""
    T = _graph(name)
    est, _, _ = tdis._estimate_backend_costs(T, torch.bfloat16)
    assert set(est) == {"dense", "xla", "bsr", "hybrid", "pallas"} and est["pallas"] > 0
    if name == "pubmed":
        p = tdis.prepare_adjacency(T, build_transpose=False, device="cpu")
        assert p.kind == "pallas" and p.plan is not None and p.plan_t is not None
    train = tdis._flash_layout_costs(T, train=True)
    serve = tdis._flash_layout_costs(T, train=False)
    assert train.keys() == serve.keys() and all(train[k] > serve[k] for k in train)
    big = max(T.n_rows, T.n_cols) + tdis.H100_COSTS.flash_full_cover_n
    assert tdis._choose_flash_plan(T, big, train=True) == min(train, key=train.get)
    assert tdis._choose_flash_plan(T, big, train=False) == min(serve, key=serve.get)
