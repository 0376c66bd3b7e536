"""The fused plan's chunk-width chooser (``build_fused_plan(K=None)``,
``ops/dispatch.choose_chunk_k``) against the JAX package: on the JAX
constants (``_torch_common.jax_cost_table``) it takes the JAX K, and the
hybrid prepare's fused pair is the JAX package's, array for array; on the
card's table it prices the remainder at the width the plan takes."""

import numpy as np
import pytest
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import bsr as jb
from sgracex1_tpu.ops import dispatch as jdis
from sgracex1_tpu.ops import fused_agg as jf
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.graph import datasets as t_ds
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.ops import bsr as tb_
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.ops import fused_agg as tf

from _torch_common import jax_cost_table
from test_torch_padding import _same_plan

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _to_jax(T):
    return JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)


def _band_and_rest(counts, n=1024, tb=128, seed=0):
    """Diagonal mask tiles covering every row block and a value-mode
    remainder of ``counts[b]`` edges in row block b (distinct columns,
    values in (0.5, 1.5)): both packages' tiles, tile keys and remainder."""
    rng = np.random.default_rng(seed)
    part = TSparse.from_coo(np.arange(n), np.arange(n), np.ones(n, np.float32), (n, n))
    rows = np.concatenate([b * tb + rng.integers(0, tb, c) for b, c in enumerate(counts)])
    cols = np.concatenate([rng.choice(n, c, replace=False) for c in counts])
    vals = rng.uniform(0.5, 1.5, len(rows)).astype(np.float32)
    rest = TSparse.from_coo(rows, cols, vals, (n, n))
    cover = dict(cover_rows=True, cover_cols=True)
    keys = tb_.bsr_tile_keys(part, tb, **cover)
    Bj = jb.bsr_mask_from_sparse(_to_jax(part), tb=tb, device_build=False, **cover)
    Bt = tb_.bsr_mask_from_sparse(part, tb=tb, **cover)
    return Bj, Bt, keys, rest


@pytest.mark.parametrize("counts,want", [((100, 3, 0, 90, 0, 0, 0, 7), 128), ((200, 180, 0, 0, 0, 0, 0, 0), 256),
                                         ((300, 290, 0, 0, 0, 0, 0, 0), 512), ((0,) * 8, 128)])
@pytest.mark.parametrize("attach", [False, True])
def test_chooser_takes_the_jax_k(counts, want, attach):
    Bj, Bt, keys, rest = _band_and_rest(counts)
    pj = jf.build_fused_plan(Bj, _to_jax(rest) if rest.nnz else None, K=None, tile_keys=keys, attach_chunks=attach)
    assert pj.K == want
    assert tdis.choose_chunk_k(np.asarray(counts), 128, jax_cost_table()) == want
    p = tf.build_fused_plan(Bt, rest if rest.nnz else None, K=None, costs=jax_cost_table(), tile_keys=keys,
                            attach_chunks=attach)
    _same_plan(pj, p)


def _graphs():
    pw = t_ds.powerlaw_node_classification(n=4096, num_features=8, num_classes=4, seed=3)
    sbm = t_ds.sbm_node_classification(n=2048, num_classes=4, seed=4)
    # 3000 edges from 256 hub rows to every column: at the JAX split's tile
    # size (1024) they stay remainder, a few hundred a row block
    n = 16384
    rng = np.random.default_rng(5)
    hub = np.stack([rng.integers(0, 256, 3000), rng.integers(0, n, 3000)])
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n])
    # uniform pairs both ways, ~190 remainder edges a row block of 256:
    # the card's table takes K = 256 there
    pairs = np.random.default_rng(6).integers(0, n, (2, 3 * n // 8))
    return {
        "sparse": pt.sym_norm(np.concatenate([pairs, pairs[::-1]], axis=1), n),
        "powerlaw": pt.sym_norm(pw.edge_index, 4096),
        "sbm": pt.sym_norm(sbm.edge_index, 2048),
        "hub": pt.sym_norm(np.unique(np.concatenate([hub, hub[::-1], ring, ring[::-1]], axis=1), axis=1), n),
    }


@pytest.mark.parametrize("name", ["powerlaw", "sbm", "hub"])
def test_hybrid_prepare_matches_jax(name):
    """``prepare_adjacency(method="hybrid")`` without a tile size: the same
    split and the same chunk width in each direction, so the fused pair is
    the JAX package's array for array."""
    T = _graphs()[name]
    jp = jdis.prepare_adjacency(_to_jax(T), method="hybrid")
    tp = tdis.prepare_adjacency(T, method="hybrid", costs=jax_cost_table(), device="cpu")
    assert tp.choice["split"][0] == jp.bsr.tb
    _same_plan(jp.fused, tp.fused)
    _same_plan(jp.fused_t, tp.fused_t)
    if name == "hub":  # the hub's row blocks hold hundreds of remainder edges
        assert tp.fused.K == tp.fused_t.K == 256


@pytest.mark.parametrize("name,wide", [("hub", ()), ("sparse", (256,))])
def test_card_table_prices_the_plans_width(name, wide):
    """On the card's table each plan takes the width its own remainder
    prices cheapest (K = 256 at tb 256 on the sparse graph, else 128); the
    hybrid threshold is priced at DEFAULT_K slots and the remainder at the
    width the forward plan takes."""
    T = _graphs()[name]
    costs = tdis.H100_COSTS
    assert sorted(costs.rest_chunk_s) == [128, 256, 512] and costs.rest_fixed is None
    for tb in (128, 256):
        tp = tdis.prepare_adjacency(T, method="hybrid", tb=tb, device="cpu")
        for plan, rest in ((tp.fused, tp.rest), (tp.fused_t, tp.rest.transpose())):
            counts = np.bincount(rest.rows[: rest.nnz] // tb, minlength=plan.B.n_row_tiles)
            assert plan.K == tdis.choose_chunk_k(counts, tb, costs)
            assert tb_.ring_shape_ok(tb_._tile_mode(plan.B.tiles, tb), tb, 128, plan.K)
        r, c = tdis._edge_keys(T)
        uniq, cnt = tdis._tile_populations(r, c, (tb,))[tb]
        tc = tdis._tile_cost_s(tb, tdis._tile_itemsize(tb, True, 2, costs), costs)
        thresh, _, rest_by_rb, chunk, _, K = tdis._hybrid_split(tb, uniq, cnt, tc, costs)
        assert thresh == tdis._rest_thresh(tb, True, 2, costs)
        assert K == tp.fused.K and chunk == tdis._chunk_cost_s(tb, K, costs)
        assert K == tdis.choose_chunk_k(rest_by_rb, tb, costs)
        assert tp.fused.K == tp.fused_t.K == (256 if tb in wide else tdis.DEFAULT_K)
        # an explicit width prices and builds at that width
        fixed = tdis.prepare_adjacency(T, method="hybrid", tb=tb, fused_k=256, device="cpu")
        assert fixed.fused.K == fixed.fused_t.K == 256
        assert fixed.choice is None
        want = int(np.ceil(tc / (costs.rest_slot_s + costs.rest_chunk_s[256] / 256)))
        assert tdis._rest_thresh(tb, True, 2, costs, K=256) == want


def test_explicit_width_callers_keep_theirs():
    """The int8 hybrid plan and the flash hybrid plan keep their fixed
    widths, as in the JAX package, and so does a direct build."""
    from sgracex1_tpu_torch.quant import int8 as tq
    from sgracex1_tpu_torch.quant.affine import QuantConstants

    T = _graphs()["hub"]
    c_a = QuantConstants(s_o=1.0, s=float(np.asarray(T.vals).max()) / 255.0, z=0, qbits=8, signed=False)
    assert tq.prepare_int8_hybrid(T, c_a, tb=128, device="cpu").K == tf.DEFAULT_K
    gp = tdis.prepare_adjacency(T, method="xla", for_gat=True, gat_tb=128, gat_rest_thresh=8, device="cpu")
    assert gp.gat_plan is not None and gp.gat_plan.K == tdis.H100_COSTS.flash_chunk_k
    assert tf.build_fused_plan(gp.gat_bsr, None).K == tf.DEFAULT_K
