"""The plan attention (``ops/plan_gat``) on the CPU: its plain kernels
against the edge-path spec ``ops/flash_gat.gat_attention_agg_ref``, forward
and the gradients ``(ds1, ds2, dWh)``, and ``prepare_adjacency(for_gat=True)``'s
choice between it and the flash layouts on a ``pallas`` prep.

The operands are bf16-representable (``Wh`` and the output's cotangent), so
the kernels' one rounding, bf16 rows of ``Wh`` and ``gO``, changes nothing and
the plain kernels meet the f32 spec to f32 round-off: 1e-5 of the largest
magnitude (the sums run in another order, over pieces merged under the
row's max)."""

import numpy as np
import pytest
import torch

import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.ops import dispatch as D
from sgracex1_tpu_torch.ops import plan_gat as PG
from sgracex1_tpu_torch.ops.flash_gat import gat_attention_agg_ref
from sgracex1_tpu_torch.ops.pallas_spmm import ROW_SEG_SLOTS

N = 400
TOL = 1e-5


def _graph(seed=0, n=N):
    """Random edges, three hub rows and columns of ~3 x ROW_SEG_SLOTS edges
    (split rows in both plans), 20 isolated nodes; ``sym_norm`` adds a
    zero-valued self-loop a node."""
    rng = np.random.default_rng(seed)
    lone = np.arange(n - 20, n)
    src = rng.integers(0, n - 20, 6 * n)
    dst = rng.integers(0, n - 20, 6 * n)
    hubs = np.repeat([0, 7, 11], 3 * ROW_SEG_SLOTS)
    far = rng.integers(0, n - 20, hubs.size)
    ei = np.stack([np.concatenate([src, hubs, far]), np.concatenate([dst, far, hubs])])
    ei = ei[:, ei[0] != ei[1]]
    assert not np.isin(ei, lone).any()
    return pt.sym_norm(np.unique(ei, axis=1), n)


def _with_unit_diagonal(A: SparseMatrix) -> SparseMatrix:
    """``A`` with every stored self-loop at value 1: the spec's mask
    (``val > 0``) then attends over one self-loop a node."""
    r, c, v = (np.asarray(x)[: A.nnz] for x in (A.rows, A.cols, A.vals))
    v = np.where(r == c, 1.0, v).astype(np.float32)
    return SparseMatrix.from_coo(r, c, v, (A.n_rows, A.n_cols))


def _bf16_exact(*shape, gen):
    return torch.randn(*shape, generator=gen).to(torch.bfloat16).float()


def _prep(A):
    return D.prepare_adjacency(A, method="pallas", rb=128, cb=128, be=1024, device="cpu")


@pytest.fixture(scope="module")
def graph():
    A = _graph()
    prep = _prep(A)
    assert prep.plan.segments.n_fin > 0 and prep.plan_t.segments.n_fin > 0  # split rows, both plans
    return A, prep


def _both(A, prep, H, F, self_loops, seed=1):
    gen = torch.Generator().manual_seed(seed)
    s1, s2 = torch.randn(N, H, generator=gen), torch.randn(N, H, generator=gen)
    Wh = _bf16_exact(N, H, F, gen=gen)
    gO = _bf16_exact(N, H, F, gen=gen)
    leaves = [x.clone().requires_grad_(True) for x in (s1, s2, Wh)]
    out = PG.plan_gat_agg(prep, *leaves, alpha=0.2, self_loops=self_loops)
    out.backward(gO)
    spec_A = _with_unit_diagonal(A) if self_loops else A
    ref_leaves = [x.clone().requires_grad_(True) for x in (s1, s2, Wh)]
    ref = gat_attention_agg_ref(spec_A, *ref_leaves, alpha=0.2)
    ref.backward(gO)
    return (out, *(x.grad for x in leaves)), (ref, *(x.grad for x in ref_leaves))


def _close(got, want, what):
    scale = float(want.detach().abs().max())
    gap = float((got - want).abs().max())
    assert gap <= TOL * max(scale, 1e-30), (what, gap, scale)


@pytest.mark.parametrize("H,F", [(1, 128), (4, 128), (4, 47), (1, 47)])
@pytest.mark.parametrize("self_loops", [False, True])
def test_plain_plan_attention_matches_the_edge_spec(graph, H, F, self_loops):
    A, prep = graph
    got, want = _both(A, prep, H, F, self_loops)
    for name, g, w in zip(("out", "ds1", "ds2", "dWh"), got, want):
        assert g.shape == w.shape, name
        _close(g, w, name)
    lone = slice(N - 20, N)
    if self_loops:  # an isolated node attends to itself alone: its own row
        assert float(got[0][lone].abs().max()) > 0
    else:  # nothing to attend: zeros, and no gradient through its scores
        assert float(got[0][lone].abs().max()) == 0.0
        assert float(got[1][lone].abs().max()) == 0.0


def test_zero_valued_self_loops_are_masked_without_add_self_loops(graph):
    """Without ``self_loops`` the stored diagonal (value 0) takes no part;
    with it the diagonal counts once however it is stored."""
    A, prep = graph
    r, c = (np.asarray(x)[: A.nnz] for x in (A.rows, A.cols))
    assert (r == c).sum() == N and np.all(np.asarray(A.vals)[: A.nnz][r == c] == 0)
    gen = torch.Generator().manual_seed(3)
    s1, s2, Wh = torch.randn(N, 2, generator=gen), torch.randn(N, 2, generator=gen), _bf16_exact(N, 2, 16, gen=gen)
    plain = PG.plan_gat_agg(prep, s1, s2, Wh, self_loops=False)
    _close(plain, gat_attention_agg_ref(A, s1, s2, Wh), "no loops")
    # the same graph with its diagonal stored at value 1: the loops are one each
    prep1 = _prep(_with_unit_diagonal(A))
    looped = PG.plan_gat_agg(prep1, s1, s2, Wh, self_loops=True)
    _close(looped, PG.plan_gat_agg(prep, s1, s2, Wh, self_loops=True), "stored or not")


def test_the_three_plain_kernels_walk_the_pieces():
    """The row pass's ``ds1 = u1 - t u2`` and the column pass's sums are
    what autograd of the spec gives, kernel by kernel, at a row cut of 8
    slots (every row of more than 8 slots split)."""
    A = _graph(seed=4)
    prep = _prep(A)
    cut = lambda p: pt.ops.pallas_spmm.recut_rows(p, 8)
    plan, plan_t = cut(prep.plan), cut(prep.plan_t)
    assert plan.segments.n_fin > 50
    gen = torch.Generator().manual_seed(5)
    s1, s2 = torch.randn(N, 4, generator=gen), torch.randn(N, 4, generator=gen)
    Wh, gO = _bf16_exact(N, 4, 24, gen=gen), _bf16_exact(N, 4, 24, gen=gen)
    Whs, gOs = PG.stage(Wh, 24), PG.stage(gO, 24)
    out, m, l = PG.plan_gat_fwd(plan, s1, s2, Whs, self_loops=True)
    t, u1, u2 = PG.plan_gat_bwd_rows(plan, s1, s2, m, l, Whs, gOs, self_loops=True)
    dWh, ds2 = PG.plan_gat_bwd_cols(plan_t, s1, s2, m, l, t, Whs, gOs, self_loops=True)
    leaves = [x.clone().requires_grad_(True) for x in (s1, s2, Wh)]
    ref = gat_attention_agg_ref(_with_unit_diagonal(A), *leaves)
    ref.backward(gO)
    _close(out, ref.detach(), "out")
    _close(u1 - t * u2, leaves[0].grad, "ds1")
    _close(ds2, leaves[1].grad, "ds2")
    _close(dWh, leaves[2].grad, "dWh")
    assert torch.all(l > 0)  # every row has its self-loop


def test_staged_widths():
    assert PG.plan_gat_width(4, 128) == 128
    assert PG.plan_gat_width(4, 47) == 48  # 192 features: one slice
    assert PG.plan_gat_width(4, 96) == 128  # 384: a head may not cross a slice
    assert PG.plan_gat_width(1, 200) == 200
    assert PG.plan_gat_width(2, 300) is None
    x = torch.randn(5, 4, 47)
    s = PG.stage(x, 48)
    assert s.dtype == torch.bfloat16 and s.shape == (5, 4, 48)
    assert torch.equal(s[..., :47], x.to(torch.bfloat16)) and not s[..., 47:].any()


def _powerlaw(n, seed=0):
    """No id locality: a Chung-Lu graph at random ids, mean degree ~50."""
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1) ** -0.6)
    w = rng.permutation(w / w.sum())
    src = rng.choice(n, 25 * n, p=w)
    dst = rng.integers(0, n, 25 * n)
    ei = np.concatenate([np.stack([src, dst]), np.stack([dst, src])], axis=1)
    return pt.sym_norm(np.unique(ei[:, ei[0] != ei[1]], axis=1), n)


def _banded(n, width=24):
    r = np.repeat(np.arange(n), 2 * width)
    c = r + np.tile(np.r_[-width:0, 1:width + 1], n)
    keep = (c >= 0) & (c < n)
    return pt.sym_norm(np.stack([r[keep], c[keep]]), n)


@pytest.mark.parametrize("graph_kind,want", [("powerlaw", "plan"), ("banded", "flash")])
def test_for_gat_on_a_pallas_prep_takes_the_cheaper_layout(graph_kind, want):
    A = _powerlaw(16384) if graph_kind == "powerlaw" else _banded(16384)
    prep = D.prepare_adjacency(A, method="pallas", for_gat=True, device="cpu")
    c = prep.choice
    assert c["gat"] == want and set(c["gat_costs"]) == {"plan", "flash"}
    assert (c["gat_costs"]["plan"] < c["gat_costs"]["flash"]) == (want == "plan")
    if want == "plan":
        assert prep.gat_on_plan and prep.gat_bsr is None and prep.flash_tiles is None
        assert "flash" not in c
    else:
        assert not prep.gat_on_plan and prep.gat_bsr is not None and c["flash"][0] <= 256


def test_a_table_without_the_plan_price_keeps_the_flash_layout():
    import dataclasses

    A = _powerlaw(16384)
    costs = dataclasses.replace(D.H100_COSTS, plan_gat_slot_s=float("inf"))
    prep = D.prepare_adjacency(A, method="pallas", for_gat=True, costs=costs, device="cpu")
    assert not prep.gat_on_plan and prep.gat_bsr is not None and prep.choice["gat"] == "flash"


def test_gatconv_runs_the_layout_the_prep_carries(monkeypatch):
    """On a ``gat_on_plan`` prep the layer launches the plan attention (its
    result equal to the edge path with self-loops, to round-off of the bf16
    rows); concat=False averages the heads and adds the bias."""
    A = _powerlaw(16384, seed=2)
    prep = D.prepare_adjacency(A, method="pallas", for_gat=True, device="cpu")
    assert prep.gat_on_plan
    calls = []
    real = PG.plan_gat_agg
    monkeypatch.setattr(pt.nn.layers, "plan_gat_agg", lambda *a, **k: calls.append(1) or real(*a, **k))
    conv = pt.nn.GATConv(16, 8, nheads=3, concat=False, bias=True, add_self_loops=True,
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.bias.uniform_(-1, 1)
    x = torch.randn(16384, 16, generator=torch.Generator().manual_seed(1))
    got = conv(prep, x)
    assert calls and got.shape == (16384, 8)
    want = conv(A, x)  # the edge path, with the self-loops
    assert float((got - want).abs().max() / want.abs().max()) < 1e-2


def test_gat_self_loops_take_the_plan_attention_unpriced():
    """A model whose attention adds self-loops gets the plan attention on
    the banded graph too, where the flash layout prices cheaper: no mask
    tile holds a self-loop. ``auto`` prepares the pallas kind for it; another
    kind, or an asked-for flash layout, raises."""
    A = _banded(16384)
    prep = D.prepare_adjacency(A, method="auto", for_gat=True, gat_self_loops=True, device="cpu")
    assert prep.kind == "pallas" and prep.gat_on_plan and prep.gat_bsr is None
    assert prep.choice["gat"] == "plan" and set(prep.choice["gat_costs"]) == {"plan"}
    for kw in (dict(method="bsr"), dict(method="hybrid"), dict(method="pallas", gat_tb=256),
               dict(method="pallas", gat_rest_thresh=32)):
        with pytest.raises(ValueError, match="gat_self_loops"):
            D.prepare_adjacency(A, for_gat=True, gat_self_loops=True, device="cpu", **kw)


def test_gatconv_self_loops_on_a_flash_layout(monkeypatch):
    """``add_self_loops`` on a pallas prep that chose a flash layout runs the
    plan attention (its plans carry the loops), equal to the edge path with
    the loops; on a prep of another kind with flash tiles it raises."""
    A = _banded(4096)
    prep = D.prepare_adjacency(A, method="pallas", for_gat=True, device="cpu")
    assert not prep.gat_on_plan and prep.flash_tiles is not None
    calls = []
    real = PG.plan_gat_agg
    monkeypatch.setattr(pt.nn.layers, "plan_gat_agg", lambda *a, **k: calls.append(1) or real(*a, **k))
    conv = pt.nn.GATConv(16, 8, nheads=2, add_self_loops=True, generator=torch.Generator().manual_seed(0))
    x = torch.randn(4096, 16, generator=torch.Generator().manual_seed(1))
    got = conv(prep, x)
    want = conv(A, x)  # the edge path, with the self-loops
    assert calls and float((got - want).abs().max() / want.abs().max()) < 1e-2
    tiles = D.prepare_adjacency(A, method="bsr", for_gat=True, device="cpu")
    assert tiles.flash_tiles is not None
    with pytest.raises(ValueError, match="add_self_loops"):
        conv(tiles, x)


def _hub(n, seed=0):
    """Random edges plus a few hub rows and columns of thousands of edges."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, 8 * n), rng.integers(0, n, 8 * n)
    hubs = np.repeat(rng.choice(n, 6, replace=False), n // 4)
    far = rng.integers(0, n, hubs.size)
    ei = np.stack([np.concatenate([src, hubs, far]), np.concatenate([dst, far, hubs])])
    return pt.sym_norm(np.unique(ei[:, ei[0] != ei[1]], axis=1), n)


def _per_threshold_costs(A, *, train: bool, costs) -> dict:
    """``_flash_layout_costs`` as the formula reads, one threshold at a
    time: each tile's population by ``np.unique`` of its key, the dense
    mask, ``np.unique`` of the dense tiles' row and column blocks, the
    remainder a row block by ``bincount``."""
    r, c = (np.asarray(x)[: A.nnz].astype(np.int64) for x in (A.rows, A.cols))
    K, passes = costs.flash_chunk_k, (costs.flash_train_passes if train else 1.0)
    out = {}
    for tb in costs.flash_tbs:
        uniq, counts = np.unique((r // tb) << 32 | (c // tb), return_counts=True)
        T = len(uniq)
        n_rt, n_ct = -(-A.n_rows // tb), -(-A.n_cols // tb)
        for packed in ((False, True) if tb in costs.flash_packed_tbs else (False,)):
            tile_bytes = tb * tb / (8.0 if packed else 1.0)
            tc = D._flash_tile_s(tb, packed, costs)
            if T * tile_bytes <= costs.flash_tile_budget:
                out[(tb, packed, None)] = passes * (T * tc + len(np.unique(uniq >> 32)) * D._flash_run_s(tb, costs))
            for thresh in costs.flash_threshs:
                dense = counts >= thresh
                T_d = int(dense.sum())
                if T_d == 0:
                    continue
                rest = np.bincount((uniq >> 32)[~dense], weights=counts[~dense].astype(np.float64))
                n_chunks = int(np.ceil(rest / K).sum())
                cover = (n_rt - len(np.unique((uniq >> 32)[dense]))) + (
                    n_ct - len(np.unique((uniq & 0xFFFFFFFF)[dense])))
                if (T_d + cover) * tile_bytes <= costs.flash_tile_budget:
                    out[(tb, packed, thresh)] = (
                        passes * ((T_d + cover) * tc + n_rt * D._flash_run_s(tb, costs))
                        + n_chunks * D._flash_chunk_s(tb, n_chunks, costs=costs)
                        + costs.flash_hybrid_fixed_s
                        + (int(counts[~dense].sum()) * costs.flash_edge_bwd_s + costs.flash_bwd_fixed_s
                           if train else 0.0)
                    )
    return out


@pytest.mark.parametrize("graph_kind", ["powerlaw", "banded", "hub"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("budget", [None, 1 << 22])
def test_flash_layout_costs_match_the_per_threshold_formula(graph_kind, train, budget):
    """The one-pass pricing gives the per-threshold formula's prices, key
    for key and to the last bit; a tight mask budget drops the same keys."""
    import dataclasses

    A = dict(powerlaw=_powerlaw, banded=_banded, hub=_hub)[graph_kind](16384)
    costs = D.H100_COSTS if budget is None else dataclasses.replace(D.H100_COSTS, flash_tile_budget=budget)
    got = D._flash_layout_costs(A, train=train, costs=costs)
    want = _per_threshold_costs(A, train=train, costs=costs)
    assert got == want
    assert any(k[2] is not None for k in got)  # the hybrid splits are priced
    if budget is not None:
        assert len(got) < len(D._flash_layout_costs(A, train=train))
