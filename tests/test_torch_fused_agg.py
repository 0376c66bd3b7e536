"""sgracex1_tpu_torch.ops.fused_agg against sgracex1_tpu.ops.fused_agg:
identical host schedules, and the plain K2 against the Pallas kernel (run
in interpret mode) and scipy."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import bsr as jb
from sgracex1_tpu.ops import fused_agg as jf
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.graph.normalize import rank1_factor, sym_norm
from sgracex1_tpu_torch.ops import bsr as tb_
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.ops import fused_agg as tf

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _skewed_rank1(rng, n=8192, tb=128):
    """Sym-normalized graph whose row block 3 owns ~600 remainder edges
    (several chunks) beside dense diagonal tiles (tests/test_fused_agg.py)."""
    rows = [np.arange(n), np.arange(n - 1), rng.integers(3 * tb, 4 * tb, 600)]
    cols = [np.arange(n), np.arange(1, n), rng.integers(0, n, 600)]
    ei = np.unique(np.stack([np.concatenate(rows), np.concatenate(cols)]), axis=1)
    return sym_norm(ei, n, fill=1.0)


def _weighted(rng, n=2048, avg_degree=12):
    m = n * avg_degree
    k = np.unique(rng.integers(0, n, m) * n + rng.integers(0, n, m))
    v = rng.uniform(0.5, 2.0, len(k)).astype(np.float32)
    return TSparse.from_coo(k // n, k % n, v, (n, n))


def _to_jax(T):
    return JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)


def _plans(graph, tb, thresh, attach, packed=False, K=128):
    """(jax plan, torch plan, scipy matrix) of one hybrid split."""
    rng = np.random.default_rng(7)
    T = _skewed_rank1(rng) if graph == "skewed" else (
        sym_norm(np.unique(rng.integers(0, 2500, (2, 9000)), axis=1), 2500)
        if graph == "symnorm" else _weighted(rng)
    )
    fac = rank1_factor(T)
    part, rest = tdis.split_by_tile_density(T, tb, thresh)
    if fac is not None:
        rest = tdis._drop_zero_val_edges(rest)
    rest = rest if rest.nnz else None
    cover = dict(cover_rows=True, cover_cols=True)
    jpart = _to_jax(part)
    if packed:
        Bj = jb.bsr_bitmask_from_sparse(jpart, tb=tb, device_build=False, **cover)
        Bt = tb_.bsr_bitmask_from_sparse(part, tb=tb, **cover)
    elif fac is not None:
        Bj, Bt = jb.bsr_mask_from_sparse(jpart, tb=tb, **cover), tb_.bsr_mask_from_sparse(part, tb=tb, **cover)
    else:
        Bj = jb.bsr_from_sparse(jpart, tb=tb, device_build=False, **cover)
        Bt = tb_.bsr_from_sparse(part, tb=tb, **cover)
    r1 = dict(r1_row=fac[0], r1_col=fac[1]) if fac is not None else {}
    keys = tb_.bsr_tile_keys(part, tb, **cover)
    pj = jf.build_fused_plan(
        Bj, _to_jax(rest) if rest is not None else None, K=K, tile_keys=keys,
        attach_chunks=attach, device=False, **r1,
    )
    pt = tf.build_fused_plan(Bt, rest, K=K, tile_keys=keys, attach_chunks=attach, **r1)
    return pj, pt, T.to_scipy()


CASES = [
    ("skewed", 128, 8, True),
    ("skewed", 128, 8, False),
    ("weighted", 128, 40, True),
    ("weighted", 128, 40, False),
]


@pytest.mark.parametrize("graph,tb,thresh,attach", CASES)
def test_schedule_identical(graph, tb, thresh, attach):
    pj, pt, _ = _plans(graph, tb, thresh, attach)
    for k in ("step_rb", "step_cb", "step_tile", "step_chunk", "step_kind", "slot_col", "slot_scale"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, k)), getattr(pt, k).numpy(), err_msg=k)
    np.testing.assert_array_equal(np.asarray(pj.lrow)[:, 0, :], pt.lrow.numpy())
    assert (pj.K, pj.num_steps, pj.num_chunks, pj.num_rest_chunks) == (
        pt.K, pt.num_steps, pt.num_chunks, pt.num_rest_chunks
    )
    assert (pj.colscale is None) == (pt.colscale is None) == (graph == "weighted")
    if pt.colscale is not None:
        np.testing.assert_array_equal(np.asarray(pj.colscale)[:, 0].reshape(-1), pt.colscale.numpy())
        np.testing.assert_array_equal(np.asarray(pj.rowscale)[:, 0].reshape(-1), pt.rowscale.numpy())
    if graph == "skewed":  # the hub block spans several chunks
        assert pt.num_rest_chunks >= 5


@pytest.mark.parametrize(
    "graph,tb,thresh,attach,packed",
    [
        ("skewed", 128, 8, True, False),
        ("weighted", 128, 40, False, False),
        ("symnorm", 1024, 100, True, True),
    ],
)
def test_fused_plain_matches_pallas(graph, tb, thresh, attach, packed):
    """Both write bf16: 2e-2 between them; 5e-2 against scipy f32 (the
    JAX suite's own bound)."""
    pj, pt, mat = _plans(graph, tb, thresh, attach, packed=packed)
    P = 48 if graph != "weighted" else 64
    H = np.random.default_rng(8).standard_normal((mat.shape[1], P)).astype(np.float32)
    out_j = np.asarray(jf.bsr_spmm_fused(pj, jnp.asarray(H))).astype(np.float32)
    out_t = tf.bsr_spmm_fused(pt, torch.from_numpy(H))
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (mat.shape[0], P)
    out_t = out_t.float().numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=2e-2, atol=2e-2)
    ref = mat @ H
    np.testing.assert_allclose(out_t, ref, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(out_j, ref, rtol=5e-2, atol=5e-2)


def test_no_remainder_plan_is_all_tiles():
    """With no remainder, R_pad = 1 all-dead chunk and every step is a
    tile step."""
    pj, pt, mat = _plans("weighted", 128, 1, True)
    assert pt.num_rest_chunks == 0 and pt.num_chunks == 1
    assert (pt.lrow == 128).all() and (pt.step_kind == 0).all()
    H = torch.randn(mat.shape[1], 32, generator=torch.Generator().manual_seed(0))
    out = tf.bsr_spmm_fused(pt, H).float().numpy()
    np.testing.assert_allclose(out, mat @ H.numpy(), rtol=5e-2, atol=5e-2)


# ----------------------------------------------- the ring K2's live schedule


def _hub_graph(kind, n=1500, tb=128, seed=11):
    """Random edges plus hub rows (dense tiles and a remainder); blocks 2
    and 5 hold no edge at all, block 4 no dense tile. ``kind``: "symnorm" (rank-1) or
    "weighted" with dyadic values."""
    rng = np.random.default_rng(seed)
    hub = np.stack([rng.integers(0, 100, 6 * n), rng.integers(0, n, 6 * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 3 * n)), hub, hub[::-1]], axis=1), axis=1)
    ei = ei[:, (ei // tb != 2).all(axis=0) & (ei // tb != 5).all(axis=0)]
    # block 4 keeps only its sparse edges: chunks that ride a cover tile's step
    ei = ei[:, ~((ei[0] // tb == 4) & (ei[1] < 100)) & ~((ei[1] // tb == 4) & (ei[0] < 100))]
    if kind == "symnorm":
        return sym_norm(ei, n)
    v = (rng.integers(2, 9, ei.shape[1]) / 4.0).astype(np.float32)
    return TSparse.from_coo(ei[0], ei[1], v, (n, n))


def _hub_plans(kind, attach=True, tb=128, thresh=60):
    """(forward plan, transposed plan, matrix) as ``prepare_adjacency``
    builds them (cover tiles for every row and column block)."""
    T = _hub_graph(kind, tb=tb)
    prep = tdis.prepare_adjacency(T, method="hybrid", tb=tb, rest_thresh=thresh, device="cpu")
    assert prep.rest is not None and prep.fused.num_rest_chunks > 0
    if attach:
        return prep.fused, prep.fused_t, T
    r1 = {} if prep.r1_row is None else dict(r1_row=prep.r1_row.numpy(), r1_col=prep.r1_col.numpy())
    rt = {} if prep.r1_row is None else dict(r1_row=prep.r1_col.numpy(), r1_col=prep.r1_row.numpy())
    return (tf.build_fused_plan(prep.bsr, prep.rest, attach_chunks=False, **r1),
            tf.build_fused_plan(prep.bsr_t, prep.rest.transpose(), attach_chunks=False, **rt), T)


@pytest.mark.parametrize("kind", ["symnorm", "weighted"])
@pytest.mark.parametrize("attach", [True, False])
def test_ring_plan_lists_the_steps_that_do_work(kind, attach):
    """``plan.ring``: a tile product only where the tile holds a nonzero, a
    chunk wherever the step had one, nothing else, in run order; forward
    and transposed (whose (0, cb) cover tiles fill row block 0's run)."""
    for plan in _hub_plans(kind, attach)[:2]:
        B, S = plan.B, plan.num_steps
        nonzero = B.tiles.reshape(B.num_tiles, -1).ne(0).any(dim=1)
        assert torch.equal(B.live, nonzero) and (~nonzero).any()
        kindv, tile = plan.step_kind.numpy(), plan.step_tile.numpy()
        has_tile = (kindv != 1) & nonzero.numpy()[tile]
        has_chunk = kindv >= 1
        keep = has_tile | has_chunk
        slot_live = plan.lrow.numpy() < B.tb  # per chunk: the slots up to the last live one
        slots = np.array([np.flatnonzero(r).max() + 1 if r.any() else 0 for r in slot_live])
        chunk = plan.step_chunk.numpy()
        want = np.stack([np.where(has_tile, tile, -1), plan.step_cb.numpy(), np.where(has_chunk, chunk, -1),
                         np.where(has_chunk, slots[chunk], 0)], axis=1)[keep]
        np.testing.assert_array_equal(plan.ring.step.numpy(), want)
        np.testing.assert_array_equal(plan.ring.rb.numpy(), plan.step_rb.numpy()[:S][keep])
        assert (want[want[:, 2] >= 0, 3] > 0).all() and (want[:, 3] < plan.K).any()  # some chunks are part full
        assert plan.ring.n_tile_steps == has_tile.sum()
        assert plan.ring.n_dead_tile_steps == ((kindv != 1) & ~has_tile).sum() > 0
        # a chunk that rode a dead tile's step is still there
        if attach and kind == "weighted":  # (sym_norm's self-loops give block 4 a dense tile)
            assert ((want[:, 0] == -1) & (want[:, 2] >= 0)).any()
        rb = plan.ring.segments.seg_rb.numpy()
        assert set(rb.tolist()) == set(range(B.n_row_tiles))
        empty = plan.ring.segments.seg_hi.numpy() == plan.ring.segments.seg_lo.numpy()
        assert empty.any()  # the edgeless row block keeps a work item that writes its zeros


def test_ring_plan_drops_the_k_steps_pads():
    """The dead chunk steps that pad runs for K11 do no work."""
    plan, _, _ = _hub_plans("symnorm")
    r1 = dict(r1_row=plan.rowscale.numpy()[: plan.B.n_rows], r1_col=plan.colscale.numpy()[: plan.B.n_cols])
    rest = tdis.split_by_tile_density(_hub_graph("symnorm"), 128, 60)[1]
    padded = tf.build_fused_plan(plan.B, tdis._drop_zero_val_edges(rest), attach_chunks=True, k_steps=4, **r1)
    assert padded.num_steps > plan.num_steps
    np.testing.assert_array_equal(padded.ring.step.numpy(), plan.ring.step.numpy())


def test_staged_h_rows_are_the_rank1_chunk_rows():
    """Rank-1 mode: ``slot_scale == colscale[slot_col]``, so a chunk row
    ``bf16(bf16(H[c]) * bf16(slot_scale))`` is row ``c`` of the operand the
    pre-pass stages once, bit for bit."""
    plan, plan_t, T = _hub_plans("symnorm")
    rng = np.random.default_rng(12)
    for p in (plan, plan_t):
        B = p.B
        rows = -(-B.n_cols // B.tb) * B.tb
        H = torch.from_numpy(rng.standard_normal((B.n_cols, 40)).astype(np.float32))
        Hs = tb_.stage_h_plain(H, p.colscale, rows, B.n_cols)
        col = p.slot_col.long()
        assert torch.equal(p.slot_scale, p.colscale[col] * (p.lrow.reshape(-1) < B.tb))  # dead slots hold 0
        live = p.lrow.reshape(-1) < B.tb
        G = (H[col].to(torch.bfloat16).float() * p.slot_scale.to(torch.bfloat16).float()[:, None]).to(torch.bfloat16)
        assert live.any() and torch.equal(G[live], Hs[col][live])
        # and a tile's block is the plain version's scaled operand
        scaled = (H.to(torch.bfloat16).float() * p.colscale[: B.n_cols].to(torch.bfloat16).float()[:, None])
        assert torch.equal(Hs[: B.n_cols], scaled.to(torch.bfloat16)) and not Hs[B.n_cols:].any()


def _ring_flow(plan, H, seg_steps):
    """The ring K2's data flow in plain PyTorch: the operand staged once,
    the live steps of ``plan.ring`` only, one f32 sum per work item, split
    runs summed in partial order, ``bf16(rowscale * acc)``."""
    B = plan.B
    tb, P, K = B.tb, H.shape[1], plan.K
    n_ct = -(-B.n_cols // tb)
    Hs = tb_.stage_h_plain(H, plan.colscale, n_ct * tb, B.n_cols).float()
    L = tb_.recut_live_schedule(plan.ring, B.n_row_tiles, seg_steps)
    S, step = L.segments, L.step.long()
    out = torch.zeros((B.n_row_tiles * tb, P))
    partial = torch.zeros((max(S.n_part, 1), tb, P))
    for s in range(S.n_seg):
        acc = torch.zeros((tb + 1, P))  # row tb takes the dead slots
        for g in range(S.seg_lo[s], S.seg_hi[s]):
            tile, cb, chunk, slots = step[g]
            if tile >= 0:
                acc[:tb] += tb_._tile_values(B.tiles[tile], tb) @ Hs[cb * tb: (cb + 1) * tb]
            if chunk >= 0:
                read = -(-int(slots) // 64) * 64  # whole 64-slot slabs up to the last live slot
                assert 0 < read <= K and not (plan.lrow[chunk, read:] < tb).any()
                sl = slice(chunk * K, chunk * K + read)
                G = Hs[plan.slot_col[sl].long()]
                if plan.colscale is None:  # value mode: scaled on the gathered rows
                    G = (G * plan.slot_scale[sl].to(torch.bfloat16).float()[:, None]).to(torch.bfloat16).float()
                acc.index_add_(0, plan.lrow[chunk, :read].long(), G)
        if S.seg_part[s] >= 0:
            partial[S.seg_part[s]] = acc[:tb]
        else:
            out[S.seg_rb[s] * tb: (S.seg_rb[s] + 1) * tb] = acc[:tb]
    for f in range(S.n_fin):
        r = S.fin_rb[f].item()
        out[r * tb: (r + 1) * tb] = partial[S.fin_p0[f]: S.fin_p0[f] + S.fin_np[f]].sum(dim=0)
    if plan.rowscale is not None:
        out = out * plan.rowscale[:, None]
    return out[: B.n_rows].to(torch.bfloat16), S


@pytest.mark.parametrize("kind", ["rank1", "weighted"])
@pytest.mark.parametrize("attach", [True, False])
def test_ring_data_flow_equals_plain_k2(kind, attach):
    """Operands are small dyadic numbers (H, edge values, and power-of-two
    rank-1 scalings), so every f32 sum is exact and the two summation
    orders must agree bit for bit: ``torch.equal`` with
    ``bsr_spmm_fused_plain``, forward and transposed, with split runs."""
    rng = np.random.default_rng(13)
    T = _hub_graph("weighted")
    part, rest = tdis.split_by_tile_density(T, 128, 60)
    cover = dict(tb=128, cover_rows=True, cover_cols=True)
    for M, R in ((part, rest), (part.transpose(), rest.transpose())):
        if kind == "rank1":
            B = tb_.bsr_mask_from_sparse(M, **cover)
            r1 = dict(r1_row=(0.5 ** rng.integers(0, 3, M.n_rows)).astype(np.float32),
                      r1_col=(0.5 ** rng.integers(0, 3, M.n_cols)).astype(np.float32))
        else:
            B, r1 = tb_.bsr_from_sparse(M, **cover), {}
        plan = tf.build_fused_plan(B, R, attach_chunks=attach, **r1)
        assert plan.ring.n_dead_tile_steps > 0 and plan.num_rest_chunks > 0
        H = torch.from_numpy((rng.integers(-16, 17, (M.n_cols, 24)) / 8.0).astype(np.float32))
        ref = tf.bsr_spmm_fused_plain(plan, H)
        for seg_steps in (3, 16):
            out, S = _ring_flow(plan, H, seg_steps)
            assert torch.equal(out, ref)
        assert S.n_seg >= B.n_row_tiles
        out3, S3 = _ring_flow(plan, H.to(torch.bfloat16), 3)
        assert S3.n_fin > 0 and torch.equal(out3, ref)  # bf16 H holds the same numbers


def test_k2_wrappers_count_nothing_on_the_cpu():
    plan, _, T = _hub_plans("symnorm")
    H = torch.ones(T.n_cols, 8)
    k = tf.bsr_spmm_fused
    before = (k.launches, k.launches_ring, k.launches_single)
    assert torch.equal(k(plan, H), tf.bsr_spmm_fused_plain(plan, H))
    assert (k.launches, k.launches_ring, k.launches_single) == before
