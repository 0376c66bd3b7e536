"""The host side and the data flow of the redesigned variant kernels, on
the CPU, against the JAX package's Pallas kernels in interpret mode on the
same numpy inputs.

K10 (the cluster kernel, ``csrc/bsr_spmm_cluster.cu``): the cluster work
list (``ops/bsr.cluster_schedule``) and the plain version that sums each
heavy row block's C partials in rank order. K11 (the ring kernel with k
slabs a stage, ``csrc/fused_agg_ring.cu``): the k-plan's ring schedule
against the unpadded plan's, the slab depth the launch passes, and a plain
emulation of the kernel's data flow."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import bsr as jb
from sgracex1_tpu.ops import fused_agg as jf
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.ops import bsr as tb_
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.ops import fused_agg as tf

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

EXACT = 1e-3  # the same bf16 operands; f32 sums in another order
FUSED = 2e-2  # both write bf16
N_SM = 132  # the H100's SMs: the heavy rule's fair share


def _to_jax(T):
    return JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)


def _hub_band(n_blocks, tb, seed, hub=True, weights="ones"):
    """A band near the diagonal (one or two live tiles a row block, fewer
    than a cluster has CTAs), with ``hub`` rows of row block 0 linked to
    every column block but 3 (a run of ``n_blocks - 1`` live tiles, with
    row block 0's empty cover tile (0, 3) inside it) and of row block 1 to
    every other column block; row and column block 3 hold no edge (an empty
    row block). ``weights``: "ones", "uniform" or "dyadic"."""
    rng = np.random.default_rng(seed)
    n = n_blocks * tb
    r = np.arange(n).repeat(3)
    ei = [np.stack([r, (r + rng.integers(-4, 5, r.shape[0])) % n])]
    if hub:
        ei.append(np.stack([rng.integers(0, tb // 2, 4 * n_blocks),
                            np.arange(4 * n_blocks) // 4 * tb + rng.integers(0, tb, 4 * n_blocks)]))
        half = np.arange(0, n_blocks, 2)
        ei.append(np.stack([tb + rng.integers(0, tb, len(half)), half * tb + rng.integers(0, tb, len(half))]))
    ei = np.unique(np.concatenate(ei, axis=1), axis=1)
    ei = ei[:, (ei // tb != 3).all(axis=0)]
    m = ei.shape[1]
    v = {"ones": np.ones(m), "uniform": rng.uniform(0.2, 1.0, m),
         "dyadic": rng.integers(1, 9, m) / 8.0}[weights].astype(np.float32)
    return TSparse.from_coo(ei[0], ei[1], v, (n, n))


# ------------------------------------------------------------------- K10


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("hub", [True, False])
def test_cluster_schedule_lists_each_live_tile_once(C, hub):
    """Every live tile once (twice for a row block in two half-height
    items), in no cover tile; a heavy row block's C ranges contiguous and
    balanced; every row block in the list (the empty one too), light slots
    at most ``heavy_min`` tiles; each cluster's items contiguous, most
    costly first, the load spread within one item's cost."""
    tb, n_cl = 64, 7
    B = tb_.bsr_mask_from_sparse(_hub_band(300, tb, seed=C, hub=hub), tb=tb, cover_rows=True, cover_cols=True)
    n_live = int(B.live.sum())
    assert (~B.live).any() and B.ring.n_tile_steps == n_live
    heavy_min = tb_.rowloop_heavy_min(n_live, N_SM, C)
    assert heavy_min == max(C, -(-n_live // N_SM))
    S = tb_.cluster_schedule(B, C, heavy_min, n_cl)
    lo, hi, rb = S.item_lo.numpy(), S.item_hi.numpy(), S.item_rb.numpy()
    kind = S.item_kind.numpy()
    cl = S.cl_start.numpy()
    assert lo.shape == hi.shape == rb.shape == (S.n_items * C,) and S.C == C and S.n_clusters == n_cl
    assert cl[0] == 0 and cl[-1] == S.n_items and (np.diff(cl) >= 1).all()
    # heavy: row blocks 0 and 1 with the hub (tb 64: never in halves), none without
    assert S.n_heavy == 2 * int(hub) and set(kind.tolist()) <= {tb_.LIGHT, tb_.HEAVY}
    if hub:
        assert sorted(rb[::C][kind != tb_.LIGHT].tolist()) == [0, 1]
    # every live step once
    steps = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
    np.testing.assert_array_equal(np.sort(steps), np.arange(B.ring.step.shape[0]))
    step = B.ring.step.numpy()
    assert B.live.numpy()[step[:, 0]].all() and (step[:, 2] == -1).all()  # no cover tile, no chunk
    ring_rb = B.ring.rb.numpy()
    count = np.bincount(ring_rb, minlength=B.n_row_tiles)
    for i in range(S.n_items):
        sl = slice(i * C, (i + 1) * C)
        if kind[i] != tb_.LIGHT:
            b = rb[sl][0]
            assert (rb[sl] == b).all() and count[b] > heavy_min and count[b] >= 100
            assert (hi[sl][:-1] == lo[sl][1:]).all()  # contiguous, in rank order
            assert lo[sl][0] == np.searchsorted(ring_rb, b) and hi[sl][-1] == np.searchsorted(ring_rb, b + 1)
            sizes = hi[sl] - lo[sl]
            assert sizes.max() - sizes.min() <= 1
        else:
            for r in range(C):
                s = i * C + r
                if rb[s] < 0:
                    assert lo[s] == hi[s] == 0
                else:
                    assert (ring_rb[lo[s]: hi[s]] == rb[s]).all() and hi[s] - lo[s] == count[rb[s]] <= heavy_min
    heavy = np.repeat(kind != tb_.LIGHT, C)
    listed = np.concatenate([rb[~heavy & (rb >= 0)], rb[heavy][::C]])
    np.testing.assert_array_equal(np.sort(listed), np.arange(B.n_row_tiles))  # each row block once
    assert count[3] == 0 and 3 in listed  # the empty row block is written
    # the greedy spread: a cluster's items most costly first, loads within one item
    cost = (hi - lo).reshape(-1, C).max(axis=1) + tb_._EPILOGUE_COST
    load = np.array([cost[a:b].sum() for a, b in zip(cl[:-1], cl[1:])])
    assert load.max() - load.min() <= cost.max() + 1e-9
    for a, b in zip(cl[:-1], cl[1:]):
        assert (np.diff(cost[a:b]) <= 1e-9).all()


def test_cluster_schedule_halves_a_long_row_block():
    """At tb >= 128 a row block whose C ranges would each hold more than
    ``heavy_min`` tiles becomes two items over half the tile height each,
    with the same ranges; shorter heavy blocks stay whole."""
    tb, C = 128, 8
    B = tb_.bsr_mask_from_sparse(_hub_band(200, tb, seed=4), tb=tb, cover_rows=True, cover_cols=True)
    S = tb_.cluster_schedule(B, C, 8, 5)
    kind, rb = S.item_kind.numpy(), S.item_rb.numpy()[:: C]
    count = np.bincount(B.ring.rb.numpy(), minlength=B.n_row_tiles)
    assert count[0] > C * 8 and count[1] > C * 8  # both hub blocks are long
    for b in (0, 1):
        mine = np.flatnonzero(rb == b)
        assert sorted(kind[mine].tolist()) == [tb_.UPPER, tb_.LOWER]
        a, c = mine
        for f in ("item_lo", "item_hi"):
            t = getattr(S, f).numpy()
            np.testing.assert_array_equal(t[a * C: (a + 1) * C], t[c * C: (c + 1) * C])
    S2 = tb_.cluster_schedule(B, C, count[1], 5)  # row block 1 is no longer heavy, row block 0 stays whole
    assert S2.item_kind.numpy().tolist().count(tb_.HEAVY) == 1 and S2.n_heavy == 1


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("form,h_dtype", [("mask", "float32"), ("values", "float32"), ("values", "bfloat16")])
def test_cluster_plain_matches_pallas(C, form, h_dtype):
    """The plain cluster K10 (heavy partials summed in rank order) against
    the Pallas row-loop kernel in interpret mode and the plain K1, at 1e-3."""
    tb, P = 64, 40
    T = _hub_band(40, tb, seed=21 + C, weights="ones" if form == "mask" else "uniform")
    J = _to_jax(T)
    cover = dict(cover_rows=True, cover_cols=True)
    if form == "mask":
        Bt, Bj = tb_.bsr_mask_from_sparse(T, tb=tb, **cover), jb.bsr_mask_from_sparse(J, tb=tb, **cover)
    else:
        Bt = tb_.bsr_from_sparse(T, tb=tb, **cover)
        Bj = jb.bsr_from_sparse(J, tb=tb, device_build=False, **cover)
    S = tb_.cluster_schedule(Bt, C, tb_.rowloop_heavy_min(int(Bt.live.sum()), N_SM, C), 7)
    assert S.n_heavy >= 1
    H = np.random.default_rng(22).standard_normal((T.n_cols, P)).astype(np.float32)
    Ht = torch.from_numpy(H).to(getattr(torch, h_dtype))
    out = tb_.bsr_spmm_rowloop_cluster_plain(Bt, Ht, S)
    assert out.dtype == torch.float32 and out.shape == (T.n_rows, P)
    want = np.asarray(jb.bsr_spmm_rowloop(Bj, jnp.asarray(H).astype(getattr(jnp, h_dtype)), interpret=True))
    np.testing.assert_allclose(out.numpy(), want, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(out.numpy(), tb_.bsr_spmm_plain(Bt, Ht).numpy(), rtol=EXACT, atol=EXACT)
    assert not out[3 * tb: 4 * tb].any()


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("tb", [64, 128])
def test_cluster_partials_sum_exactly(C, tb):
    """Dyadic tiles and H keep every f32 sum exact, so the rank-order sum of
    the partials must equal the plain K1 bit for bit: whole row blocks at
    tb 64, halves of the tile height at tb 128."""
    B = tb_.bsr_from_sparse(_hub_band(60, tb, seed=C, weights="dyadic"), tb=tb, cover_rows=True,
                            cover_cols=True)
    S = tb_.cluster_schedule(B, C, 2, 5)
    assert S.n_heavy >= 1 and ((S.item_kind == tb_.UPPER).any() == (tb == 128))
    H = torch.from_numpy((np.random.default_rng(23).integers(-16, 17, (B.n_cols, 24)) / 8.0).astype(np.float32))
    assert torch.equal(tb_.bsr_spmm_rowloop_cluster_plain(B, H, S), tb_.bsr_spmm_plain(B, H))


def test_cluster_kernel_rules():
    """The entry point on a CPU tensor is the plain version and counts
    nothing; a cluster size the kernel lacks is refused."""
    B = tb_.bsr_mask_from_sparse(_hub_band(20, 64, seed=3), tb=64, cover_rows=True)
    H = torch.randn(B.n_cols, 16)
    k = tb_.bsr_spmm_rowloop
    before = (k.launches, k.launches_cluster, k.launches_single)
    assert torch.equal(k(B, H), tb_.bsr_spmm_rowloop_plain(B, H))
    assert (k.launches, k.launches_cluster, k.launches_single) == before
    with pytest.raises(ValueError, match="clusters of"):
        tb_._bsr_spmm_rowloop_cluster(B, H, 4)
    with pytest.raises(ValueError, match="schedule has clusters of 8"):
        tb_._bsr_spmm_rowloop_cluster(B, H, 16, sched=tb_.cluster_schedule(B, 8, 8, 2))
    assert tb_.ROWLOOP_CLUSTER in tb_.ROWLOOP_CLUSTERS == (8, 16)


# ------------------------------------------------------------------- K11


def _hub_graph(kind, n=1500, tb=128, seed=11):
    """Random edges plus hub rows (dense tiles and a remainder); blocks 2
    and 5 hold no edge; ``kind`` "symnorm" (rank-1) or "weighted" with
    dyadic values."""
    rng = np.random.default_rng(seed)
    hub = np.stack([rng.integers(0, 100, 6 * n), rng.integers(0, n, 6 * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 3 * n)), hub, hub[::-1]], axis=1), axis=1)
    ei = ei[:, (ei // tb != 2).all(axis=0) & (ei // tb != 5).all(axis=0)]
    if kind == "symnorm":
        return sym_norm(ei, n)
    v = (rng.integers(2, 9, ei.shape[1]) / 4.0).astype(np.float32)
    return TSparse.from_coo(ei[0], ei[1], v, (n, n))


def _k_plans(kind, attach, k, tb=128, thresh=60):
    """(k-padded plan, unpadded plan, graph) as ``prepare_adjacency``'s
    split builds them, with the JAX k-plan."""
    T = _hub_graph(kind, tb=tb)
    prep = tdis.prepare_adjacency(T, method="hybrid", tb=tb, rest_thresh=thresh, build_transpose=False,
                                  device="cpu")
    r1 = {} if prep.r1_row is None else dict(r1_row=prep.r1_row.numpy(), r1_col=prep.r1_col.numpy())
    kw = dict(attach_chunks=attach, **r1)
    return tf.build_fused_plan(prep.bsr, prep.rest, k_steps=k, **kw), tf.build_fused_plan(prep.bsr, prep.rest, **kw), T


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("kind,attach", [("symnorm", True), ("symnorm", False), ("weighted", True), ("weighted", False)])
def test_k_plan_ring_schedule_is_the_unpadded_one(kind, attach, k):
    """The k-plan's pads (dead chunk steps) do no work: its ring schedule,
    live steps and work items, is the unpadded plan's, so the ring K11 walks
    what K2's ring walks."""
    plan, base, _ = _k_plans(kind, attach, k)
    assert plan.num_steps > base.num_steps
    assert torch.equal(plan.ring.step, base.ring.step) and torch.equal(plan.ring.rb, base.ring.rb)
    for f in ("seg_rb", "seg_lo", "seg_hi", "seg_part", "fin_rb", "fin_p0", "fin_np"):
        assert torch.equal(getattr(plan.ring.segments, f), getattr(base.ring.segments, f)), f
    assert plan.ring.n_tile_steps == base.ring.n_tile_steps


def _slabs(L, tb, sd):
    """Each work item's slabs in the kernel's walk: (step, chunk?, k0) per
    slab, each live step's tile slabs, then its chunk slabs up to the
    chunk's last live slot."""
    step = L.step.numpy()
    out = []
    for lo, hi in zip(L.segments.seg_lo.tolist(), L.segments.seg_hi.tolist()):
        item = []
        for g in range(lo, hi):
            tile, _, chunk, slots = step[g]
            if tile >= 0:
                item += [(g, False, k0) for k0 in range(0, tb, sd)]
            if chunk >= 0:
                item += [(g, True, k0) for k0 in range(0, int(slots), sd)]
        out.append(item)
    return out


def _ring_k_flow(plan, H, k):
    """The ring K11's data flow in plain PyTorch: the operand staged once,
    each work item's slabs in the kernel's walk (a stage takes k of them and
    never crosses an item, so the grouping does not change a sum), each
    slab ``sd`` deep (a tile
    slab: tile columns k0 .. k0 + sd times those rows of the H block; a chunk
    slab: slots k0 .. k0 + sd), one f32 sum per work item, split runs summed
    in partial order, ``bf16(rowscale * acc)``."""
    B = plan.B
    tb, P, K = B.tb, H.shape[1], plan.K
    sd = tf.k_ring_slab_depth(k)
    n_ct = -(-B.n_cols // tb)
    Hs = tb_.stage_h_plain(H, plan.colscale, n_ct * tb, B.n_cols).float()
    L = plan.ring
    S, step = L.segments, L.step.long()
    slabs = _slabs(L, tb, sd)
    out = torch.zeros((B.n_row_tiles * tb, P))
    partial = torch.zeros((max(S.n_part, 1), tb, P))
    acc = {}
    for item, item_slabs in enumerate(slabs):
        a = acc.setdefault(item, torch.zeros((tb + 1, P)))  # row tb takes the dead slots
        for g, chunk, k0 in item_slabs:
            tile, cb, ch, _ = step[g].tolist()
            if not chunk:
                a[:tb] += tb_._tile_values(B.tiles[tile], tb)[:, k0: k0 + sd] @ Hs[cb * tb + k0: cb * tb + k0 + sd]
            else:
                sl = slice(ch * K + k0, ch * K + k0 + sd)
                G = Hs[plan.slot_col[sl].long()]
                if plan.colscale is None:  # value mode: scaled on the gathered rows
                    G = (G * plan.slot_scale[sl].to(torch.bfloat16).float()[:, None]).to(torch.bfloat16).float()
                a.index_add_(0, plan.lrow[ch, k0: k0 + sd].long(), G)
    for s in range(S.n_seg):
        a = acc.get(s, torch.zeros((tb + 1, P)))
        if S.seg_part[s] >= 0:
            partial[S.seg_part[s]] = a[:tb]
        else:
            out[S.seg_rb[s] * tb: (S.seg_rb[s] + 1) * tb] = a[:tb]
    for f in range(S.n_fin):
        r = S.fin_rb[f].item()
        out[r * tb: (r + 1) * tb] = partial[S.fin_p0[f]: S.fin_p0[f] + S.fin_np[f]].sum(dim=0)
    if plan.rowscale is not None:
        out = out * plan.rowscale[:, None]
    return out[: B.n_rows].to(torch.bfloat16)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("kind,attach", [("rank1", True), ("rank1", False), ("weighted", True), ("weighted", False)])
def test_ring_k_data_flow_equals_plain_k11(kind, attach, k):
    """Dyadic operands (H, edge values, power-of-two rank-1 scalings) keep
    every f32 sum exact, so the ring K11's walk must equal the plain K11
    bit for bit; and the JAX kernel in interpret mode at 2e-2."""
    rng = np.random.default_rng(31 + k)
    T = _hub_graph("weighted")
    part, rest = tdis.split_by_tile_density(T, 128, 60)
    cover = dict(tb=128, cover_rows=True, cover_cols=True)
    if kind == "rank1":
        B, Bj = tb_.bsr_mask_from_sparse(part, **cover), jb.bsr_mask_from_sparse(_to_jax(part), **cover)
        r1 = dict(r1_row=(0.5 ** rng.integers(0, 3, T.n_rows)).astype(np.float32),
                  r1_col=(0.5 ** rng.integers(0, 3, T.n_cols)).astype(np.float32))
    else:
        B, r1 = tb_.bsr_from_sparse(part, **cover), {}
        Bj = jb.bsr_from_sparse(_to_jax(part), device_build=False, **cover)
    kw = dict(attach_chunks=attach, K=128, **r1)
    plan = tf.build_fused_plan(B, rest, k_steps=k, **kw)
    # work items of 3 live steps: split runs, summed by the finalize pass
    plan = dataclasses.replace(plan, ring=tb_.recut_live_schedule(plan.ring, B.n_row_tiles, 3))
    assert plan.ring.n_dead_tile_steps > 0 and plan.num_rest_chunks > 0 and plan.ring.segments.n_fin > 0
    H = torch.from_numpy((rng.integers(-16, 17, (T.n_cols, 24)) / 8.0).astype(np.float32))
    out = _ring_k_flow(plan, H, k)
    assert torch.equal(out, tf.bsr_spmm_fused_k_plain(plan, H))
    pj = jf.build_fused_plan(Bj, _to_jax(rest), k_steps=k, tile_keys=tb_.bsr_tile_keys(part, 128, cover_rows=True,
                                                                                         cover_cols=True), **kw)
    want = np.asarray(jf.bsr_spmm_fused_k(pj, jnp.asarray(H.numpy()), interpret=True)).astype(np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=FUSED, atol=FUSED)


def test_fused_k_ring_shape_rule():
    """The ring K11 takes K2's ring shapes at k = 2, and int8 tiles only at
    k = 4 (four bf16 slabs fit one stage); the rule reads shapes and the
    tile form only."""
    i8, bf, f32, packed = 2, 0, 1, 3
    # the slab depth the launch passes: K2 (k = 1) and k = 2 at 64, k = 4 at 32
    assert [tf.k_ring_slab_depth(k) for k in (1, 2, 4)] == [64, 64, 32]
    assert tf.fused_k_ring_shape_ok(i8, 256, 128, 128, 2) and tf.fused_k_ring_shape_ok(i8, 64, 8, 64, 4)
    assert tf.fused_k_ring_shape_ok(bf, 128, 200, 128, 2) and not tf.fused_k_ring_shape_ok(bf, 128, 200, 128, 4)
    for mode, tb_s, P, K, k in ((f32, 128, 128, 128, 2), (packed, 256, 128, 128, 2), (i8, 128, 100, 128, 2),
                                (i8, 128, 128, 32, 2), (i8, 32, 128, 128, 4), (i8, 512, 128, 128, 2),
                                (i8, 128, 128, 128, 3)):
        assert not tf.fused_k_ring_shape_ok(mode, tb_s, P, K, k)
    plan, _, T = _k_plans("symnorm", True, 2)
    H = torch.randn(T.n_cols, 8)
    k = tf.bsr_spmm_fused_k
    before = (k.launches, k.launches_ring, k.launches_single)
    assert torch.equal(k(plan, H), tf.bsr_spmm_fused_k_plain(plan, H))
    assert (k.launches, k.launches_ring, k.launches_single) == before
