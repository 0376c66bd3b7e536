"""sgracex1_tpu_torch.ops.bsr against sgracex1_tpu.ops.bsr: host tile
builds must be identical; the plain K1 must match the Pallas kernel (run
in interpret mode) on identical bf16 operands."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import bsr as jb
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.ops import bsr as tb_

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _graphs(n=2048, weighted=True, seed=0):
    """(jax matrix, torch matrix) of one random graph; weighted values or
    a sym-normalized (fill=0 self-loops) pattern."""
    rng = np.random.default_rng(seed)
    ei = np.unique(rng.integers(0, n, (2, 4 * n)), axis=1)
    if weighted:
        v = rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32)
        T = TSparse.from_coo(ei[0], ei[1], v, (n, n))
    else:
        T = sym_norm(ei, n)
    J = JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)
    return J, T


def _np_tiles(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "V" or str(a.dtype) == "bfloat16" else a


def _assert_same_bsr(J, T):
    jt = _np_tiles(J.tiles)
    tt = T.tiles.float().numpy() if T.tiles.dtype == torch.bfloat16 else T.tiles.numpy()
    assert jt.shape == tt.shape
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(np.asarray(J.tile_rb), T.tile_rb.numpy())
    np.testing.assert_array_equal(np.asarray(J.tile_cb), T.tile_cb.numpy())
    assert (J.n_rows, J.n_cols, J.tb) == (T.n_rows, T.n_cols, T.tb)


@pytest.mark.parametrize("cover", [(False, False), (True, False), (True, True)])
def test_tile_keys(cover):
    J, T = _graphs(n=3000, seed=1)
    # sparse corner: drop edges so some row/col blocks are empty
    keep = (np.asarray(T.rows[: T.nnz]) < 1000) & (np.asarray(T.cols[: T.nnz]) > 500)
    T = TSparse.from_coo(T.rows[: T.nnz][keep], T.cols[: T.nnz][keep], T.vals[: T.nnz][keep], T.shape)
    J = JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)
    kw = dict(cover_rows=cover[0], cover_cols=cover[1])
    np.testing.assert_array_equal(
        jb.bsr_tile_keys(J, 128, **kw), tb_.bsr_tile_keys(T, 128, **kw)
    )


@pytest.mark.parametrize("form", ["bf16", "f32", "mask"])
def test_bsr_from_sparse(form):
    J, T = _graphs(weighted=form != "mask")
    kw = dict(tb=128, cover_rows=True, cover_cols=True)
    if form == "mask":
        a, b = jb.bsr_mask_from_sparse(J, **kw), tb_.bsr_mask_from_sparse(T, **kw)
        assert b.tiles.dtype == torch.int8
    else:
        jd, td = (jnp.bfloat16, torch.bfloat16) if form == "bf16" else (jnp.float32, torch.float32)
        a = jb.bsr_from_sparse(J, dtype=jd, device_build=False, **kw)
        b = tb_.bsr_from_sparse(T, dtype=td, **kw)
    _assert_same_bsr(a, b)


def test_bitmask_and_unpack():
    J, T = _graphs(weighted=False, seed=2)
    a = jb.bsr_bitmask_from_sparse(J, tb=1024, cover_rows=True, device_build=False)
    b = tb_.bsr_bitmask_from_sparse(T, tb=1024, cover_rows=True)
    assert b.tiles.dtype == torch.uint8 and b.tiles.shape[-1] == 128
    _assert_same_bsr(a, b)
    m = tb_.bsr_mask_from_sparse(T, tb=1024, cover_rows=True)
    np.testing.assert_array_equal(
        tb_.unpack_mask01_tile(b.tiles, 1024).numpy(), m.tiles.float().numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jb.unpack_mask01_tile(jnp.asarray(np.asarray(a.tiles)), 1024)),
        tb_.unpack_mask01_tile(b.tiles, 1024).numpy(),
    )


@pytest.mark.parametrize("mask", [False, True])
def test_bsr_transpose(mask):
    J, T = _graphs(n=1500, weighted=not mask, seed=3)
    kw = dict(tb=128, cover_rows=True, cover_cols=True)
    if mask:
        a, b = jb.bsr_mask_from_sparse(J, **kw), tb_.bsr_mask_from_sparse(T, **kw)
    else:
        a = jb.bsr_from_sparse(J, device_build=False, **kw)
        b = tb_.bsr_from_sparse(T, **kw)
    _assert_same_bsr(jb.bsr_transpose(a), tb_.bsr_transpose(b))
    with pytest.raises(ValueError):
        tb_.bsr_transpose(tb_.bsr_bitmask_from_sparse(T, tb=1024))


def test_run_segments_cover_every_step_once():
    L = tb_.SEG_STEPS
    rb = np.repeat(np.arange(6), [0, 1, 2 * L + 8, L, L + 1, 3])  # block 0 empty
    S = tb_.run_segments(rb, n_rt=7)
    lo, hi, part = S.seg_lo.numpy(), S.seg_hi.numpy(), S.seg_part.numpy()
    seg_rb = S.seg_rb.numpy()
    assert sorted(set(seg_rb)) == list(range(7))  # every block written
    steps = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
    np.testing.assert_array_equal(steps, np.arange(len(rb)))
    np.testing.assert_array_equal(rb[steps], np.repeat(seg_rb, hi - lo))
    # blocks 2 (3 segments) and 4 (2) split; partial slots are contiguous
    np.testing.assert_array_equal(S.fin_rb.numpy(), [2, 4])
    np.testing.assert_array_equal(S.fin_np.numpy(), [3, 2])
    np.testing.assert_array_equal(np.sort(part[part >= 0]), np.arange(S.n_part))
    assert (part[np.isin(seg_rb, [2, 4], invert=True)] == -1).all()


@pytest.mark.parametrize("form", ["values", "int8", "packed"])
def test_bsr_spmm_plain_matches_pallas(form):
    """Identical bf16 operands, f32 sums in another order: 1e-3."""
    J, T = _graphs(n=2048 if form != "packed" else 2500, weighted=form == "values", seed=4)
    kw = dict(cover_rows=True)
    if form == "values":
        a = jb.bsr_from_sparse(J, tb=128, device_build=False, **kw)
        b = tb_.bsr_from_sparse(T, tb=128, **kw)
    elif form == "int8":
        a, b = jb.bsr_mask_from_sparse(J, tb=128, **kw), tb_.bsr_mask_from_sparse(T, tb=128, **kw)
    else:
        a = jb.bsr_bitmask_from_sparse(J, tb=1024, device_build=False, **kw)
        b = tb_.bsr_bitmask_from_sparse(T, tb=1024, **kw)
    H = np.random.default_rng(5).standard_normal((T.n_cols, 48)).astype(np.float32)
    out_j = np.asarray(jb.bsr_spmm_pallas(a, jnp.asarray(H)))
    out_t = tb_.bsr_spmm(b, torch.from_numpy(H))
    assert out_t.dtype == torch.float32 and out_t.shape == (T.n_rows, 48)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-3, atol=1e-3)
    if form != "values":  # masks: A @ H of the positive-edge pattern
        pat = (T.to_scipy() > 0).astype(np.float32)
        ref = pat @ H.astype(jnp.bfloat16).astype(np.float32)
        np.testing.assert_allclose(out_t.numpy(), ref, rtol=1e-3, atol=1e-3)


# ----------------------------------------------- the ring K1's live schedule


def _sbm(n=1536, blocks=6, seed=5):
    """Block-diagonal communities plus a few cross edges, sym-normalized."""
    rng = np.random.default_rng(seed)
    size = n // blocks
    src = rng.integers(0, n, 6 * n)
    dst = (src // size) * size + rng.integers(0, size, 6 * n)
    cross = rng.integers(0, n, (2, n // 8))
    return sym_norm(np.unique(np.concatenate([np.stack([src, dst]), cross], axis=1), axis=1), n)


def _powerlaw(n=2048, seed=6):
    from sgracex1_tpu_torch.graph.datasets import powerlaw_node_classification

    d = powerlaw_node_classification(n=n, num_features=4, num_classes=2, seed=seed)
    return sym_norm(d.edge_index, n)


def _empty_row_block(n=1200, tb=128, seed=7):
    """Weighted edges with row block 2 and column block 5 left empty."""
    rng = np.random.default_rng(seed)
    ei = np.unique(rng.integers(0, n, (2, 5 * n)), axis=1)
    ei = ei[:, (ei[0] // tb != 2) & (ei[1] // tb != 5)]
    v = rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32)
    return TSparse.from_coo(ei[0], ei[1], v, (n, n))


LIVE_GRAPHS = {"sbm": _sbm, "powerlaw": _powerlaw, "empty-row-block": _empty_row_block}


def _forms(T):
    cover = dict(tb=128, cover_rows=True, cover_cols=True)
    return {
        "values": tb_.bsr_from_sparse(T, **cover),
        "mask": tb_.bsr_mask_from_sparse(T, **cover),
        "packed": tb_.bsr_bitmask_from_sparse(T, **cover),
        "packed-transposed": tb_.bsr_bitmask_from_sparse(T.transpose(), **cover),
    }


@pytest.mark.parametrize("graph", sorted(LIVE_GRAPHS))
def test_live_flags_mark_the_tiles_with_a_nonzero(graph):
    """``live`` is "an edge with a value produced this tile", which on
    these graphs is "the tile holds a nonzero": forward and transposed, in
    every tile form; the cover tiles are the rest."""
    T = LIVE_GRAPHS[graph]()
    forms = _forms(T)
    forms["values-transposed"] = tb_.bsr_transpose(forms["values"])
    forms["mask-transposed"] = tb_.bsr_transpose(forms["mask"])
    for name, B in forms.items():
        nonzero = B.tiles.reshape(B.num_tiles, -1).ne(0).any(dim=1)
        assert torch.equal(B.live, nonzero), name
        assert B.live.dtype == torch.bool and B.live.shape == (B.num_tiles,)
    if graph == "empty-row-block":
        B = forms["values"]
        assert not B.live[B.tile_rb == 2].any() and not B.live[B.tile_cb == 5].any()
        assert (~B.live).sum() >= 2  # a cover tile for the row block, one for the column block


def test_live_flags_of_shifted_and_empty_tile_sets():
    T = _empty_row_block()
    B = tb_.bsr_from_sparse(T, tb=128, dtype=torch.int8, shift=128.0, cover_rows=True)
    assert B.live.all()  # -128 everywhere: no tile is zero
    z = np.zeros(0, np.int64)
    E = tb_.bsr_from_sparse(TSparse.from_coo(z, z, np.zeros(0, np.float32), (300, 300)), tb=128)
    assert E.num_tiles == 1 and not E.live.any() and E.ring.step.shape == (0, 4)
    assert E.ring.segments.n_seg == 3  # every row block keeps a work item: its rows are written


@pytest.mark.parametrize("graph", sorted(LIVE_GRAPHS))
@pytest.mark.parametrize("seg_steps", [2, 16])
def test_ring_schedule_lists_each_live_tile_once(graph, seg_steps):
    T = LIVE_GRAPHS[graph]()
    for B in (tb_.bsr_from_sparse(T, tb=128, cover_rows=True, cover_cols=True),
              tb_.bsr_transpose(tb_.bsr_mask_from_sparse(T, tb=128, cover_rows=True, cover_cols=True))):
        L = tb_.recut_live_schedule(B.ring, B.n_row_tiles, seg_steps)
        step, S = L.step.numpy(), L.segments
        live = np.flatnonzero(B.live.numpy())
        np.testing.assert_array_equal(step[:, 0], live)  # run order kept
        np.testing.assert_array_equal(step[:, 1], B.tile_cb.numpy()[live])
        np.testing.assert_array_equal(L.rb.numpy(), B.tile_rb.numpy()[live])
        assert (step[:, 2] == -1).all() and (step[:, 3] == 0).all()
        assert L.n_tile_steps == len(live) and B.ring.n_dead_tile_steps == B.num_tiles - len(live)
        lo, hi, rb = S.seg_lo.numpy(), S.seg_hi.numpy(), S.seg_rb.numpy()
        assert ((hi - lo) <= seg_steps).all() and (np.diff(hi - lo) <= 0).all()  # longest first
        seen = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)] + [np.zeros(0, np.int64)])
        np.testing.assert_array_equal(np.sort(seen), np.arange(len(live)))
        for a, b, r in zip(lo, hi, rb):
            assert (L.rb.numpy()[a:b] == r).all()
        assert set(rb.tolist()) == set(range(B.n_row_tiles))  # empty row blocks too
        # a split run's partials: consecutive ids, in run order
        part = S.seg_part.numpy()
        for f in range(S.n_fin):
            mine = np.flatnonzero(rb == S.fin_rb[f].item())
            ids = part[mine][np.argsort(lo[mine])]
            np.testing.assert_array_equal(ids, S.fin_p0[f].item() + np.arange(S.fin_np[f].item()))
        assert ((part >= 0) == np.isin(rb, S.fin_rb.numpy())).all()


def _dyadic(rng, shape):
    """Small multiples of 1/8: bf16 holds them and every f32 sum of their
    products is exact, so two summation orders agree bit for bit."""
    return torch.from_numpy((rng.integers(-16, 17, shape) / 8.0).astype(np.float32))


@pytest.mark.parametrize("graph", sorted(LIVE_GRAPHS))
@pytest.mark.parametrize("form", ["values", "mask"])
def test_ring_data_flow_equals_plain_k1(graph, form):
    """The ring K1's data flow in plain PyTorch (H rounded once by the
    pre-pass, tile products over the live steps of ``B.ring`` only, summed
    per work item, split runs summed in partial order) equals
    ``bsr_spmm_plain``; so does the plain version on the tile set with the
    empty tiles dropped."""
    T = LIVE_GRAPHS[graph]()
    rng = np.random.default_rng(8)
    for B in (_forms(T)[form], tb_.bsr_transpose(_forms(T)[form])):
        tb, P = B.tb, 24
        H = _dyadic(rng, (B.n_cols, P))
        ref = tb_.bsr_spmm_plain(B, H)
        # the empty tiles dropped from the tile set
        live = B.live
        dropped = tb_.BSRMatrix(
            tiles=B.tiles[live], tile_rb=B.tile_rb[live], tile_cb=B.tile_cb[live], n_rows=B.n_rows,
            n_cols=B.n_cols, tb=tb,
            **tb_._schedules(B.tile_rb[live].numpy(), B.tile_cb[live].numpy(), np.ones(int(live.sum()), bool),
                             B.n_rows, B.n_cols, tb, "cpu"),
        )
        assert torch.equal(tb_.bsr_spmm_plain(dropped, H), ref)
        # the ring's flow
        n_ct = -(-B.n_cols // tb)
        Hs = tb_.stage_h_plain(H, None, n_ct * tb, B.n_cols)
        assert Hs.dtype == torch.bfloat16 and Hs.shape == (n_ct * tb, P)
        assert torch.equal(Hs[: B.n_cols], H.to(torch.bfloat16)) and not Hs[B.n_cols:].any()
        L = tb_.recut_live_schedule(B.ring, B.n_row_tiles, 3)  # short items: runs split
        S, step = L.segments, L.step.long()
        assert S.n_fin > 0
        out = torch.zeros((B.n_row_tiles * tb, P))
        partial = torch.zeros((max(S.n_part, 1), tb, P))
        Hblk = Hs.float().view(n_ct, tb, P)
        for s in range(S.n_seg):
            acc = torch.zeros((tb, P))
            for g in range(S.seg_lo[s], S.seg_hi[s]):
                acc += tb_._tile_values(B.tiles[step[g, 0]], tb) @ Hblk[step[g, 1]]
            if S.seg_part[s] >= 0:
                partial[S.seg_part[s]] = acc
            else:
                out[S.seg_rb[s] * tb: (S.seg_rb[s] + 1) * tb] = acc
        for f in range(S.n_fin):
            r = S.fin_rb[f].item()
            out[r * tb: (r + 1) * tb] = partial[S.fin_p0[f]: S.fin_p0[f] + S.fin_np[f]].sum(dim=0)
        assert torch.equal(out[: B.n_rows], ref)


def test_ring_shape_rule():
    """The ring kernels take int8 and bf16 tiles of height 64..256 at
    P % 8 == 0 and K % 64 == 0; everything else is the single-stage
    kernels'. The rule reads nothing but the tile form and the shapes."""
    ok = tb_.ring_shape_ok
    bf16, f32, i8, bits = 0, 1, 2, 3
    for mode in (bf16, i8):
        for tb in (64, 128, 192, 256):
            for P in (8, 64, 128, 200):
                assert ok(mode, tb, P) and ok(mode, tb, P, 128) and ok(mode, tb, P, 64)
    assert not ok(f32, 256, 128) and not ok(bits, 1024, 128)
    assert not ok(i8, 32, 128) and not ok(i8, 96, 128) and not ok(i8, 512, 128)
    assert not ok(i8, 256, 100) and not ok(bf16, 128, 33) and not ok(i8, 256, 4)
    assert not ok(i8, 256, 128, 32) and not ok(bf16, 128, 64, 96)
    assert tb_._tile_mode(torch.zeros((1, 64, 64), dtype=torch.int8), 64) == i8
    assert tb_._tile_mode(torch.zeros((1, 64, 64), dtype=torch.bfloat16), 64) == bf16


def test_k1_wrappers_count_nothing_on_the_cpu():
    _, T = _graphs(n=512)
    B = tb_.bsr_from_sparse(T, tb=128)
    before = (tb_.bsr_spmm.launches, tb_.bsr_spmm.launches_ring, tb_.bsr_spmm.launches_single)
    out = tb_.bsr_spmm(B, torch.ones(512, 8))
    assert torch.equal(out, tb_.bsr_spmm_plain(B, torch.ones(512, 8)))
    assert (tb_.bsr_spmm.launches, tb_.bsr_spmm.launches_ring, tb_.bsr_spmm.launches_single) == before
