"""The three kernel variants of the port against the JAX package's, the
Pallas kernels run in interpret mode on the same numpy inputs: the plain
K10 (``bsr_spmm_rowloop``) in the three tile forms, the ``k_steps`` padding
of ``build_fused_plan`` and the plain K11 (``bsr_spmm_fused_k``), the
sub-block bitmap and the plain K12 (``flash_gat_forward_subskip``)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import bsr as jb
from sgracex1_tpu.ops import flash_gat as jfg
from sgracex1_tpu.ops import fused_agg as jf
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.graph.normalize import rank1_factor, sym_norm
from sgracex1_tpu_torch.ops import bsr as tb_
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.ops import flash_gat as tfg
from sgracex1_tpu_torch.ops import fused_agg as tf

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

EXACT = 1e-3  # the same bf16 operands; f32 sums in another order
FUSED = 2e-2  # both write bf16
SCIPY = 5e-2  # bf16 operands against the f32 product


def _to_jax(T):
    return JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)


def _graph(n, weighted, seed, empty_rb=None, tb=128, hub=4):
    """Random edges plus a hub block (a long run of tiles in the first row
    blocks); with ``empty_rb`` that row block gets no edge."""
    rng = np.random.default_rng(seed)
    hub = np.stack([rng.integers(0, 100, hub * n), rng.integers(0, n, hub * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 4 * n)), hub, hub[::-1]], axis=1), axis=1)
    if empty_rb is not None:
        ei = ei[:, ei[0] // tb != empty_rb]
    if not weighted:
        return sym_norm(ei, n)
    v = rng.uniform(0.2, 1.0, ei.shape[1]).astype(np.float32)
    return TSparse.from_coo(ei[0], ei[1], v, (n, n))


# ------------------------------------------------------------------- K10


@pytest.mark.parametrize(
    "form,tb,n,P,h_dtype",
    [("values", 128, 1100, 40, "float32"), ("mask", 256, 1500, 128, "float32"),
     ("packed", 1024, 2500, 24, "float32"), ("values", 128, 1100, 16, "bfloat16")],
)
def test_rowloop_plain_matches_pallas(form, tb, n, P, h_dtype):
    """The three tile forms, a row block without a tile (the values
    case), ragged n; 1e-3 against the Pallas kernel, 5e-2 against scipy,
    1e-3 against the plain K1."""
    T = _graph(n, form == "values", seed=3, empty_rb=2 if form == "values" else None, tb=tb)
    J = _to_jax(T)
    if form == "values":
        Bt, Bj = tb_.bsr_from_sparse(T, tb=tb), jb.bsr_from_sparse(J, tb=tb, device_build=False)
        assert 2 not in Bt.tile_rb.tolist()
        M = T
    else:
        build = "bsr_bitmask_from_sparse" if form == "packed" else "bsr_mask_from_sparse"
        Bt = getattr(tb_, build)(T, tb=tb)
        Bj = getattr(jb, build)(J, tb=tb, **(dict(device_build=False) if form == "packed" else {}))
        M = T.with_vals((T.vals > 0).astype(np.float32))
    H = np.random.default_rng(4).standard_normal((n, P)).astype(np.float32)
    Ht = torch.from_numpy(H).to(getattr(torch, h_dtype))
    out = tb_.bsr_spmm_rowloop(Bt, Ht)  # a CPU tensor: the plain version
    assert out.dtype == torch.float32 and out.shape == (n, P)
    want = np.asarray(jb.bsr_spmm_rowloop(Bj, jnp.asarray(H).astype(getattr(jnp, h_dtype)), interpret=True))
    np.testing.assert_allclose(out.numpy(), want, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(out.numpy(), tb_.bsr_spmm_plain(Bt, Ht).numpy(), rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(out.numpy(), M.to_scipy() @ Ht.float().numpy(), rtol=SCIPY, atol=SCIPY)
    if form == "values":
        assert (out.numpy()[2 * tb : 3 * tb] == 0).all()
    before = tb_.bsr_spmm_rowloop.launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        tb_.bsr_spmm_rowloop(Bt, Ht.to("meta"))
    assert tb_.bsr_spmm_rowloop.launches == before


# ------------------------------------------------------------------- K11


def _k_plans(graph, attach, k, tb=128, thresh=40):
    """(jax plan, torch plan, torch base plan, scipy matrix) of one hybrid
    split, the k-padded plans built by both packages."""
    # a lighter hub for the weighted graph: bf16 rounding of a hub row's
    # sum would pass the bound against scipy
    T = _graph(2500, graph == "weighted", seed=5, tb=tb, hub=1 if graph == "weighted" else 4)
    fac = rank1_factor(T)
    assert (fac is None) == (graph == "weighted")
    part, rest = tdis.split_by_tile_density(T, tb, thresh)
    if fac is not None:
        rest = tdis._drop_zero_val_edges(rest)
    assert rest.nnz
    cover = dict(cover_rows=True, cover_cols=True)
    if fac is not None:
        Bj, Bt = jb.bsr_mask_from_sparse(_to_jax(part), tb=tb, **cover), tb_.bsr_mask_from_sparse(part, tb=tb, **cover)
    else:
        Bj = jb.bsr_from_sparse(_to_jax(part), tb=tb, device_build=False, **cover)
        Bt = tb_.bsr_from_sparse(part, tb=tb, **cover)
    r1 = dict(r1_row=fac[0], r1_col=fac[1]) if fac is not None else {}
    kw = dict(K=128, tile_keys=tb_.bsr_tile_keys(part, tb, **cover), attach_chunks=attach, **r1)
    pj = jf.build_fused_plan(Bj, _to_jax(rest), k_steps=k, **kw)
    return pj, tf.build_fused_plan(Bt, rest, k_steps=k, **kw), tf.build_fused_plan(Bt, rest, **kw), T.to_scipy()


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("graph,attach", [("symnorm", True), ("symnorm", False), ("weighted", True), ("weighted", False)])
def test_k_steps_plan_identical_and_plain_matches(graph, attach, k):
    pj, pt, base, mat = _k_plans(graph, attach, k)
    assert pt.k_steps == pj.k_steps == k and base.k_steps == 1
    for name in ("step_rb", "step_cb", "step_tile", "step_chunk", "step_kind", "slot_col", "slot_scale"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, name)), getattr(pt, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(pj.lrow)[:, 0, :], pt.lrow.numpy())
    assert (pj.K, pj.num_steps, pj.num_chunks, pj.num_rest_chunks) == (
        pt.K, pt.num_steps, pt.num_chunks, pt.num_rest_chunks)
    # the padding: runs and segments on multiples of k, by dead steps of
    # kind 1 on one extra all-sentinel chunk
    runs = np.bincount(base.step_rb[:-1].numpy())
    pads = int(((-runs) % k).sum())
    assert pt.num_steps % k == 0 and pt.num_steps == base.num_steps + pads
    assert pads > 0 or k == 2
    if pads:
        assert pt.num_chunks == base.num_chunks + 1 and (pt.lrow[-1] == pt.B.tb).all()
        dead = pt.step_chunk == pt.num_chunks - 1
        assert int(dead.sum()) == pads and (pt.step_kind[dead] == 1).all()
    S = pt.segments
    assert (S.seg_lo % k == 0).all() and (S.seg_hi % k == 0).all()
    assert set(S.seg_rb.tolist()) == set(range(pt.B.n_row_tiles))

    H = np.random.default_rng(6).standard_normal((mat.shape[1], 48)).astype(np.float32)
    Ht = torch.from_numpy(H)
    out = tf.bsr_spmm_fused_k(pt, Ht)  # a CPU tensor: the plain version
    assert out.dtype == torch.bfloat16 and out.shape == (mat.shape[0], 48)
    want = np.asarray(jf.bsr_spmm_fused_k(pj, jnp.asarray(H), interpret=True)).astype(np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=FUSED, atol=FUSED)
    # the dead steps add nothing: the plain K2 on the base plan, to the
    # bound the JAX test holds the two kernels to
    k2 = tf.bsr_spmm_fused_plain(base, Ht).float().numpy()
    np.testing.assert_allclose(out.float().numpy(), k2, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.float().numpy(), mat @ H, rtol=SCIPY, atol=SCIPY)


def test_fused_k_rules():
    _, pt, base, mat = _k_plans("symnorm", True, 2)
    H = torch.zeros(mat.shape[1], 8)
    # k_steps == 1 is K2 itself
    torch.testing.assert_close(tf.bsr_spmm_fused_k(base, H), tf.bsr_spmm_fused(base, H), rtol=0, atol=0)
    # a plan that claims k_steps without the padding is refused
    import dataclasses
    with pytest.raises(ValueError, match="k_steps"):
        tf.bsr_spmm_fused_k(dataclasses.replace(base, k_steps=4), H)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tf.bsr_spmm_fused_k(pt, H.to("meta"))
    assert pt.to("cpu").k_steps == 2


# ------------------------------------------------------------------- K12


def _scores(n, F, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) * 2).astype(np.float32), (rng.standard_normal(n) * 2).astype(np.float32),
            rng.standard_normal((n, F)).astype(np.float32))


def _isolating_graph(n, weighted, seed, isolated=7):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, 3 * n))
    ei = ei[:, (ei % isolated != 3).all(axis=0)]
    ei = np.unique(np.concatenate([ei, ei[::-1]], axis=1), axis=1)
    if not weighted:
        return sym_norm(ei, n)  # fill-0 self-loops: in the edge list, masked out
    v = rng.uniform(0.1, 1.0, ei.shape[1]).astype(np.float32)
    return TSparse.from_coo(ei[0], ei[1], v, (n, n))


@pytest.mark.parametrize(
    "weighted,tb,sb,n",
    [(False, 256, 64, 700), (False, 256, 128, 700), (False, 256, 256, 700),
     (True, 128, 64, 500), (False, 512, 128, 1100),
     (False, 64, 8, 300), (False, 128, 16, 400), (True, 128, 32, 400)],
)
def test_subskip_bitmap_identical_and_plain_matches(weighted, tb, sb, n):
    T = _isolating_graph(n, weighted, seed=8)
    J = _to_jax(T)
    if weighted:
        Bt, Bj = tb_.bsr_from_sparse(T, tb=tb), jb.bsr_from_sparse(J, tb=tb, device_build=False)
    else:
        Bt, Bj = tb_.bsr_mask_from_sparse(T, tb=tb), jb.bsr_mask_from_sparse(J, tb=tb)
    pop = tfg.subblock_pop_bitmap(Bt, T, sb)
    want_pop = jfg.subblock_pop_bitmap(Bj, J, sb)
    assert pop.dtype == np.int32 and pop.shape == (Bt.num_tiles, -(-((tb // sb) ** 2) // 32))
    np.testing.assert_array_equal(pop, want_pop)
    if sb == 64 and not weighted:
        assert (pop != (1 << ((tb // sb) ** 2)) - 1).any()  # some sub-block is empty
    s1, s2, Wh = _scores(n, 24, seed=9)
    out = tfg.flash_gat_forward_subskip(Bt, pop, *map(torch.from_numpy, (s1, s2, Wh)), sb=sb)
    assert out.shape == (n, 24) and out.dtype == torch.float32
    want = np.asarray(jfg.flash_gat_forward_subskip(
        Bj, want_pop, jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(Wh), sb=sb, interpret=True))
    np.testing.assert_allclose(out.numpy(), want, rtol=EXACT, atol=EXACT)
    # the same function as K3, whose bf16(p) rounds against the running
    # max after a whole tile instead of after each strip
    k3 = tfg.flash_gat_forward_plain(Bt, *map(torch.from_numpy, (s1, s2, Wh)))
    np.testing.assert_allclose(out.numpy(), k3.numpy(), rtol=FUSED, atol=FUSED)
    has = np.zeros(n, bool)
    has[T.rows[: T.nnz][T.vals[: T.nnz] > 0]] = True
    assert not has.all() and (out.numpy()[~has] == 0).all()  # isolated rows come out 0


@pytest.mark.parametrize("tb,sb", [(64, 8), (128, 32), (256, 64)])
def test_subskip_cleared_bitmap_matches_pallas(tb, sb):
    """A bitmap that clears populated sub-blocks: their edges are never
    seen, in the plain K12 as in the Pallas kernel (interpret mode)."""
    n = 3 * tb + 40
    T = _isolating_graph(n, False, seed=tb + sb)
    J = _to_jax(T)
    Bt, Bj = tb_.bsr_mask_from_sparse(T, tb=tb), jb.bsr_mask_from_sparse(J, tb=tb)
    full = tfg.subblock_pop_bitmap(Bt, T, sb)
    rng = np.random.default_rng(sb)
    pop = full & rng.integers(-2**31, 2**31, full.shape, dtype=np.int64).astype(np.int32)
    assert (pop != full).any()
    s1, s2, Wh = _scores(n, 16, seed=sb)
    out = tfg.flash_gat_forward_subskip(Bt, pop, *map(torch.from_numpy, (s1, s2, Wh)), sb=sb)
    want = np.asarray(jfg.flash_gat_forward_subskip(
        Bj, pop, jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(Wh), sb=sb, interpret=True))
    np.testing.assert_allclose(out.numpy(), want, rtol=EXACT, atol=EXACT)
    kept = tfg.flash_gat_forward_subskip(Bt, full, *map(torch.from_numpy, (s1, s2, Wh)), sb=sb)
    assert not torch.allclose(out, kept, rtol=FUSED, atol=FUSED)


def test_subskip_reads_its_bitmap_and_keeps_the_jax_rules():
    T = _isolating_graph(400, False, seed=10)
    B = tb_.bsr_mask_from_sparse(T, tb=128)
    s1, s2, Wh = map(torch.from_numpy, _scores(400, 8, seed=11))
    pop = tfg.subblock_pop_bitmap(B, T, 64)
    full = tfg.flash_gat_forward_subskip(B, pop, s1, s2, Wh, sb=64)
    # clearing tile 0's bits removes its edges from the softmax
    cut = pop.copy()
    cut[0] = 0
    assert not torch.equal(tfg.flash_gat_forward_subskip(B, cut, s1, s2, Wh, sb=64), full)
    with pytest.raises(AssertionError, match="single-head"):
        tfg.flash_gat_forward_subskip(B, pop, s1[:, None].repeat(1, 2), s2[:, None].repeat(1, 2),
                                      Wh[:, None].repeat(1, 2, 1), sb=64)
    packed = tb_.bsr_bitmask_from_sparse(T, tb=128)
    with pytest.raises(NotImplementedError, match="unpacked"):
        tfg.flash_gat_forward_subskip(packed, pop, s1, s2, Wh, sb=64)
    with pytest.raises(ValueError, match="pop"):
        tfg.flash_gat_forward_subskip(B, pop[:, :0], s1, s2, Wh, sb=64)
    before = tfg.flash_gat_forward_subskip.launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfg.flash_gat_forward_subskip(B, pop, s1, s2, Wh.to("meta"), sb=64)
    assert tfg.flash_gat_forward_subskip.launches == before
