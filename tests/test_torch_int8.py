"""The full-integer int8 path of the port against the JAX package on the
same numpy inputs: shifted tiles and the hybrid plan's arrays identical;
the plain K7 and K8 array_equal to the Pallas kernels (interpret mode) and
to a scipy integer product; every quant/int8 function against its twin,
integer outputs equal and float outputs at 1e-6 (the same float32
operations; libm's exp differs in the last bit)."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import bsr as jbsr
from sgracex1_tpu.ops import dispatch as jdis
from sgracex1_tpu.ops import fused_agg as jfa
from sgracex1_tpu.quant import int8 as jq
from sgracex1_tpu.quant.affine import QuantConstants as JConst
from sgracex1_tpu.quant.calibration import CalibrationTable as JCal
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.nn import int8_layer_from_jax
from sgracex1_tpu_torch.ops import bsr as tbsr
from sgracex1_tpu_torch.ops import fused_agg as tfa
from sgracex1_tpu_torch.ops.dispatch import split_by_tile_density
from sgracex1_tpu_torch.quant import int8 as tq
from sgracex1_tpu_torch.quant.affine import QuantConstants as TConst
from sgracex1_tpu_torch.quant.calibration import CalibrationTable as TCal

torch.set_num_threads(1)

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _uc(cls, beta):
    return cls(s_o=1.0, s=beta / 255.0, z=0, qbits=8, signed=False)


def _sc(cls, absmax):
    return cls(s_o=1.0, s=absmax / 127.0, z=0, qbits=8, signed=True)


def _graph(n, seed, hub=True, empty_rb=None, tb=128):
    """Coalesced weighted edges in (0, 1]: a sparse tail, a hub block of
    dense tiles, optionally one row block with no edge."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, 4 * n))
    if hub:
        h = np.stack([rng.integers(0, 150, 9 * n), rng.integers(0, n, 9 * n)])
        ei = np.concatenate([ei, h, h[::-1]], axis=1)
    ei = np.unique(ei, axis=1)
    if empty_rb is not None:
        ei = ei[:, ei[0] // tb != empty_rb]
    v = rng.uniform(0.01, 1.0, ei.shape[1]).astype(np.float32)
    T = pt.SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))
    J = JSparse.from_coo(ei[0], ei[1], v, (n, n))
    return J, T


def _host_product(T, c_a, hq):
    v = T.vals[: T.nnz]
    aq = np.clip(np.round(v / c_a.s + c_a.z), 0, c_a.beta_q).astype(np.int64)
    mat = sp.coo_matrix((aq, (T.rows[: T.nnz], T.cols[: T.nnz])), shape=T.shape).tocsr()
    return mat @ hq.astype(np.int64)


def _jax_thresh(tb):
    return int(np.ceil(jdis._tile_cost_s(tb, 1.0) / (jdis._REST_SLOT_S + jdis._REST_CHUNK_S / jdis._REST_K)))


# ----------------------------------------------------------------- K7


@pytest.mark.parametrize("n,tb,P,empty_rb", [(700, 128, 8, 3), (700, 64, 12, None), (1100, 256, 8, None)])
def test_plain_k7_equals_pallas_and_scipy(n, tb, P, empty_rb):
    J, T = _graph(n, 1, empty_rb=empty_rb, tb=tb)
    cj, ct = _uc(JConst, 1.0), _uc(TConst, 1.0)
    Bj = jq.bsr_int8_from_sparse(J, cj, tb=tb)
    Bt = tq.bsr_int8_from_sparse(T, ct, tb=tb, device="cpu")
    assert Bt.tiles.dtype == torch.int8
    for k in ("tiles", "tile_rb", "tile_cb"):
        np.testing.assert_array_equal(np.asarray(getattr(Bj, k)), getattr(Bt, k).numpy(), err_msg=k)
    if empty_rb is not None:  # the cover tile holds the shifted zero everywhere
        cover = Bt.tiles[(Bt.tile_rb == empty_rb).nonzero()[0, 0]]
        assert (cover == -128).all()
    hq = np.random.default_rng(2).integers(-127, 128, (n, P)).astype(np.int8)
    before = tbsr.bsr_spmm_int8.launches
    out = tbsr.bsr_spmm_int8(Bt, torch.from_numpy(hq))
    assert tbsr.bsr_spmm_int8.launches == before  # a CPU tensor runs the plain version
    assert out.dtype == torch.int32 and out.shape == (Bt.n_row_tiles * tb, P)  # not sliced to n_rows
    np.testing.assert_array_equal(out.numpy(), np.asarray(jbsr.bsr_spmm_int8(Bj, jnp.asarray(hq))))
    np.testing.assert_array_equal(out.numpy()[:n], _host_product(T, ct, hq))
    assert (out.numpy()[n:] == 0).all()


def test_k7_wrapper_contract():
    _, T = _graph(300, 3, hub=False)
    B = tq.bsr_int8_from_sparse(T, _uc(TConst, 1.0), tb=128, device="cpu")
    hq = torch.zeros(300, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        tbsr.bsr_spmm_int8(B, hq.float())
    with pytest.raises(ValueError, match="shifted int8"):
        tbsr.bsr_spmm_int8(dataclasses.replace(B, tiles=B.tiles.float()), hq)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tbsr.bsr_spmm_int8(B, hq.to("meta"))
    assert (tbsr.bsr_spmm_int8(B, hq) == 0).all()  # (-128) * 0 + 128 * 0


# ----------------------------------------------------------------- K8


@pytest.mark.parametrize("n,tb,P", [(1600, 128, 8), (900, 64, 12)])
def test_hybrid_plan_identical_and_plain_k8_exact(n, tb, P):
    J, T = _graph(n, 5)
    cj, ct = _uc(JConst, 1.0), _uc(TConst, 1.0)
    pj = jq.prepare_int8_hybrid(J, cj, tb=tb, K=128)
    plan = tq.prepare_int8_hybrid(T, ct, tb=tb, K=128, rest_thresh=_jax_thresh(tb), device="cpu")
    assert plan.num_rest_chunks == pj.num_rest_chunks > 0 and plan.colscale is None
    for k in ("tiles", "tile_rb", "tile_cb"):
        np.testing.assert_array_equal(np.asarray(getattr(pj.B, k)), getattr(plan.B, k).numpy(), err_msg=k)
    for k in ("step_rb", "step_cb", "step_tile", "step_chunk", "step_kind", "slot_col", "slot_scale"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, k)), getattr(plan, k).numpy(), err_msg=k)
    np.testing.assert_array_equal(np.asarray(pj.lrow)[:, 0, :], plan.lrow.numpy())
    assert (plan.lrow == tb).any() and set(plan.step_kind.tolist()) >= {0, 3}
    hq = np.random.default_rng(6).integers(-127, 128, (n, P)).astype(np.int8)
    before = tfa.bsr_spmm_int8_fused.launches
    out = tq.int8_hybrid_agg(plan, torch.from_numpy(hq))
    assert tfa.bsr_spmm_int8_fused.launches == before
    assert out.dtype == torch.int32 and out.shape == (n, P)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jq.int8_hybrid_agg(pj, jnp.asarray(hq))))
    np.testing.assert_array_equal(out.numpy(), _host_product(T, ct, hq))


def test_plain_k8_unattached_chunks_and_contract():
    """Chunk-only steps (kind 1) next to tile steps; rank-1 plans refused."""
    n, tb = 900, 128
    J, T = _graph(n, 7)
    cj, ct = _uc(JConst, 1.0), _uc(TConst, 1.0)
    part, rest = split_by_tile_density(T, tb, 30)
    B8 = tq.bsr_int8_from_sparse(part, ct, tb=tb, cover_cols=True, device="cpu")
    plan = tfa.build_fused_plan(B8, rest.with_vals(tq._quantize_vals(rest.vals, ct)), attach_chunks=False)
    assert set(plan.step_kind.tolist()) == {0, 1}
    jpart, jrest = jdis.split_by_tile_density(J, tb, 30)
    jB8 = jq.bsr_int8_from_sparse(jpart, cj, tb=tb, cover_cols=True)
    jplan = jfa.build_fused_plan(jB8, jrest.with_vals(tq._quantize_vals(np.asarray(jrest.vals), cj)), attach_chunks=False)
    hq = np.random.default_rng(8).integers(-127, 128, (n, 8)).astype(np.int8)
    out = tfa.bsr_spmm_int8_fused(plan, torch.from_numpy(hq))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jfa.bsr_spmm_int8_fused(jplan, jnp.asarray(hq))))
    np.testing.assert_array_equal(out.numpy(), _host_product(T, ct, hq))
    with pytest.raises(ValueError, match="value-mode"):
        tfa.bsr_spmm_int8_fused(dataclasses.replace(plan, colscale=torch.ones(1)), torch.from_numpy(hq))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.bsr_spmm_int8_fused(plan, torch.from_numpy(hq).to("meta"))


# ------------------------------------------------- the quant/int8 functions


def test_quantize_and_requantize_twins():
    rng = np.random.default_rng(9)
    cj, ct = _uc(JConst, 0.9), _uc(TConst, 0.9)
    sj, st = _sc(JConst, 0.5), _sc(TConst, 0.5)
    k = np.arange(-3, 260)
    x = np.concatenate([(k + 0.5) * cj.s, k * cj.s, rng.uniform(-0.2, 1.2, 300)]).astype(np.float32)
    np.testing.assert_array_equal(
        tq.quantize_unsigned_shifted(torch.from_numpy(x), ct).numpy(),
        np.asarray(jq.quantize_unsigned_shifted(jnp.asarray(x), cj)))
    w = np.concatenate([(np.arange(-130, 131) + 0.5) * sj.s, rng.uniform(-0.7, 0.7, 300)]).astype(np.float32)
    np.testing.assert_array_equal(
        tq.quantize_signed(torch.from_numpy(w), st).numpy(), np.asarray(jq.quantize_signed(jnp.asarray(w), sj)))
    acc = rng.integers(-(2**20), 2**20, (64, 9)).astype(np.int32)
    acc[0, :] = [0, 1, -1, 127, -127, 255, 256, 2**23, -(2**23)]
    for m in (1.0 / 3.0, 0.5, 0.0123456789, 2.5e-4):  # 0.5 makes exact ties
        np.testing.assert_array_equal(
            tq.requantize_signed(torch.from_numpy(acc), m).numpy(), np.asarray(jq.requantize_signed(jnp.asarray(acc), m)))
        got = tq.requantize_unsigned_shifted(torch.from_numpy(acc), m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jq.requantize_unsigned_shifted(jnp.asarray(acc), m)))
        assert (got[torch.from_numpy(acc) < 0] == -128).all()  # the lower clamp is the ReLU
        np.testing.assert_array_equal(
            tq.dequantize_acc(torch.from_numpy(acc), m).numpy(), np.asarray(jq.dequantize_acc(jnp.asarray(acc), m)))


def test_matmul_unsigned_x_signed_exact():
    rng = np.random.default_rng(10)
    us = rng.integers(-128, 128, (50, 100)).astype(np.int8)
    sq = rng.integers(-127, 128, (100, 12)).astype(np.int8)
    got = tq.matmul_unsigned_x_signed(torch.from_numpy(us), torch.from_numpy(sq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.matmul_unsigned_x_signed(jnp.asarray(us), jnp.asarray(sq))))
    np.testing.assert_array_equal(got.numpy(), (us.astype(np.int64) + 128) @ sq.astype(np.int64))


def _gcn_inputs(n=600, f=16, h=12, p=8, seed=11):
    rng = np.random.default_rng(seed)
    J, T = _graph(n, seed, hub=False)
    X = rng.uniform(0, 1, (n, f)).astype(np.float32)
    W1 = rng.uniform(-0.5, 0.5, (f, h)).astype(np.float32)
    W2 = rng.uniform(-0.5, 0.5, (h, p)).astype(np.float32)
    ov = dict(w_min=-0.5, w_max=0.5, w_min2=-0.5, w_max2=0.5, f_min=0.0, f_max=1.0,
              a_min=0.0, a_max=float(T.vals.max()))
    return J, T, X, W1, W2, JCal.for_qbits(8, ov), TCal.for_qbits(8, ov)


def _same_layer(lt, lj):
    for f in dataclasses.fields(lt):
        a, b = getattr(lt, f.name), getattr(lj, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name


def test_int8_gcn2_dense_and_sparse_twins():
    J, T, X, W1, W2, calj, calt = _gcn_inputs()
    n = T.n_rows
    amax = tq.collect_amax_gcn2_sparse(T, X, W1, W2)
    assert amax == jq.collect_amax_gcn2_sparse(J, X, W1, W2)
    dense = T.to_dense()
    assert tq.collect_amax_gcn2(dense, X, W1, W2) == jq.collect_amax_gcn2(dense, X, W1, W2)
    xs_j = jq.quantize_unsigned_shifted(jnp.asarray(X), calj.features)
    xs = tq.quantize_unsigned_shifted(torch.from_numpy(X), calt.features)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xs_j))

    nj = jq.freeze_gcn2(W1, W2, dense, calj, **amax)
    nt = tq.freeze_gcn2(W1, W2, dense, calt, device="cpu", **amax)
    _same_layer(nt.layer1, nj.layer1)
    _same_layer(nt.layer2, nj.layer2)
    np.testing.assert_array_equal(nt.a_s.numpy(), np.asarray(nj.a_s))
    _same_layer(int8_layer_from_jax(nj.layer2), nj.layer2)
    acc_t, sc_t = tq.int8_gcn_layer(nt.layer1, nt.a_s, xs)
    acc_j, sc_j = jq.int8_gcn_layer(nj.layer1, nj.a_s, xs_j)
    assert sc_t == sc_j
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    out_d = tq.int8_gcn2_forward(nt, xs)
    np.testing.assert_allclose(out_d.numpy(), np.asarray(jq.int8_gcn2_forward(nj, xs_j)), **FLOAT_TOL)

    sj = jq.freeze_gcn2_sparse(W1, W2, J, calj, tb=128, **amax)
    st = tq.freeze_gcn2_sparse(W1, W2, T, calt, tb=128, device="cpu", **amax)
    np.testing.assert_array_equal(st.a_bsr.tiles.numpy(), np.asarray(sj.a_bsr.tiles))
    acc_t, _ = tq.int8_gcn_layer_sparse(st.layer1, st.a_bsr, xs)
    acc_j, _ = jq.int8_gcn_layer_sparse(sj.layer1, sj.a_bsr, xs_j)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    out_s = tq.int8_gcn2_sparse_forward(st, xs)
    assert out_s.shape == (n, W2.shape[1])
    np.testing.assert_allclose(out_s.numpy(), np.asarray(jq.int8_gcn2_sparse_forward(sj, xs_j))[:n], **FLOAT_TOL)
    np.testing.assert_array_equal(out_s.numpy(), out_d.numpy())  # the same integers either way
    mat = T.to_scipy()
    ref = mat @ (np.maximum(mat @ (X @ W1), 0) @ W2)
    assert np.abs(out_s.numpy() - ref).max() / np.abs(ref).max() < 0.08


def test_int8_gat_layer_twins_and_flash():
    rng = np.random.default_rng(12)
    n, f, p = 900, 16, 8
    J, T = _graph(n, 12, hub=False)
    X = rng.uniform(0, 1, (n, f)).astype(np.float32)
    W = rng.uniform(-0.5, 0.5, (f, p)).astype(np.float32)
    att = rng.uniform(-0.5, 0.5, (2 * p, 1)).astype(np.float32)
    lj = jq.freeze_gat_layer(W, att, _uc(JConst, 1.0), _sc(JConst, 0.5), h_absmax=4.0)
    lt = tq.freeze_gat_layer(W, att, _uc(TConst, 1.0), _sc(TConst, 0.5), h_absmax=4.0, device="cpu")
    _same_layer(lt, lj)
    _same_layer(int8_layer_from_jax(lj), lj)
    xs_j = jq.quantize_unsigned_shifted(jnp.asarray(X), _uc(JConst, 1.0))
    xs = torch.from_numpy(np.array(xs_j))
    acc_j, sc_j = jq.int8_gat_layer(lj, jnp.asarray(J.rows), jnp.asarray(J.cols), jnp.asarray(J.vals) > 0, n, xs_j)
    Td = T.to("cpu")
    acc_t, sc_t = tq.int8_gat_layer(lt, Td.rows, Td.cols, Td.vals > 0, n, xs)
    assert sc_t == sc_j and acc_t.dtype == torch.int32
    # round(att * 255) sits on an exp whose last bit differs between the two
    # libraries: a tie may move one edge's weight by one grid step, |h_q| <= 127
    diff = np.abs(acc_t.numpy().astype(np.int64) - np.asarray(acc_j).astype(np.int64))
    assert diff.max() <= 127 and (diff > 0).mean() < 1e-3
    out_e = acc_t.numpy().astype(np.float64) * sc_t
    Bt = tbsr.bsr_mask_from_sparse(T, tb=128, device="cpu")
    acc_f, sc_f = tq.int8_gat_layer_flash(lt, Bt, xs)
    acc_fj, sc_fj = jq.int8_gat_layer_flash(lj, jbsr.bsr_mask_from_sparse(J, tb=128), xs_j)
    assert sc_f == sc_fj and acc_f.shape == (n, p)
    # plain K3 against the Pallas kernel: bf16 attention weights (1e-3 of |h_q| <= 127)
    np.testing.assert_allclose(acc_f.numpy(), np.asarray(acc_fj), rtol=1e-3, atol=0.2)
    out_f = acc_f.numpy().astype(np.float64) * sc_f
    assert np.abs(out_f - out_e).max() / np.abs(out_e).max() < 0.03


def test_entry_points_default_to_the_card():
    """With no CUDA device and no explicit device="cpu" the entry points
    raise; they never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, T = _graph(200, 13, hub=False)
    cal = TCal.for_qbits(8)
    data = pt.graph.datasets.sbm_node_classification(n=60, num_classes=2, seed=0)
    calls = [
        lambda: pt.prepare_adjacency(T),
        lambda: pt.prepare_from_config(T, pt.SGRACEConfig()),
        lambda: pt.train_node_classifier(pt.GCNModel(data.num_features, 4, 2), data, pt.SGRACEConfig(num_epochs=1)),
        lambda: tq.prepare_int8_hybrid(T, cal.adjacency),
        lambda: tq.bsr_int8_from_sparse(T, cal.adjacency),
        lambda: tq.dense_adjacency_int8(np.zeros((4, 4), np.float32), cal.adjacency),
        lambda: tq.freeze_gcn_layer(np.zeros((4, 4), np.float32), cal.features, cal.weights, cal.adjacency, h_absmax=1.0),
        lambda: tq.freeze_gat_layer(np.zeros((4, 4), np.float32), np.ones((8, 1), np.float32), cal.features, cal.weights, h_absmax=1.0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert pt.prepare_adjacency(T, method="xla", device="cpu").A.vals.device.type == "cpu"
