"""sgracex1_tpu_torch.ops.dispatch / spmm / fused_gnn against the JAX
package: agg_matmul for every ported kind on the same graph and H."""

import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import dispatch as jdis
from sgracex1_tpu.ops import fused_gnn as jgnn
from sgracex1_tpu.quant import affine as ja
from sgracex1_tpu.quant.calibration import CalibrationTable as JCal
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.ops import fused_gnn as tgnn
from sgracex1_tpu_torch.quant import affine as ta
from sgracex1_tpu_torch.quant.calibration import CalibrationTable as TCal

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

# the ops packages export functions named like these modules
jspmm = importlib.import_module("sgracex1_tpu.ops.spmm")
tspmm = importlib.import_module("sgracex1_tpu_torch.ops.spmm")


def _graph(kind, n=2048):
    rng = np.random.default_rng(11)
    if kind == "symnorm":  # rank-1: mask tiles + scalings
        # a hub block gives the hybrid split both tiles and a remainder
        hub = np.stack([rng.integers(0, 128, 6000), rng.integers(0, n, 6000)])
        ei = np.concatenate([rng.integers(0, n, (2, 3 * n)), hub, hub[::-1]], axis=1)
        T = sym_norm(np.unique(ei, axis=1), n)
    else:  # weighted: value tiles
        ei = np.unique(rng.integers(0, n, (2, 8 * n)), axis=1)
        v = rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32)
        T = TSparse.from_coo(ei[0], ei[1], v, (n, n))
    J = JSparse.from_coo(T.rows[: T.nnz], T.cols[: T.nnz], T.vals[: T.nnz], T.shape)
    return J, T


def _jax_thresh(tb, rank1):
    """The remainder threshold JAX's hybrid prepare derives at this tb."""
    item = jdis._tile_itemsize(tb, rank1, 2)
    per_edge = jdis._REST_SLOT_S + jdis._REST_CHUNK_S / jdis._REST_K
    return int(np.ceil(jdis._tile_cost_s(tb, item) / per_edge))


@pytest.mark.parametrize(
    "method,fuse,graph",
    [
        ("dense", True, "symnorm"),
        ("xla", True, "weighted"),
        ("bsr", True, "symnorm"),
        ("bsr", False, "symnorm"),
        ("bsr", True, "weighted"),
        ("hybrid", True, "symnorm"),
        ("hybrid", False, "symnorm"),
        ("hybrid", True, "weighted"),
        ("hybrid", False, "weighted"),
    ],
)
def test_agg_matmul_matches_jax(method, fuse, graph):
    J, T = _graph(graph)
    tb = 128
    jp = jdis.prepare_adjacency(J, method=method, tb=tb, fuse=fuse, build_transpose=False)
    thresh = _jax_thresh(tb, jp.r1_row is not None) if method == "hybrid" else None
    tp = tdis.prepare_adjacency(
        T, method=method, tb=tb, rest_thresh=thresh, fuse=fuse, build_transpose=False, device="cpu"
    )
    assert tp.kind == jp.kind == method
    if method in ("bsr", "hybrid"):
        assert (tp.r1_row is None) == (jp.r1_row is None) == (graph == "weighted")
        assert tp.bsr.num_tiles == jp.bsr.num_tiles
        assert (tp.fused is None) == (not fuse)
    if method == "hybrid":
        assert tp.rest.nnz == jp.rest.nnz > 0
    H = np.random.default_rng(12).standard_normal((T.n_cols, 40)).astype(np.float32)
    out_j = np.asarray(jdis.agg_matmul(jp, jnp.asarray(H)))
    out_t = tdis.agg_matmul(tp, torch.from_numpy(H))
    assert out_t.dtype == torch.float32 and out_t.shape == (T.n_rows, 40)
    # fused preps round the output through bf16; the others sum in f32
    tol = 2e-2 if fuse and method in ("bsr", "hybrid") else 1e-3
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=tol, atol=tol)
    np.testing.assert_allclose(out_t.numpy(), T.to_scipy() @ H, rtol=5e-2, atol=5e-2)


def test_transposed_plans_and_auto():
    J, T = _graph("symnorm", n=1024)
    tp = tdis.prepare_adjacency(T, method="hybrid", tb=128, device="cpu")
    assert tp.bsr_t is not None and tp.fused_t is not None
    assert tp.fused_t.B.n_rows == T.n_cols
    Hg = torch.randn(T.n_rows, 8, generator=torch.Generator().manual_seed(1))
    out = tdis.bsr_spmm_fused(tp.fused_t, Hg).float().numpy()
    np.testing.assert_allclose(out, T.to_scipy().T @ Hg.numpy(), rtol=5e-2, atol=5e-2)
    # auto takes the cheapest kind the cost model prices, at its tile size
    # or split; dense only within the budget
    for budget in (tdis.DENSE_MAX_BYTES, 0):
        auto = tdis.prepare_adjacency(T, dense_max_bytes=budget, build_transpose=False, device="cpu")
        est = auto.choice["costs"]
        assert ("dense" in est) == (budget > 0) and auto.kind == min(est, key=est.get)
        if auto.kind in ("bsr", "hybrid"):
            _, best_tb, best_hy = tdis._estimate_backend_costs(T, rank1=True)
            assert auto.bsr.tb == (best_tb if auto.kind == "bsr" else best_hy[0])
    # the pallas kind on request, at the JAX tiling
    pp = tdis.prepare_adjacency(T, method="pallas", device="cpu")
    assert pp.kind == "pallas" and pp.plan is not None and pp.plan_t is not None
    assert (pp.plan.rb, pp.plan.cb, pp.plan.be) == (1024, 1024, 1024)  # the JAX defaults
    assert pp.bsr is None and pp.fused is None and pp.dense is None
    with pytest.raises(ValueError, match="unknown method"):
        tdis.prepare_adjacency(T, method="mosaic", device="cpu")


def test_agg_matmul_is_inference_only():
    """No longer inference only: grad_H = A^T @ g on the edge list."""
    _, T = _graph("weighted", n=256)
    tp = tdis.prepare_adjacency(T, method="xla", device="cpu")
    H = torch.randn(256, 4, requires_grad=True)
    g = torch.randn(256, 4)
    (tdis.agg_matmul(tp, H) * g).sum().backward()
    np.testing.assert_allclose(H.grad.numpy(), T.to_scipy().T @ g.numpy(), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert tdis.agg_matmul(tp, H).shape == (256, 4)


def test_spmm_family_matches_jax():
    J, T = _graph("weighted", n=512)
    H = np.random.default_rng(13).standard_normal((512, 24)).astype(np.float32)
    Ht = torch.from_numpy(H)
    np.testing.assert_allclose(
        tspmm.spmm(T, Ht).numpy(), np.asarray(jspmm.spmm(J, jnp.asarray(H))), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        tspmm.spmm_t(T.to("cpu"), Ht).numpy(), np.asarray(jspmm.spmm_t(J, jnp.asarray(H))),
        rtol=1e-5, atol=1e-5,
    )
    base = np.ones((512, 24), np.float32)
    out = torch.from_numpy(base.copy())
    res = tspmm.spmm_into(T, Ht, out)
    assert res is out  # f32 accumulator: updated in place
    np.testing.assert_allclose(
        res.numpy(), np.asarray(jspmm.spmm_into(J, jnp.asarray(H), jnp.asarray(base))),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("sparse_x,relu", [(False, True), (True, False)])
def test_gnn_layer_matches_jax(sparse_x, relu):
    J, T = _graph("weighted", n=512)
    rng = np.random.default_rng(14)
    X = (rng.random((512, 32)) * (rng.random((512, 32)) < 0.2)).astype(np.float32)
    W = rng.standard_normal((32, 16)).astype(np.float32)
    if sparse_x:
        xj, xt = JSparse.from_dense(X), TSparse.from_dense(X)
    else:
        xj, xt = jnp.asarray(X), torch.from_numpy(X)
    out_j = np.asarray(jgnn.gnn_layer(J, xj, jnp.asarray(W), relu=relu))
    out_t = tgnn.gnn_layer(T, xt, torch.from_numpy(W), relu=relu).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=1e-4)
    if relu:
        assert (out_t >= 0).all()


PLAN = 1e-4  # the pallas kind: the same bf16 roundings in both, f32 sums in another order


def _same_plan(tp, jp):
    for name in ("lrow", "lcol", "val", "perm"):
        np.testing.assert_array_equal(
            getattr(tp, name).numpy(), np.asarray(getattr(jp, name)).reshape(-1, jp.be), err_msg=name)
    for name in ("tile_rb", "tile_cb"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)


@pytest.mark.parametrize("graph", ["symnorm", "weighted"])
@pytest.mark.parametrize("rb,cb,be", [(1024, 1024, 1024), (128, 256, 2048)])
def test_agg_matmul_pallas_matches_jax(graph, rb, cb, be):
    J, T = _graph(graph, n=1500)
    jp = jdis.prepare_adjacency(J, method="pallas", rb=rb, cb=cb, be=be)
    tp = tdis.prepare_adjacency(T, method="pallas", rb=rb, cb=cb, be=be, device="cpu")
    assert tp.kind == jp.kind == "pallas"
    _same_plan(tp.plan, jp.plan)
    _same_plan(tp.plan_t, jp.plan_t)
    # the kind builds plan_t whatever the flag, as the JAX package
    jserve = jdis.prepare_adjacency(J, method="pallas", rb=rb, cb=cb, be=be, build_transpose=False)
    serve = tdis.prepare_adjacency(T, method="pallas", rb=rb, cb=cb, be=be, build_transpose=False, device="cpu")
    _same_plan(serve.plan_t, jserve.plan_t)
    H = np.random.default_rng(15).standard_normal((T.n_cols, 40)).astype(np.float32)
    out_j = np.asarray(jdis.agg_matmul(jp, jnp.asarray(H)))
    out_t = tdis.agg_matmul(tp, torch.from_numpy(H))
    assert out_t.dtype == torch.float32 and out_t.shape == (T.n_rows, 40)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=PLAN, atol=PLAN)
    np.testing.assert_allclose(out_t.numpy(), T.to_scipy() @ H, rtol=5e-2, atol=5e-2)
    # in H's dtype, as every kind
    assert tdis.agg_matmul(tp, torch.from_numpy(H).to(torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["pallas", "hybrid", "xla"])
def test_agg_matmul_with_vals_matches_jax(kind):
    """Runtime edge values in the source edge order: K9's plan takes them by
    a gather, every other kind runs the edge path."""
    J, T = _graph("weighted", n=1024)
    kw = dict(tb=128) if kind == "hybrid" else {}
    jp = jdis.prepare_adjacency(J, method=kind, **kw)
    tp = tdis.prepare_adjacency(T, method=kind, device="cpu", **kw)
    rng = np.random.default_rng(16)
    vals = (rng.uniform(0.1, 1.0, T.vals.shape[0]) * (T.vals != 0)).astype(np.float32)
    H = rng.standard_normal((T.n_cols, 24)).astype(np.float32)
    out_j = np.asarray(jdis.agg_matmul_with_vals(jp, jnp.asarray(vals), jnp.asarray(H)))
    out_t = tdis.agg_matmul_with_vals(tp, torch.from_numpy(vals), torch.from_numpy(H))
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=PLAN, atol=PLAN)
    want = T.with_vals(vals).to_scipy() @ H
    np.testing.assert_allclose(out_t.numpy(), want, rtol=5e-2 if kind == "pallas" else 1e-4, atol=5e-2 if kind == "pallas" else 1e-4)


@pytest.mark.parametrize("qbits", [8, 2])
def test_map_adjacency_vals_on_pallas_prep(qbits):
    J, T = _graph("weighted", n=1024)
    ov = dict(a_max=float(np.max(T.vals)))
    calj, calt = JCal.for_qbits(qbits, ov), TCal.for_qbits(qbits, ov)
    jp = jdis.prepare_adjacency(J, method="pallas", rb=256, cb=256)
    tp = tdis.prepare_adjacency(T, method="pallas", rb=256, cb=256, device="cpu")
    mj = jdis.map_adjacency_vals(jp, lambda v: ja.fake_quant_unsigned(v, calj.adjacency, qbits))
    mt = tdis.map_adjacency_vals(tp, lambda v: ta.fake_quant_unsigned(v, calt.adjacency, qbits))
    assert mt.kind == mj.kind == "pallas"
    _same_plan(mt.plan, mj.plan)
    _same_plan(mt.plan_t, mj.plan_t)
    assert not torch.equal(mt.plan.val, tp.plan.val)  # the quantizer acted
    assert mt.plan.segments is tp.plan.segments  # the launch schedule is the plan's, not the values'
    np.testing.assert_array_equal(mt.A.vals.numpy(), np.asarray(mj.A.vals))
    H = np.random.default_rng(17).standard_normal((T.n_cols, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tdis.agg_matmul(mt, torch.from_numpy(H)).numpy(), np.asarray(jdis.agg_matmul(mj, jnp.asarray(H))),
        rtol=PLAN, atol=PLAN)
