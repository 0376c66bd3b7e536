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
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.ops import fused_gnn as tgnn

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
    assert tdis.prepare_adjacency(T, device="cpu").kind == "dense"
    auto = tdis.prepare_adjacency(T, dense_max_bytes=0, build_transpose=False, device="cpu")
    assert auto.kind == "hybrid" and auto.bsr.tb == tdis.DEFAULT_TB
    with pytest.raises(ValueError):
        tdis.prepare_adjacency(T, method="pallas", device="cpu")


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
