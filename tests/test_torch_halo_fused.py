"""The port's distributed fused aggregation (sgracex1_tpu_torch.parallel.
halo_fused, K2 per shard) against sgracex1_tpu.parallel.halo_fused on the
same numpy inputs, the JAX side on the conftest's virtual CPU mesh with its
Pallas kernels in interpret mode, at the JAX plan's tile size, the split
threshold of both packages' cost model (the port's on a table of the JAX
constants, ``jax_cost_table``) and the port's chunk width K = 128, forced
on the JAX side (the port's is a fixed value).

Tolerances: host arrays ``array_equal``; outputs and gradients 2e-2 (both
kernels write bf16, as tests/test_halo_fused.py holds them)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sgracex1_tpu.graph.normalize import rank1_factor as j_rank1
from sgracex1_tpu.parallel import halo as jh
from sgracex1_tpu.parallel import halo_fused as jhf
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.graph.normalize import rank1_factor
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.parallel import halo as th
from sgracex1_tpu_torch.parallel import halo_fused as thf
from sgracex1_tpu_torch.parallel.mesh import make_mesh
from sgracex1_tpu_torch.parallel.partition import pad_nodes
from tests._torch_common import dist_graph, grads_of, jax_cost_table, jax_mesh_put, leaf, to_jax

torch.set_num_threads(1)

BF16 = 2e-2
K = 128
JT = jax_cost_table()  # the JAX constants: the JAX threshold at each tb
STEP_FIELDS = ("step_cb", "step_tile", "step_chunk", "step_kind")


def _plans(monkeypatch, J, T, JG, TG, tb, rank1):
    """Both packages' plans at the JAX tile size, K and threshold."""
    fac = j_rank1(J) if rank1 else None
    JP = jhf.build_halo_fused(JG, tb=tb, K=K, rank1_factors=fac)
    TP = thf.build_halo_fused(TG, tb=tb, rank1_factors=rank1_factor(T) if rank1 else None, costs=JT)

    return JP, TP


def _check_identical(JP, TP):
    """Each shard's plan pair equals the JAX stack's rows for that shard
    (its padding steps, tiles and chunks aside)."""
    assert TP.rank1 == (JP.colscale is not None) and (TP.tb, TP.K) == (JP.tb, JP.K)
    for sfx, field in (("", "fused"), ("_t", "fused_t")):
        plans = [getattr(prep, field) for prep in TP.preps]
        g = lambda name: np.asarray(getattr(JP, name + sfx))
        for s, p in enumerate(plans):
            S, T, R = p.num_steps, p.B.num_tiles, p.num_chunks
            np.testing.assert_array_equal(p.B.tiles.float().numpy(), g("tiles")[s, :T].astype(np.float32))
            np.testing.assert_array_equal(p.step_rb.numpy()[:S], g("step_rb")[s, :S])
            np.testing.assert_array_equal(p.step_rb.numpy()[S], g("step_rb")[s, -1])
            for f in STEP_FIELDS:
                np.testing.assert_array_equal(getattr(p, f).numpy(), g(f)[s, :S], err_msg=f)
            assert (g("step_kind")[s, S:] == 0).all()
            np.testing.assert_array_equal(p.lrow.numpy(), g("lrow")[s, :R, 0, :])
            np.testing.assert_array_equal(p.slot_col.numpy(), g("slot_col")[s, : R * K])
            np.testing.assert_array_equal(p.slot_scale.numpy(), g("slot_scale")[s, : R * K])
            if TP.rank1:
                for f in ("colscale", "rowscale"):  # JAX: [n_blocks, 8, tb], row 0 read
                    np.testing.assert_array_equal(getattr(p, f).numpy(), g(f)[s][:, 0, :].reshape(-1))


@pytest.mark.parametrize("S,tb,weighted", [(2, 64, False), (4, 64, False), (8, 64, False), (4, 64, True),
                                           (2, 1024, False)])
def test_build_halo_fused_identical(monkeypatch, S, tb, weighted):
    n = 4096 if tb == 1024 else 384
    J, T, JG, TG = dist_graph(n, 70 + S, S, weighted=weighted)
    JP, TP = _plans(monkeypatch, J, T, JG, TG, tb, not weighted)
    _check_identical(JP, TP)
    assert TP.preps[0].fused.B.packed == (tb == 1024)


def test_build_halo_fused_mixed_rank1_degrades_uniformly(monkeypatch):
    """Per-shard detection: one shard without a factorization turns every
    shard to value tiles, as in the JAX package."""
    rng = np.random.default_rng(0)
    n, half, m = 192, 96, 400
    r0, c0 = rng.integers(0, half, m), rng.integers(0, half, m)
    v0 = rng.uniform(0.5, 2.0, m).astype(np.float32)
    r1, c1 = rng.integers(half, n, m), rng.integers(half, n, m)
    k0 = np.unique(r0.astype(np.int64) * n + c0)
    k1 = np.unique(r1.astype(np.int64) * n + c1)
    T = TSparse.from_coo(np.concatenate([k0 // n, k1 // n]), np.concatenate([k0 % n, k1 % n]),
                         np.concatenate([v0[: len(k0)], np.full(len(k1), 0.7, np.float32)]), (n, n))
    JG, TG = jh.build_halo(to_jax(T), 2)[0], th.build_halo(T, 2, device="cpu")[0]
    JP = jhf.build_halo_fused(JG, tb=64, K=K)
    TP = thf.build_halo_fused(TG, tb=64, costs=JT)
    assert not TP.rank1 and JP.colscale is None
    _check_identical(JP, TP)
    H = rng.standard_normal((n, 12)).astype(np.float32)
    out = thf.dist_spmm_halo_fused(make_mesh(2, device="cpu"), TG, TP, torch.from_numpy(H))
    np.testing.assert_allclose(out.numpy(), T.to_scipy() @ H, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("S,weighted", [(2, False), (4, False), (8, False), (4, True)])
def test_dist_spmm_halo_fused(monkeypatch, S, weighted):
    J, T, JG, TG = dist_graph(384, 80 + S, S, weighted=weighted)
    JP, TP = _plans(monkeypatch, J, T, JG, TG, 64, not weighted)
    H = np.random.default_rng(S).standard_normal((TG.n_pad, 12)).astype(np.float32)
    jm, JGd, Hd = jax_mesh_put(S, JG, H)
    want = np.asarray(jax.jit(lambda h: jhf.dist_spmm_halo_fused(jm, JGd, JP, h))(Hd))
    got = thf.dist_spmm_halo_fused(make_mesh(S, device="cpu"), TG, TP, torch.from_numpy(H))
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16, atol=BF16)


@pytest.mark.parametrize("S", [2, 4])
def test_dist_gnn_layer_halo_fused_grads(monkeypatch, S):
    """Gradients of x and W (K2 on each shard's transposed plan, the
    all_to_all transposed)."""
    J, T, JG, TG = dist_graph(192, 90 + S, S)
    JP, TP = _plans(monkeypatch, J, T, JG, TG, 64, True)
    rng = np.random.default_rng(6)
    X = pad_nodes(rng.standard_normal((192, 8)).astype(np.float32), TG.n_pad)
    W = (rng.standard_normal((8, 6)) * 0.3).astype(np.float32)
    jm, JGd, Xd = jax_mesh_put(S, JG, X)
    loss = lambda x, w: jnp.sum(jhf.dist_gnn_layer_halo_fused(jm, JGd, JP, x, w, relu=True) ** 2)
    jl, jg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(Xd, jnp.asarray(W))
    x, w = leaf(X), leaf(W)
    tl = torch.sum(thf.dist_gnn_layer_halo_fused(make_mesh(S, device="cpu"), TG, TP, x, w, relu=True) ** 2)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=BF16)
    for a, b in zip(grads_of(tl, x, w), jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=BF16, atol=BF16 * np.abs(b).max())


def test_prepare_adjacency_rank1_factors(monkeypatch):
    """A caller-given factorization skips the detection and prepares the
    mask tiles and scalings the detected one gives."""
    J, T, _, _ = dist_graph(384, 3, 2)
    fac = rank1_factor(T)
    calls = []
    monkeypatch.setattr(tdis, "rank1_factor", lambda A: calls.append(A) or fac)
    got = tdis.prepare_adjacency(T, method="hybrid", tb=64, rank1_factors=fac, device="cpu")
    assert not calls
    want = tdis.prepare_adjacency(T, method="hybrid", tb=64, device="cpu")
    assert len(calls) == 1
    for f in ("r1_row", "r1_col"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=0)
    torch.testing.assert_close(got.bsr.tiles, want.bsr.tiles, rtol=0, atol=0)
    assert got.bsr.tiles.dtype == torch.int8
    # the factors override rank1=False, as in the JAX package
    assert tdis.prepare_adjacency(T, method="bsr", tb=64, rank1=False, rank1_factors=fac,
                                  device="cpu").r1_row is not None
