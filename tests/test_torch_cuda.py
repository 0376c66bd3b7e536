"""The CUDA kernels against their plain PyTorch versions on the card.

Imports only torch and the port (no jax), so it runs on a GPU machine
without the JAX package: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Without a card the cuda tests skip; the wrapper contract tests run
anywhere."""

import numpy as np
import pytest
import torch

import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.ops import bsr as K1
from sgracex1_tpu_torch.ops import fused_agg as K2
from sgracex1_tpu_torch.ops import flash_gat as FG
from sgracex1_tpu_torch.ops import pallas_spmm as K9
from sgracex1_tpu_torch.ops.dispatch import split_by_tile_density
from sgracex1_tpu_torch.quant import int8 as Q
from sgracex1_tpu_torch.quant.affine import generate_constants

from _k9_walk import gather_walk

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _graph(n, weighted, seed=0):
    """Random edges plus hub rows/cols: dense tiles and a remainder."""
    rng = np.random.default_rng(seed)
    hub = np.stack([rng.integers(0, 150, 15 * n), rng.integers(0, n, 15 * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 4 * n)), hub, hub[::-1]], axis=1), axis=1)
    if not weighted:
        return pt.sym_norm(ei, n)
    v = rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32)
    return SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "form,tb,P,hdtype",
    [("values", 128, 100, torch.float32), ("int8", 256, 128, torch.bfloat16),
     ("packed", 1024, 72, torch.float32), ("f32", 128, 40, torch.float32)],
)
def test_bsr_spmm_kernel_matches_plain(cuda_device, form, tb, P, hdtype):
    A = _graph(3001, weighted=form in ("values", "f32"))
    if form == "packed":
        B = K1.bsr_bitmask_from_sparse(A, tb=tb, cover_rows=True, device=cuda_device)
    else:
        B = K1.bsr_from_sparse(
            A, tb=tb, cover_rows=True, mask=form == "int8",
            dtype=torch.float32 if form == "f32" else torch.bfloat16, device=cuda_device,
        )
    H = torch.randn(A.n_cols, P, device=cuda_device).to(hdtype)
    before = K1.bsr_spmm.launches
    out = K1.bsr_spmm(B, H)
    torch.cuda.synchronize()
    assert K1.bsr_spmm.launches == before + 1
    torch.testing.assert_close(out, K1.bsr_spmm_plain(B, H), rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "weighted,tb,attach,P",
    [(False, 128, True, 100), (False, 256, False, 128), (True, 128, True, 64), (True, 256, False, 200)],
)
def test_fused_kernel_matches_plain(cuda_device, weighted, tb, attach, P):
    A = _graph(2600, weighted, seed=1)
    fac = pt.graph.normalize.rank1_factor(A) if not weighted else None
    part, rest = split_by_tile_density(A, tb, 40)
    r1 = {}
    if fac is not None:
        rest = pt.ops.dispatch._drop_zero_val_edges(rest)
        r1 = dict(r1_row=fac[0], r1_col=fac[1])
        B = K1.bsr_mask_from_sparse(part, tb=tb, cover_rows=True, cover_cols=True, device=cuda_device)
    else:
        B = K1.bsr_from_sparse(part, tb=tb, cover_rows=True, cover_cols=True, device=cuda_device)
    plan = K2.build_fused_plan(B, rest, attach_chunks=attach, **r1)
    assert plan.num_rest_chunks > 0
    H = torch.randn(A.n_cols, P, device=cuda_device)
    out = K2.bsr_spmm_fused(plan, H)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out.float(), K2.bsr_spmm_fused_plain(plan, H).float(), rtol=2e-2, atol=2e-2
    )


@pytest.mark.cuda
def test_gcn_forward_through_kernels(cuda_device):
    A = _graph(3001, weighted=False, seed=2)
    net = pt.GCNModel(32, 64, 7, generator=torch.Generator().manual_seed(0)).to(cuda_device).eval()
    x = torch.randn(3001, 32, device=cuda_device)
    prep = pt.prepare_adjacency(A, method="hybrid", tb=128, rest_thresh=40,
                                build_transpose=False, device=cuda_device)
    with torch.no_grad():
        before = K2.bsr_spmm_fused.launches
        out = net(prep, x)
        assert K2.bsr_spmm_fused.launches == before + 2
        ref = net(pt.prepare_adjacency(A, method="xla", device=cuda_device), x)
    torch.testing.assert_close(out, ref, rtol=5e-2, atol=5e-2)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_operands(cuda_device):
    A = _graph(600, weighted=True, seed=3)
    B = K1.bsr_from_sparse(A, tb=128, cover_rows=True)  # tiles stay on the CPU
    with pytest.raises(ValueError, match="on cpu"):
        K1.bsr_spmm(B, torch.randn(600, 8, device=cuda_device))
    B = K1.bsr_from_sparse(A, tb=80, cover_rows=True, device=cuda_device)
    with pytest.raises(ValueError, match="tb % 32"):
        K1.bsr_spmm(B, torch.randn(600, 8, device=cuda_device))


def _scores(n, H, F, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    s1 = torch.randn(n, H, generator=g, device=device) * 2
    s2 = torch.randn(n, H, generator=g, device=device) * 2
    return s1, s2, torch.randn(n, H, F, generator=g, device=device)


def _check_flash(res, ref):
    """out within 2e-2 (bf16(p) rounds against each segment's running
    max); m exact (the same f32 ops); l within 1e-3 (fast exp)."""
    torch.cuda.synchronize()
    (out, m, l), (out_r, m_r, l_r) = res, ref
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, out_r, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(m, m_r, rtol=0, atol=0)
    torch.testing.assert_close(l, l_r, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "form,tb,n,H,F",
    [("int8", 128, 3001, 4, 64), ("int8", 256, 3001, 1, 40), ("packed", 1024, 5000, 2, 16),
     ("values", 256, 2100, 4, 8), ("int8", 128, 3001, 2, 100), ("int8", 256, 3001, 3, 20)],
)
def test_flash_kernel_matches_plain(cuda_device, form, tb, n, H, F):
    A = _graph(n, weighted=form == "values", seed=5)
    if form == "packed":
        B = K1.bsr_bitmask_from_sparse(A, tb=tb, device=cuda_device)
    else:
        B = K1.bsr_from_sparse(A, tb=tb, mask=form == "int8", device=cuda_device)
    if tb == 128:
        assert B.segments.n_fin > 0  # the hub row blocks' runs split
    s1, s2, Wh = _scores(n, H, F, cuda_device)
    before = FG.flash_gat_forward.launches
    res = FG.flash_gat_forward(B, s1, s2, Wh, return_stats=True)
    assert FG.flash_gat_forward.launches == before + 1
    _check_flash(res, FG.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=True))
    out = FG.flash_gat_forward(B, s1, s2, Wh.to(torch.bfloat16))  # bf16 Wh, no stats
    torch.testing.assert_close(out, res[0], rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("attach,H", [(True, 4), (False, 4), (True, 1)])
def test_flash_hybrid_kernel_matches_plain(cuda_device, attach, H):
    A = _graph(3001, weighted=False, seed=6)
    part, rest = split_by_tile_density(A, 128, 40)
    rest = pt.ops.dispatch._drop_zero_val_edges(rest)
    B = K1.bsr_mask_from_sparse(part, tb=128, cover_rows=True, cover_cols=True, device=cuda_device)
    plan = K2.build_fused_plan(B, rest, attach_chunks=attach)
    assert plan.num_rest_chunks > 0 and plan.segments.n_fin > 0
    s1, s2, Wh = _scores(3001, H, 64, cuda_device, seed=1)
    before = FG.flash_gat_hybrid_forward.launches
    res = FG.flash_gat_hybrid_forward(plan, s1, s2, Wh, return_stats=True)
    assert FG.flash_gat_hybrid_forward.launches == before + 1
    _check_flash(res, FG.flash_gat_hybrid_forward_plain(plan, s1, s2, Wh, return_stats=True))


@pytest.mark.cuda
def test_gat_forward_through_kernels(cuda_device):
    A = _graph(3001, weighted=False, seed=7)
    net = pt.GATModel(32, 16, 7, nheads=4, generator=torch.Generator().manual_seed(0)).to(cuda_device).eval()
    x = torch.randn(3001, 32, device=cuda_device)
    with torch.no_grad():
        ref = net(pt.prepare_adjacency(A, method="xla", device=cuda_device), x)
        for kw, kern in ((dict(), FG.flash_gat_forward),
                         (dict(gat_tb=128, gat_rest_thresh=40), FG.flash_gat_hybrid_forward)):
            prep = pt.prepare_adjacency(A, method="xla", for_gat=True, device=cuda_device, **kw)
            before = kern.launches
            out = net(prep, x)
            assert kern.launches == before + 2
            torch.testing.assert_close(out, ref, rtol=5e-2, atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "form,tb,n,H,F",
    [("int8", 128, 3001, 4, 64), ("packed", 1024, 5000, 2, 16), ("values", 256, 2100, 1, 40),
     ("int8", 128, 3001, 2, 100), ("int8", 256, 3001, 3, 20)],
)
def test_flash_bwd_kernels_match_plain(cuda_device, form, tb, n, H, F):
    """K4 and K5 against their plain versions at 2e-2: bf16 q and dWh
    operands are identical, p differs in the fast exp and so may round to
    the neighbouring bf16 value."""
    A = _graph(n, weighted=form == "values", seed=8)
    if form == "packed":
        B = K1.bsr_bitmask_from_sparse(A, tb=tb, device=cuda_device)
    else:
        B = K1.bsr_from_sparse(A, tb=tb, mask=form == "int8", device=cuda_device)
    if tb == 128:
        assert B.segments.n_fin > 0 and B.col_segments.n_fin > 0  # hub runs split
    s1, s2, Wh = _scores(n, H, F, cuda_device, seed=2)
    gO = _scores(n, H, F, cuda_device, seed=3)[2]
    _, m, l = FG.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=True)
    before = (FG.flash_gat_bwd_row.launches, FG.flash_gat_bwd_col.launches)
    got = FG.flash_gat_bwd_row(B, s1, s2, m, l, Wh, gO)
    ref = FG.flash_gat_bwd_row_plain(B, s1, s2, m, l, Wh, gO)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, r, rtol=2e-2, atol=2e-2)
    got = FG.flash_gat_bwd_col(B, s1, s2, m, l, ref[0], Wh, gO)
    ref = FG.flash_gat_bwd_col_plain(B, s1, s2, m, l, ref[0], Wh, gO)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-2, atol=2e-2)
    assert (FG.flash_gat_bwd_row.launches, FG.flash_gat_bwd_col.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted,fuse", [(False, True), (True, True), (False, False), (True, False)])
def test_transposed_plans_match_plain(cuda_device, weighted, fuse):
    """The backward's kernels: K2 on fused_t and K1 on bsr_t."""
    A = _graph(2600, weighted, seed=9)
    prep = pt.prepare_adjacency(A, method="hybrid", tb=128, rest_thresh=40, fuse=fuse, device=cuda_device)
    g = torch.randn(A.n_rows, 64, device=cuda_device)
    if fuse:
        gb = g.to(torch.bfloat16)  # the cotangent of K2's bf16 output
        torch.testing.assert_close(K2.bsr_spmm_fused(prep.fused_t, gb).float(),
                                   K2.bsr_spmm_fused_plain(prep.fused_t, gb).float(), rtol=2e-2, atol=2e-2)
    else:
        torch.testing.assert_close(K1.bsr_spmm(prep.bsr_t, g), K1.bsr_spmm_plain(prep.bsr_t, g),
                                   rtol=1e-3, atol=1e-3)


def _grads(net, prep, x):
    net.zero_grad(set_to_none=True)
    net(prep, x).square().mean().backward()
    return {k: p.grad.clone() for k, p in net.named_parameters()}


@pytest.mark.cuda
def test_model_grads_through_kernels(cuda_device):
    """One GCN step through K2 (forward plan and fused_t) and one GAT step
    each through K3/K6 with K4/K5, against autograd on the f32 edge path."""
    A = _graph(3001, weighted=False, seed=10)
    x = torch.randn(3001, 32, device=cuda_device)
    edge = pt.prepare_adjacency(A, method="xla", device=cuda_device)
    gcn = pt.GCNModel(32, 64, 7, dropout=0.0, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    prep = pt.prepare_adjacency(A, method="hybrid", tb=128, rest_thresh=40, device=cuda_device)
    before = K2.bsr_spmm_fused.launches
    got = _grads(gcn, prep, x)
    assert K2.bsr_spmm_fused.launches == before + 4
    runs = [(gcn, got, _grads(gcn, edge, x))]
    gat = pt.GATModel(32, 16, 7, nheads=4, dropout=0.0, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    ref = _grads(gat, edge, x)
    for kw, fwd in ((dict(), FG.flash_gat_forward),
                    (dict(gat_tb=128, gat_rest_thresh=40), FG.flash_gat_hybrid_forward)):
        prep = pt.prepare_adjacency(A, method="xla", for_gat=True, device=cuda_device, **kw)
        kernels = (fwd, FG.flash_gat_bwd_row, FG.flash_gat_bwd_col)
        before = [k.launches for k in kernels]
        runs.append((gat, _grads(gat, prep, x), ref))
        assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2, 2]
    for net, got, ref in runs:
        for k, r in ref.items():
            scale = float(r.abs().max())
            torch.testing.assert_close(got[k], r, rtol=5e-2, atol=5e-2 * scale, msg=lambda m: f"{k}: {m}")


def _int8_graph(n, seed, empty_rb=None, tb=128):
    rng = np.random.default_rng(seed)
    hub = np.stack([rng.integers(0, 150, 12 * n), rng.integers(0, n, 12 * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 4 * n)), hub, hub[::-1]], axis=1), axis=1)
    if empty_rb is not None:
        ei = ei[:, ei[0] // tb != empty_rb]
    v = rng.uniform(0.01, 1.0, ei.shape[1]).astype(np.float32)
    return SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n,tb,P,empty_rb", [(3001, 128, 8, 2), (3001, 256, 16, None), (2600, 128, 100, 5),
                                             (4100, 256, 128, 1)])
def test_bsr_spmm_int8_kernel_equals_plain(cuda_device, n, tb, P, empty_rb):
    """K7 is an exact integer product: equal to its plain version, bit for bit."""
    A = _int8_graph(n, 11, empty_rb, tb)
    c_a = generate_constants(0.0, 1.0, 8, signed=False, w_qbits=8)
    B = Q.bsr_int8_from_sparse(A, c_a, tb=tb, device=cuda_device)
    Hq = torch.randint(-127, 128, (n, P), dtype=torch.int8, device=cuda_device)
    before = K1.bsr_spmm_int8.launches
    out = K1.bsr_spmm_int8(B, Hq)
    torch.cuda.synchronize()
    assert K1.bsr_spmm_int8.launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (B.n_row_tiles * tb, P)
    assert torch.equal(out, K1.bsr_spmm_int8_plain(B, Hq))
    assert torch.equal(out.cpu(), K1.bsr_spmm_int8_plain(B.to("cpu"), Hq.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("tb,attach,P", [(128, True, 8), (128, False, 100), (256, True, 128), (256, False, 16)])
def test_fused_int8_kernel_equals_plain(cuda_device, tb, attach, P):
    """K8 equal to its plain version: tile steps, chunk steps with dead
    slots, both attach modes."""
    A = _int8_graph(3001, 12)
    c_a = generate_constants(0.0, 1.0, 8, signed=False, w_qbits=8)
    part, rest = split_by_tile_density(A, tb, 40 * (tb // 128) ** 2)
    B8 = Q.bsr_int8_from_sparse(part, c_a, tb=tb, cover_cols=True, device=cuda_device)
    plan = K2.build_fused_plan(B8, rest.with_vals(Q._quantize_vals(rest.vals, c_a)), attach_chunks=attach)
    assert plan.num_rest_chunks > 0 and (plan.lrow == tb).any()
    Hq = torch.randint(-127, 128, (3001, P), dtype=torch.int8, device=cuda_device)
    before = K2.bsr_spmm_int8_fused.launches
    out = Q.int8_hybrid_agg(plan, Hq)
    torch.cuda.synchronize()
    assert K2.bsr_spmm_int8_fused.launches == before + 1
    assert out.dtype == torch.int32 and torch.equal(out, K2.bsr_spmm_int8_fused_plain(plan, Hq))


@pytest.mark.cuda
def test_int8_gcn_forward_through_k7(cuda_device):
    rng = np.random.default_rng(13)
    n = 2000
    A = _int8_graph(n, 13)
    X = rng.uniform(0, 1, (n, 100)).astype(np.float32)
    W1 = rng.uniform(-0.5, 0.5, (100, 32)).astype(np.float32)
    W2 = rng.uniform(-0.5, 0.5, (32, 16)).astype(np.float32)
    cal = pt.quant.CalibrationTable.for_qbits(8, dict(w_min=-0.5, w_max=0.5, w_min2=-0.5, w_max2=0.5))
    amax = Q.collect_amax_gcn2_sparse(A, X, W1, W2)
    net = Q.freeze_gcn2_sparse(W1, W2, A, cal, tb=128, device=cuda_device, **amax)
    xs = Q.quantize_unsigned_shifted(torch.from_numpy(X).to(cuda_device), cal.features)
    before = K1.bsr_spmm_int8.launches
    out = Q.int8_gcn2_sparse_forward(net, xs)
    assert K1.bsr_spmm_int8.launches == before + 2
    cpu = Q.freeze_gcn2_sparse(W1, W2, A, cal, tb=128, device="cpu", **amax)
    torch.testing.assert_close(out.cpu(), Q.int8_gcn2_sparse_forward(cpu, xs.cpu()), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "weighted,blk,be,P,hdtype",
    [(False, 128, 1024, 16, torch.float32), (True, 256, 2048, 100, torch.float32),
     (False, 1024, 1024, 128, torch.bfloat16), (True, 128, 1024, 33, torch.float32)],
)
def test_plan_spmm_kernel_matches_plain(cuda_device, weighted, blk, be, P, hdtype):
    """K9 on plan and plan_t, with substituted values, spare rows of H and
    a split hub row: 1e-3 (identical roundings, f32 sums in another order)."""
    A = _graph(3001, weighted, seed=14)
    prep = pt.prepare_adjacency(A, method="pallas", rb=blk, cb=blk, be=be, device=cuda_device)
    assert prep.plan.segments.n_fin > 0  # hub rows split over several workers
    H = torch.randn(A.n_cols + 5, P, device=cuda_device).to(hdtype)
    before = K9.spmm_plan.launches
    out = K9.spmm_plan(prep.plan, H)
    torch.cuda.synchronize()
    assert K9.spmm_plan.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (A.n_rows, P)
    torch.testing.assert_close(out, K9.spmm_plan_plain(prep.plan, H), rtol=1e-3, atol=1e-3)
    g = torch.randn(A.n_rows, P, device=cuda_device)
    torch.testing.assert_close(K9.spmm_plan(prep.plan_t, g), K9.spmm_plan_plain(prep.plan_t, g),
                               rtol=1e-3, atol=1e-3)
    pv = K9.plan_with_vals(prep.plan, torch.rand(A.vals.shape[0], device=cuda_device))
    torch.testing.assert_close(K9.spmm_plan(pv, H), K9.spmm_plan_plain(pv, H), rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_plan_spmm_kernel_empty_blocks(cuda_device):
    A = _int8_graph(2600, 15, empty_rb=2, tb=256)
    plan = K9.plan_spmm(A, rb=256, cb=256, device=cuda_device)
    H = torch.randn(2600, 40, device=cuda_device)
    out = K9.spmm_plan(plan, H)
    torch.testing.assert_close(out, K9.spmm_plan_plain(plan, H), rtol=1e-3, atol=1e-3)
    assert (out[512:768] == 0).all()
    z = np.zeros(0, np.int64)
    empty = K9.plan_spmm(SparseMatrix.from_coo(z, z, np.zeros(0, np.float32), (300, 300)), device=cuda_device)
    assert (K9.spmm_plan(empty, H[:300]) == 0).all()


@pytest.mark.cuda
def test_pallas_kind_grads_through_k9(cuda_device):
    """A GCN step on the pallas kind (K9 on plan and plan_t) and
    agg_matmul_with_vals against autograd on the f32 edge path."""
    A = _graph(3001, weighted=False, seed=16)
    x = torch.randn(3001, 32, device=cuda_device)
    edge = pt.prepare_adjacency(A, method="xla", device=cuda_device)
    prep = pt.prepare_adjacency(A, method="pallas", rb=256, cb=256, device=cuda_device)
    gcn = pt.GCNModel(32, 64, 7, dropout=0.0, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    before = K9.spmm_plan.launches
    got = _grads(gcn, prep, x)
    assert K9.spmm_plan.launches == before + 4
    for k, r in _grads(gcn, edge, x).items():
        torch.testing.assert_close(got[k], r, rtol=5e-2, atol=5e-2 * float(r.abs().max()), msg=lambda m: f"{k}: {m}")
    from sgracex1_tpu_torch.ops.dispatch import agg_matmul_with_vals
    vals = torch.rand(A.vals.shape[0], device=cuda_device) * (prep.A.vals != 0)
    res = []
    for p in (prep, edge):
        v, h = vals.clone().requires_grad_(True), x.clone().requires_grad_(True)
        agg_matmul_with_vals(p, v, h).square().sum().backward()
        res.append((v.grad, h.grad))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=5e-2, atol=5e-2 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "form,tb,P,hdtype",
    [("values", 128, 100, torch.float32), ("int8", 256, 128, torch.bfloat16),
     ("packed", 1024, 72, torch.float32), ("f32", 128, 33, torch.float32), ("packed", 128, 40, torch.float32)],
)
def test_rowloop_kernel_matches_plain_and_k1(cuda_device, form, tb, P, hdtype):
    """K10 in the tile forms, without cover tiles (row blocks without a
    tile are written as zeros)."""
    A = _int8_graph(3001, 17, empty_rb=3, tb=tb) if form in ("values", "f32") else _graph(3001, False, seed=17)
    if form == "packed":
        B = K1.bsr_bitmask_from_sparse(A, tb=tb, device=cuda_device)
    else:
        B = K1.bsr_from_sparse(A, tb=tb, mask=form == "int8",
                               dtype=torch.float32 if form == "f32" else torch.bfloat16, device=cuda_device)
    H = torch.randn(A.n_cols, P, device=cuda_device).to(hdtype)
    before = K1.bsr_spmm_rowloop.launches
    out = K1.bsr_spmm_rowloop(B, H)
    torch.cuda.synchronize()
    assert K1.bsr_spmm_rowloop.launches == before + 1
    torch.testing.assert_close(out, K1.bsr_spmm_rowloop_plain(B, H), rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(out, K1.bsr_spmm(B, H), rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted,attach,k", [(False, True, 2), (False, False, 4), (True, True, 4), (True, False, 2)])
def test_fused_k_kernel_matches_plain_and_k2(cuda_device, weighted, attach, k):
    A = _graph(2600, weighted, seed=18)
    prep = pt.prepare_adjacency(A, method="hybrid", tb=128, rest_thresh=40, build_transpose=False,
                                device=cuda_device)
    r1 = {} if weighted else dict(r1_row=prep.r1_row.cpu().numpy(), r1_col=prep.r1_col.cpu().numpy())
    plan = K2.build_fused_plan(prep.bsr, prep.rest, attach_chunks=attach, k_steps=k, **r1)
    base = K2.build_fused_plan(prep.bsr, prep.rest, attach_chunks=attach, **r1)
    assert plan.k_steps == k and plan.num_steps % k == 0 and plan.num_steps > base.num_steps
    H = torch.randn(A.n_cols, 100, device=cuda_device)
    before = K2.bsr_spmm_fused_k.launches
    out = K2.bsr_spmm_fused_k(plan, H)
    torch.cuda.synchronize()
    assert K2.bsr_spmm_fused_k.launches == before + 1 and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), K2.bsr_spmm_fused_k_plain(plan, H).float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(out.float(), K2.bsr_spmm_fused(base, H).float(), rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="k_steps 2 or 4"):
        K2.bsr_spmm_fused_k(K2.build_fused_plan(prep.bsr, prep.rest, k_steps=3, **r1), H)


@pytest.mark.cuda
@pytest.mark.parametrize("form,sb", [("int8", 64), ("int8", 128), ("int8", 256), ("values", 64)])
def test_subskip_kernel_matches_plain_and_k3(cuda_device, form, sb):
    """K12 against its plain version at 2e-2 (bf16(p) rounds against another
    running max) and equal to K3: what it skips adds exact zeros there."""
    A = _graph(3001, weighted=form == "values", seed=19)
    B = K1.bsr_from_sparse(A, tb=256, mask=form == "int8", device=cuda_device)
    s1, s2, Wh = (t[:, 0] for t in _scores(3001, 1, 40, cuda_device, seed=4))
    pop = FG.subblock_pop_bitmap(B, A, sb)
    before = FG.flash_gat_forward_subskip.launches
    out = FG.flash_gat_forward_subskip(B, pop, s1, s2, Wh, sb=sb)
    torch.cuda.synchronize()
    assert FG.flash_gat_forward_subskip.launches == before + 1
    torch.testing.assert_close(out, FG.flash_gat_forward_subskip_plain(B, pop, s1, s2, Wh, sb=sb),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(out, FG.flash_gat_forward(B, s1, s2, Wh))
    # sub-blocks narrower than 64 columns run too (every sb that divides tb)
    pop = FG.subblock_pop_bitmap(B, A, 32)
    torch.testing.assert_close(FG.flash_gat_forward_subskip(B, pop, s1, s2, Wh, sb=32),
                               FG.flash_gat_forward_subskip_plain(B, pop, s1, s2, Wh, sb=32), rtol=2e-2, atol=2e-2)


def _counts(kern):
    return kern.launches, kern.launches_ring, kern.launches_single


@pytest.mark.cuda
@pytest.mark.parametrize("tb", [64, 128, 192, 256, 512])
@pytest.mark.parametrize("P", [16, 128, 100])
def test_ring_k7_equals_plain_and_single(cuda_device, tb, P):
    """The ring K7 (the int8 ring kernel over BSRMatrix.edge_ring's row
    pieces) bit-equal to the plain and the single-stage K7; P = 100 takes
    the single-stage route."""
    n = 5 * tb + 37
    A = _int8_graph(n, 21, empty_rb=1, tb=tb)
    B = Q.bsr_int8_from_sparse(A, generate_constants(0.0, 1.0, 8, signed=False, w_qbits=8), tb=tb,
                               device=cuda_device)
    Hq = torch.randint(-127, 128, (n, P), dtype=torch.int8, device=cuda_device)
    ring = K1.int8_ring_shape_ok_k7(tb, P, Hq.data_ptr())
    assert ring == (P != 100)
    before = _counts(K1.bsr_spmm_int8)
    out = K1.bsr_spmm_int8(B, Hq)
    torch.cuda.synchronize()
    assert _counts(K1.bsr_spmm_int8) == (before[0] + 1, before[1] + ring, before[2] + (not ring))
    ref = K1.bsr_spmm_int8_plain(B, Hq)
    assert out.dtype == torch.int32 and torch.equal(out, ref) and not out[tb: 2 * tb].any()
    assert torch.equal(K1._bsr_spmm_int8_single(B, Hq), ref)
    if ring and tb == 512:
        assert B.edge_ring.n_dead_tile_steps > 0  # row halves of -128 bytes only


@pytest.mark.cuda
@pytest.mark.parametrize("sb", [8, 16, 32, 64, 128, 256])
def test_ring_subskip_equals_ring_k3_and_matches_plain(cuda_device, sb):
    """The ring K12 at every sb: torch.equal to the ring K3 on a bitmap of
    the tiles' own edges; the ring and the single-stage K12 within 2e-2 of
    the plain K12, also on a bitmap that clears populated sub-blocks."""
    A = _graph(3001, weighted=False, seed=23)
    B = K1.bsr_from_sparse(A, tb=256, mask=True, device=cuda_device)
    s1, s2, Wh = (t[:, 0] for t in _scores(3001, 1, 64, cuda_device, seed=5))
    full = torch.from_numpy(FG.subblock_pop_bitmap(B, A, sb))
    cut = full & torch.from_numpy(np.random.default_rng(sb).integers(-2**31, 2**31, tuple(full.shape),
                                                                     dtype=np.int64).astype(np.int32))
    for pop in (full.to(cuda_device), cut.to(cuda_device)):
        # the fold kernel and its plain version give the same live steps
        assert torch.equal(FG._subskip_fold(B, pop, sb).step, FG.subskip_schedule(B, pop, sb).step)
        before = _counts(FG.flash_gat_forward_subskip)
        out = FG.flash_gat_forward_subskip(B, pop, s1, s2, Wh, sb=sb)
        torch.cuda.synchronize()
        assert _counts(FG.flash_gat_forward_subskip) == (before[0] + 1, before[1] + 1, before[2])
        ref = FG.flash_gat_forward_subskip_plain(B, pop, s1, s2, Wh, sb=sb)
        torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(FG._flash_gat_forward_subskip_single(B, pop, s1, s2, Wh, sb=sb), ref,
                                   rtol=2e-2, atol=2e-2)
    full_out = FG.flash_gat_forward_subskip(B, full.to(cuda_device), s1, s2, Wh, sb=sb)
    assert torch.equal(full_out, FG._flash_gat_forward_ring(B, s1, s2, Wh))


def test_wrappers_run_plain_on_cpu_and_raise_elsewhere():
    A = _graph(600, weighted=True, seed=4)
    B = K1.bsr_from_sparse(A, tb=128, cover_rows=True)
    plan = K2.build_fused_plan(B, None)
    H = torch.randn(600, 8)
    b1, b2 = K1.bsr_spmm.launches, K2.bsr_spmm_fused.launches
    torch.testing.assert_close(K1.bsr_spmm(B, H), K1.bsr_spmm_plain(B, H))
    torch.testing.assert_close(K2.bsr_spmm_fused(plan, H), K2.bsr_spmm_fused_plain(plan, H))
    assert (K1.bsr_spmm.launches, K2.bsr_spmm_fused.launches) == (b1, b2)
    with pytest.raises(ValueError):
        K1.bsr_spmm(B, H.to("meta"))
    with pytest.raises(ValueError):
        K2.bsr_spmm_fused(plan, H.to("meta"))
    s1, s2, Wh = _scores(600, 2, 8, "cpu")
    b3 = FG.flash_gat_forward.launches
    torch.testing.assert_close(FG.flash_gat_forward(B, s1, s2, Wh), FG.flash_gat_forward_plain(B, s1, s2, Wh))
    assert FG.flash_gat_forward.launches == b3
    with pytest.raises(ValueError):
        FG.flash_gat_forward(B, s1, s2, Wh.to("meta"))


def test_variant_wrappers_run_plain_on_cpu_and_raise_elsewhere():
    """K9-K12: a CPU tensor takes the plain version and counts nothing;
    any other device raises."""
    A = _graph(600, weighted=True, seed=4)
    B = K1.bsr_from_sparse(A, tb=128, cover_rows=True)
    H = torch.randn(600, 8)
    plan9 = K9.plan_spmm(A, rb=128, cb=128)
    plan11 = K2.build_fused_plan(B, None, k_steps=2)
    pop = FG.subblock_pop_bitmap(B, A, 64)
    s1, s2, Wh = (t[:, 0] for t in _scores(600, 1, 8, "cpu"))
    cases = [
        (K9.spmm_plan, K9.spmm_plan_plain, (plan9, H), 1),
        (K1.bsr_spmm_rowloop, K1.bsr_spmm_rowloop_plain, (B, H), 1),
        (K2.bsr_spmm_fused_k, K2.bsr_spmm_fused_k_plain, (plan11, H), 1),
        (lambda *a: FG.flash_gat_forward_subskip(*a, sb=64),
         lambda *a: FG.flash_gat_forward_subskip_plain(*a, sb=64), (B, pop, s1, s2, Wh), 4),
    ]
    counters = (K9.spmm_plan, K1.bsr_spmm_rowloop, K2.bsr_spmm_fused_k, FG.flash_gat_forward_subskip)
    before = [k.launches for k in counters]
    for kern, plain, args, i in cases:
        torch.testing.assert_close(kern(*args), plain(*args), rtol=0, atol=0)
        with pytest.raises(ValueError, match="cpu or cuda"):
            kern(*args[:i], args[i].to("meta"), *args[i + 1:])
    assert [k.launches for k in counters] == before


# --------------------------------------------------- the ring K1 and K2


def _ring_graph(n, tb, weighted, seed):
    """Hub rows and columns (dense tiles, a run longer than RING_SEG_STEPS
    in row block 0 at tb <= 128) and random edges (a remainder); block 2
    and block 5 hold no edge at all (zeros must be written), block 4 only
    sparse edges (a row block whose work is a chunk alone)."""
    rng = np.random.default_rng(seed)
    hub = np.stack([rng.integers(0, 60, 25 * n), rng.integers(0, n, 25 * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 3 * n)), hub, hub[::-1]], axis=1), axis=1)
    ei = ei[:, (ei // tb != 2).all(axis=0) & (ei // tb != 5).all(axis=0)]
    ei = ei[:, ~((ei[0] // tb == 4) & (ei[1] < 60)) & ~((ei[1] // tb == 4) & (ei[0] < 60))]
    if not weighted:
        return pt.sym_norm(ei, n, fill=0.0)
    v = rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32)
    return SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))


RING_SHAPES = [(64, 8), (64, 200), (128, 64), (128, 128), (256, 128), (256, 200), (192, 8), (256, 264)]


@pytest.mark.cuda
@pytest.mark.parametrize("tb,P", RING_SHAPES)
@pytest.mark.parametrize("form", ["int8", "values"])
def test_ring_k1_matches_plain(cuda_device, form, tb, P):
    """The ring K1 (and the single-stage K1 on the same operands) against
    the plain version at 1e-3: each tile mode it takes, tile heights 64 to
    256, P from one 16-byte piece to three feature slices, a run split over
    several work items, row blocks without a live tile; forward and
    transposed; f32 and bf16 H."""
    n = 20 * tb + 37
    A = _ring_graph(n, tb, weighted=form == "values", seed=tb + P)
    B = K1.bsr_from_sparse(A, tb=tb, mask=form == "int8", cover_rows=True, cover_cols=True, device=cuda_device)
    assert K1.ring_shape_ok(K1._tile_mode(B.tiles, tb), tb, P)
    assert (~B.live).any() and not B.live[B.tile_rb == 2].any()
    if tb <= 128:
        assert B.ring.segments.n_fin > 0  # row block 0's run is longer than RING_SEG_STEPS
    for M in (B, K1.bsr_transpose(B)):
        for hdtype in (torch.float32, torch.bfloat16):
            H = torch.randn(M.n_cols, P, device=cuda_device).to(hdtype)
            ref = K1.bsr_spmm_plain(M, H)
            before = (K1.bsr_spmm.launches, K1.bsr_spmm.launches_ring, K1.bsr_spmm.launches_single)
            out = K1.bsr_spmm(M, H)
            torch.cuda.synchronize()
            after = (K1.bsr_spmm.launches, K1.bsr_spmm.launches_ring, K1.bsr_spmm.launches_single)
            assert after == (before[0] + 1, before[1] + 1, before[2])
            assert out.dtype == torch.float32 and out.shape == (M.n_rows, P)
            torch.testing.assert_close(out, ref, rtol=1e-3, atol=1e-3)
            assert not out[2 * tb: 3 * tb].any()  # the edgeless row block is written, with zeros
            torch.testing.assert_close(K1._bsr_spmm_single(M, H), ref, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("tb,P", RING_SHAPES)
@pytest.mark.parametrize("mode", ["rank1", "values"])
@pytest.mark.parametrize("attach", [True, False])
def test_ring_k2_matches_plain(cuda_device, mode, attach, tb, P):
    """The ring K2 (and the single-stage K2) against the plain version at
    2e-2 (both write bf16): rank-1 mask tiles with scalings and value tiles
    with scaled chunk rows, chunks attached to tile steps or on their own
    steps, a row block whose only work is a chunk, one with none, split
    runs; forward and transposed plans as ``prepare_adjacency`` builds
    them."""
    n = 20 * tb + 37
    A = _ring_graph(n, tb, weighted=mode == "values", seed=3 * tb + P)
    prep = pt.prepare_adjacency(A, method="hybrid", tb=tb, rest_thresh=tb * tb // 256, device=cuda_device)
    assert (prep.r1_row is not None) == (mode == "rank1") and prep.rest is not None
    plans = [prep.fused, prep.fused_t]
    if not attach:
        r1 = {} if prep.r1_row is None else dict(r1_row=prep.r1_row.cpu().numpy(), r1_col=prep.r1_col.cpu().numpy())
        plans = [K2.build_fused_plan(prep.bsr, prep.rest, attach_chunks=False, **r1)]
    k = K2.bsr_spmm_fused
    for plan in plans:
        step = plan.ring.step
        assert plan.ring.n_dead_tile_steps > 0 and (step[:, 2] >= 0).any()
        if not attach:  # chunks on steps of their own
            assert ((step[:, 0] < 0) & (step[:, 2] >= 0)).any()
        assert K1.ring_shape_ok(K1._tile_mode(plan.B.tiles, tb), tb, P, plan.K)
        for hdtype in (torch.float32, torch.bfloat16):
            H = torch.randn(plan.B.n_cols, P, device=cuda_device).to(hdtype)
            ref = K2.bsr_spmm_fused_plain(plan, H).float()
            before = (k.launches, k.launches_ring, k.launches_single)
            out = k(plan, H)
            torch.cuda.synchronize()
            assert (k.launches, k.launches_ring, k.launches_single) == (before[0] + 1, before[1] + 1, before[2])
            assert out.dtype == torch.bfloat16 and out.shape == (plan.B.n_rows, P)
            torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
            assert not out[2 * tb: 3 * tb].any()
            torch.testing.assert_close(K2._bsr_spmm_fused_single(plan, H).float(), ref, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("seg_steps", [1, 8, 64])
def test_ring_kernels_over_segment_lengths(cuda_device, seg_steps):
    """The same live steps cut into work items of 1, 8 and 64 steps."""
    import dataclasses

    A = _ring_graph(2600, 128, weighted=False, seed=9)
    prep = pt.prepare_adjacency(A, method="hybrid", tb=128, rest_thresh=40, build_transpose=False,
                                device=cuda_device)
    H = torch.randn(2600, 128, device=cuda_device)
    plan, B = prep.fused, prep.bsr
    cut = dataclasses.replace(plan, ring=K1.recut_live_schedule(plan.ring, B.n_row_tiles, seg_steps))
    torch.testing.assert_close(K2.bsr_spmm_fused(cut, H).float(), K2.bsr_spmm_fused_plain(plan, H).float(),
                               rtol=2e-2, atol=2e-2)
    cutB = dataclasses.replace(B, ring=K1.recut_live_schedule(B.ring, B.n_row_tiles, seg_steps))
    torch.testing.assert_close(K1.bsr_spmm(cutB, H), K1.bsr_spmm_plain(B, H), rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_stage_h_kernel_equals_plain(cuda_device):
    """The pre-pass is elementwise: bit-equal to its plain version, f32
    and bf16 H, with and without the column scale, zero rows past n_valid."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for P in (8, 128, 200):
        H = torch.randn(1000, P, generator=g, device=cuda_device)
        cs = torch.rand(1024, generator=g, device=cuda_device)
        for h in (H, H.to(torch.bfloat16)):
            for scale in (None, cs):
                out = K1._stage_h(h, scale, 1024, 990)
                torch.cuda.synchronize()
                assert torch.equal(out, K1.stage_h_plain(h, scale, 1024, 990))
    hb = torch.randn(1024, 64, generator=g, device=cuda_device).to(torch.bfloat16)
    assert K1._stage_h(hb, None, 1024, 1024) is hb  # already the operand: no pass


@pytest.mark.cuda
@pytest.mark.parametrize(
    "form,tb,P,K,ring",
    [("int8", 256, 128, 128, True), ("values", 64, 8, 64, True), ("int8", 128, 100, 128, False),
     ("f32", 128, 128, 128, False), ("packed", 1024, 128, 128, False), ("int8", 128, 64, 32, False),
     ("values", 32, 64, 128, False)],
)
def test_kernel_choice_reads_shape_and_tile_form_only(cuda_device, form, tb, P, K, ring):
    """Which kernel a launch takes follows ``ring_shape_ok`` and nothing
    else; both kernels agree with the plain version wherever they run."""
    A = _graph(max(8 * tb, 1500), weighted=form in ("values", "f32"), seed=4)
    part, rest = split_by_tile_density(A, tb, max(tb * tb // 400, 2))
    cover = dict(tb=tb, cover_rows=True, cover_cols=True, device=cuda_device)
    if form == "packed":
        B, r1 = K1.bsr_bitmask_from_sparse(part, **cover), {}
    else:
        B = K1.bsr_from_sparse(part, mask=form == "int8",
                               dtype=torch.float32 if form == "f32" else torch.bfloat16, **cover)
    fac = pt.graph.normalize.rank1_factor(A) if form in ("int8", "packed") else None
    r1 = dict(r1_row=fac[0], r1_col=fac[1]) if fac is not None else {}
    if fac is not None:
        rest = pt.ops.dispatch._drop_zero_val_edges(rest)
    plan = K2.build_fused_plan(B, rest, K=K, attach_chunks=True, **r1)
    assert K1.ring_shape_ok(K1._tile_mode(B.tiles, tb), tb, P, K) == ring
    H = torch.randn(A.n_cols, P, device=cuda_device)
    for kern, op, plain, tol in ((K2.bsr_spmm_fused, plan, K2.bsr_spmm_fused_plain, 2e-2),):
        before = (kern.launches_ring, kern.launches_single)
        out = kern(op, H)
        torch.cuda.synchronize()
        assert (kern.launches_ring - before[0], kern.launches_single - before[1]) == (int(ring), int(not ring))
        torch.testing.assert_close(out.float(), plain(op, H).float(), rtol=tol, atol=tol)
    ring1 = K1.ring_shape_ok(K1._tile_mode(B.tiles, tb), tb, P)
    before = (K1.bsr_spmm.launches_ring, K1.bsr_spmm.launches_single)
    out = K1.bsr_spmm(B, H)
    torch.cuda.synchronize()
    assert (K1.bsr_spmm.launches_ring - before[0], K1.bsr_spmm.launches_single - before[1]) == (
        int(ring1), int(not ring1))
    torch.testing.assert_close(out, K1.bsr_spmm_plain(B, H), rtol=1e-3, atol=1e-3)


def _ring_counts(kern):
    return kern.launches, kern.launches_ring, kern.launches_single


@pytest.mark.cuda
@pytest.mark.parametrize(
    "form,tb,H",
    [("int8", 64, 4), ("int8", 128, 2), ("int8", 192, 4), ("int8", 256, 1), ("int8", 256, 4),
     ("values", 128, 4), ("values", 256, 2)],
)
def test_flash_ring_k3_matches_plain(cuda_device, form, tb, H):
    """The ring K3 (and the single-stage K3 on the same operands) against
    the plain version: m exact, out at 2e-2, l at 1e-3; tile heights 64 to
    256, one, two and four heads, runs split over work items, row blocks
    whose only tiles are empty cover tiles (out exactly 0, m = -1e5, l = 0)."""
    n = 20 * tb + 37
    A = _ring_graph(n, tb, weighted=form == "values", seed=tb + H)
    B = K1.bsr_from_sparse(A, tb=tb, mask=form == "int8", cover_rows=True, cover_cols=True, device=cuda_device)
    assert FG.flash_ring_shape_ok(K1._tile_mode(B.tiles, tb), tb, H, 64)
    assert B.tiles[B.tile_rb == 2].eq(0).all() and not B.live[B.tile_rb == 2].any()
    s1, s2, Wh = _scores(n, H, 64, cuda_device, seed=tb)
    ref = FG.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=True)
    before = _ring_counts(FG.flash_gat_forward)
    res = FG.flash_gat_forward(B, s1, s2, Wh, return_stats=True)
    assert tuple(a - b for a, b in zip(_ring_counts(FG.flash_gat_forward), before)) == (1, 1, 0)
    _check_flash(res, ref)
    _check_flash(FG._flash_gat_forward_single(B, s1, s2, Wh, return_stats=True), ref)
    out, m, l = res
    empty = slice(2 * tb, 3 * tb)
    assert (out[empty] == 0).all() and (m[empty] == -1e5).all() and (l[empty] == 0).all()
    # the single-head call and bf16 Wh take the same kernel
    if H == 1:
        one = FG.flash_gat_forward(B, s1[:, 0], s2[:, 0], Wh[:, 0].to(torch.bfloat16))
        torch.testing.assert_close(one, out[:, 0], rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("tb,H,attach,K", [(64, 4, True, 64), (128, 1, False, 128), (256, 4, True, 128),
                                           (256, 2, False, 64), (192, 4, True, 128)])
def test_flash_ring_k6_matches_plain(cuda_device, tb, H, attach, K):
    """The ring K6 against the plain version on hybrid plans: tile and
    chunk steps, a CTA of fewer rows than the tile gathering only its
    slots, dead chunk slots, split runs."""
    n = 20 * tb + 37
    A = _ring_graph(n, tb, weighted=False, seed=tb + 3 * H)
    part, rest = split_by_tile_density(A, tb, max(tb * tb // 400, 2))
    rest = pt.ops.dispatch._drop_zero_val_edges(rest)
    B = K1.bsr_mask_from_sparse(part, tb=tb, cover_rows=True, cover_cols=True, device=cuda_device)
    plan = K2.build_fused_plan(B, rest, K=K, attach_chunks=attach)
    assert plan.num_rest_chunks > 0 and (plan.ring.step[:, 2] >= 0).any()
    s1, s2, Wh = _scores(n, H, 64, cuda_device, seed=tb + 1)
    ref = FG.flash_gat_hybrid_forward_plain(plan, s1, s2, Wh, return_stats=True)
    before = _ring_counts(FG.flash_gat_hybrid_forward)
    res = FG.flash_gat_hybrid_forward(plan, s1, s2, Wh, return_stats=True)
    assert tuple(a - b for a, b in zip(_ring_counts(FG.flash_gat_hybrid_forward), before)) == (1, 1, 0)
    _check_flash(res, ref)
    _check_flash(FG._flash_gat_hybrid_forward_single(plan, s1, s2, Wh, return_stats=True), ref)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "form,tb,H,F,ring",
    [("int8", 256, 4, 64, True), ("values", 64, 1, 64, True), ("int8", 256, 3, 64, False),
     ("int8", 128, 4, 32, False), ("packed", 1024, 1, 64, False), ("f32", 128, 2, 64, False),
     ("int8", 32, 1, 64, False)],
)
def test_flash_kernel_choice_reads_shape_and_tile_form_only(cuda_device, form, tb, H, F, ring):
    """Which K3 kernel a launch takes follows ``flash_ring_shape_ok`` and
    nothing else; the kernel that ran agrees with the plain version."""
    n = max(8 * tb, 1500)
    A = _graph(n, weighted=form in ("values", "f32"), seed=7)
    if form == "packed":
        B = K1.bsr_bitmask_from_sparse(A, tb=tb, device=cuda_device)
    else:
        B = K1.bsr_from_sparse(A, tb=tb, mask=form == "int8",
                               dtype=torch.float32 if form == "f32" else torch.bfloat16, device=cuda_device)
    assert FG.flash_ring_shape_ok(K1._tile_mode(B.tiles, tb), tb, H, F) == ring
    s1, s2, Wh = _scores(n, H, F, cuda_device, seed=3)
    before = _ring_counts(FG.flash_gat_forward)
    res = FG.flash_gat_forward(B, s1, s2, Wh, return_stats=True)
    assert tuple(a - b for a, b in zip(_ring_counts(FG.flash_gat_forward), before)) == (1, int(ring), int(not ring))
    _check_flash(res, FG.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=True))


# ------------------------------------------------ the backward ring K4 / K5


_BWD = (FG.flash_gat_bwd_row, FG.flash_gat_bwd_col)


def _bwd_moved(before):
    """How far (launches, launches_ring, launches_single) of K4 and K5 moved
    since ``before = [_ring_counts(k) for k in _BWD]``."""
    return [tuple(a - b for a, b in zip(_ring_counts(k), bk)) for k, bk in zip(_BWD, before)]


def _bwd_ring_run(B, H, device, seed):
    """K4 and K5 on ``B`` through their wrappers against the plain
    versions at 2e-2 (bf16 q and dWh operands are identical; p differs in
    the fast exp); also the single-stage kernels on the same operands.
    Returns the counter moves of the two wrappers."""
    n = B.n_rows
    s1, s2, Wh = _scores(n, H, 64, device, seed=seed)
    gO = _scores(n, H, 64, device, seed=seed + 1)[2]
    _, m, l = FG.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=True)
    ref = FG.flash_gat_bwd_row_plain(B, s1, s2, m, l, Wh, gO)
    ref_c = FG.flash_gat_bwd_col_plain(B, s1, s2, m, l, ref[0], Wh, gO)
    before = [_ring_counts(k) for k in _BWD]
    got = FG.flash_gat_bwd_row(B, s1, s2, m, l, Wh, gO)
    got_c = FG.flash_gat_bwd_col(B, s1, s2, m, l, ref[0], Wh, gO)
    moved = _bwd_moved(before)
    single = (FG._flash_gat_bwd_row_single(B, s1, s2, m, l, Wh, gO),
              FG._flash_gat_bwd_col_single(B, s1, s2, m, l, ref[0], Wh, gO))
    torch.cuda.synchronize()
    for res, want in ((got, ref), (got_c, ref_c), (single[0], ref), (single[1], ref_c)):
        for g, r in zip(res, want):
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g, r, rtol=2e-2, atol=2e-2)
    return moved, got, got_c


@pytest.mark.cuda
@pytest.mark.parametrize(
    "form,tb,H,seg_steps",
    [("int8", 64, 4, 16), ("int8", 128, 2, 2), ("int8", 192, 4, 16), ("int8", 256, 1, 16), ("int8", 256, 4, 1),
     ("values", 128, 4, 3), ("values", 256, 2, 16), ("values", 64, 1, 64)],
)
def test_flash_bwd_ring_matches_plain(cuda_device, monkeypatch, form, tb, H, seg_steps):
    """The ring K4 and K5 against the plain versions: tile heights 64 to
    256, one, two and four heads, runs cut into work items of 1 to 64 live
    steps (split runs summed in order), a row block and a column block whose
    only tiles are empty cover tiles (their sums exactly 0)."""
    monkeypatch.setattr(K1, "RING_SEG_STEPS", seg_steps)
    n = 20 * tb + 37
    A = _ring_graph(n, tb, weighted=form == "values", seed=tb + H)
    B = K1.bsr_from_sparse(A, tb=tb, mask=form == "int8", cover_rows=True, cover_cols=True, device=cuda_device)
    assert FG.flash_bwd_ring_shape_ok(K1._tile_mode(B.tiles, tb), tb, H, 64)
    assert not B.live[B.tile_rb == 2].any() and not B.live[B.tile_cb == 5].any()
    if seg_steps <= 3:
        assert B.ring.segments.n_fin > 0 and B.live_t.ring.segments.n_fin > 0
    moved, (t, u1, u2), (dWh, ds2) = _bwd_ring_run(B, H, cuda_device, seed=tb)
    assert moved == [(1, 1, 0), (1, 1, 0)]
    empty_r, empty_c = slice(2 * tb, 3 * tb), slice(5 * tb, 6 * tb)
    assert all((x[empty_r] == 0).all() for x in (t, u1, u2))
    assert (dWh[empty_c] == 0).all() and (ds2[empty_c] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "form,tb,H,F,ring",
    [("int8", 256, 4, 64, True), ("values", 64, 1, 64, True), ("int8", 256, 3, 64, False),
     ("int8", 128, 4, 32, False), ("packed", 1024, 1, 64, False), ("f32", 128, 2, 64, False),
     ("int8", 32, 1, 64, False)],
)
def test_flash_bwd_kernel_choice_reads_shape_and_tile_form_only(cuda_device, form, tb, H, F, ring):
    """Which K4 / K5 kernel a launch takes follows
    ``flash_bwd_ring_shape_ok`` and nothing else; the kernel that ran
    agrees with the plain version."""
    n = max(8 * tb, 1500)
    A = _graph(n, weighted=form in ("values", "f32"), seed=7)
    if form == "packed":
        B = K1.bsr_bitmask_from_sparse(A, tb=tb, device=cuda_device)
    else:
        B = K1.bsr_from_sparse(A, tb=tb, mask=form == "int8",
                               dtype=torch.float32 if form == "f32" else torch.bfloat16, device=cuda_device)
    assert FG.flash_bwd_ring_shape_ok(K1._tile_mode(B.tiles, tb), tb, H, F) == ring
    s1, s2, Wh = _scores(n, H, F, cuda_device, seed=3)
    gO = _scores(n, H, F, cuda_device, seed=4)[2]
    _, m, l = FG.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=True)
    want = [(1, int(ring), int(not ring))] * 2
    before = [_ring_counts(k) for k in _BWD]
    ref = FG.flash_gat_bwd_row_plain(B, s1, s2, m, l, Wh, gO)
    got = FG.flash_gat_bwd_row(B, s1, s2, m, l, Wh, gO)
    got_c = FG.flash_gat_bwd_col(B, s1, s2, m, l, ref[0], Wh, gO)
    moved = _bwd_moved(before)
    assert moved == want
    for g, r in zip((*got, *got_c), (*ref, *FG.flash_gat_bwd_col_plain(B, s1, s2, m, l, ref[0], Wh, gO))):
        torch.testing.assert_close(g, r, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(gat_tb=128, gat_rest_thresh=40)])
def test_gat_model_grads_through_ring_bwd(cuda_device, monkeypatch, kw):
    """GATModel gradients with the backward on the ring K4 / K5 (K3 or K6
    forward) against the same step with K4 / K5 swapped for their plain
    versions: within 2e-2 of each gradient's largest entry."""
    A = _graph(3001, weighted=False, seed=12)
    x = torch.randn(3001, 32, device=cuda_device)
    gat = pt.GATModel(32, 64, 7, nheads=4, dropout=0.0, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    prep = pt.prepare_adjacency(A, method="xla", for_gat=True, device=cuda_device, **kw)
    before = [_ring_counts(k) for k in _BWD]
    got = _grads(gat, prep, x)
    moved = _bwd_moved(before)
    assert moved == [(2, 2, 0), (2, 2, 0)]
    monkeypatch.setattr(FG, "flash_gat_bwd_row", FG.flash_gat_bwd_row_plain)
    monkeypatch.setattr(FG, "flash_gat_bwd_col", FG.flash_gat_bwd_col_plain)
    ref = _grads(gat, prep, x)
    for k, r in ref.items():
        scale = float(r.abs().max())
        torch.testing.assert_close(got[k], r, rtol=2e-2, atol=2e-2 * scale, msg=lambda m: f"{k}: {m}")


# ------------------------------------- the cluster K10 and the ring K11


def _hub_band_graph(n_blocks, tb, hub, seed, weighted=False):
    """A band of edges near the diagonal (one or two tiles a row block,
    fewer live tiles than a cluster has CTAs) and, with ``hub``, rows of
    row block 0 linked to every column block (a row block of ``n_blocks``
    live tiles); row and column block 3 hold no edge (an empty row block,
    and an empty cover tile in row block 0's run)."""
    rng = np.random.default_rng(seed)
    n = n_blocks * tb
    r = np.arange(n).repeat(3)
    c = (r + rng.integers(-4, 5, r.shape[0])) % n
    ei = [np.stack([r, c])]
    if hub:
        hr = rng.integers(0, tb // 2, 4 * n_blocks)
        hc = np.arange(4 * n_blocks) // 4 * tb + rng.integers(0, tb, 4 * n_blocks)
        ei.append(np.stack([hr, hc]))
    ei = np.unique(np.concatenate(ei, axis=1), axis=1)
    ei = ei[:, (ei // tb != 3).all(axis=0)]
    v = rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32) if weighted else np.ones(ei.shape[1], np.float32)
    return SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))


CLUSTER_CASES = [
    ("int8", 256, 128, torch.float32, 16, True), ("int8", 256, 200, torch.bfloat16, 8, True),
    ("int8", 64, 8, torch.float32, 8, True), ("int8", 128, 64, torch.bfloat16, 16, True),
    ("values", 128, 128, torch.float32, 8, True), ("values", 192, 264, torch.float32, 16, True),
    ("values", 64, 128, torch.bfloat16, 16, False), ("int8", 256, 128, torch.float32, 8, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("form,tb,P,hdtype,C,hub", CLUSTER_CASES)
def test_rowloop_cluster_matches_plain_and_k1(cuda_device, form, tb, P, hdtype, C, hub):
    """The cluster K10 against its plain version (each heavy block's C
    partials summed in rank order) and against the ring K1 at 1e-3: int8
    and bf16 tiles of height 64-256, f32 and bf16 H, one to three feature
    slices, clusters of 8 and 16, a hub row block of hundreds of live tiles
    (split over a cluster, in halves of the tile height where its ranges
    are long) and an all-light band graph; the empty row block comes out as
    zeros."""
    A = _hub_band_graph(320 if tb == 64 else 200, tb, hub, seed=tb + P, weighted=form == "values")
    B = K1.bsr_from_sparse(A, tb=tb, mask=form == "int8", cover_rows=True, cover_cols=True, device=cuda_device)
    assert (~B.live).any()
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    sched = K1._cluster_sched(B, C, n_sm, K1.rowloop_cluster_occupancy(K1._tile_mode(B.tiles, tb), C))
    assert (sched.n_heavy > 0) == hub
    if hub and tb >= 128 and C == 8:  # the hub's ranges hold more than heavy_min: two half-height items
        assert (sched.item_kind == K1.UPPER).sum() == (sched.item_kind == K1.LOWER).sum() == 1
    H = torch.randn(A.n_cols, P, device=cuda_device).to(hdtype)
    k = K1.bsr_spmm_rowloop
    before = (k.launches, k.launches_cluster, k.launches_single)
    out = K1._bsr_spmm_rowloop_cluster(B, H, C)
    torch.cuda.synchronize()
    assert (k.launches, k.launches_cluster, k.launches_single) == (before[0] + 1, before[1] + 1, before[2])
    assert out.dtype == torch.float32 and out.shape == (A.n_rows, P)
    torch.testing.assert_close(out, K1.bsr_spmm_rowloop_cluster_plain(B, H, sched), rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(out, K1.bsr_spmm(B, H), rtol=1e-3, atol=1e-3)
    assert not out[3 * tb: 4 * tb].any()
    # the entry point takes the cluster kernel at these shapes
    before = (k.launches_cluster, k.launches_single)
    torch.testing.assert_close(k(B, H), out, rtol=1e-3, atol=1e-3)
    assert (k.launches_cluster, k.launches_single) == (before[0] + 1, before[1])


@pytest.mark.cuda
def test_rowloop_cluster_occupancy(cuda_device):
    """Clusters of 8 and 16 CTAs of the ring's shared memory both fit."""
    for mode in (0, 2):
        for C in K1.ROWLOOP_CLUSTERS:
            assert K1.rowloop_cluster_occupancy(mode, C) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mode,tb,P,k",
    [("rank1", 256, 128, 2), ("rank1", 256, 128, 4), ("rank1", 128, 200, 4), ("values", 128, 64, 2),
     ("values", 64, 8, 2), ("rank1", 64, 128, 4), ("values", 256, 128, 4)],
)
def test_fused_k_ring_matches_k2_ring(cuda_device, mode, tb, P, k):
    """The K11 ring kernel walks K2's ring schedule (the k-plan's pads are
    not on it), k slabs a stage: at k = 2 (64-deep slabs, the products of K2's
    ring in its order) equal to K2's ring bit for bit, at k = 4 (32-deep
    slabs) within K2_TOL; both within K2_TOL of the plain K11. bf16 tiles
    at k = 4 take the single-stage kernel (``fused_k_ring_shape_ok``)."""
    A = _ring_graph(20 * tb + 37, tb, weighted=mode == "values", seed=5 * tb + P)
    prep = pt.prepare_adjacency(A, method="hybrid", tb=tb, rest_thresh=tb * tb // 256, build_transpose=False,
                                device=cuda_device)
    r1 = {} if prep.r1_row is None else dict(r1_row=prep.r1_row.cpu().numpy(), r1_col=prep.r1_col.cpu().numpy())
    plan = K2.build_fused_plan(prep.bsr, prep.rest, attach_chunks=True, k_steps=k, **r1)
    base = prep.fused
    assert plan.num_steps > base.num_steps or k == 2
    assert torch.equal(plan.ring.step, base.ring.step)
    for f in ("seg_rb", "seg_lo", "seg_hi", "seg_part"):
        assert torch.equal(getattr(plan.ring.segments, f), getattr(base.ring.segments, f))
    ring = K2.fused_k_ring_shape_ok(K1._tile_mode(plan.B.tiles, tb), tb, P, plan.K, k)
    assert ring == (mode == "rank1" or k == 2)
    kern = K2.bsr_spmm_fused_k
    for hdtype in (torch.float32, torch.bfloat16):
        H = torch.randn(A.n_cols, P, device=cuda_device).to(hdtype)
        before = (kern.launches, kern.launches_ring, kern.launches_single)
        out = kern(plan, H)
        torch.cuda.synchronize()
        assert (kern.launches, kern.launches_ring, kern.launches_single) == (
            before[0] + 1, before[1] + int(ring), before[2] + int(not ring))
        assert out.dtype == torch.bfloat16 and out.shape == (A.n_rows, P)
        torch.testing.assert_close(out.float(), K2.bsr_spmm_fused_k_plain(plan, H).float(), rtol=2e-2, atol=2e-2)
        k2 = K2.bsr_spmm_fused(base, H)
        if ring and k == 2:
            assert torch.equal(out, k2)
        else:
            torch.testing.assert_close(out.float(), k2.float(), rtol=2e-2, atol=2e-2)
        assert not out[2 * tb: 3 * tb].any()


# ------------------------------------------ the gather K9 and the int8 ring K8


def _counts3(kern, a, b):
    return kern.launches, getattr(kern, a), getattr(kern, b)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "weighted,blk,be,P,hdtype",
    [(False, 128, 1024, 16, torch.float32), (True, 256, 2048, 8, torch.float32),
     (False, 1024, 1024, 128, torch.bfloat16), (True, 128, 1024, 200, torch.float32),
     (True, 256, 1024, 264, torch.bfloat16), (False, 256, 1024, 64, torch.float32)],
)
def test_plan_gather_matches_plain_and_walk(cuda_device, weighted, blk, be, P, hdtype):
    """The gather K9 on plan, plan_t and plan_with_vals, a split hub row,
    spare rows of H, one to two 256-feature slices: ``torch.equal`` to the
    walk of ``_k9_walk`` and within 1e-3 of the plain K9 (identical
    roundings, f32 sums in another order); every launch counted."""
    A = _graph(3001, weighted, seed=17)
    prep = pt.prepare_adjacency(A, method="pallas", rb=blk, cb=blk, be=be, device=cuda_device)
    assert prep.plan.segments.n_fin > 0
    H = torch.randn(A.n_cols + 5, P, device=cuda_device).to(hdtype)
    g = torch.randn(A.n_rows, P, device=cuda_device).to(hdtype)
    pv = K9.plan_with_vals(prep.plan, torch.rand(A.vals.shape[0], device=cuda_device))
    for plan, x in ((prep.plan, H), (prep.plan_t, g), (pv, H)):
        before = K9.spmm_plan.launches
        out = K9.spmm_plan(plan, x)
        torch.cuda.synchronize()
        assert K9.spmm_plan.launches == before + 1
        assert out.dtype == torch.float32 and out.shape == (plan.n_rows, P)
        assert torch.equal(out, gather_walk(plan, x))
        torch.testing.assert_close(out, K9.spmm_plan_plain(plan, x), rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("seg_slots", [1, 5, 16, 256])
def test_plan_gather_over_row_pieces(cuda_device, seg_slots):
    """The same slots cut into row pieces of 1 to 256 slots (the sweep of
    ROW_SEG_SLOTS): every cut within 1e-3 of the plain K9, rows without a
    slot exactly 0."""
    A = _int8_graph(2600, 18, empty_rb=2, tb=256)
    plan = K9.recut_rows(K9.plan_spmm(A, rb=256, cb=256, device=cuda_device), seg_slots)
    H = torch.randn(2600, 128, device=cuda_device)
    out = K9.spmm_plan(plan, H)
    torch.testing.assert_close(out, K9.spmm_plan_plain(plan, H), rtol=1e-3, atol=1e-3)
    assert (out[512:768] == 0).all()


@pytest.fixture(scope="module")
def hub_prep():
    """The pallas prep of 8192 nodes: random edges, 40 rows of 100-1000
    edges and two hub rows of 7000 (at 64 slots a piece, 2-16 pieces and
    110), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    n, rng = 8192, np.random.default_rng(21)
    rows = [rng.integers(0, n, 8 * n)]
    cols = [rng.integers(0, n, 8 * n)]
    mid = [(r, int(rng.integers(100, 1000))) for r in rng.choice(n, 40, replace=False)]
    for r, d in mid + [(5, 7000), (6000, 7000)]:
        rows.append(np.full(d, r))
        cols.append(rng.choice(n, d, replace=False))
    ei = np.unique(np.stack([np.concatenate(rows), np.concatenate(cols)]), axis=1)
    A = SparseMatrix.from_coo(ei[0], ei[1], rng.uniform(0.05, 1.0, ei.shape[1]).astype(np.float32), (n, n))
    prep = pt.prepare_adjacency(A, method="pallas", rb=256, cb=256, be=1024, device="cuda")
    assert int(K9.recut_rows(prep.plan, 64).segments.fin_np.max()) >= 100  # at every cut up to 64
    return A, prep


@pytest.mark.cuda
@pytest.mark.parametrize("seg_slots", [1, 5, 16, 64])
@pytest.mark.parametrize("P", [8, 64, 256, 264, 512, 100, 33])
def test_plan_split_rows_equal_walk(cuda_device, hub_prep, seg_slots, P):
    """K9 over row pieces of 1 to 64 slots, a hub row of >= 100 pieces, on
    plan, plan_t and plan_with_vals: the gather kernel (one to two
    256-feature slices; at P 100 and 33 on H padded to 104 and 40) is
    ``torch.equal`` to the walk of ``_k9_walk`` (bf16 roundings, piece sums
    in slot order, split rows in the fixed residue order) and within 1e-3 of
    the plain K9 (f32 sums in another order); ``launches`` moves by one at
    every P, ``launches_finalize`` by one where the plan has split rows."""
    A, prep = hub_prep
    H = torch.randn(A.n_cols + 5, P, device=cuda_device)
    pv = K9.plan_with_vals(prep.plan, torch.rand(A.vals.shape[0], device=cuda_device))
    for plan, x in ((prep.plan, H), (prep.plan_t, torch.randn(A.n_rows, P, device=cuda_device)), (pv, H)):
        plan = K9.recut_rows(plan, seg_slots)
        before = K9.spmm_plan.launches, K9.spmm_plan.launches_finalize
        out = K9.spmm_plan(plan, x)
        torch.cuda.synchronize()
        assert (K9.spmm_plan.launches, K9.spmm_plan.launches_finalize) == (
            before[0] + 1, before[1] + int(plan.segments.n_fin > 0))
        assert torch.equal(out, gather_walk(plan, x))
        torch.testing.assert_close(out, K9.spmm_plan_plain(plan, x), rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("P,offset,hdtype", [(7, 0, torch.float32), (16, 0, torch.float32), (33, 0, torch.float32),
                                             (100, 0, torch.float32), (128, 0, torch.float32),
                                             (128, 2, torch.float32), (64, 4, torch.bfloat16)])
def test_plan_gather_takes_every_width_and_address(cuda_device, P, offset, hdtype):
    """Every width and address runs the gather kernel, on plan, plan_t and
    plan_with_vals: an odd width or an H not aligned to 16 bytes (``offset``
    elements past an aligned one) through a zero-padded copy of H, one
    launch each, ``torch.equal`` to the walk of ``_k9_walk`` at width P."""
    A = _graph(1500, weighted=True, seed=19)
    prep = pt.prepare_adjacency(A, method="pallas", rb=256, cb=256, device=cuda_device)
    pv = K9.plan_with_vals(prep.plan, torch.rand(A.vals.shape[0], device=cuda_device))
    at = lambda n: torch.randn(n * P + offset, device=cuda_device).to(hdtype)[offset:].view(n, P)
    H, g = at(A.n_cols), at(A.n_rows)
    assert (H.data_ptr() % 16 != 0) == (offset != 0)
    for plan, x in ((prep.plan, H), (prep.plan_t, g), (pv, H)):
        before = K9.spmm_plan.launches
        out = K9.spmm_plan(plan, x)
        torch.cuda.synchronize()
        assert K9.spmm_plan.launches == before + 1
        assert out.shape == (plan.n_rows, P) and out.is_contiguous()
        assert torch.equal(out, gather_walk(plan, x))
        torch.testing.assert_close(out, K9.spmm_plan_plain(plan, x), rtol=1e-3, atol=1e-3)


def _int8_edge_graph(n, tb, seed):
    """Hub rows (dense tiles, a long run in row block 0), random edges (a
    remainder), row block 2 without an edge (a cover tile only), column
    block 3 with remainder edges only (a cover tile (0, 3) in the tile set),
    and some edges whose value quantizes to 0."""
    rng = np.random.default_rng(seed)
    hub = np.stack([rng.integers(0, tb // 2, 20 * n), rng.integers(0, n, 20 * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 3 * n)), hub, hub[::-1]], axis=1), axis=1)
    ei = ei[:, ei[0] // tb != 2]
    dense3 = (ei[1] // tb == 3) & (ei[0] < tb // 2)
    ei = ei[:, ~dense3]
    v = rng.uniform(0.01, 1.0, ei.shape[1]).astype(np.float32)
    v[rng.random(ei.shape[1]) < 0.05] = 1e-4  # on the unsigned grid: 0
    return SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))


def _int8_ring_plan(A, tb, attach, device, thresh=None):
    c_a = generate_constants(0.0, 1.0, 8, signed=False, w_qbits=8)
    part, rest = split_by_tile_density(A, tb, thresh or max(tb * tb // 600, 2))
    keys = K1.bsr_tile_keys(part, tb, cover_rows=True, cover_cols=True)
    B8 = Q.bsr_int8_from_sparse(part, c_a, tb=tb, cover_cols=True, device=device)
    return K2.build_fused_plan(B8, rest.with_vals(Q._quantize_vals(rest.vals, c_a)), attach_chunks=attach,
                               edge_tiles=Q.int8_edge_tiles(part, c_a, tb, keys))


@pytest.mark.cuda
@pytest.mark.parametrize("tb,P,attach", [(64, 16, True), (128, 128, False), (256, 128, True), (192, 144, False),
                                         (256, 32, False), (128, 272, True)])
def test_int8_ring_equals_plain_and_single_stage(cuda_device, tb, P, attach):
    """The int8 ring K8 over the tiles that carry an edge: torch.equal to the
    plain K8 and to the single-stage kernel, with cover tiles, chunk slots
    whose value is 0, dead slots, split runs and ragged feature slices."""
    n = 20 * tb + 45
    plan = _int8_ring_plan(_int8_edge_graph(n, tb, seed=tb + P), tb, attach, cuda_device)
    carry = (plan.B.tiles != -128).flatten(1).any(1)
    assert (~carry).any() and plan.num_rest_chunks > 0 and (plan.lrow == tb).any()
    assert plan.edge_ring.segments.n_fin > 0
    assert K2.int8_ring_shape_ok(tb, P, plan.K)
    Hq = torch.randint(-128, 128, (n, P), dtype=torch.int8, device=cuda_device)
    kern = K2.bsr_spmm_int8_fused
    before = _counts3(kern, "launches_ring", "launches_single")
    out = Q.int8_hybrid_agg(plan, Hq)
    torch.cuda.synchronize()
    assert _counts3(kern, "launches_ring", "launches_single") == (before[0] + 1, before[1] + 1, before[2])
    assert out.dtype == torch.int32 and out.shape == (n, P)
    assert torch.equal(out, K2.bsr_spmm_int8_fused_plain(plan, Hq))
    assert torch.equal(out, K2._bsr_spmm_int8_fused_single(plan, Hq))
    assert not out[2 * tb: 3 * tb].any()


@pytest.mark.cuda
def test_int8_ring_through_prepare(cuda_device):
    """prepare_int8_hybrid builds the ring schedule; the main entry point
    takes the ring kernel and equals the plain version."""
    A = _int8_edge_graph(3000, 128, seed=21)
    c_a = generate_constants(0.0, 1.0, 8, signed=False, w_qbits=8)
    plan = Q.prepare_int8_hybrid(A, c_a, tb=128, rest_thresh=40, device=cuda_device)
    assert plan.edge_ring is not None and plan.edge_ring.n_dead_tile_steps > 0
    Hq = torch.randint(-127, 128, (3000, 128), dtype=torch.int8, device=cuda_device)
    before = K2.bsr_spmm_int8_fused.launches_ring
    out = Q.int8_hybrid_agg(plan, Hq)
    assert K2.bsr_spmm_int8_fused.launches_ring == before + 1
    assert torch.equal(out, K2.bsr_spmm_int8_fused_plain(plan, Hq))


@pytest.mark.cuda
@pytest.mark.parametrize("tb,P,edge,offset,ring", [(128, 128, True, 0, True), (128, 8, True, 0, False),
                                                   (128, 100, True, 0, False), (32, 128, True, 0, False),
                                                   (128, 128, False, 0, False), (128, 128, True, 8, False)])
def test_int8_kernel_choice_reads_shape_and_schedule_only(cuda_device, tb, P, edge, offset, ring):
    """``int8_ring_shape_ok`` on a plan with ``edge_ring`` picks the ring
    kernel; other shapes, an unaligned Hq or a plan built without
    ``edge_tiles`` take the single-stage kernel; both equal the plain K8."""
    A = _int8_edge_graph(1600, max(tb, 64), seed=22)
    plan = _int8_ring_plan(A, tb, True, cuda_device)
    if not edge:
        plan = K2.build_fused_plan(plan.B, None)
    Hq = torch.randint(-127, 128, (1600 * P + offset,), dtype=torch.int8, device=cuda_device)[offset:].view(1600, P)
    kern = K2.bsr_spmm_int8_fused
    before = _counts3(kern, "launches_ring", "launches_single")
    out = kern(plan, Hq)
    torch.cuda.synchronize()
    assert _counts3(kern, "launches_ring", "launches_single") == (
        before[0] + 1, before[1] + int(ring), before[2] + int(not ring))
    assert torch.equal(out, K2.bsr_spmm_int8_fused_plain(plan, Hq))


@pytest.mark.cuda
def test_stage_hqt_kernel_equals_plain(cuda_device):
    """The int8 ring's pre-pass: Hq transposed, zero columns past n_valid."""
    for n, P in ((1000, 16), (4100, 128), (700, 144)):
        Hq = torch.randint(-128, 128, (n, P), dtype=torch.int8, device=cuda_device)
        rows = (n + 63) // 64 * 64
        out = K1._stage_hqt(Hq, rows, n - 3)
        torch.cuda.synchronize()
        assert torch.equal(out, K1.stage_hqt_plain(Hq, rows, n - 3))
