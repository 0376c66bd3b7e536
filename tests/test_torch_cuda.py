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
from sgracex1_tpu_torch.ops.dispatch import split_by_tile_density
from sgracex1_tpu_torch.quant import int8 as Q
from sgracex1_tpu_torch.quant.affine import generate_constants

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
