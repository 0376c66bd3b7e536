"""The plan attention's CUDA kernels (``csrc/plan_gat.cu``) against their
plain PyTorch versions on the card.

Imports only torch and the port (no jax), so it runs on a GPU machine
without the JAX package:
``SGRACE_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_plan_gat_cuda.py``.
Without a card every test skips.

Tolerances: the kernels and the plain versions take the same bf16 rows and
f32 scores, and both round nothing else; they differ in the order of their
f32 sums (a kernel lane sums its piece's slots in slot order, the head's
dot product over a tree of lanes, split rows merged in piece order; the
plain versions sum by ``index_add``) and in the exponential (``__expf``, a
few ulp from ``torch.exp`` over the softmax's range). So every output is
held to 2e-5 of its largest magnitude, about 100 f32 ulp: a slot dropped,
a wrong head or a lost piece moves an output by a share of its row's
weight, orders of magnitude more. The row max ``m`` is a max of the same
f32 scores, and is held equal."""

import dataclasses

import numpy as np
import pytest
import torch

import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.ops import dispatch as D
from sgracex1_tpu_torch.ops import plan_gat as PG
from sgracex1_tpu_torch.ops.pallas_spmm import recut_rows

TOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _graph(n=3000, seed=0):
    """Random edges, 40 hub rows and columns of 100-600 edges (split rows in
    both plans), the last 30 nodes isolated."""
    rng = np.random.default_rng(seed)
    m = n - 30
    ei = [rng.integers(0, m, (2, 8 * n))]
    for h in rng.integers(0, m, 40):
        far = rng.integers(0, m, int(rng.integers(100, 600)))
        ei += [np.stack([np.full_like(far, h), far]), np.stack([far, np.full_like(far, h)])]
    ei = np.concatenate(ei, axis=1)
    ei = ei[:, ei[0] != ei[1]]
    return pt.sym_norm(np.unique(ei, axis=1), n)


def _preps(device, cut=None):
    A = _graph()
    cpu = D.prepare_adjacency(A, method="pallas", rb=256, cb=256, device="cpu")
    if cut:
        cpu = dataclasses.replace(cpu, plan=recut_rows(cpu.plan, cut), plan_t=recut_rows(cpu.plan_t, cut))
    dev = dataclasses.replace(cpu, plan=cpu.plan.to(device), plan_t=cpu.plan_t.to(device))
    assert cpu.plan.segments.n_fin > 0 and cpu.plan_t.segments.n_fin > 0
    return A, cpu, dev


def _close(got, want, what):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape, what
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    assert gap <= TOL * max(scale, 1e-30), (what, gap, scale)


def _operands(n, H, F, device, seed=1):
    g = torch.Generator().manual_seed(seed)
    Fp = PG.plan_gat_width(H, F)
    s1, s2 = torch.randn(n, H, generator=g) * 2, torch.randn(n, H, generator=g) * 2
    Wh, gO = torch.randn(n, H, F, generator=g), torch.randn(n, H, F, generator=g)
    cpu = dict(s1=s1, s2=s2, Whs=PG.stage(Wh, Fp), gOs=PG.stage(gO, Fp))
    return cpu, {k: v.to(device) for k, v in cpu.items()}


CASES = [(4, 128, True), (4, 47, True), (1, 128, False), (4, 47, False), (2, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,F,loops", CASES)
@pytest.mark.parametrize("cut", [None, 8])
def test_forward_kernel_matches_plain(cuda_device, H, F, loops, cut):
    """Split rows at the plan's cut (ROW_SEG_SLOTS) and at 8 slots; the
    last layer's 4 x 47 = 188-wide rows staged at 4 x 48."""
    _, cpu, dev = _preps(cuda_device, cut)
    c, d = _operands(cpu.plan.n_rows, H, F, cuda_device)
    want = PG.plan_gat_fwd(cpu.plan, c["s1"], c["s2"], c["Whs"], self_loops=loops)
    before = PG.plan_gat_agg.launches
    got = PG.plan_gat_fwd(dev.plan, d["s1"], d["s2"], d["Whs"], self_loops=loops)
    torch.cuda.synchronize()
    assert PG.plan_gat_agg.launches == before + 1
    _close(got[0], want[0], "out")
    assert torch.equal(got[1].cpu(), want[1]), "m"
    _close(got[2], want[2], "l")
    if not loops:  # the isolated rows: nothing attended
        assert float(got[0][-30:].abs().max()) == 0.0 and float(got[2][-30:].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("H,F,loops", CASES)
@pytest.mark.parametrize("cut", [None, 8])
def test_backward_kernels_match_plain(cuda_device, H, F, loops, cut):
    _, cpu, dev = _preps(cuda_device, cut)
    c, d = _operands(cpu.plan.n_rows, H, F, cuda_device)
    _, m, l = PG.plan_gat_fwd(cpu.plan, c["s1"], c["s2"], c["Whs"], self_loops=loops)
    md, ld = m.to(cuda_device), l.to(cuda_device)
    kw = dict(self_loops=loops)
    want = PG.plan_gat_bwd_rows(cpu.plan, c["s1"], c["s2"], m, l, c["Whs"], c["gOs"], **kw)
    got = PG.plan_gat_bwd_rows(dev.plan, d["s1"], d["s2"], md, ld, d["Whs"], d["gOs"], **kw)
    for name, g, w in zip(("t", "u1", "u2"), got, want):
        _close(g, w, name)
    t = want[0]
    want = PG.plan_gat_bwd_cols(cpu.plan_t, c["s1"], c["s2"], m, l, t, c["Whs"], c["gOs"], **kw)
    got = PG.plan_gat_bwd_cols(dev.plan_t, d["s1"], d["s2"], md, ld, t.to(cuda_device), d["Whs"], d["gOs"], **kw)
    torch.cuda.synchronize()
    _close(got[0], want[0], "dWh")
    _close(got[1], want[1], "ds2")


@pytest.mark.cuda
def test_layer_entry_and_counters(cuda_device):
    """``plan_gat_agg`` under autograd on the card against the CPU's plain
    path: the output and the three gradients, one launch of each kernel,
    and a merge counted for each (both plans have split rows)."""
    _, cpu, dev = _preps(cuda_device)
    g = torch.Generator().manual_seed(3)
    n, H, F = cpu.plan.n_rows, 4, 47
    s1, s2, Wh, gO = (torch.randn(n, H, generator=g), torch.randn(n, H, generator=g),
                      torch.randn(n, H, F, generator=g), torch.randn(n, H, F, generator=g))
    res = {}
    for name, prep, dv in (("cpu", cpu, "cpu"), ("cuda", dev, cuda_device)):
        leaves = [x.detach().to(dv).requires_grad_(True) for x in (s1, s2, Wh)]
        before = {k: getattr(PG.plan_gat_agg, k) for k in
                  ("launches", "launches_bwd_rows", "launches_bwd_cols", "launches_merge")}
        out = PG.plan_gat_agg(prep, *leaves, self_loops=True)
        out.backward(gO.to(dv))
        res[name] = [out.detach()] + [x.grad for x in leaves]
        after = {k: getattr(PG.plan_gat_agg, k) - v for k, v in before.items()}
    assert after == dict(launches=1, launches_bwd_rows=1, launches_bwd_cols=1, launches_merge=3)
    for what, a, b in zip(("out", "ds1", "ds2", "dWh"), res["cuda"], res["cpu"]):
        _close(a, b, what)


@pytest.mark.cuda
def test_model_step_through_the_kernels(cuda_device):
    """A ``GATSkipModel`` step on a ``for_gat`` pallas prep at 16384 nodes:
    the plan attention runs (its counters move, no flash kernel launches)
    and the gradients equal the CPU's plain path's to round-off."""
    from sgracex1_tpu_torch.ops import flash_gat as FG

    rng = np.random.default_rng(4)
    n = 16384
    ei = rng.integers(0, n, (2, 30 * n))
    ei = np.concatenate([ei, ei[::-1]], axis=1)
    A = pt.sym_norm(np.unique(ei[:, ei[0] != ei[1]], axis=1), n)
    prep = D.prepare_adjacency(A, method="pallas", for_gat=True, device=cuda_device)
    assert prep.gat_on_plan and prep.choice["gat"] == "plan"
    cpu = D.prepare_adjacency(A, method="pallas", for_gat=True, device="cpu")
    net = pt.GATSkipModel(24, 16, 5, num_layers=3, heads=4, dropout=0.0)
    x = torch.randn(n, 24, generator=torch.Generator().manual_seed(0))
    grads = {}
    flash = FG.flash_gat_forward.launches
    for name, p, dv in (("cuda", prep, cuda_device), ("cpu", cpu, "cpu")):
        m = net.to(dv)
        m.zero_grad()
        before = PG.plan_gat_agg.launches_bwd_cols
        m(p, x.to(dv)).square().sum().backward()
        if name == "cuda":
            assert PG.plan_gat_agg.launches_bwd_cols == before + 3
        grads[name] = {k: q.grad.detach().cpu().clone() for k, q in m.named_parameters()}
    assert FG.flash_gat_forward.launches == flash
    for k in grads["cpu"]:
        gap = float((grads["cuda"][k] - grads["cpu"][k]).norm() / grads["cpu"][k].norm())
        assert gap < 1e-3, (k, gap)


@pytest.mark.cuda
def test_shape_rule_rejects_unstaged_widths(cuda_device):
    _, _, dev = _preps(cuda_device)
    n = dev.plan.n_rows
    with pytest.raises(ValueError):
        PG.plan_gat_fwd(dev.plan, torch.zeros(n, 4, device=cuda_device), torch.zeros(n, 4, device=cuda_device),
                        torch.zeros(n, 4, 47, dtype=torch.bfloat16, device=cuda_device))
