"""The host side and the data flow of the gather K9
(``csrc/plan_spmm_gather.cu``), on the CPU, against the plain K9 and the
JAX package's Pallas kernel in interpret mode on the same numpy inputs.

The kernel reads the compacted slot arrays ``SpMMPlan.slot_cv`` (each live
slot's global column and value, in ``slot_idx`` order), H rounded to bf16
once, and sums each row piece of ``plan.segments`` in slot order; a split
row's pieces are summed in a fixed order (for each feature, the pieces of
each residue mod 8 in increasing order, then the 8 residues' sums in
order). ``_k9_walk.gather_walk`` repeats that walk in PyTorch."""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import pallas_spmm as jps
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.ops import dispatch as tdis
from sgracex1_tpu_torch.ops import pallas_spmm as tps

from _k9_walk import gather_walk

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

WALK = 1e-5  # the plain K9's roundings; only a split row's pieces add in another order
KERNEL = 1e-4  # against the Pallas kernel: f32 sums in another order


def _case(n, m, density, seed=0, hub=False):
    """A random matrix; ``hub``: rows 0-2 linked to most columns (rows split
    into pieces); density < 0: rows 256..767 without an edge."""
    rng = np.random.default_rng(seed)
    mat = sp.random(n, m, density=abs(density), format="lil", random_state=seed).astype(np.float32)
    if density < 0:
        mat[256:768] = 0
    if hub:
        for r in range(3):
            mat[r, rng.choice(m, size=int(0.8 * m), replace=False)] = rng.uniform(0.1, 1.0, int(0.8 * m))
    mat = mat.tocsr()
    mat.eliminate_zeros()
    coo = mat.tocoo()
    J = JSparse.from_coo(coo.row, coo.col, coo.data, mat.shape)
    T = TSparse.from_coo(coo.row, coo.col, coo.data, mat.shape)
    return J, T, mat, rng


def _slot_arrays(plan):
    slot = plan.slot_idx.long()
    col = plan.tile_cb.long()[slot // plan.be] * plan.cb + plan.lcol.reshape(-1)[slot].long()
    return col, plan.val.reshape(-1)[slot]


def _assert_compacted(plan):
    col, val = _slot_arrays(plan)
    assert plan.slot_cv.dtype == torch.int32 and plan.slot_cv.shape == (plan.nnz, 2)
    assert torch.equal(plan.slot_cv[:, 0].long(), col)
    assert torch.equal(plan.slot_cv[:, 1].contiguous().view(torch.float32), val)


@pytest.mark.parametrize("n,m,density", [(300, 300, 0.05), (1500, 900, 0.01), (257, 129, 0.3),
                                         (100, 100, 0.0), (900, 700, -0.03)])
@pytest.mark.parametrize("rb,cb,be", [(256, 256, 1024), (128, 128, 2048)])
def test_compacted_slot_arrays(n, m, density, rb, cb, be):
    """slot_cv holds tile_cb[slot // be] * cb + lcol[slot] and val[slot] at
    slot_idx, for the plan, its transpose and after value substitution."""
    _, T, _, rng = _case(n, m, density)
    plan = tps.plan_spmm(T, rb=rb, cb=cb, be=be)
    _assert_compacted(plan)
    _assert_compacted(tps.plan_spmm(T.transpose(), rb=cb, cb=rb, be=be))
    vals = torch.from_numpy(rng.uniform(-1.0, 1.0, T.vals.shape[0]).astype(np.float32))
    pv = tps.plan_with_vals(plan, vals)
    _assert_compacted(pv)
    assert torch.equal(pv.slot_cv[:, 0], plan.slot_cv[:, 0])
    # the value map of the quantized path remaps slot_cv with val
    _assert_compacted(plan.with_val(plan.val * 0.5 - 0.25))


def test_map_adjacency_vals_keeps_slot_values_in_step():
    _, T, _, _ = _case(600, 600, 0.02, seed=2)
    prep = tdis.prepare_adjacency(T, method="pallas", rb=256, cb=256, device="cpu")
    mapped = tdis.map_adjacency_vals(prep, lambda v: v * 3.0)
    for plan in (mapped.plan, mapped.plan_t):
        _assert_compacted(plan)
    torch.testing.assert_close(mapped.plan.slot_cv[:, 1].contiguous().view(torch.float32),
                               prep.plan.slot_cv[:, 1].contiguous().view(torch.float32) * 3.0)


@pytest.mark.parametrize("n,m,density,hub", [(300, 300, 0.05, False), (1500, 900, 0.01, True),
                                             (257, 129, 0.3, False), (900, 700, -0.03, True)])
@pytest.mark.parametrize("P,dtype", [(128, "float32"), (16, "bfloat16"), (264, "float32")])
def test_gather_walk_matches_plain_and_pallas(n, m, density, hub, P, dtype):
    """The kernel's walk equals the plain K9 to 1e-5 and the Pallas kernel
    (interpret mode) to 1e-4 on the rows it writes; rows without an edge
    come out 0."""
    J, T, mat, rng = _case(n, m, density, seed=1, hub=hub)
    H = rng.standard_normal((m, P)).astype(np.float32)
    Ht = torch.from_numpy(H).to(getattr(torch, dtype))
    plan = tps.plan_spmm(T, rb=256, cb=256, be=1024)
    if hub:
        assert plan.segments.n_fin > 0
    got = gather_walk(plan, Ht)
    torch.testing.assert_close(got, tps.spmm_plan_plain(plan, Ht), rtol=WALK, atol=WALK)
    want = np.asarray(jps.spmm_pallas(jps.plan_spmm(J, rb=256, cb=256, be=1024),
                                      jnp.asarray(H).astype(getattr(jnp, dtype)), interpret=True))
    rows = np.ones(n, bool)
    if density < 0:
        # the Pallas kernel leaves a row block without a group unwritten
        rows[256:768] = False
        assert (got.numpy()[~rows] == 0).all()
    np.testing.assert_allclose(got.numpy()[rows], want[rows], rtol=KERNEL, atol=KERNEL)


@pytest.mark.parametrize("seg_slots", [1, 3, 64, 1000])
def test_gather_walk_over_row_pieces(seg_slots):
    """recut_rows cuts every row into pieces of at most seg_slots slots in
    row order; the walk at any cut stays within 1e-5 of the plain K9."""
    _, T, _, rng = _case(900, 800, 0.02, seed=4, hub=True)
    plan = tps.recut_rows(tps.plan_spmm(T, rb=128, cb=128), seg_slots)
    S = plan.segments
    lo, hi = S.seg_lo.numpy(), S.seg_hi.numpy()
    assert (hi - lo).sum() == T.nnz and (hi - lo).max() <= seg_slots
    assert set(S.seg_rb.tolist()) == set(range(900))
    H = torch.from_numpy(rng.standard_normal((800, 24)).astype(np.float32))
    torch.testing.assert_close(gather_walk(plan, H), tps.spmm_plan_plain(plan, H), rtol=WALK, atol=WALK)


@pytest.mark.parametrize("P,ptr,ok", [(8, 0, True), (16, 64, True), (128, 1024, True), (264, 16, True),
                                      (100, 0, False), (33, 0, False), (4, 0, False), (128, 8, False)])
def test_gather_shape_rule(P, ptr, ok):
    """The gather kernel's operand is round_up(P, 8) wide; H is read (or
    staged) as it is only where its rows are whole 16-byte bf16 pieces at a
    16-byte-aligned address (``ok``), and is otherwise first copied into a
    zero-padded tensor of that width."""
    assert tps._gather_operand(P, ptr) == (-(-P // 8) * 8, not ok)
