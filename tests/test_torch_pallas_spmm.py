"""sgracex1_tpu_torch.ops.pallas_spmm against sgracex1_tpu.ops.pallas_spmm:
the plan arrays element for element (the JAX arrays reshaped ``(-1, be)``),
value substitution, and the plain K9 against the Pallas kernel in interpret
mode and against scipy, on the same numpy inputs."""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

from sgracex1_tpu.graph.csr import SparseMatrix as JSparse
from sgracex1_tpu.ops import pallas_spmm as jps
from sgracex1_tpu_torch.graph.csr import SparseMatrix as TSparse
from sgracex1_tpu_torch.ops import pallas_spmm as tps

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

KERNEL = 1e-4  # the same bf16 roundings in both; f32 sums in another order
SCIPY = 5e-2  # bf16 operands against the f32 product (the JAX test's limit)

# the shapes of tests/test_pallas_spmm.py (the empty matrix too) and a
# matrix whose middle row blocks hold no edge
CASES = [(300, 300, 0.05), (1500, 900, 0.01), (257, 129, 0.3), (100, 100, 0.0), (900, 700, -1.0)]


def _case(n, m, density, seed=0):
    rng = np.random.default_rng(seed)
    if density < 0:  # rows 256..767 empty: two row blocks without a group at rb=256
        mat = sp.random(n, m, density=0.03, format="lil", random_state=seed).astype(np.float32)
        mat[256:768] = 0
        mat = mat.tocsr()
        mat.eliminate_zeros()
    else:
        mat = sp.random(n, m, density=density, format="csr", random_state=seed).astype(np.float32)
    coo = mat.tocoo()
    J = JSparse.from_coo(coo.row, coo.col, coo.data, mat.shape)
    T = TSparse.from_coo(coo.row, coo.col, coo.data, mat.shape)
    return J, T, mat, rng


def _assert_same_plan(tp, jp):
    be = jp.be
    assert (tp.be, tp.num_groups, tp.rb, tp.cb, tp.nnz) == (be, jp.num_groups, jp.rb, jp.cb, jp.nnz)
    assert (tp.n_rows, tp.n_cols) == (jp.n_rows, jp.n_cols)
    for name in ("lrow", "lcol", "val", "perm"):
        t = getattr(tp, name)
        j = np.asarray(getattr(jp, name)).reshape(-1, be)
        assert t.dtype == (torch.float32 if name == "val" else torch.int32)
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    for name in ("tile_rb", "tile_cb"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)


@pytest.mark.parametrize("n,m,density", CASES)
@pytest.mark.parametrize("rb,cb,be", [(256, 256, 1024), (128, 128, 2048)])
def test_plan_arrays_identical(n, m, density, rb, cb, be):
    J, T, mat, _ = _case(n, m, density)
    tp = tps.plan_spmm(T, rb=rb, cb=cb, be=be)
    _assert_same_plan(tp, jps.plan_spmm(J, rb=rb, cb=cb, be=be))
    # the launch schedule: every live slot once, by output row then slot
    live = np.flatnonzero(tp.perm.numpy().reshape(-1) >= 0)
    idx = tp.slot_idx.numpy()
    assert sorted(idx.tolist()) == live.tolist() and len(idx) == T.nnz
    row = tp.tile_rb.numpy()[idx // be] * rb + tp.lrow.numpy().reshape(-1)[idx]
    assert (np.diff(row) >= 0).all()
    assert ((np.diff(idx) > 0) | (np.diff(row) > 0)).all()
    S = tp.segments
    assert S.n_seg >= n and set(S.seg_rb.tolist()) == set(range(n))
    hi, lo = S.seg_hi.numpy(), S.seg_lo.numpy()
    assert (hi - lo).sum() == T.nnz and (hi - lo).max(initial=0) <= tps.ROW_SEG_SLOTS
    for r, a, b in zip(S.seg_rb.tolist(), lo.tolist(), hi.tolist()):
        assert (row[a:b] == r).all()


def test_plan_rejects_edge_block():
    _, T, _, _ = _case(100, 100, 0.05)
    with pytest.raises(ValueError, match="multiple of 1024"):
        tps.plan_spmm(T, be=512)


def test_plan_with_vals_identical():
    J, T, mat, rng = _case(500, 400, 0.03, seed=3)
    vals = rng.uniform(-1.0, 1.0, T.vals.shape[0]).astype(np.float32)
    tp = tps.plan_with_vals(tps.plan_spmm(T, rb=256, cb=128, be=1024), torch.from_numpy(vals))
    jp = jps.plan_with_vals(jps.plan_spmm(J, rb=256, cb=128, be=1024), jnp.asarray(vals))
    _assert_same_plan(tp, jp)
    assert tp.val.dtype == torch.float32
    # the transposed plan reads the same edge order
    tt = tps.plan_with_vals(tps.plan_spmm(T.transpose(), rb=128, cb=256, be=1024), torch.from_numpy(vals))
    jt = jps.plan_with_vals(jps.plan_spmm(J.transpose(), rb=128, cb=256, be=1024), jnp.asarray(vals))
    _assert_same_plan(tt, jt)


@pytest.mark.parametrize("n,m,density", CASES)
@pytest.mark.parametrize("P,dtype", [(128, "float32"), (100, "float32"), (16, "bfloat16")])
def test_plain_k9_matches_pallas_and_scipy(n, m, density, P, dtype):
    J, T, mat, rng = _case(n, m, density, seed=1)
    H = rng.standard_normal((m, P)).astype(np.float32)
    Ht = torch.from_numpy(H).to(getattr(torch, dtype))
    Hj = jnp.asarray(H).astype(getattr(jnp, dtype))
    tp = tps.plan_spmm(T, rb=256, cb=256, be=1024)
    jp = jps.plan_spmm(J, rb=256, cb=256, be=1024)
    out = tps.spmm_plan(tp, Ht)  # a CPU tensor: the plain version
    assert out.dtype == torch.float32 and out.shape == (n, P)
    torch.testing.assert_close(out, tps.spmm_plan_plain(tp, Ht), rtol=0, atol=0)
    want = np.asarray(jps.spmm_pallas(jp, Hj, interpret=True))
    rows = np.ones(n, bool)
    if density < 0:
        # the Pallas kernel zeroes an out block on its first visit, so it
        # leaves a row block without a group unwritten; here it is A @ H: 0
        rows[256:768] = False
        assert (out.numpy()[~rows] == 0).all()
    np.testing.assert_allclose(out.numpy()[rows], want[rows], rtol=KERNEL, atol=KERNEL)
    np.testing.assert_allclose(out.numpy(), mat @ Ht.float().numpy(), rtol=SCIPY, atol=SCIPY)


def test_plain_k9_extra_rows_of_h_and_transpose():
    """H may hold more rows than n_cols; the transposed plan gives A^T @ g."""
    J, T, mat, rng = _case(420, 300, 0.04, seed=5)
    H = rng.standard_normal((333, 24)).astype(np.float32)
    tp = tps.plan_spmm(T, rb=128, cb=128, be=1024)
    out = tps.spmm_plan(tp, torch.from_numpy(H))
    np.testing.assert_allclose(out.numpy(), mat @ H[:300], rtol=SCIPY, atol=SCIPY)
    g = rng.standard_normal((420, 24)).astype(np.float32)
    tt = tps.plan_spmm(T.transpose(), rb=128, cb=128, be=1024)
    jt = jps.plan_spmm(J.transpose(), rb=128, cb=128, be=1024)
    got = tps.spmm_plan(tt, torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, np.asarray(jps.spmm_pallas(jt, jnp.asarray(g), interpret=True)),
                               rtol=KERNEL, atol=KERNEL)
    np.testing.assert_allclose(got, mat.T @ g, rtol=SCIPY, atol=SCIPY)


def test_wrapper_device_rule_and_counter():
    _, T, _, _ = _case(100, 100, 0.05)
    tp = tps.plan_spmm(T, rb=128, cb=128)
    before = tps.spmm_plan.launches
    tps.spmm_plan(tp, torch.zeros(100, 4))
    assert tps.spmm_plan.launches == before  # the plain version counts nothing
    with pytest.raises(ValueError, match="cpu or cuda"):
        tps.spmm_plan(tp, torch.zeros(100, 4, device="meta"))
    moved = tp.to("cpu")
    assert moved.be == tp.be and moved.segments.n_seg == tp.segments.n_seg
