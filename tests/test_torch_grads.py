"""Gradients of the training slice against sgracex1_tpu: agg_matmul on
every ported backend (K2 on the transposed plan, K1 on the transposed
tiles, dense, edge list), GATConv's repaired score stop-gradient, and the
parameter gradients of both models against ``jax.grad`` of the flax models
on the same parameters and layouts."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sgracex1_tpu.nn.layers import GATConv as JGATConv
from sgracex1_tpu.ops import dispatch as jdis
from sgracex1_tpu_torch.nn import GATConv, params_from_jax
from sgracex1_tpu_torch.ops import dispatch as tdis

from _torch_common import graph, jax_thresh, model_pair, np_tree, to_jax

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

FUSED = 2e-2  # K2 rounds forward and grad_H through bf16
EXACT = 1e-3  # identical bf16 operands (K1) or f32 paths; sums in another order
PLAN = 1e-4  # K9 on plan_t: the same bf16 roundings in both packages, f32 sums


@pytest.mark.parametrize(
    "method,fuse,values",
    [("hybrid", True, "symnorm"), ("hybrid", True, "weighted"), ("hybrid", False, "symnorm"),
     ("bsr", False, "weighted"), ("dense", True, "symnorm"), ("xla", True, "weighted"),
     ("pallas", True, "symnorm"), ("pallas", True, "weighted")],
)
def test_agg_matmul_grads_match_jax(method, fuse, values):
    J, T = graph(values)
    jp = jdis.prepare_adjacency(J, method=method, tb=128, fuse=fuse)
    thresh = jax_thresh(128, jp.r1_row is not None) if method == "hybrid" else None
    tp = tdis.prepare_adjacency(T, method=method, tb=128, rest_thresh=thresh, fuse=fuse, device="cpu")
    assert tp.kind == jp.kind == method
    if method in ("bsr", "hybrid"):
        assert (tp.fused_t is not None) == fuse and tp.bsr_t is not None
    if method == "hybrid":
        assert tp.rest.nnz == jp.rest.nnz > 0
    rng = np.random.default_rng(22)
    H = rng.standard_normal((T.n_cols, 24)).astype(np.float32)
    R = rng.standard_normal((T.n_rows, 24)).astype(np.float32)
    want = jax.grad(lambda h: jnp.vdot(jdis.agg_matmul(jp, h), jnp.asarray(R)))(jnp.asarray(H))
    Ht = torch.from_numpy(H).requires_grad_(True)
    (tdis.agg_matmul(tp, Ht) * torch.from_numpy(R)).sum().backward()
    tol = FUSED if fuse and method in ("bsr", "hybrid") else PLAN if method == "pallas" else EXACT
    np.testing.assert_allclose(Ht.grad.numpy(), np.asarray(want), rtol=tol, atol=tol)
    # A^T @ R, the gradient's definition
    np.testing.assert_allclose(Ht.grad.numpy(), T.to_scipy().T @ R, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("fuse", [True, False])
def test_backward_without_transpose_raises(fuse):
    _, T = graph("symnorm", n=384)
    tp = tdis.prepare_adjacency(T, method="hybrid", tb=128, rest_thresh=8, fuse=fuse,
                                build_transpose=False, device="cpu")
    H = torch.randn(384, 4, requires_grad=True)
    out = tdis.agg_matmul(tp, H)  # the forward needs no transpose
    with pytest.raises(ValueError, match="build_transpose"):
        out.sum().backward()


def test_pallas_backward_without_transpose_raises():
    """The name is from when it did: the pallas kind builds ``plan_t``
    whatever ``build_transpose`` says, as the JAX package, so a prep made
    for serving trains too. Both backwards against ``jax.grad`` at the
    pallas tolerance."""
    J, T = graph("weighted", n=384)
    jp = jdis.prepare_adjacency(J, method="pallas", rb=128, cb=128, build_transpose=False)
    tp = tdis.prepare_adjacency(T, method="pallas", rb=128, cb=128, build_transpose=False, device="cpu")
    assert tp.plan_t is not None and jp.plan_t is not None
    rng = np.random.default_rng(23)
    H = rng.standard_normal((384, 8)).astype(np.float32)
    R = rng.standard_normal((384, 8)).astype(np.float32)
    vals = np.asarray(T.vals, np.float32)
    want = jax.grad(lambda h: jnp.vdot(jdis.agg_matmul(jp, h), jnp.asarray(R)))(jnp.asarray(H))
    want_v = jax.grad(
        lambda h: jnp.vdot(jdis.agg_matmul_with_vals(jp, jnp.asarray(vals), h), jnp.asarray(R))
    )(jnp.asarray(H))
    for agg, ref in (
        (lambda h: tdis.agg_matmul(tp, h), want),
        (lambda h: tdis.agg_matmul_with_vals(tp, torch.from_numpy(vals), h), want_v),
    ):
        Ht = torch.from_numpy(H).requires_grad_(True)
        (agg(Ht) * torch.from_numpy(R)).sum().backward()
        np.testing.assert_allclose(Ht.grad.numpy(), np.asarray(ref), rtol=PLAN, atol=PLAN)


@pytest.mark.parametrize("kind", ["pallas", "hybrid"])
def test_agg_matmul_with_vals_grads_match_jax(kind):
    """Both gradients of A(vals) @ H against jax.grad at 1e-4: grad_H by K9
    on plan_t with the same values, grad_vals the SDDMM of the cotangent;
    the hybrid kind runs the f32 edge path in both packages."""
    J, T = graph("weighted")
    kw = dict(tb=128) if kind == "hybrid" else dict(rb=256, cb=256)
    jp = jdis.prepare_adjacency(J, method=kind, **kw)
    tp = tdis.prepare_adjacency(T, method=kind, device="cpu", **kw)
    rng = np.random.default_rng(25)
    vals = (rng.uniform(0.1, 1.0, T.vals.shape[0]) * (T.vals != 0)).astype(np.float32)
    H = rng.standard_normal((T.n_cols, 24)).astype(np.float32)
    R = rng.standard_normal((T.n_rows, 24)).astype(np.float32)
    gv, gh = jax.grad(
        lambda v, h: jnp.vdot(jdis.agg_matmul_with_vals(jp, v, h), jnp.asarray(R)), argnums=(0, 1)
    )(jnp.asarray(vals), jnp.asarray(H))
    vt = torch.from_numpy(vals).requires_grad_(True)
    Ht = torch.from_numpy(H).requires_grad_(True)
    out = tdis.agg_matmul_with_vals(tp, vt, Ht)
    (out * torch.from_numpy(R)).sum().backward()
    live = slice(0, T.nnz)  # padding entries carry no edge
    np.testing.assert_allclose(vt.grad.numpy()[live], np.asarray(gv)[live], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Ht.grad.numpy(), np.asarray(gh), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Ht.grad.numpy(), T.with_vals(vals).to_scipy().T @ R, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("exact", [False, True])
def test_gatconv_grads_match_flax(exact):
    """The scores read Wh detached unless exact_gradients: weight.grad
    equals the JAX layer's either way (edge path)."""
    _, T = graph("symnorm", n=300)
    J = to_jax(T)
    rng = np.random.default_rng(23)
    x = rng.standard_normal((300, 12)).astype(np.float32)
    R = rng.standard_normal((300, 3 * 8)).astype(np.float32)
    jconv = JGATConv(12, 8, nheads=3, exact_gradients=exact)
    variables = jconv.init(jax.random.PRNGKey(3), J, jnp.asarray(x))

    def loss(params):
        out = jconv.apply({**variables, "params": params}, J, jnp.asarray(x), relu=True)
        return jnp.vdot(out, jnp.asarray(R))

    want = np_tree(jax.grad(loss)(variables["params"]))
    conv = GATConv(12, 8, nheads=3, exact_gradients=exact)
    conv.load_state_dict({k: torch.from_numpy(np.array(variables["params"][k])) for k in ("weight", "attention")})
    (conv(T, torch.from_numpy(x), relu=True) * torch.from_numpy(R)).sum().backward()
    for k in ("weight", "attention"):
        np.testing.assert_allclose(getattr(conv, k).grad.numpy(), want[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["gcn", "gat-full", "gat-hybrid", "gcn-pallas"])
def test_model_param_grads_match_flax(kind, monkeypatch):
    d, e, jp, tp, model, variables, net = model_pair(kind, monkeypatch=monkeypatch)
    R = np.random.default_rng(24).standard_normal((d.x.shape[0], 4)).astype(np.float32)

    def loss(params):
        logits = model.apply({**variables, "params": params}, jp, jnp.asarray(d.x))
        return jnp.vdot(logits, jnp.asarray(R))

    want = params_from_jax(np_tree(jax.grad(loss)(variables["params"])))
    (net(tp, torch.from_numpy(e.x)) * torch.from_numpy(R)).sum().backward()
    got = dict(net.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].grad.numpy()
        # bf16 rounding error scales with each leaf's own largest gradient
        scale = float(np.abs(w.numpy()).max())
        assert scale > 0, k
        tol = PLAN if kind == "gcn-pallas" else FUSED
        np.testing.assert_allclose(g, w.numpy(), rtol=tol, atol=tol * scale, err_msg=k)
