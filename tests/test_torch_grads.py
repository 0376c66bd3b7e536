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


@pytest.mark.parametrize(
    "method,fuse,values",
    [("hybrid", True, "symnorm"), ("hybrid", True, "weighted"), ("hybrid", False, "symnorm"),
     ("bsr", False, "weighted"), ("dense", True, "symnorm"), ("xla", True, "weighted")],
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
    tol = FUSED if fuse and method in ("bsr", "hybrid") else EXACT
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


@pytest.mark.parametrize("kind", ["gcn", "gat-full", "gat-hybrid"])
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
        np.testing.assert_allclose(g, w.numpy(), rtol=FUSED, atol=FUSED * scale, err_msg=k)
