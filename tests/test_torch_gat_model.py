"""The GAT serving path at small size: prepare_adjacency(for_gat=True)
layouts against the JAX package's, and GATModel logits from the flax
model's parameters (params_from_jax) on full-cover, hybrid and edge-path
adjacencies. Plus GATConv's attention read-back, its unported options and
gradients through the flash path."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sgracex1_tpu.graph import datasets as j_ds
from sgracex1_tpu.graph import normalize as j_norm
from sgracex1_tpu.graph import reorder as j_reorder
from sgracex1_tpu.nn.layers import GATConv as JGATConv
from sgracex1_tpu.nn.models import GATModel as JGAT
from sgracex1_tpu.ops import dispatch as jdis
import sgracex1_tpu_torch as pt
from sgracex1_tpu_torch.graph import datasets as t_ds
from sgracex1_tpu_torch.graph import reorder as t_reorder
from sgracex1_tpu_torch.nn import GATConv, params_from_jax

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _graphs(n, F=24, C=5):
    """The slice's graph at size n in both packages: power-law, sym_norm
    (fill-0 self-loops), degree order."""
    d = j_ds.powerlaw_node_classification(n=n, num_features=F, num_classes=C, seed=0)
    J = j_norm.sym_norm(d.edge_index, n)
    perm = j_reorder.degree_order(J)
    J, _ = j_reorder.permute_graph(J, perm)
    e = t_ds.powerlaw_node_classification(n=n, num_features=F, num_classes=C, seed=0)
    T = pt.sym_norm(e.edge_index, n)
    T, _ = t_reorder.permute_graph(T, t_reorder.degree_order(T))
    x = d.x[perm]
    return J, T, x


# layout: n, the JAX chooser's (tb, packed, rest_thresh) forced by
# monkeypatch (None: its own rule), and the port's keywords
LAYOUTS = {
    "full": (2048, None, {}),
    "full-packed": (2048, (1024, True, None), dict(gat_tb=1024)),
    "hybrid": (600, (64, False, 3), dict(gat_tb=64, gat_rest_thresh=3)),
}


def _preps(layout, monkeypatch, method="xla"):
    n, forced, kw = LAYOUTS[layout]
    J, T, x = _graphs(n)
    if forced is not None:
        monkeypatch.setattr(jdis, "_choose_flash_plan", lambda A, n, hybrid=True, train=True: forced)
    jp = jdis.prepare_adjacency(J, method=method, for_gat=True)
    tp = pt.prepare_adjacency(T, method=method, for_gat=True, **kw, device="cpu")
    return jp, tp, x


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_for_gat_layout_identical(layout, monkeypatch):
    jp, tp, _ = _preps(layout, monkeypatch)
    jb, tb = jp.flash_tiles, tp.flash_tiles
    assert tb is tp.gat_bsr and (tb.tb, tb.packed, tb.tiles.dtype) == (
        jb.tb, layout == "full-packed", torch.uint8 if layout == "full-packed" else torch.int8
    )
    for k in ("tiles", "tile_rb", "tile_cb"):
        np.testing.assert_array_equal(np.asarray(getattr(jb, k)), getattr(tb, k).numpy(), err_msg=k)
    assert (tp.gat_plan is None) == (jp.gat_plan is None) == (layout != "hybrid")
    if layout != "hybrid":
        return
    jr, tr = jp.gat_rest, tp.gat_rest
    assert jr.nnz == tr.nnz > 0 and (np.asarray(tr.vals)[: tr.nnz] > 0).all()
    for k in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, k))[: jr.nnz], getattr(tr, k).numpy()[: tr.nnz])
    pj, pl = jp.gat_plan, tp.gat_plan
    assert pl.B is tp.gat_bsr and pl.colscale is None and pl.K == pj.K == 128
    for k in ("step_rb", "step_cb", "step_tile", "step_chunk", "step_kind", "slot_col", "slot_scale"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, k)), getattr(pl, k).numpy(), err_msg=k)
    np.testing.assert_array_equal(np.asarray(pj.lrow)[:, 0, :], pl.lrow.numpy())
    assert pl.num_rest_chunks == pj.num_rest_chunks > 0
    # tile edges and chunk edges partition the positive edges
    assert int((tp.gat_bsr.tiles > 0).sum()) + tr.nnz == int((tp.A.vals > 0).sum())


def test_for_gat_rule_and_reuse():
    _, T, _ = _graphs(2048)
    # a bsr prep's own tiles serve the flash kernels: nothing is attached
    bsr = pt.prepare_adjacency(T, method="bsr", rank1=False, for_gat=True, build_transpose=False, device="cpu")
    assert bsr.gat_bsr is None and bsr.flash_tiles is bsr.bsr and bsr.bsr.tiles.dtype == torch.bfloat16
    # the fixed rule: full cover at tb=256 up to 8192 nodes, else hybrid
    small = pt.prepare_adjacency(T, method="xla", for_gat=True, device="cpu")
    assert small.gat_plan is None and small.gat_bsr.tb == 256
    hyb = pt.prepare_adjacency(T, method="xla", for_gat=True, gat_rest_thresh=8, device="cpu")
    assert hyb.gat_plan is not None and hyb.gat_bsr.tb == pt.ops.dispatch.DEFAULT_GAT_TB
    # a hybrid GCN prep's partial tiles are no mask: the layout is attached
    h = pt.prepare_adjacency(T, method="hybrid", tb=128, for_gat=True, build_transpose=False, device="cpu")
    assert h.gat_bsr is not None and h.flash_tiles is h.gat_bsr


def _jax_model(jp, x, F=24, hidden=16, C=5, H=2):
    model = JGAT(num_features=F, hidden_channels=hidden, num_classes=C, nheads=H)
    variables = model.init(jax.random.PRNGKey(0), jp, jnp.asarray(x))
    net = pt.GATModel(F, hidden, C, nheads=H)
    net.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    return model, variables, net.eval()


@pytest.mark.parametrize("layout", ["full", "hybrid", "edge"])
def test_gat_logits_match_jax(layout, monkeypatch):
    if layout == "edge":
        J, T, x = _graphs(600)
        jp, tp = J, T
    else:
        jp, tp, x = _preps(layout, monkeypatch)
    model, variables, net = _jax_model(jp, x)
    logits_j = np.asarray(model.apply(variables, jp, jnp.asarray(x)))
    before = (pt.ops.flash_gat.flash_gat_forward.launches, pt.ops.flash_gat.flash_gat_hybrid_forward.launches)
    with torch.no_grad():
        logits_t = net(tp, torch.from_numpy(x))
    # CPU tensors run the plain versions: no launch counted
    assert before == (pt.ops.flash_gat.flash_gat_forward.launches, pt.ops.flash_gat.flash_gat_hybrid_forward.launches)
    assert logits_t.shape == logits_j.shape and torch.isfinite(logits_t).all()
    np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=2e-2, atol=2e-2)
    # every route against the port's f32 edge path
    with torch.no_grad():
        ref = net(tp if layout == "edge" else tp.A, torch.from_numpy(x))
    np.testing.assert_allclose(logits_t.numpy(), ref.numpy(), rtol=5e-2, atol=5e-2)


def test_return_attention_matches_jax(monkeypatch):
    jp, tp, x = _preps("hybrid", monkeypatch)
    conv = JGATConv(24, 8, nheads=3)
    variables = conv.init(jax.random.PRNGKey(2), jp, jnp.asarray(x))
    out_j, (e_j, s_j) = conv.apply(variables, jp, jnp.asarray(x), relu=True, return_attention=True)
    tconv = GATConv(24, 8, nheads=3)
    p = variables["params"]
    tconv.load_state_dict({k: torch.from_numpy(np.array(p[k])) for k in ("weight", "attention")})
    with torch.no_grad():
        out_t, (e_t, s_t) = tconv(tp, torch.from_numpy(x), relu=True, return_attention=True)
    assert e_t.shape == s_t.shape == (3, tp.A.rows.shape[0])
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=2e-2, atol=2e-2)
    assert (out_t >= 0).all()


def test_gat_unported_options_raise():
    # the quantized datapath is ported: quant= is kept and changes the output
    q = pt.quant.CalibrationTable.for_qbits(8).layer_params(0)
    conv = GATConv(4, 4, quant=q, generator=torch.Generator().manual_seed(1))
    plain = GATConv(4, 4)
    plain.load_state_dict(conv.state_dict())
    A3 = pt.sym_norm(np.array([[0, 1, 2], [1, 2, 0]]), 3)
    x3 = torch.rand(3, 4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert not torch.allclose(conv(A3, x3), plain(A3, x3))
    assert GATConv(4, 4, exact_gradients=True).exact_gradients  # ported now
    assert pt.nn.GCNConv(4, 4, quant=q).quant is q
    A = pt.prepare_adjacency(pt.sym_norm(np.array([[0, 1, 2], [1, 2, 0]]), 3), method="xla", for_gat=True, device="cpu")
    net = pt.GATModel(8, 4, 3, nheads=2, generator=torch.Generator().manual_seed(0))
    # training works now: the flash path takes gradients (K3 with K4/K5)
    out = net.eval()(A, torch.ones(3, 8))
    out.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in net.parameters())
    with torch.no_grad():
        torch.testing.assert_close(net(A, torch.ones(3, 8)), out.detach())
