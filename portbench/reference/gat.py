"""Plain GAT node classifier with skip connections, as PyTorch Geometric's
``examples/ogbn_products_gat.py`` builds it: ``num_layers`` ``GATConv``
layers of ``heads`` heads, the last averaging its heads into the classes,
each with a linear skip from its input (``x = conv(x) + skip(x)``), ELU and
dropout after every layer but the last. The loss is the NLL of
``log_softmax``, which the harness's cross-entropy on the logits computes.

``GATConv`` (PyG's defaults): ``Wh = x @ W`` (no bias, ``W`` shared by the
source and target sides of a full-graph layer), per head the scores
``a_dst . Wh[i]`` and ``a_src . Wh[j]``, an edge j -> i's logit
``LeakyReLU(score_dst[i] + score_src[j], 0.2)``, a softmax over each target's
edges and one self-loop a node (stored self-loops removed first; the
benchmark's edges have none), the weighted sum of ``Wh[j]``, heads
concatenated or averaged, plus a bias. No attention dropout.

The attention runs as a ``torch.autograd.Function`` in blocks of edges, so
that no ``[E, H, F]`` tensor exists (at 2^20 nodes one would be ~110 GB):
the forward keeps the per-edge probabilities ``[E, H]``, the backward is
the softmax's Jacobian, ``dE = p (q - sum_row p q) lr'`` with ``q = gO[i] .
Wh[j]``. Float32 throughout, TF32 off (``Precision.gemms``). The control's
``Precision`` rounds the gathered ``Wh`` and the cotangent ``gO`` (the port's
bf16 operands) to fp8.

Departures, each also in the configuration's ``assumed``: full-batch
training on the whole graph (PyG trains on NeighborSampler batches); the
weights' layout is the port's (``conv{i}.weight`` ``[in, H * F]``,
``conv{i}.attention`` ``[2 H F, 1]``: the target halves, then the source
halves; ``skip{i}`` as ``torch.nn.Linear``). Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import Adjacency, Precision

ALPHA = 0.2  # GATConv's negative_slope
BLOCK = 1 << 20  # edges a block of the attention's gathers


def _widths(cfg: dict):
    """``(f_in, F, concat)`` of each layer."""
    H, hid, L = cfg["heads"], cfg["hidden_channels"], cfg["num_layers"]
    return [(cfg["num_features"] if i == 0 else H * hid, cfg["num_classes"] if i == L - 1 else hid, i < L - 1)
            for i in range(L)]


def leaves(cfg: dict):
    """``(name, shape, init bound)`` of every parameter: ``GATConv``'s glorot
    ``lin`` and attention vectors (over ``[1, H, F]``: ``sqrt(6 / (H + F))``),
    zero bias; the skips as ``torch.nn.Linear`` (``1 / sqrt(fan_in)``)."""
    H, out = cfg["heads"], []
    for i, (fi, f, concat) in enumerate(_widths(cfg)):
        width = H * f if concat else f
        out += [
            (f"conv{i + 1}.weight", (fi, H * f), math.sqrt(6.0 / (fi + H * f))),
            (f"conv{i + 1}.attention", (2 * f * H, 1), math.sqrt(6.0 / (H + f))),
            (f"conv{i + 1}.bias", (width,), 0.0),
        ]
    for i, (fi, f, concat) in enumerate(_widths(cfg)):
        width = H * f if concat else f
        b = 1.0 / math.sqrt(fi)
        out += [(f"skip{i + 1}.weight", (width, fi), b), (f"skip{i + 1}.bias", (width,), b)]
    return out


def hidden_shape(cfg: dict, n: int):
    """The shape of one step's dropout draw: every hidden layer's mask."""
    return (cfg["num_layers"] - 1, n, cfg["heads"] * cfg["hidden_channels"])


def edges(adj: Adjacency):
    """Targets and sources of the adjacency's edges without self-loops,
    then one self-loop a node."""
    A = adj.A
    n = A.shape[0]
    crow = A.crow_indices()
    r = torch.repeat_interleave(torch.arange(n, device=crow.device), crow[1:] - crow[:-1])
    c = A.col_indices().long()
    keep = r != c
    own = torch.arange(n, device=crow.device)
    return torch.cat([r[keep], own]), torch.cat([c[keep], own]), n


def _blocks(E: int):
    for i in range(0, E, BLOCK):
        yield slice(i, i + BLOCK)


class _Attention(torch.autograd.Function):
    """``out[i] = sum_j p_ij Wh[j]`` over the edges ``(r, c)``, a softmax a
    target and head, in blocks of edges."""

    @staticmethod
    def forward(ctx, graph, prec: Precision, s_dst, s_src, Wh):
        r, c, n = graph
        pre = s_dst.index_select(0, r) + s_src.index_select(0, c)
        e = F.leaky_relu(pre, ALPHA)
        top = torch.full((n, e.shape[1]), float("-inf"), device=e.device)
        top = top.scatter_reduce(0, r[:, None].expand_as(e), e, "amax")
        p = torch.exp(e - top.index_select(0, r))
        del e
        den = torch.zeros_like(top).index_add_(0, r, p)
        p /= den.index_select(0, r)
        out = torch.zeros((n, *Wh.shape[1:]), device=Wh.device)
        for b in _blocks(r.shape[0]):
            out.index_add_(0, r[b], Wh.index_select(0, c[b]) * p[b, :, None])
        ctx.graph, ctx.prec = graph, prec
        ctx.save_for_backward(Wh, p, pre > 0)
        return out

    @staticmethod
    def backward(ctx, gO):
        Wh, p, pos = ctx.saved_tensors
        r, c, n = ctx.graph
        g = ctx.prec.operand(gO.contiguous())
        q = torch.empty_like(p)
        dWh = torch.zeros_like(Wh)
        for b in _blocks(r.shape[0]):
            gr = g.index_select(0, r[b])
            q[b] = (gr * Wh.index_select(0, c[b])).sum(-1)
            dWh.index_add_(0, c[b], gr * p[b, :, None])
        t = torch.zeros((n, p.shape[1]), device=p.device).index_add_(0, r, p * q)
        dE = p * (q - t.index_select(0, r)) * torch.where(pos, 1.0, ALPHA)
        ds_dst = torch.zeros_like(t).index_add_(0, r, dE)
        ds_src = torch.zeros_like(t).index_add_(0, c, dE)
        return None, None, ds_dst, ds_src, dWh


def forward(cfg: dict, adj: Adjacency, theta: dict, x: torch.Tensor, keep, prec: Precision) -> torch.Tensor:
    graph = edges(adj)
    H, L, p = cfg["heads"], cfg["num_layers"], cfg["dropout"]
    h = x
    for i, (fi, f, concat) in enumerate(_widths(cfg)):
        k = i + 1
        Wh = torch.matmul(h, theta[f"conv{k}.weight"]).view(-1, H, f)
        a = theta[f"conv{k}.attention"].view(2, H, f)
        s_dst, s_src = (Wh * a[0]).sum(-1), (Wh * a[1]).sum(-1)
        out = _Attention.apply(graph, prec, s_dst, s_src, prec.operand(Wh))
        out = out.reshape(-1, H * f) if concat else out.mean(dim=1)
        out = out + theta[f"conv{k}.bias"]
        out = out + torch.matmul(h, theta[f"skip{k}.weight"].T) + theta[f"skip{k}.bias"]
        if i < L - 1:
            out = F.elu(out)
            if keep is not None:
                out = torch.where(keep[i], out / (1.0 - p), torch.zeros_like(out))
        h = out
    return h
