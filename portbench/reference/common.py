"""Plain PyTorch pieces of the reference: the normalized adjacency worked
out from the benchmark's edges, the precision of a run, the loss and
Adam. Imports nothing of the program.

The reference computes in float32 with TF32 off. Its control lowers each
precision the configuration states by one step: the float32 GEMMs run in
TF32, and the bfloat16 operands of the aggregation run in
fp8 (e4m3, one scale a tensor), with float32 accumulation as before.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference rounds: ``fp8`` rounds the kernels' operands to
    fp8 e4m3 (scaled so the largest magnitude is 448), ``tf32`` lets the
    GEMMs run in TF32."""

    fp8: bool = False
    tf32: bool = False

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        s = t.detach().abs().amax() / 448.0
        if float(s) == 0.0:
            return t
        q = (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return t + (q - t.detach())  # the rounded value, the gradient of t

    @contextlib.contextmanager
    def gemms(self):
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


EXACT = Precision()
CONTROL = Precision(fp8=True, tf32=True)


class Adjacency:
    """``D^-1/2 A D^-1/2`` of the benchmark's directed edges (both
    directions, no self-loops; a node's degree is its count of edges), as
    the forward and the transposed CSR."""

    def __init__(self, edges: torch.Tensor, n: int):
        r, c = edges[0], edges[1]
        deg = torch.bincount(r, minlength=n).to(torch.float64)
        dis = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
        vals = (dis[r] * dis[c]).to(torch.float32)
        self.A = torch.sparse_csr_tensor(_rowptr(r, n), c, vals, (n, n))
        order = torch.argsort(c * n + r)
        self.At = torch.sparse_csr_tensor(_rowptr(c[order], n), r[order], vals[order], (n, n))

    def agg(self, H: torch.Tensor, prec: Precision) -> torch.Tensor:
        return _Agg.apply(self, prec, H)


def _rowptr(rows: torch.Tensor, n: int) -> torch.Tensor:
    counts = torch.bincount(rows, minlength=n)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


class _Agg(torch.autograd.Function):
    """``A @ H``, and ``A^T @ G`` backward, each with its operand and its
    product rounded as the precision says (the port's aggregation takes
    and gives bfloat16, its configuration says, so the control's takes and
    gives fp8)."""

    @staticmethod
    def forward(ctx, adj: Adjacency, prec: Precision, H):
        ctx.adj, ctx.prec = adj, prec
        return prec.operand(torch.sparse.mm(adj.A, prec.operand(H).contiguous()))

    @staticmethod
    def backward(ctx, G):
        gH = torch.sparse.mm(ctx.adj.At, ctx.prec.operand(G).contiguous())
        return None, None, ctx.prec.operand(gH)


def masked_xent(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows of ``mask``."""
    m = mask.to(torch.float32)
    return torch.sum(F.cross_entropy(logits, y, reduction="none") * m) / torch.clamp(m.sum(), min=1.0)


def dropout_mask(shape, seed: int, draw: int, p: float, device) -> torch.Tensor:
    """The keep-mask of the ``draw``-th (0-based) dropout of a generator
    seeded with ``seed``: ``torch.rand(shape) < 1 - p``, as inverted
    dropout draws it."""
    g = torch.Generator(device=device).manual_seed(seed)
    for _ in range(draw):
        torch.rand(shape, generator=g, device=device)
    return torch.rand(shape, generator=g, device=device) < 1.0 - p


class Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8, no weight decay) over a dict of
    leaves, its moments starting at zero."""

    def __init__(self, theta: Dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in theta.items()}
        self.v = {k: torch.zeros_like(v) for k, v in theta.items()}

    @torch.no_grad()
    def step(self, theta: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        for k, p in theta.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + 1e-8))


def train_steps(forward, theta0: Dict[str, torch.Tensor], data, calls: List[dict], lr: float,
                p_drop: float, hidden_shape, prec: Precision) -> dict:
    """The reference's steps from ``theta0``: each of ``calls`` is one call
    of the training loop, ``{"seed": s, "epochs": k}``, which starts a
    fresh Adam and a dropout generator seeded with ``s``, and takes ``k``
    steps (forward on a new dropout mask, masked cross-entropy, backward,
    Adam). Returns the loss of every step, the first step's gradient by
    leaf and the final leaves."""
    theta = {k: v.detach().clone() for k, v in theta0.items()}
    losses, first_grad = [], None
    for call in calls:
        opt = Adam(theta, lr)
        for k in range(call["epochs"]):
            keep = dropout_mask(hidden_shape, call["seed"], k, p_drop, data.x.device)
            leaves = {n: v.detach().requires_grad_(True) for n, v in theta.items()}
            with prec.gemms():
                loss = masked_xent(forward(leaves, data.x, keep, prec), data.y, data.train_mask)
                grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            del keep
            losses.append(float(loss.detach()))
            if first_grad is None:
                first_grad = {n: g.detach().clone() for n, g in grads.items()}
            opt.step(theta, grads)
    return dict(losses=losses, first_grad=first_grad, theta=theta)
