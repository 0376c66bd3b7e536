"""A power-law graph with class communities, made on the device from the
seed with one ``torch.Generator``: the same seed on the same kind of
device gives the same graph.

Nodes get uniform labels over ``num_classes``. Edges are undirected:

- a ring: each node to its next ``ring`` ids (a band of ``2 * ring``
  directed edges a node, which also keeps every node connected);
- a Chung-Lu tail that carries the rest of the mean degree. Each node has
  an expected degree from a power law of exponent ``exponent``
  (``P(k) ~ k^-exponent``): ``(rank + i0)^(-1 / (exponent - 1))``, scaled
  to the mean, with ``i0`` set so that the largest is ``max_degree``
  (where absent, ``sqrt(n * mean_degree)``, the largest a Chung-Lu graph
  holds without its hubs' edges collapsing into duplicates). The ranks
  go to the nodes at random, so no range of ids holds the hubs. An edge's
  source is drawn by weight; its destination by weight among the nodes of
  the source's class with probability ``in_class``, else among all.

Draws repeat until the directed edges, without self-loops and duplicates,
come within 0.5% below ``mean_degree`` a node.
"""

from __future__ import annotations

import math

import torch

from portbench.gen import Graph, labelled

SHORT = 0.005  # the share of the target's edges the draws may fall short by


def expected_degrees(n: int, mean: float, exponent: float, max_degree: float, device) -> torch.Tensor:
    """``(rank + i0)^(-1 / (exponent - 1))`` over ranks 0..n-1, scaled to
    ``mean``, with ``i0`` such that the largest is ``max_degree`` (float64)."""
    beta = 1.0 / (exponent - 1.0)
    rank = torch.arange(n, dtype=torch.float64, device=device)
    ratio = lambda i0: float((i0 ** -beta) / ((rank + i0) ** -beta).mean())
    lo, hi = math.log(1e-6), math.log(float(n))
    for _ in range(80):  # the largest over the mean falls as i0 grows
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if ratio(math.exp(mid)) > max_degree / mean else (lo, mid)
    w = (rank + math.exp(hi)) ** -beta
    return w * (mean / w.mean())


def make(cfg: dict, seed: int, device) -> Graph:
    p, n, classes = cfg["graph"], cfg["num_nodes"], cfg["num_classes"]
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randint(0, classes, (n,), generator=g, device=device)
    ring = p["ring"]
    target = int(round(n * cfg["mean_degree"]))
    tail_mean = cfg["mean_degree"] - 2 * ring
    cap = p.get("max_degree") or math.sqrt(n * cfg["mean_degree"])
    w = expected_degrees(n, tail_mean, p["exponent"], cap - 2 * ring, device)
    w = w[torch.randperm(n, generator=g, device=device)]

    order = torch.argsort(y, stable=True)  # the nodes class by class
    cdf = torch.cumsum(w[order], 0)
    total = float(cdf[-1])
    count = torch.bincount(y, minlength=classes)
    end = torch.cumsum(count, 0)
    start = end - count
    lo = torch.where(start > 0, cdf[(start - 1).clamp(min=0)], torch.zeros_like(cdf[:1]))
    hi = cdf[(end - 1).clamp(min=0)]
    f64 = dict(dtype=torch.float64, device=device)

    def draw(m: int):
        src = order[torch.searchsorted(cdf, torch.rand(m, generator=g, **f64) * total, right=True).clamp_(max=n - 1)]
        c = y[src]
        inside = torch.rand(m, generator=g, device=device) < p["in_class"]
        u = torch.rand(m, generator=g, **f64)
        u = torch.where(inside, lo[c] + u * (hi[c] - lo[c]), u * total)
        i = torch.searchsorted(cdf, u, right=True)
        i = torch.where(inside, torch.minimum(torch.maximum(i, start[c]), end[c] - 1), i.clamp(max=n - 1))
        return src, order[i]

    i = torch.arange(n, device=device).repeat_interleave(ring)
    j = (i + torch.arange(1, ring + 1, device=device).repeat(n)) % n
    key = torch.unique(torch.cat([i * n + j, j * n + i]))
    del i, j
    while key.numel() < target * (1.0 - SHORT):
        src, dst = draw((target - key.numel() + 1) // 2)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        key = torch.unique(torch.cat([key, src * n + dst, dst * n + src]))  # sorted
    edges = torch.stack([key // n, key % n])
    del key
    return labelled(edges, y, cfg["num_features"], g)
