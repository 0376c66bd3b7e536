"""Inputs of a run, made from its seed on the device.

The graph comes from the generator a configuration names
(``graph.generator``): ``portbench/graphs/<generator>.py``, whose
``make(cfg, seed, device)`` gives a ``Graph``. ``weights`` makes every
parameter of a model in one uniform draw, each leaf scaled to the bound
its family's reference gives. ``refresh`` overwrites a share of the
features, as an inference request's traffic does.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, List, Tuple

import torch


@dataclasses.dataclass
class Graph:
    """An undirected graph as directed edges (both directions, no
    self-loops, sorted by (row, col)) with node features, labels and
    split masks, all on one device."""

    edges: torch.Tensor  # int64 [2, E]
    x: torch.Tensor  # float32 [n, F]
    y: torch.Tensor  # int64 [n]
    train_mask: torch.Tensor  # bool [n]
    val_mask: torch.Tensor
    test_mask: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]


def graph(cfg: dict, seed: int, device) -> Graph:
    """The graph of configuration ``cfg`` from its generator's module."""
    mod = importlib.import_module(f"portbench.graphs.{cfg['graph']['generator']}")
    return mod.make(cfg, seed, device)


def labelled(edges: torch.Tensor, y: torch.Tensor, num_features: int, g: torch.Generator) -> Graph:
    """A graph of ``edges`` and labels ``y`` with class-correlated Gaussian
    features (a standard normal centre a class plus standard normal noise)
    and a 60/20/20 split of the nodes at random."""
    n, device = y.shape[0], y.device
    centers = torch.randn(int(y.max()) + 1, num_features, generator=g, device=device)
    x = centers[y] + torch.randn(n, num_features, generator=g, device=device)
    perm = torch.randperm(n, generator=g, device=device)
    masks = torch.zeros(3, n, dtype=torch.bool, device=device)
    a, b = int(n * 0.6), int(n * 0.8)
    masks[0, perm[:a]] = True
    masks[1, perm[a:b]] = True
    masks[2, perm[b:]] = True
    return Graph(edges, x, y, masks[0], masks[1], masks[2])


def weights(shapes: List[Tuple[str, Tuple[int, ...], float]], seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``(name, shape, bound)`` leaves: one uniform
    draw in [-1, 1) over all of them from ``seed``, each leaf scaled by its
    bound (a bound of 0 gives zeros, as a bias starts)."""
    sizes = [math.prod(s) for _, s, _ in shapes]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=g, device=device).mul_(2).sub_(1)
    out = {}
    for (name, shape, bound), part in zip(shapes, torch.split(flat, sizes)):
        out[name] = (part * bound).reshape(shape).contiguous()
    return out


def refresh(x: torch.Tensor, share: float, seed: int) -> None:
    """Overwrite the features of ``share`` of the nodes in place: distinct
    nodes and standard normal values, both drawn from ``seed``."""
    n, f = x.shape
    g = torch.Generator(device=x.device).manual_seed(seed)
    idx = torch.randperm(n, generator=g, device=x.device)[: max(1, int(n * share))]
    x[idx] = torch.randn(idx.numel(), f, generator=g, device=x.device)
