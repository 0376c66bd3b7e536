"""Plain GCN node classifier: ``num_layers`` convolutions
``A_hat @ (H @ W)`` with ReLU on all but the last, inverted dropout, a
linear head. The port's ``GCNModel``; OGB's products GCN puts dropout
after every hidden layer, has a bias in each convolution and its last
convolution gives the classes (the configuration file lists each
departure). Weights ``[in, out]``; the head as ``torch.nn.Linear``."""

from __future__ import annotations

import math

import torch

from portbench.reference.common import Adjacency, Precision


def leaves(cfg: dict):
    """``(name, shape, init bound)`` of every parameter, in the model's order."""
    f, h, c = cfg["num_features"], cfg["hidden_channels"], cfg["num_classes"]
    out = []
    for i in range(cfg["num_layers"]):
        fi = f if i == 0 else h
        out.append((f"conv{i + 1}.weight", (fi, h), 1.414 * math.sqrt(6.0 / (fi + h))))
    b = 1.0 / math.sqrt(h)
    return out + [("head.weight", (c, h), b), ("head.bias", (c,), b)]


def hidden_shape(cfg: dict, n: int):
    """The shape dropout draws its mask for."""
    return (n, cfg["hidden_channels"])


def forward(cfg: dict, adj: Adjacency, theta: dict, x: torch.Tensor, keep, prec: Precision) -> torch.Tensor:
    h = x
    for i in range(cfg["num_layers"]):
        h = adj.agg(torch.matmul(h, theta[f"conv{i + 1}.weight"]), prec)
        if i < cfg["num_layers"] - 1:
            h = torch.relu(h)
    if keep is not None:
        p = cfg["dropout"]
        h = torch.where(keep, h / (1.0 - p), torch.zeros_like(h))
    return torch.matmul(h, theta["head.weight"].T) + theta["head.bias"]
