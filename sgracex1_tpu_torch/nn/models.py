"""GCN and GAT node-classification models as ``torch.nn.Module``s."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sgracex1_tpu_torch.nn.layers import GATConv, GCNConv


class GCNModel(nn.Module):
    """``num_layers`` GCN convolutions (ReLU on all but the last), dropout,
    and a linear head: the reference's 2-layer node classifier by default.

    Parameters are named ``conv1.weight`` ... ``convN.weight``,
    ``head.weight``, ``head.bias`` (see ``nn/convert.params_from_jax``).
    Dropout draws from the ``generator`` passed to ``forward``."""

    def __init__(
        self,
        num_features: int,
        hidden_channels: int,
        num_classes: int,
        *,
        dropout: float = 0.5,
        num_layers: int = 2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.num_layers = num_layers
        for i in range(num_layers):
            f_in = num_features if i == 0 else hidden_channels
            self.add_module(
                f"conv{i + 1}",
                GCNConv(f_in, hidden_channels, generator=generator),
            )
        self.head = nn.Linear(hidden_channels, num_classes)

    def forward(
        self, A, x: torch.Tensor, *, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        for i in range(self.num_layers):
            conv = getattr(self, f"conv{i + 1}")
            x = conv(A, x, relu=i < self.num_layers - 1)
        return self.head(_dropout(self, x, generator))


def _dropout(model: nn.Module, x: torch.Tensor, generator) -> torch.Tensor:
    """Inverted dropout at rate ``model.dropout`` in training mode, drawn
    from ``generator``; identity in eval mode."""
    if not model.training or model.dropout <= 0:
        return x
    keep = 1.0 - model.dropout
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class GATModel(nn.Module):
    """2-layer GAT node classifier: ``conv1`` with ``nheads`` heads and
    ReLU, ``conv2`` with one head, dropout, a linear head (the JAX
    ``GATModel``).

    Parameters are named ``conv{1,2}.weight``, ``conv{1,2}.attention``,
    ``head.weight``, ``head.bias`` (see ``nn/convert.params_from_jax``)."""

    def __init__(
        self,
        num_features: int,
        hidden_channels: int,
        num_classes: int,
        *,
        nheads: int = 1,
        alpha: float = 0.2,
        dropout: float = 0.5,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.conv1 = GATConv(
            num_features, hidden_channels, nheads=nheads, alpha=alpha,
            generator=generator,
        )
        self.conv2 = GATConv(
            hidden_channels * nheads, hidden_channels, nheads=1, alpha=alpha,
            generator=generator,
        )
        self.head = nn.Linear(hidden_channels, num_classes)

    def forward(
        self, A, x: torch.Tensor, *, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        x = self.conv1(A, x, relu=True)
        x = self.conv2(A, x)
        return self.head(_dropout(self, x, generator))
