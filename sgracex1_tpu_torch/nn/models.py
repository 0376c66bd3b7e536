"""GCN node-classification model as a ``torch.nn.Module``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sgracex1_tpu_torch.nn.layers import GCNConv


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
        if self.training and self.dropout > 0:
            keep = 1.0 - self.dropout
            mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        return self.head(x)
