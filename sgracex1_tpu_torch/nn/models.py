"""GCN and GAT node-classification models and the molecule
graph-classification model as ``torch.nn.Module``s."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sgracex1_tpu_torch.nn.layers import GATConv, GCNConv
from sgracex1_tpu_torch.quant.calibration import CalibrationTable


class GCNModel(nn.Module):
    """``num_layers`` GCN convolutions (ReLU on all but the last), dropout,
    and a linear head: the reference's 2-layer node classifier by default.

    Parameters are named ``conv1.weight`` ... ``convN.weight``,
    ``head.weight``, ``head.bias`` (see ``nn/convert.params_from_jax``).
    Dropout draws from the ``generator`` passed to ``forward``. With
    ``calibration`` the convolutions run the fake-quant datapath: conv1
    on the table's layer-1 constants, every later one on its layer-2
    constants."""

    def __init__(
        self,
        num_features: int,
        hidden_channels: int,
        num_classes: int,
        *,
        calibration: Optional[CalibrationTable] = None,
        dropout: float = 0.5,
        num_layers: int = 2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.num_layers = num_layers
        for i in range(num_layers):
            f_in = num_features if i == 0 else hidden_channels
            q = calibration.layer_params(i) if calibration else None
            self.add_module(
                f"conv{i + 1}",
                GCNConv(f_in, hidden_channels, quant=q, generator=generator),
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
    ``head.weight``, ``head.bias`` (see ``nn/convert.params_from_jax``).
    ``calibration`` as in ``GCNModel``."""

    def __init__(
        self,
        num_features: int,
        hidden_channels: int,
        num_classes: int,
        *,
        nheads: int = 1,
        alpha: float = 0.2,
        calibration: Optional[CalibrationTable] = None,
        dropout: float = 0.5,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        q1 = calibration.layer_params(0) if calibration else None
        q2 = calibration.layer_params(1) if calibration else None
        self.conv1 = GATConv(
            num_features, hidden_channels, nheads=nheads, alpha=alpha,
            quant=q1, generator=generator,
        )
        self.conv2 = GATConv(
            hidden_channels * nheads, hidden_channels, nheads=1, alpha=alpha,
            quant=q2, generator=generator,
        )
        self.head = nn.Linear(hidden_channels, num_classes)

    def forward(
        self, A, x: torch.Tensor, *, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        x = self.conv1(A, x, relu=True)
        x = self.conv2(A, x)
        return self.head(_dropout(self, x, generator))


def global_mean_pool(x: torch.Tensor, graph_ids: torch.Tensor, num_graphs: int) -> torch.Tensor:
    """Mean of the node rows of each graph (PyG's ``global_mean_pool``):
    ``[num_graphs, F]``, zero for a graph without nodes. Sums and counts
    are taken in float32 whatever ``x``'s dtype."""
    idx = graph_ids.long()
    sums = torch.zeros((num_graphs, x.shape[1]), dtype=torch.float32, device=x.device)
    sums.index_add_(0, idx, x.float())
    counts = torch.zeros((num_graphs, 1), dtype=torch.float32, device=x.device)
    counts.index_add_(0, idx, torch.ones((x.shape[0], 1), dtype=torch.float32, device=x.device))
    return (sums / torch.clamp(counts, min=1.0)).to(x.dtype)


class MoleculeGCN(nn.Module):
    """2-layer GCN + global mean pool for graph classification (the JAX
    ``MoleculeGCN``, the molecule notebook's GCN): conv1 with ReLU, conv2,
    ``global_mean_pool`` over the batch's graphs, dropout, a linear head.

    Parameters are named ``conv1.weight``, ``conv2.weight``,
    ``head.weight``, ``head.bias`` (see ``nn/convert.params_from_jax``).
    ``calibration`` as in ``GCNModel``."""

    def __init__(
        self,
        num_features: int,
        hidden_channels: int,
        num_classes: int,
        *,
        calibration: Optional[CalibrationTable] = None,
        dropout: float = 0.5,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        q1 = calibration.layer_params(0) if calibration else None
        q2 = calibration.layer_params(1) if calibration else None
        self.conv1 = GCNConv(num_features, hidden_channels, quant=q1, generator=generator)
        self.conv2 = GCNConv(hidden_channels, hidden_channels, quant=q2, generator=generator)
        self.head = nn.Linear(hidden_channels, num_classes)

    def forward(
        self, A, x: torch.Tensor, graph_ids: torch.Tensor, num_graphs: int, *,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = self.conv1(A, x, relu=True)
        x = self.conv2(A, x)
        x = global_mean_pool(x, graph_ids, num_graphs)
        return self.head(_dropout(self, x, generator))
