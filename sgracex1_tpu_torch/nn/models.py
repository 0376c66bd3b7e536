"""GCN and GAT node-classification models and the molecule
graph-classification model as ``torch.nn.Module``s.

``remat=True`` checkpoints each convolution (the JAX models' ``nn.remat``):
under grad its activations are not kept but recomputed in the backward
(``torch.utils.checkpoint``, non-reentrant, stopping as soon as what the
backward reads is recomputed). Parameter names and results do not change.
Dropout sits outside the convolutions, so no random draw is replayed.
Each model's ``forward`` runs in a ``model.forward`` span
(``utils/profiling``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sgracex1_tpu_torch.nn.layers import GATConv, GCNConv
from sgracex1_tpu_torch.quant.calibration import CalibrationTable
from sgracex1_tpu_torch.utils.profiling import span


@contextlib.contextmanager
def _no_telemetry(conv: nn.Module):
    """The recompute records no range telemetry: the forward has."""
    saved, conv.telemetry = conv.telemetry, False
    try:
        yield
    finally:
        conv.telemetry = saved


def _conv_apply(remat: bool, conv: nn.Module, A, x: torch.Tensor, relu: bool) -> torch.Tensor:
    """``conv(A, x, relu=relu)``, checkpointed with ``remat`` under grad.
    The adjacency is quantized once, outside the checkpoint, so the
    recompute reads the forward's."""
    if not (remat and torch.is_grad_enabled()):
        return conv(A, x, relu=relu)
    Aq = conv.quantize_adjacency(A)
    return checkpoint(
        lambda x: conv(Aq, x, relu=relu, adj_quantized=True), x, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _no_telemetry(conv)),
    )


class GCNModel(nn.Module):
    """``num_layers`` GCN convolutions (ReLU on all but the last), dropout,
    and a linear head: the reference's 2-layer node classifier by default.

    Parameters are named ``conv1.weight`` ... ``convN.weight``,
    ``head.weight``, ``head.bias`` (see ``nn/convert.params_from_jax``).
    Dropout draws from the ``generator`` passed to ``forward``. With
    ``calibration`` the convolutions run the fake-quant datapath: conv1
    on the table's layer-1 constants, every later one on its layer-2
    constants. ``remat`` checkpoints each convolution."""

    def __init__(
        self,
        num_features: int,
        hidden_channels: int,
        num_classes: int,
        *,
        calibration: Optional[CalibrationTable] = None,
        dropout: float = 0.5,
        remat: bool = False,
        num_layers: int = 2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.remat = remat
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
        with span("model.forward"):
            for i in range(self.num_layers):
                conv = getattr(self, f"conv{i + 1}")
                x = _conv_apply(self.remat, conv, A, x, i < self.num_layers - 1)
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
    ``calibration`` and ``remat`` as in ``GCNModel``."""

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
        remat: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.remat = remat
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
        with span("model.forward"):
            x = _conv_apply(self.remat, self.conv1, A, x, True)
            x = _conv_apply(self.remat, self.conv2, A, x, False)
            return self.head(_dropout(self, x, generator))


class GATSkipModel(nn.Module):
    """PyTorch Geometric's deep GAT with skip connections (its
    ``examples/ogbn_products_gat.py``): ``num_layers`` GAT convolutions of
    ``heads`` heads, each with a linear skip from its input, ``x =
    conv(x) + skip(x)``. Hidden layers give ``hidden_channels`` a head,
    concatenated, then ELU and dropout; the last averages its heads into
    ``num_classes`` (no linear head). Its output is the logits, which the
    loops' cross-entropy takes through ``log_softmax`` (PyG returns
    ``log_softmax`` and takes the NLL: the same loss).

    Every convolution has PyG's defaults: a bias, one self-loop a node in
    the attention (``GATConv(add_self_loops=True)``), LeakyReLU slope 0.2,
    no attention dropout; and ``exact_gradients``, so the scores' gradients
    reach ``Wh``, as PyG's autograd's do.
    Parameters are named ``conv{i}.weight`` ``[in, heads * out]``,
    ``conv{i}.attention``, ``conv{i}.bias``, and ``skip{i}.weight`` /
    ``skip{i}.bias`` (``nn.Linear``). In training one draw,
    ``torch.rand((num_layers - 1, n, heads * hidden_channels))`` from the
    ``generator`` passed to ``forward``, gives every dropout mask of the
    step (inverted dropout at rate ``dropout``). ``attention_self_loops``
    tells the training loops' prepare so (``gat_self_loops``): the
    ``pallas`` kind's plan attention is the layout that serves it."""

    uses_attention = True
    attention_self_loops = True

    def __init__(
        self,
        num_features: int,
        hidden_channels: int,
        num_classes: int,
        *,
        num_layers: int = 3,
        heads: int = 4,
        dropout: float = 0.5,
    ):
        super().__init__()
        self.dropout, self.num_layers = dropout, num_layers
        self.heads, self.hidden_channels = heads, hidden_channels
        width = hidden_channels * heads
        for i in range(num_layers):
            last = i == num_layers - 1
            f_in = num_features if i == 0 else width
            self.add_module(f"conv{i + 1}", GATConv(
                f_in, num_classes if last else hidden_channels, nheads=heads, exact_gradients=True,
                concat=not last, bias=True, add_self_loops=True,
            ))
        for i in range(num_layers):
            f_in = num_features if i == 0 else width
            self.add_module(f"skip{i + 1}", nn.Linear(f_in, num_classes if i == num_layers - 1 else width))

    def forward(
        self, A, x: torch.Tensor, *, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        with span("model.forward"):
            L, keep = self.num_layers, None
            if self.training and self.dropout > 0 and L > 1:
                shape = (L - 1, x.shape[0], self.heads * self.hidden_channels)
                keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - self.dropout
            for i in range(L):
                h = getattr(self, f"conv{i + 1}")(A, x) + getattr(self, f"skip{i + 1}")(x)
                if i < L - 1:
                    h = torch.nn.functional.elu(h)
                    if keep is not None:
                        h = torch.where(keep[i], h / (1.0 - self.dropout), torch.zeros_like(h))
                x = h
            return x


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
    ``calibration`` and ``remat`` as in ``GCNModel``."""

    def __init__(
        self,
        num_features: int,
        hidden_channels: int,
        num_classes: int,
        *,
        calibration: Optional[CalibrationTable] = None,
        dropout: float = 0.5,
        remat: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.remat = remat
        q1 = calibration.layer_params(0) if calibration else None
        q2 = calibration.layer_params(1) if calibration else None
        self.conv1 = GCNConv(num_features, hidden_channels, quant=q1, generator=generator)
        self.conv2 = GCNConv(hidden_channels, hidden_channels, quant=q2, generator=generator)
        self.head = nn.Linear(hidden_channels, num_classes)

    def forward(
        self, A, x: torch.Tensor, graph_ids: torch.Tensor, num_graphs: int, *,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        with span("model.forward"):
            x = _conv_apply(self.remat, self.conv1, A, x, True)
            x = _conv_apply(self.remat, self.conv2, A, x, False)
            x = global_mean_pool(x, graph_ids, num_graphs)
            return self.head(_dropout(self, x, generator))
