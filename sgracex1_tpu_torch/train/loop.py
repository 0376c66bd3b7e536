"""Full-graph node-classification training, as
``sgracex1_tpu.train.loop.train_node_classifier``.

Adam with the reference's qbits-dependent learning-rate rule, masked
cross-entropy, per-epoch accuracy, best-model tracking. Each epoch is one
step on the whole graph (forward, backward, Adam) in ``model.train()``,
then an evaluation in ``model.eval()`` under ``torch.no_grad()``. The
adjacency is prepared once and stays on the device; on a prepared
backend the aggregations and their gradients run the port's kernels.

The sampled, graph-level and multi-label loops are not ported yet
(ROADMAP queue 1, items 10 and 15).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from sgracex1_tpu_torch._device import resolve_device
from sgracex1_tpu_torch.config import SGRACEConfig
from sgracex1_tpu_torch.graph.datasets import NodeClassificationData
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.ops.dispatch import PreparedAdjacency, prepare_from_config


def _uses_attention(model) -> bool:
    """Whether the model runs GAT layers (needs flash mask tiles attached):
    an explicit ``uses_attention`` attribute, else the model family's name
    (GATModel, ...)."""
    flag = getattr(model, "uses_attention", None)
    if flag is not None:
        return bool(flag)
    return "GAT" in type(model).__name__


def _prepare_backend(data: NodeClassificationData, cfg: SGRACEConfig, model, prepare, device):
    """Resolve ``prepare`` into the adjacency the step consumes:

    - ``"auto"`` / ``True`` (default): ``prepare_from_config`` on the
      sym-normalized graph, with flash mask tiles for GAT models;
    - a backend name (``"dense"``/``"bsr"``/``"hybrid"``/``"xla"``): that
      method;
    - ``"off"`` / ``None`` / ``False``: the bare ``SparseMatrix`` edge path;
    - a ``PreparedAdjacency``: used as it is (its device is the caller's)."""
    if isinstance(prepare, PreparedAdjacency):
        return prepare
    A = sym_norm(data.edge_index, data.num_nodes)
    if prepare is None or prepare is False or prepare == "off":
        return A.to(device)
    method = None if prepare in (True, "auto") else prepare
    return prepare_from_config(
        A, cfg, for_gat=_uses_attention(model), method=method, device=device
    )


@dataclasses.dataclass
class TrainState:
    """The trained model, its optimizer and the number of steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclasses.dataclass
class History:
    train_acc: List[float] = dataclasses.field(default_factory=list)
    test_acc: List[float] = dataclasses.field(default_factory=list)
    loss: List[float] = dataclasses.field(default_factory=list)
    best_test_acc: float = 0.0
    best_params: Optional[dict] = None  # CPU copy of the best state_dict


def _masked_xent(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    ls = F.cross_entropy(logits, y, reduction="none")
    return torch.sum(ls * mask) / torch.clamp(torch.sum(mask), min=1.0)


def train_node_classifier(
    model: torch.nn.Module,
    data: NodeClassificationData,
    cfg: SGRACEConfig,
    *,
    seed: int = 12345,
    log_every: int = 0,
    prepare="auto",
    device=None,
) -> Tuple[TrainState, History]:
    """Full-graph node classification for ``cfg.num_epochs`` epochs.

    ``model`` comes initialised (``GCNModel`` / ``GATModel``) and is moved
    to ``device``: the CUDA card by default (a ``RuntimeError`` where there
    is none), the CPU only with ``device="cpu"``. With ``cfg.preload`` its
    weights are first replaced by that checkpoint's. The optimizer is ``torch.optim.Adam(lr, betas=(0.9,
    0.999), eps=1e-8)``, optax's ``adam``. Dropout draws from one
    ``torch.Generator(device)`` seeded with ``seed``. ``prepare`` is as in
    ``_prepare_backend``. Returns the final state and the per-epoch
    history (loss of each step, train and test accuracy after it)."""
    device = resolve_device(device)
    A = _prepare_backend(data, cfg, model, prepare, device)
    x = torch.as_tensor(data.x, device=device)
    y = torch.as_tensor(data.y, device=device).long()
    masks = {
        k: torch.as_tensor(getattr(data, f"{k}_mask"), device=device).float()
        for k in ("train", "test")
    }
    model = model.to(device)
    if cfg.preload is not None:
        # the reference's preload + very-low-LR fine-tune flow
        from sgracex1_tpu_torch.train.checkpoint import load_checkpoint

        model.load_state_dict(load_checkpoint(cfg.preload, model.state_dict()))
    opt = torch.optim.Adam(
        model.parameters(), lr=cfg.resolved_learning_rate(), betas=(0.9, 0.999), eps=1e-8
    )
    state = TrainState(model=model, optimizer=opt)
    gen = torch.Generator(device=device).manual_seed(seed)

    hist = History()
    for epoch in range(cfg.num_epochs):
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = _masked_xent(model(A, x, generator=gen), y, masks["train"])
        loss.backward()
        opt.step()
        state.step += 1
        model.eval()
        with torch.no_grad():
            pred = model(A, x).argmax(dim=-1)
            accs = {
                k: float(torch.sum((pred == y) * m) / torch.clamp(torch.sum(m), min=1.0))
                for k, m in masks.items()
            }
        tr, te = accs["train"], accs["test"]
        hist.loss.append(loss.item())
        hist.train_acc.append(tr)
        hist.test_acc.append(te)
        if te > hist.best_test_acc:
            hist.best_test_acc = te
            hist.best_params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        if log_every and (epoch + 1) % log_every == 0:
            print(f"epoch {epoch + 1:03d} loss {hist.loss[-1]:.4f} train {tr:.4f} test {te:.4f}")
    return state, hist
