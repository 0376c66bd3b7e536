"""Training loops, as ``sgracex1_tpu.train.loop``: full-graph and
neighbor-sampled node classification, graph classification over
block-diagonal batches, and inductive multi-label node classification
over whole graphs (PPI).

Adam with the reference's qbits-dependent learning-rate rule, masked
losses, per-epoch metrics and best-model tracking. Each step is forward,
backward and Adam in ``model.train()``; each evaluation runs in
``model.eval()`` under ``torch.no_grad()``. Adjacencies are prepared on
the host and live on the device; on a prepared backend the aggregations
and their gradients run the port's kernels.

Spans (``utils/profiling``): each epoch of the four loops in
``loop.epoch``; a step in ``loop.step``, split into ``loop.forward``,
``loop.backward`` and ``loop.optimizer`` (``zero_grad``, then ``step``);
each evaluation in ``loop.eval``; ``_end_epoch``'s sync and best-state copy
in ``loop.end_epoch``; the sampled loop's sampling in ``loop.sample`` and
each batch's prepare in ``loop.batch_prepare``.

The three batch loops pad every batch's prep to sticky maxima
(``_pad_prep_tiles``, through ``ops/bsr.pad_bsr_tile_count`` and
``ops/fused_agg.pad_fused_plan``) where the JAX loops do, so every batch's
tensors keep one shape (what a captured CUDA graph needs); the padding
adds no work to the ring kernels' live schedules.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sgracex1_tpu_torch._device import resolve_device
from sgracex1_tpu_torch.config import SGRACEConfig
from sgracex1_tpu_torch.graph.batch import GraphBatch
from sgracex1_tpu_torch.graph.csr import SparseMatrix, _round_up
from sgracex1_tpu_torch.graph.datasets import NodeClassificationData
from sgracex1_tpu_torch.graph.normalize import sym_norm, sym_norm_edges
from sgracex1_tpu_torch.graph.sampling import make_neighbor_batches
from sgracex1_tpu_torch.ops.bsr import pad_bsr_tile_count
from sgracex1_tpu_torch.ops.dispatch import PreparedAdjacency, prepare_from_config
from sgracex1_tpu_torch.ops.fused_agg import pad_fused_plan
from sgracex1_tpu_torch.utils.profiling import span


def _uses_attention(model) -> bool:
    """Whether the model runs GAT layers (needs flash mask tiles attached):
    an explicit ``uses_attention`` attribute, else the model family's name
    (GATModel, ...)."""
    flag = getattr(model, "uses_attention", None)
    if flag is not None:
        return bool(flag)
    return "GAT" in type(model).__name__


def _prepare_backend(A, cfg: SGRACEConfig, model, prepare, device):
    """Resolve ``prepare`` into the adjacency the step consumes, for the
    host matrix ``A`` (a ``SparseMatrix``, or a callable that builds it,
    called only when ``prepare`` is not a ``PreparedAdjacency``):

    - ``"auto"`` / ``True`` (default): ``prepare_from_config``, with flash
      mask tiles for GAT models;
    - a backend name (``"dense"``/``"bsr"``/``"hybrid"``/``"pallas"``/
      ``"xla"``): that method;
    - ``"off"`` / ``None`` / ``False``: the bare ``SparseMatrix`` edge path;
    - a ``PreparedAdjacency``: used as it is (its device is the caller's)."""
    if isinstance(prepare, PreparedAdjacency):
        return prepare
    if callable(A):
        A = A()
    if prepare is None or prepare is False or prepare == "off":
        return A.to(device)
    method = None if prepare in (True, "auto") else prepare
    return prepare_from_config(
        A, cfg, for_gat=_uses_attention(model), method=method, device=device
    )


def _pad_prep_tiles(prep: PreparedAdjacency, sticky: dict) -> PreparedAdjacency:
    """``prep`` padded to the sticky maxima in ``sticky`` (updated here), so
    re-prepared batches keep one shape, as JAX ``_pad_prep_tiles``:

    - tile sets (``bsr``, ``bsr_t``, ``gat_bsr``) grow to the largest tile
      count seen at their tile size (``pad_bsr_tile_count``);
    - fused plans grow to sticky (steps, tiles, chunks, K) maxima
      (``pad_fused_plan``), the chunk target one past any plan's chunks, so
      the padding steps have a dead chunk to point at (where a plan's
      chunks reach the target and its last one is live, the target moves
      one further: JAX keeps it there and its padding steps would read that
      live chunk). A plan's tiles are padded once with its tile set's;
    - ``rest`` is dropped where the fused plans carry its edges (only the
      unfused aggregation reads it);
    - ``gat_rest`` pads to a sticky edge count with ``nnz == e_pad``: the
      padding edges (last row, column 0, value 0) are masked out, the GAT
      edge mask being ``val > 0``.

    The ring kernels' live schedules stay those of the unpadded prep."""
    updates = {}
    for f in ("bsr", "bsr_t", "gat_bsr"):
        B = getattr(prep, f)
        if B is None:
            continue
        key = (f, B.tb)
        sticky[key] = max(sticky.get(key, 0), B.num_tiles)
        if sticky[key] > B.num_tiles:
            updates[f] = pad_bsr_tile_count(B, sticky[key])
    for f, bf in (("fused", "bsr"), ("fused_t", "bsr_t")):
        plan = getattr(prep, f)
        if plan is None:
            continue
        key = (f, plan.B.tb)
        S, T, R, K = plan.num_steps, plan.B.num_tiles, plan.num_chunks, plan.K
        prev = sticky.get(key, (0, 0, 0, 0))
        last_live = plan.num_rest_chunks >= R
        tgt = (
            max(prev[0], S),
            max(prev[1], T, sticky.get((bf, plan.B.tb), 0)),
            prev[2] if R < prev[2] or (R == prev[2] and not last_live) else R + 1,
            max(prev[3], K),
        )
        sticky[key] = tgt
        padded = updates.get(bf)
        if padded is not None and plan.B is getattr(prep, bf) and padded.num_tiles == tgt[1]:
            plan = dataclasses.replace(plan, B=padded)
        updates[f] = pad_fused_plan(plan, S=tgt[0], T=tgt[1], R=tgt[2], K=tgt[3])
    if updates.get("fused", prep.fused) is not None and prep.rest is not None:
        updates["rest"] = None
    if prep.gat_rest is not None:
        g = prep.gat_rest
        key = "gat_rest_pad"
        sticky[key] = max(sticky.get(key, 0), g.e_pad)
        pad = sticky[key] - g.e_pad
        if pad or g.nnz != g.e_pad:
            fill = lambda a, v: torch.cat([a, torch.full((pad,), v, dtype=a.dtype, device=a.device)])
            updates["gat_rest"] = dataclasses.replace(
                g, rows=fill(g.rows, max(0, g.n_rows - 1)), cols=fill(g.cols, 0), vals=fill(g.vals, 0),
                nnz=sticky[key],
            )
    return dataclasses.replace(prep, **updates) if updates else prep


def _padded_prep(A, cfg: SGRACEConfig, model, prepare, device, sticky: dict):
    """``_prepare_backend``, then ``_pad_prep_tiles`` on a prep."""
    bA = _prepare_backend(A, cfg, model, prepare, device)
    return _pad_prep_tiles(bA, sticky) if isinstance(bA, PreparedAdjacency) else bA


def _repad(A, sticky: dict):
    """The second pass of the staging loops: a staged prep re-padded to the
    final sticky maxima (they grew while later batches were staged)."""
    return _pad_prep_tiles(A, sticky) if isinstance(A, PreparedAdjacency) else A


def _per_batch(prepare) -> None:
    """The batch loops prepare each batch's own adjacency, so one
    ``PreparedAdjacency`` cannot stand for them (the JAX loops would reuse
    it for every batch)."""
    if isinstance(prepare, PreparedAdjacency):
        raise ValueError("this loop prepares every batch's adjacency: pass a method name, not a prep")


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


def _start(model: torch.nn.Module, lr: float, seed: int, device) -> Tuple[TrainState, torch.Generator]:
    """The model on ``device``, its Adam (optax's ``adam``: betas 0.9 /
    0.999, eps 1e-8) and the dropout generator seeded with ``seed``."""
    model = model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model=model, optimizer=opt), torch.Generator(device=device).manual_seed(seed)


def _train_step(state: TrainState, loss_fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    """One step: ``loss_fn()`` in train mode, backward, the Adam update."""
    with span("loop.step"):
        state.model.train()
        with span("loop.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        with span("loop.forward"):
            loss = loss_fn()
        with span("loop.backward"):
            loss.backward()
        with span("loop.optimizer"):
            state.optimizer.step()
        state.step += 1
    return loss


def _node_accuracies(model, A, x, y, masks: dict) -> dict:
    """Accuracy of the argmax over each mask, in eval mode."""
    model.eval()
    with span("loop.eval"), torch.no_grad():
        pred = model(A, x).argmax(dim=-1)
        return {
            k: float(torch.sum((pred == y) * m) / torch.clamp(torch.sum(m), min=1.0))
            for k, m in masks.items()
        }


def _end_epoch(hist: History, model, epoch: int, loss: torch.Tensor, tr: float, te: float,
               select: float, log_every: int, extra: str = "") -> None:
    """Record the epoch; keep a CPU copy of the parameters when ``select``
    (the test metric, or validation's) beats the best so far."""
    with span("loop.end_epoch") as s:
        hist.loss.append(loss.item())
        hist.train_acc.append(tr)
        hist.test_acc.append(te)
        best = select > hist.best_test_acc
        if best:
            hist.best_test_acc = select
            hist.best_params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        s.set(best_copy=int(best))
    if log_every and (epoch + 1) % log_every == 0:
        print(f"epoch {epoch + 1:03d} loss {hist.loss[-1]:.4f} train {tr:.4f} {extra}test {te:.4f}")


def _node_tensors(data: NodeClassificationData, device):
    x = torch.as_tensor(data.x, device=device)
    y = torch.as_tensor(data.y, device=device).long()
    masks = {
        k: torch.as_tensor(getattr(data, f"{k}_mask"), device=device).float()
        for k in ("train", "test")
    }
    return x, y, masks


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
    weights are first replaced by that checkpoint's. The optimizer is
    ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, optax's
    ``adam``. Dropout draws from one ``torch.Generator(device)`` seeded
    with ``seed``. ``prepare`` is as in ``_prepare_backend``, on the
    sym-normalized graph. Returns the final state and the per-epoch
    history (loss of each step, train and test accuracy after it)."""
    device = resolve_device(device)
    A = _prepare_backend(lambda: sym_norm(data.edge_index, data.num_nodes), cfg, model, prepare, device)
    x, y, masks = _node_tensors(data, device)
    if cfg.preload is not None:
        # the reference's preload + very-low-LR fine-tune flow
        from sgracex1_tpu_torch.train.checkpoint import load_checkpoint

        model.load_state_dict(load_checkpoint(cfg.preload, model.to(device).state_dict()))
    state, gen = _start(model, cfg.resolved_learning_rate(), seed, device)
    model = state.model

    hist = History()
    for epoch in range(cfg.num_epochs):
        with span("loop.epoch", epoch=epoch):
            loss = _train_step(state, lambda: _masked_xent(model(A, x, generator=gen), y, masks["train"]))
            accs = _node_accuracies(model, A, x, y, masks)
            _end_epoch(hist, model, epoch, loss, accs["train"], accs["test"], accs["test"], log_every)
    return state, hist


def train_node_classifier_sampled(
    model: torch.nn.Module,
    data: NodeClassificationData,
    cfg: SGRACEConfig,
    *,
    batch_size: int = 128,
    fanouts=(10, 10),
    seed: int = 12345,
    log_every: int = 0,
    prepare="auto",
    device=None,
) -> Tuple[TrainState, History]:
    """Neighbor-sampled node classification, the reference's NeighborLoader
    path for graphs past the full-batch limit (demo_sgrace.py:112-125).

    Every epoch samples fresh batches of ``batch_size`` seeds from the
    train mask (``graph/sampling.make_neighbor_batches``, drawing from one
    ``np.random.default_rng(seed)``); each batch's adjacency is prepared
    with ``prepare``, padded to the sticky maxima of the batches so far
    (``_pad_prep_tiles``), and takes one step, the loss on its seeds. After each
    epoch the model is evaluated on the full graph, prepared once.
    ``device``, the optimizer, dropout and the history are as in
    ``train_node_classifier``; the history's loss is the epoch's last
    batch's."""
    device = resolve_device(device)
    _per_batch(prepare)
    np_rng = np.random.default_rng(seed)
    train_nodes = np.nonzero(data.train_mask)[0]
    A_full = _prepare_backend(lambda: sym_norm(data.edge_index, data.num_nodes), cfg, model, prepare, device)
    x_full, y_full, masks = _node_tensors(data, device)
    state, gen = _start(model, cfg.resolved_learning_rate(), seed, device)
    model = state.model

    hist = History()
    n_pad = e_pad = 0  # pad floors: later epochs keep the first's shapes
    tile_pads: dict = {}  # sticky tile and plan counts of the batches' preps
    for epoch in range(cfg.num_epochs):
        with span("loop.epoch", epoch=epoch):
            with span("loop.sample") as s:
                batches = make_neighbor_batches(
                    data.edge_index, data.x, data.y, train_nodes,
                    batch_size=batch_size, fanouts=fanouts, rng=np_rng, n_pad=n_pad, e_pad=e_pad,
                )
                s.set(batches=len(batches))
            n_pad = max(n_pad, batches[0].x.shape[0])
            e_pad = max(e_pad, batches[0].A.e_pad)
            for b in batches:
                with span("loop.batch_prepare"):
                    bA = _padded_prep(b.A, cfg, model, prepare, device, tile_pads)
                bx = torch.as_tensor(b.x, device=device)
                by = torch.as_tensor(b.y, device=device).long()
                bm = torch.as_tensor(b.seed_mask, device=device).float()
                loss = _train_step(state, lambda: _masked_xent(model(bA, bx, generator=gen), by, bm))
            accs = _node_accuracies(model, A_full, x_full, y_full, masks)
            _end_epoch(hist, model, epoch, loss, accs["train"], accs["test"], accs["test"], log_every)
    return state, hist


def train_graph_classifier(
    model: torch.nn.Module,
    train_batches: Sequence[GraphBatch],
    test_batches: Sequence[GraphBatch],
    cfg: SGRACEConfig,
    *,
    seed: int = 12345,
    log_every: int = 0,
    prepare="auto",
    device=None,
) -> Tuple[TrainState, History]:
    """Graph classification (the molecule notebook's train()/test() loops:
    Adam at ``cfg.learning_rate``, 0.01 when unset, cross-entropy over the
    batch's labelled graph slots). Each batch's adjacency is prepared once
    (``prepare``) and its arrays moved to the device before the first
    epoch, each prep padded to the sticky maxima of all (``_pad_prep_tiles``).
    Accuracy counts the correct graphs over all batches.
    ``model`` (``MoleculeGCN``), ``device``, dropout and the history are as
    in ``train_node_classifier``."""
    device = resolve_device(device)
    _per_batch(prepare)
    tile_pads: dict = {}

    def stage(batches):
        t = lambda a: torch.as_tensor(a, device=device)
        return [
            (_padded_prep(b.A, cfg, model, prepare, device, tile_pads), t(b.x), t(b.graph_ids).long(),
             t(b.y).long(), t(b.label_mask).float(), b.num_graphs)
            for b in batches
        ]

    train_b, test_b = stage(train_batches), stage(test_batches)
    train_b, test_b = ([(_repad(A, tile_pads), *rest) for A, *rest in split] for split in (train_b, test_b))
    lr = cfg.learning_rate if cfg.learning_rate is not None else 0.01
    state, gen = _start(model, lr, seed, device)
    model = state.model

    def accuracy(batches) -> float:
        model.eval()
        c = t = 0
        with span("loop.eval"), torch.no_grad():
            for A, x, gid, y, m, ng in batches:
                pred = model(A, x, gid, ng).argmax(dim=-1)
                c += int(torch.sum((pred == y) * m))
                t += int(torch.sum(m))
        return c / max(t, 1)

    hist = History()
    for epoch in range(cfg.num_epochs):
        with span("loop.epoch", epoch=epoch):
            for A, x, gid, y, m, ng in train_b:
                loss = _train_step(state, lambda: _masked_xent(model(A, x, gid, ng, generator=gen), y, m))
            tr, te = accuracy(train_b), accuracy(test_b)
            _end_epoch(hist, model, epoch, loss, tr, te, te, log_every)
    return state, hist


# --------------------------------------------------------------------------
# Multi-label inductive training (PPI)
# --------------------------------------------------------------------------


def micro_f1(pred: np.ndarray, target: np.ndarray) -> float:
    """Micro-averaged F1 over all (node, label) decisions (the PPI metric)."""
    pred = np.asarray(pred, bool)
    target = np.asarray(target, bool)
    tp = np.sum(pred & target)
    fp = np.sum(pred & ~target)
    fn = np.sum(~pred & target)
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else 0.0


def _pad_multilabel_graph(g, n_pad: int, fill: float):
    """(A, x, y, node_mask) padded to ``n_pad`` nodes, host arrays. ``A``
    gets self-loops of weight ``fill``, so that attention keeps the self
    edge (the GAT edge mask drops zero-valued edges, as the reference's
    ``adj_d > 0``)."""
    n = g.num_nodes
    ei, ew = sym_norm_edges(g.edge_index, n, fill=fill)
    A = SparseMatrix.from_coo(ei[0], ei[1], ew, (n_pad, n_pad), pad_to=128, sort=False)
    x = np.zeros((n_pad, g.num_features), np.float32)
    x[:n] = g.x
    y = np.zeros((n_pad, g.num_labels), np.float32)
    y[:n] = g.y
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    return A, x, y, mask


def train_multilabel_inductive(
    model: torch.nn.Module,
    train_graphs,
    val_graphs,
    test_graphs,
    cfg: SGRACEConfig,
    *,
    fill: float = 1.0,
    seed: int = 12345,
    log_every: int = 0,
    prepare="auto",
    device=None,
) -> Tuple[TrainState, History]:
    """Inductive multi-label node classification over whole held-out graphs
    (the PPI protocol): a step a training graph, sigmoid binary
    cross-entropy over the real nodes, micro-F1 of ``logits > 0``, and the
    best model chosen on validation F1 (``History.best_test_acc`` holds
    that F1; ``train_acc`` / ``test_acc`` hold the train and test F1).

    Every graph is padded to one node count (a multiple of 128) and one
    edge count with ``nnz == e_pad`` (``_pad_multilabel_graph``,
    ``SparseMatrix.pad_edges_to``, ``with_uniform_nnz``), prepared once
    with ``prepare``, padded to the sticky maxima of all
    (``_pad_prep_tiles``) and kept on the device. ``model``, ``device``,
    dropout and the optimizer are as in ``train_node_classifier``."""
    device = resolve_device(device)
    _per_batch(prepare)
    splits = [list(train_graphs), list(val_graphs), list(test_graphs)]
    graphs = [g for s in splits for g in s]
    n_pad = _round_up(max(g.num_nodes for g in graphs), 128)
    padded = [_pad_multilabel_graph(g, n_pad, fill) for g in graphs]
    e_pad = max(A.e_pad for A, _, _, _ in padded)
    t = lambda a: torch.as_tensor(a, device=device)
    tile_pads: dict = {}
    staged = [
        (_padded_prep(A.pad_edges_to(e_pad).with_uniform_nnz(), cfg, model, prepare, device, tile_pads),
         t(x), t(y), t(m))
        for A, x, y, m in padded
    ]
    staged = [(_repad(A, tile_pads), *rest) for A, *rest in staged]
    n_tr, n_va = len(splits[0]), len(splits[1])
    train_b, val_b, test_b = staged[:n_tr], staged[n_tr : n_tr + n_va], staged[n_tr + n_va :]
    state, gen = _start(model, cfg.resolved_learning_rate(), seed, device)
    model = state.model

    def loss_fn(A, x, y, m):
        ls = F.binary_cross_entropy_with_logits(model(A, x, generator=gen), y, reduction="none")
        return torch.sum(ls * m[:, None]) / torch.clamp(torch.sum(m) * y.shape[1], min=1.0)

    def eval_f1(batches) -> float:
        model.eval()
        preds, targets = [], []
        with span("loop.eval"), torch.no_grad():
            for A, x, y, m in batches:
                keep = m > 0
                preds.append((model(A, x) > 0.0)[keep].cpu().numpy())
                targets.append(y[keep].cpu().numpy())
        return micro_f1(np.concatenate(preds), np.concatenate(targets))

    hist = History()
    for epoch in range(cfg.num_epochs):
        with span("loop.epoch", epoch=epoch):
            for A, x, y, m in train_b:
                loss = _train_step(state, lambda: loss_fn(A, x, y, m))
            tr, va, te = eval_f1(train_b), eval_f1(val_b), eval_f1(test_b)
            _end_epoch(hist, model, epoch, loss, tr, te, va, log_every, extra=f"val {va:.4f} ")
    return state, hist
