"""The GCN family: the port's ``GCNModel`` as the system under test, its
plain reference, and the count of an epoch and a request."""

from __future__ import annotations

from portbench import counts as C
from portbench.reference import gcn as reference

uses_attention = False


def program_model(cfg: dict):
    from sgracex1_tpu_torch.nn.models import GCNModel

    return GCNModel(
        cfg["num_features"], cfg["hidden_channels"], cfg["num_classes"],
        num_layers=cfg["num_layers"], dropout=cfg["dropout"],
    )


def _widths(cfg):
    h = cfg["hidden_channels"]
    return [cfg["num_features"]] + [h] * cfg["num_layers"]


def forward_ops(cfg: dict, n: int, nnz: int, edges: int, train: bool):
    """A full-graph forward: per layer the GEMM, the aggregation and the
    ReLU; dropout in training; the head."""
    w, c, ops = _widths(cfg), cfg["num_classes"], []
    for i in range(cfg["num_layers"]):
        ops.append(C.gemm(f"conv{i + 1}.gemm", n, w[i], w[i + 1]))
        ops.append(C.aggregate(f"conv{i + 1}.agg", n, nnz, w[i + 1]))
        if i < cfg["num_layers"] - 1:
            ops.append(C.elementwise(f"conv{i + 1}.relu", n * w[i + 1], C.F32, C.F32))
    if train:
        ops.append(C.elementwise("dropout", n * w[-1], C.F32, C.F32 + C.BOOL, 2.0))
    ops.append(C.gemm("head.gemm", n, w[-1], c))
    return ops


def step_ops(cfg: dict, n: int, nnz: int, edges: int, params: int):
    """One training step: forward, masked cross-entropy, backward (the
    transposed aggregations, the weight GEMMs, the input GEMMs of every
    layer but the first), Adam."""
    w, c, L = _widths(cfg), cfg["num_classes"], cfg["num_layers"]
    ops = forward_ops(cfg, n, nnz, edges, True)
    ops.append(C.cross_entropy("xent", n, c, backward=False))
    ops.append(C.cross_entropy("xent.bwd", n, c, backward=True))
    ops += [C.gemm("head.dW", w[-1], n, c), C.gemm("head.dX", n, c, w[-1])]
    ops.append(C.elementwise("dropout.bwd", n * w[-1], C.F32 + C.BOOL, C.F32))
    for i in reversed(range(L)):
        if i < L - 1:
            ops.append(C.elementwise(f"conv{i + 1}.relu.bwd", n * w[i + 1], 2 * C.F32, C.F32))
        ops.append(C.aggregate(f"conv{i + 1}.agg.bwd", n, nnz, w[i + 1]))
        ops.append(C.gemm(f"conv{i + 1}.dW", w[i], n, w[i + 1]))
        if i > 0:
            ops.append(C.gemm(f"conv{i + 1}.dX", n, w[i + 1], w[i]))
    ops.append(C.adam("adam", params))
    return ops


def epoch_ops(cfg: dict, n: int, nnz: int, edges: int, params: int):
    """An epoch of the port's loop: a training step, then the evaluation
    forward and the accuracies' argmax."""
    ops = step_ops(cfg, n, nnz, edges, params) + forward_ops(cfg, n, nnz, edges, False)
    return ops + [C.elementwise("argmax", n * cfg["num_classes"], C.F32, 0.0)]


def request_ops(cfg: dict, n: int, nnz: int, edges: int, params: int):
    return forward_ops(cfg, n, nnz, edges, False)
