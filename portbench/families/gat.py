"""The GAT family: the port's ``GATSkipModel`` (PyTorch Geometric's deep
GAT with skip connections) as the system under test, its plain reference,
the count of an epoch and a request, and the roofline share of each of the
plan attention's kernels.

The attention's three passes are the port's own kernels (kind
``"kernel"``), counted from the CSR's nnz (each entry one attended slot:
the stored self-loop stands for the added one) and the widths: each slot's
gathered row of ``heads * F`` bf16 features, its (column, value) pair and
per-row scalars, and each row's own operands, statistics and outputs.
Everything else is ``"torch"``.

The family's CPU tests (the reference against the port, the count against a
hand-worked case, a run with the timed path broken) are in
``tests/test_torch_gat_skip.py``."""

from __future__ import annotations

from portbench import counts as C
from portbench import trace
from portbench.reference import gat as reference

# imported with the family, so that a port without the model fails at once,
# before a run builds its graph and prepare
from sgracex1_tpu_torch.nn.models import GATSkipModel

uses_attention = True
SLOT = C.I32 + C.F32  # a slot's (column, value) pair

# each kernel of the plan attention and the suffix of the ops it does
KERNELS = {
    "plan_gat_fwd_kernel": ".att",
    "plan_gat_bwd_rows_kernel": ".att.bwd_rows",
    "plan_gat_bwd_cols_kernel": ".att.bwd_cols",
}


def program_model(cfg: dict):
    return GATSkipModel(
        cfg["num_features"], cfg["hidden_channels"], cfg["num_classes"],
        num_layers=cfg["num_layers"], heads=cfg["heads"], dropout=cfg["dropout"],
    )


def attention(name: str, n: int, nnz: int, H: int, f: int) -> C.Op:
    """The forward: a slot reads its row of ``Wh`` (bf16), its pair and the
    column's score a head, and takes a score, an exponential and ``f``
    products a head; a row reads its scores and writes its output and
    ``(m, l)``."""
    return C.Op(name, nnz * H * (2.0 * f + 6), nnz * (H * f * C.BF16 + SLOT + H * C.F32)
                + n * H * (C.F32 + f * C.F32 + 2 * C.F32), "kernel")


def attention_bwd_rows(name: str, n: int, nnz: int, H: int, f: int) -> C.Op:
    """The row pass: a slot as the forward plus the dot product ``gO[r] .
    Wh[c]``; a row reads its ``gO`` (bf16), ``s1``, ``m``, ``l`` and writes
    ``(t, u1, u2)``."""
    return C.Op(name, nnz * H * (2.0 * f + 10), nnz * (H * f * C.BF16 + SLOT + H * C.F32)
                + n * H * (f * C.BF16 + 6 * C.F32), "kernel")


def attention_bwd_cols(name: str, n: int, nnz: int, H: int, f: int) -> C.Op:
    """The column pass: a slot reads its row's ``gO`` (bf16) and ``(s1, m,
    1/l, t)`` a head, and takes the dot product and ``f`` products into
    ``dWh``; a column reads its ``Wh`` (bf16) and ``s2``, and writes ``dWh``
    and ``ds2``."""
    return C.Op(name, nnz * H * (4.0 * f + 10), nnz * (H * f * C.BF16 + SLOT + 4 * H * C.F32)
                + n * H * (f * C.BF16 + f * C.F32 + 2 * C.F32), "kernel")


def _layers(cfg: dict):
    """``(k, f_in, F, concat, out width)`` of each layer."""
    H = cfg["heads"]
    return [(i + 1, fi, f, concat, H * f if concat else f) for i, (fi, f, concat) in enumerate(reference._widths(cfg))]


def forward_ops(cfg: dict, n: int, nnz: int, edges: int, train: bool):
    """A full-graph forward: per layer the GEMM and the scores' GEMM, the
    bf16 staging of ``Wh``, the attention, the heads' mean (the last layer),
    the bias, the skip's GEMM and the sum; ELU and, in training, dropout
    (one draw for the step) on the hidden layers."""
    H, L, ops = cfg["heads"], cfg["num_layers"], []
    if train and L > 1:
        hid = (L - 1) * n * H * cfg["hidden_channels"]
        ops.append(C.elementwise("dropout.draw", hid, C.F32, C.F32 + C.BOOL))
    for k, fi, f, concat, w in _layers(cfg):
        ops += [C.gemm(f"conv{k}.gemm", n, fi, H * f), C.gemm(f"conv{k}.scores", n, H * f, 2 * H),
                C.elementwise(f"conv{k}.stage", n * H * f, C.F32, C.BF16),
                attention(f"conv{k}.att", n, nnz, H, f)]
        if not concat:
            ops.append(C.elementwise(f"conv{k}.mean", n * H * f, C.F32, C.F32 / H))
        ops += [C.elementwise(f"conv{k}.bias", n * w, C.F32, C.F32), C.gemm(f"skip{k}.gemm", n, fi, w),
                C.elementwise(f"skip{k}.add", n * w, 2 * C.F32, C.F32)]
        if k < L:
            ops.append(C.elementwise(f"conv{k}.elu", n * w, C.F32, C.F32, 4.0))
            if train:
                ops.append(C.elementwise(f"conv{k}.dropout", n * w, C.F32 + C.BOOL, C.F32, 2.0))
    return ops


def step_ops(cfg: dict, n: int, nnz: int, edges: int, params: int):
    """One training step: forward, masked cross-entropy, backward (per
    layer, last first: dropout and ELU, the skip's and the bias's
    gradients, the heads' mean, the bf16 staging of ``gO``, the attention's
    row and column passes and ``ds1``, the scores' GEMMs, the layer's GEMMs,
    the input gradients' sum), Adam."""
    H, L, c = cfg["heads"], cfg["num_layers"], cfg["num_classes"]
    ops = forward_ops(cfg, n, nnz, edges, True)
    ops += [C.cross_entropy("xent", n, c, backward=False), C.cross_entropy("xent.bwd", n, c, backward=True)]
    for k, fi, f, concat, w in reversed(_layers(cfg)):
        hf = H * f
        if k < L:
            ops += [C.elementwise(f"conv{k}.dropout.bwd", n * w, C.F32 + C.BOOL, C.F32),
                    C.elementwise(f"conv{k}.elu.bwd", n * w, 2 * C.F32, C.F32, 2.0)]
        ops += [C.gemm(f"skip{k}.dW", w, n, fi), C.elementwise(f"skip{k}.db", n * w, C.F32, 0.0),
                C.elementwise(f"conv{k}.db", n * w, C.F32, 0.0)]
        if not concat:
            ops.append(C.elementwise(f"conv{k}.mean.bwd", n * hf, C.F32 / H, C.F32))
        ops += [C.elementwise(f"conv{k}.stage.bwd", n * hf, C.F32, C.BF16),
                attention_bwd_rows(f"conv{k}.att.bwd_rows", n, nnz, H, f),
                C.elementwise(f"conv{k}.ds1", n * H, 3 * C.F32, C.F32, 2.0),
                attention_bwd_cols(f"conv{k}.att.bwd_cols", n, nnz, H, f),
                C.gemm(f"conv{k}.scores.dWh", n, 2 * H, hf), C.gemm(f"conv{k}.scores.da", hf, n, 2 * H),
                C.elementwise(f"conv{k}.dWh.add", n * hf, 2 * C.F32, C.F32),
                C.gemm(f"conv{k}.dW", fi, n, hf)]
        if k > 1:
            ops += [C.gemm(f"conv{k}.dX", n, hf, fi), C.gemm(f"skip{k}.dX", n, w, fi),
                    C.elementwise(f"conv{k}.dX.add", n * fi, 2 * C.F32, C.F32)]
    ops.append(C.adam("adam", params))
    return ops


def epoch_ops(cfg: dict, n: int, nnz: int, edges: int, params: int):
    """An epoch of the port's loop: a training step, then the evaluation
    forward and the accuracies' argmax."""
    ops = step_ops(cfg, n, nnz, edges, params) + forward_ops(cfg, n, nnz, edges, False)
    return ops + [C.elementwise("argmax", n * cfg["num_classes"], C.F32, 0.0)]


def request_ops(cfg: dict, n: int, nnz: int, edges: int, params: int):
    return forward_ops(cfg, n, nnz, edges, False)


def kernel_roofline(run, kernel: str):
    """``kernel``'s share of its roofline in the traced stretch, in %: the
    least time of the ops it does (``KERNELS``: those of the unit whose name
    ends in its suffix) over its device time (``run.traced["device_ops"]``
    by ``trace.base_name``); None where the run was not traced, the cell's
    family is not this one, or the kernel did not run."""
    t = run.traced
    if not t or run.fam.__name__ != __name__ or kernel not in KERNELS:
        return None
    dev = sum(s for name, s in t["device_ops"] if trace.base_name(name) == kernel)
    ops = [o for o in run.driver.unit_ops(run) if o.name.endswith(KERNELS[kernel])]
    if dev <= 0 or not ops:
        return None
    return 100.0 * C.least_time(ops) * run.trace_units / dev
