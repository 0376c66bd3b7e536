"""The numbers that decide ``correct``: what the timed path produced
against the plain reference, each number beside its limit.

Training: each step's loss as a relative gap, the largest of them and the
first step's alone (later steps amplify any rounding through Adam's
first updates, see PERF.md); the first gradient and the
parameters' change after the first steps by the worst leaf, as the gap
between the two norms over the reference's norm of that leaf or of the
median leaf, whichever is larger. Leaves whose reference gradient is
under a thousandth of the median leaf's are left out of the change (Adam
moves them by round-off alone).

Serving: the checked requests' logits, the widest gap over the largest
reference magnitude, and the relative Frobenius gap.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    """Each leaf's gap of norms over its reference norm or the median
    leaf's, whichever is larger."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    return max(leaf_gaps(prog, ref, keep).values())


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def train_numbers(prog: dict, ref: dict, theta0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``prog``: the program's step losses, first-gradient norms and
    change norms by leaf; ``ref``: ``reference.common.train_steps``'s
    result from ``theta0``."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    g_ref = norms(ref["first_grad"])
    med = statistics.median(g_ref.values())
    moved = {k for k, v in g_ref.items() if v >= 1e-3 * med}
    d_ref = norms({k: ref["theta"][k] - theta0[k] for k in theta0})
    return dict(
        loss_gap=loss,
        loss1_gap=abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
        grad_gap=_worst_leaf(prog["grad_norms"], g_ref),
        step_gap=_worst_leaf(prog["change_norms"], d_ref, moved),
        by_leaf=dict(
            loss=[abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])],
            grad=leaf_gaps(prog["grad_norms"], g_ref), step=leaf_gaps(prog["change_norms"], d_ref, moved),
            grad_norm=g_ref, change_norm=d_ref,
        ),
    )


def as_program(ref: dict, theta0: Dict[str, torch.Tensor]) -> dict:
    """A reference run's readings in the form ``train_numbers`` takes for
    the program's, so that a variant of the reference stands in its place."""
    return dict(
        losses=ref["losses"], grad_norms=norms(ref["first_grad"]),
        change_norms=norms({k: ref["theta"][k] - theta0[k] for k in theta0}),
    )


def infer_numbers(outs: List[torch.Tensor], refs: List[torch.Tensor]) -> Dict[str, float]:
    wide = rel = 0.0
    for o, r in zip(outs, refs):
        d = (o.double() - r.double())
        wide = max(wide, float(d.abs().max() / r.abs().max()))
        rel = max(rel, float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(r.double())))
    return dict(logit_wide_gap=wide, logit_rel_gap=rel)
