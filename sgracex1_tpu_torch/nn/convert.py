"""Parameters of the JAX package's flax models as ``state_dict``s, and its
frozen int8 layers as the port's."""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def params_from_jax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """Map a flax ``GCNModel`` or ``GATModel`` variable tree (numpy or JAX
    arrays) onto the port's model of the same name's ``state_dict``.

    ``params/conv{i}/weight`` [in, out] loads as ``conv{i}.weight`` and
    ``params/conv{i}/attention`` [2*F*H, 1] as ``conv{i}.attention``,
    unchanged; ``params/Dense_0/kernel`` [hidden, C] is transposed into
    ``head.weight`` and ``params/Dense_0/bias`` becomes ``head.bias``.
    Collections other than ``params`` (the ``telemetry`` that ``init``
    also returns) are ignored."""
    tree = params["params"] if "params" in params else params
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    out = OrderedDict()
    for name in sorted(tree, key=lambda k: (len(k), k)):
        leaf = tree[name]
        if re.fullmatch(r"conv\d+", name):
            out[f"{name}.weight"] = t(leaf["weight"])
            if "attention" in leaf:
                out[f"{name}.attention"] = t(leaf["attention"])
            if "bias" in leaf:
                out[f"{name}.bias"] = t(leaf["bias"])
        elif name == "Dense_0":
            out["head.weight"] = t(leaf["kernel"]).T.contiguous()
            out["head.bias"] = t(leaf["bias"])
        else:
            raise KeyError(f"unexpected parameter group {name!r}")
    return out


def int8_layer_from_jax(layer, *, device="cpu"):
    """A frozen ``Int8GCNLayer`` or ``Int8GATLayer`` of the JAX package
    (read by field name: the int8 arrays ``wq``, ``aq_src``, ``aq_dst`` and
    the static float scales) as the port's dataclass of the same name, so
    that both packages run the same frozen net."""
    from sgracex1_tpu_torch.quant.int8 import Int8GATLayer, Int8GCNLayer

    t = lambda a: torch.from_numpy(np.array(a, dtype=np.int8)).to(device)
    scales = {k: float(getattr(layer, k)) for k in ("s_x", "s_w", "s_a", "s_h")}
    if hasattr(layer, "aq_src"):
        return Int8GATLayer(
            wq=t(layer.wq), aq_src=t(layer.aq_src), aq_dst=t(layer.aq_dst),
            alpha=float(layer.alpha), **scales,
        )
    return Int8GCNLayer(wq=t(layer.wq), **scales)
