"""Parameters of the JAX package's flax models as ``state_dict``s."""

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
