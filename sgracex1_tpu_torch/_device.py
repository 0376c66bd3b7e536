"""The device rule of the port's entry points: the card unless the caller
asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card and
    raises where there is none (an entry point never carries on on the CPU
    by itself)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: sgracex1_tpu_torch runs on the GPU by default; "
            "pass device=\"cpu\" to run on the CPU"
        )
    return torch.device("cuda")
