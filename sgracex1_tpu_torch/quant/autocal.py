"""Automatic quantization calibration from observed activation ranges, as
``sgracex1_tpu.quant.autocal``.

The conv layers record |x|, |W| and |XW| maxima on themselves when their
``telemetry`` flag is set (``nn/layers``); this module closes the loop: run
a float forward, harvest the ranges, emit a ``CalibrationTable`` ready for
QAT or int8 freezing.
"""

from __future__ import annotations

from typing import Optional

import torch

from sgracex1_tpu_torch.quant.calibration import CalibrationTable


def _telemetry_layers(model: torch.nn.Module) -> list:
    return [(n, m) for n, m in model.named_modules() if hasattr(m, "telemetry_stats")]


def harvest_telemetry(model: torch.nn.Module, *args, **kwargs) -> dict:
    """One forward pass (``model(*args, **kwargs)``, no gradients, the
    model's current train/eval mode) collecting per-layer amax telemetry.

    Returns {layer_name: {x_amax, w_absmax, wh_absmax}} in module order.
    Each layer's ``telemetry`` flag is switched on for the pass and put
    back afterwards."""
    layers = _telemetry_layers(model)
    saved = [m.telemetry for _, m in layers]
    for _, m in layers:
        m.telemetry = True
        m.telemetry_stats = {}
    try:
        with torch.no_grad():
            model(*args, **kwargs)
    finally:
        for (_, m), flag in zip(layers, saved):
            m.telemetry = flag
    return {
        name: {k: float(v) for k, v in m.telemetry_stats.items()}
        for name, m in layers if m.telemetry_stats
    }


def calibrate(
    model: torch.nn.Module,
    *args,
    qbits: int = 8,
    base: Optional[CalibrationTable] = None,
    **kwargs,
) -> CalibrationTable:
    """Build a ``CalibrationTable`` whose tensor ranges come from a real
    forward pass of the float model (layers in module order: first conv =
    layer 1, second conv = layer 2)."""
    tel = harvest_telemetry(model, *args, **kwargs)
    layers = list(tel.values())
    base = base or CalibrationTable.for_qbits(qbits)
    o = {}
    if len(layers) >= 1:
        o.update(
            f_min=0.0, f_max=max(layers[0]["x_amax"], 1e-8),
            w_min=-max(layers[0]["w_absmax"], 1e-8),
            w_max=max(layers[0]["w_absmax"], 1e-8),
        )
    if len(layers) >= 2:
        o.update(
            f_min2=0.0, f_max2=max(layers[1]["x_amax"], 1e-8),
            w_min2=-max(layers[1]["w_absmax"], 1e-8),
            w_max2=max(layers[1]["w_absmax"], 1e-8),
        )
    return CalibrationTable.for_qbits(qbits, {**base.raw, **o})
