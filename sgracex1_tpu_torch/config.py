"""Typed configuration, as ``sgracex1_tpu.config.SGRACEConfig``.

One frozen dataclass with the JAX package's fields that the port reads,
under their JAX names and defaults: the training loop's (``num_epochs``,
``learning_rate``, ``preload``, ``w_qbits`` through the learning-rate
rule) and ``prepare_from_config``'s (``use_pallas``,
``fake_quantization``). The model's widths, heads, dropout, LeakyReLU
slope and calibration table are the model's own arguments. A JAX field
joins this class with the part of the port that reads it (ROADMAP queue
1: Pallas tiling with item 14, distribution with item 16).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SGRACEConfig:
    """Training and adjacency-preparation settings (JAX field names)."""

    # --- quantization ---
    w_qbits: int = 8  # 1 / 2 / 4 / 8; read by the learning-rate rule
    # QAT: prepare_from_config then keeps value tiles (no rank-1 masks),
    # whose values the quantized layers remap per call
    fake_quantization: bool = False

    # --- kernel choice ---
    # raises in prepare_from_config (ROADMAP queue 1, item 14)
    use_pallas: bool = False

    # --- training loop ---
    learning_rate: Optional[float] = None  # None => the reference's qbits rule
    num_epochs: int = 100
    # checkpoint (``train/checkpoint.save_checkpoint``) to fine-tune from
    preload: Optional[str] = None

    def resolved_learning_rate(self) -> float:
        """The reference's qbits-dependent rule: preload fine-tuning =>
        1e-4, 8/4-bit => 0.01, 2/1-bit => 0.1; an explicit
        ``learning_rate`` wins."""
        if self.learning_rate is not None:
            return self.learning_rate
        if self.preload is not None:
            return 0.0001
        return 0.01 if self.w_qbits > 2 else 0.1

    def replace(self, **kw) -> "SGRACEConfig":
        return dataclasses.replace(self, **kw)
