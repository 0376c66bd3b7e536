"""Typed configuration, as ``sgracex1_tpu.config.SGRACEConfig``.

One frozen dataclass with the JAX package's fields that the port reads,
under their JAX names and defaults: the training loop's (``num_epochs``,
``learning_rate``, ``preload``, ``w_qbits`` through the learning-rate
rule) and ``prepare_from_config``'s (``use_pallas`` with the tiling
``row_block`` / ``col_block`` / ``edge_block`` of the ``pallas`` kind,
``fake_quantization``) and the mesh's (``mesh_axis``, ``num_shards``:
``parallel.make_mesh(cfg.num_shards, cfg.mesh_axis)``). The model's widths, heads, dropout, LeakyReLU slope
and calibration table are the model's own arguments.
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

    # --- kernel tiling of the pallas kind (ops/pallas_spmm.plan_spmm) ---
    col_block: int = 128  # columns of a tile (at least 128)
    row_block: int = 128  # rows of a tile (at least 8)
    edge_block: int = 2048  # slots of an edge group (a multiple of 1024)
    # prepare_from_config then prepares the pallas kind: the edge-group
    # plan that kernel K9 (ops/pallas_spmm.spmm_plan) aggregates over
    use_pallas: bool = False

    # --- distribution (parallel.make_mesh(num_shards, mesh_axis)) ---
    mesh_axis: str = "graph"
    num_shards: Optional[int] = None  # None => one shard

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
