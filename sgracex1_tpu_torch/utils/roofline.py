"""Roofline attribution: the least time the card could take for a kernel's
work, and how far a measured time sits from it, as
``sgracex1_tpu.utils.roofline``.

A ``CostModel`` counts one call's work: operations by operand type (the
tensor cores' bf16 and int8 products, f32 multiply-adds outside them),
device-memory bytes (each input read once, each output written once),
CUDA-core elementwise operations and transcendentals (``exp``).
``CostModel.bound()`` is the bound every kernel row of ``chip_smoke.py``
reports: the larger of the bytes over the memory rate and the operations
over the peak rate of their type. ``CostModel.roofline(sec)`` attributes a
measured time to the resource closest to its peak, with the JAX module's
arithmetic under this card's names: ``memory`` (HBM), ``operations`` (the
MXU's place: tensor cores, or f32 FMAs for K9) and ``elementwise`` (the
VPU's: CUDA-core elementwise work and exps together).

The counts follow what the port's kernels read, not what the TPU kernels
did: the live tiles only (``BSRMatrix.live``, or the schedule of the tiles
that carry an edge), the live schedule's bytes, the chunk arrays, one
multiply-add a live chunk slot and feature, K9's 8 bytes of ``slot_cv`` a
live slot, K12's populated sub-blocks. ``cost_for_prep`` prices ``agg_matmul`` on any kind
from the prep's own arrays.

``H100_PEAKS``: NVIDIA's published rates for the H100 SXM at its 700 W
limit (3.35 TB/s of HBM; 989 / 1979 / 67 T operations a second for bf16 /
int8 / f32 dense), and three rates measured on the card by
``chip_smoke.phase_peaks`` (an NVIDIA H100 80GB HBM3 at 700.00 W): f32
elementwise operations, ``exp`` and an achievable device-to-device copy.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class Peaks:
    """One card's rates. ``operations`` maps an operand type to operations
    a second (a multiply-add counts two)."""

    card: str
    memory_bytes_s: float
    operations: Mapping[str, float]
    elementwise_s: float  # f32 elementwise operations / s (measured)
    exp_s: float  # f32 exp / s (measured)
    copy_bytes_s: float  # device-to-device copy, bytes read + written / s (measured)


H100_PEAKS = Peaks(
    card="NVIDIA H100 80GB HBM3, 700.00 W",
    memory_bytes_s=3.35e12,
    operations={"bf16": 989e12, "int8": 1979e12, "f32": 67e12},
    elementwise_s=6.18e13,
    exp_s=3.92e12,
    copy_bytes_s=2.95e12,
)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """One call's work. ``flops`` maps an operand type of ``Peaks.
    operations`` to its operations; ``elementwise`` and ``transcendentals``
    run on the CUDA cores beside them."""

    flops: Mapping[str, float]
    bytes: float
    note: str = ""
    elementwise: float = 0.0
    transcendentals: float = 0.0

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    def __add__(self, other: "CostModel") -> "CostModel":
        flops = dict(self.flops)
        for k, v in other.flops.items():
            flops[k] = flops.get(k, 0.0) + v
        return CostModel(
            flops, self.bytes + other.bytes, "+".join(n for n in (self.note, other.note) if n),
            self.elementwise + other.elementwise, self.transcendentals + other.transcendentals,
        )

    def _seconds(self, peaks: Peaks) -> tuple:
        ops_s = sum(v / peaks.operations[k] for k, v in self.flops.items())
        elt_s = self.elementwise / peaks.elementwise_s + self.transcendentals / peaks.exp_s
        return self.bytes / peaks.memory_bytes_s, ops_s, elt_s

    def bound(self, peaks: Peaks = H100_PEAKS) -> dict:
        """The least time the card could take: the bytes at the memory
        rate, or the operations at their type's peak, whichever is larger
        (``bound_by`` "bytes" or "operations")."""
        by_bytes, by_ops, _ = self._seconds(peaks)
        return dict(bound_ms=max(by_bytes, by_ops) * 1e3, bound_by="bytes" if by_bytes >= by_ops else "operations")

    def roofline(self, sec: float, peaks: Peaks = H100_PEAKS) -> dict:
        """Achieved rates and % of each peak at ``sec`` seconds; ``bound``
        names the resource whose utilisation is highest. ``pct_sol`` is the
        share of the serial-mix floor ``max(memory, operations +
        elementwise)`` achieved (the JAX module's speed of light: the
        elementwise work of a step feeds its products)."""
        mem_s, ops_s, elt_s = self._seconds(peaks)
        pcts = {"memory": 100.0 * mem_s / sec, "operations": 100.0 * ops_s / sec,
                "elementwise": 100.0 * elt_s / sec}
        bound = max(pcts, key=pcts.get)
        comp = ops_s + elt_s
        if mem_s >= comp:
            sol_bound = "memory"
        elif min(ops_s, elt_s) > 0.25 * comp:
            sol_bound = "elementwise+operations"
        else:
            sol_bound = "elementwise" if elt_s > ops_s else "operations"
        return dict(
            tflops=round(self.total_flops / sec / 1e12, 2),
            gb_s=round(self.bytes / sec / 1e9, 1),
            pct_memory=round(pcts["memory"], 1),
            pct_operations=round(pcts["operations"], 1),
            pct_elementwise=round(pcts["elementwise"], 1),
            bound=bound,
            pct_roofline=round(pcts[bound], 1),
            pct_sol=round(100.0 * max(mem_s, comp) / sec, 1) if sec > 0 else 0.0,
            sol_bound=sol_bound,
            note=self.note,
        )

    def fmt(self, sec: float, peaks: Peaks = H100_PEAKS) -> str:
        r = self.roofline(sec, peaks)
        return (f"{r['tflops']:6.2f} TF/s {r['gb_s']:6.1f} GB/s "
                f"{r['pct_roofline']:5.1f}% of the {r['bound']} roof")


# ------------------------------------------------------------ byte counts


def nbytes(*tensors) -> int:
    """Bytes of the tensors given (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def seg_bytes(S) -> int:
    """A ``RunSegments`` launch schedule's arrays."""
    return nbytes(*S.tensors().values())


def sched_bytes(L) -> int:
    """A ``LiveSchedule`` a ring kernel walks: its steps and segments."""
    return nbytes(L.step) + seg_bytes(L.segments)


def _tile_bytes(B) -> int:
    return (B.tiles.numel() // max(B.num_tiles, 1)) * B.tiles.element_size()


def live_tile_bytes(B) -> int:
    """Bytes of the live tiles (``B.live``). The empty cover tiles are all
    zero, so the function needs none of their bytes."""
    return int(B.live.sum()) * _tile_bytes(B)


def live_slots(plan) -> int:
    """The remainder chunk slots of a fused plan that hold an edge."""
    return int((plan.lrow < plan.B.tb).sum()) if plan.num_rest_chunks else 0


def pop_bits(pop) -> int:
    """Populated sub-blocks in a K12 bitmap (int32 words)."""
    return int(sum(((pop >> j) & 1).sum() for j in range(32)))


# ------------------------------------------------------------ kernels

# CUDA-core operations a tile element and head of the flash forward (mask
# test, score add, LeakyReLU, mask apply, running max, subtract the max),
# beside one exp; and of one backward pass's recompute and its own work
# (the JAX module's counts of the same arithmetic)
FLASH_GAT_ELT_OPS = 8
FLASH_BWD_ELT_OPS_ROW = 7 + 6
FLASH_BWD_ELT_OPS_COL = 7 + 3


def cost_tiles(B, P: int, io_bytes: int, *, plan=None, ring=None, op: str = "bf16") -> CostModel:
    """K1, K2, K8, K10 and K11 on this call's live tiles and chunks: a
    2*tb*tb*P product a live tile, one multiply-add a live chunk slot and
    feature; the tiles, the chunk arrays of ``plan``, the schedule and
    ``io_bytes`` (H and the output) once. ``ring`` counts the tiles of that
    live schedule instead of ``B.live`` (K8's ``edge_ring``: the tiles that
    carry an edge) and reads it as the schedule."""
    n_tiles = int(B.live.sum()) if ring is None else ring.n_tile_steps
    chunk_bytes = 0
    if plan is not None:
        chunk_bytes = nbytes(plan.lrow, plan.slot_col, plan.slot_scale, plan.colscale, plan.rowscale)
    sched = sched_bytes(ring if ring is not None else (plan.ring if plan is not None else B.ring))
    ops = 2.0 * n_tiles * B.tb * B.tb * P + (2.0 * live_slots(plan) * P if plan is not None else 0.0)
    return CostModel({op: ops}, float(n_tiles * _tile_bytes(B) + io_bytes + chunk_bytes + sched), "tiles")


def cost_k7(B, P: int, io_bytes: int) -> CostModel:
    """K7 on the row pieces that carry an edge (``B.edge_ring``; a piece
    of -128 bytes only is Aq = 0, and the function needs none of its
    bytes): a u8 x s8 product of 2*th*tb*P operations a piece."""
    from sgracex1_tpu_torch.ops.bsr import k7_row_piece

    L = B.edge_ring
    piece = k7_row_piece(B.tb) * B.tb
    return CostModel({"int8": 2.0 * L.n_tile_steps * piece * P},
                     float(L.n_tile_steps * piece + io_bytes + sched_bytes(L)), "k7")


def cost_pallas(plan, P: int, io_bytes: int) -> CostModel:
    """K9 (the gather kernel): the live slots' 8-byte (column, value) pairs
    of ``slot_cv``, the segment arrays and ``io_bytes`` once; two f32
    operations a live slot and feature, outside the tensor cores."""
    return CostModel({"f32": 2.0 * plan.slot_idx.numel() * P},
                     float(nbytes(plan.slot_cv) + io_bytes + seg_bytes(plan.segments)), "pallas")


def cost_flash_gat(B, H: int, F: int, io_bytes: int, *, products: int = 1, plan=None,
                   elt_ops: int = FLASH_GAT_ELT_OPS, exps: int = 1) -> CostModel:
    """One flash-GAT pass (K3, K6 with ``plan``, K4 with ``products`` 1,
    K5 with 2 on ``B.live_t``) on the live tiles and chunks: ``products``
    2*tb*tb*F products a live tile and head, one multiply-add a live chunk
    slot, head and feature, bf16 operands; the live tiles, the schedule
    (with ``plan``: its ring and the chunk rows and columns) and
    ``io_bytes`` once."""
    live = int(B.live.sum())
    sched = (nbytes(plan.lrow, plan.slot_col) + sched_bytes(plan.ring)) if plan is not None else sched_bytes(B.ring)
    slots = live_slots(plan) if plan is not None else 0
    elts = float(H * (live * B.tb * B.tb + slots))
    return CostModel(
        {"bf16": products * 2.0 * live * B.tb * B.tb * H * F + 2.0 * slots * H * F},
        float(live_tile_bytes(B) + io_bytes + sched), "flash-gat",
        elementwise=elt_ops * elts, transcendentals=exps * elts,
    )


def cost_flash_gat_bwd(B, H: int, F: int, io_bytes_row: int, io_bytes_col: int) -> CostModel:
    """The flash backward: K4 (one product a tile: the cotangent SDDMM) on
    ``B``'s live tiles and K5 (two: the SDDMM and ``p^T gO``) on the
    transposed live tiles ``B.live_t``, each recomputing ``p`` (one exp a
    tile element and head)."""
    row = cost_flash_gat(B, H, F, io_bytes_row, products=1, elt_ops=FLASH_BWD_ELT_OPS_ROW)
    col = cost_flash_gat(B.live_t, H, F, io_bytes_col, products=2, elt_ops=FLASH_BWD_ELT_OPS_COL)
    return dataclasses.replace(row + col, note="flash-gat-bwd")


def cost_subskip(B, pop, sb: int, F: int, io_bytes: int) -> CostModel:
    """K12 on its bitmap: the mask bytes and the product of the populated
    sub-blocks only, the tiles' column blocks, the bitmap and the segments."""
    bits = pop_bits(pop)
    return CostModel(
        {"bf16": 2.0 * bits * sb * sb * F},
        float(bits * sb * sb * B.tiles.element_size() + io_bytes + nbytes(B.tile_cb) + pop.nbytes
              + seg_bytes(B.segments)),
        "subskip",
    )


def cost_dense(n_pad: int, P: int, a_itemsize: int = 2) -> CostModel:
    """The dense kind: one [n, n] @ [n, P] product; the adjacency, H and the
    output once (the JAX module's count)."""
    return CostModel({"bf16": 2.0 * n_pad * n_pad * P},
                     float(n_pad * n_pad * a_itemsize + n_pad * P * 2 + n_pad * P * 4), "dense")


def cost_xla_edges(nnz: int, n_rows: int, P: int) -> CostModel:
    """The edge path (gather + scatter-add): per edge three index/value
    words, a gathered feature row and a read-modify-write of the output
    row (the JAX module's count)."""
    return CostModel({"f32": 2.0 * nnz * P}, float(nnz * 12 + nnz * P * 4 + 2 * nnz * P * 4), "xla-edges")


def cost_for_prep(prep, P: int, h_itemsize: int = 4) -> CostModel:
    """``agg_matmul(prep, H)`` at feature width ``P``, H of ``h_itemsize``
    bytes an element: the kind's kernel on this prep's arrays (K2 on the
    fused plan, else K1 plus the remainder's edge path; K9; the dense
    product; the edge path)."""
    A = prep.A
    h_bytes = A.n_cols * P * h_itemsize
    if prep.kind == "dense":
        return cost_dense(prep.dense.shape[0], P, prep.dense.element_size())
    if prep.kind == "pallas":
        return cost_pallas(prep.plan, P, h_bytes + A.n_rows * P * 4)
    if prep.kind in ("bsr", "hybrid"):
        if prep.fused is not None:
            B = prep.fused.B
            c = cost_tiles(B, P, h_bytes + B.n_row_tiles * B.tb * P * 2, plan=prep.fused)
        else:
            c = cost_tiles(prep.bsr, P, h_bytes + prep.bsr.n_row_tiles * prep.bsr.tb * P * 4)
            if prep.rest is not None and prep.rest.nnz:
                c = c + cost_xla_edges(prep.rest.nnz, A.n_rows, P)
        return dataclasses.replace(c, note=prep.kind)
    return cost_xla_edges(A.nnz, A.n_rows, P)

