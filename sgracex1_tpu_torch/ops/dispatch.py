"""Aggregation backend dispatch: ``prepare_adjacency`` once per graph on the
host, ``agg_matmul`` per layer.

Kinds, as in ``sgracex1_tpu.ops.dispatch``:

- ``dense``: the adjacency as a dense matrix (bf16 unless ``dense_dtype``
  says otherwise), one matmul.
- ``bsr``: nonempty dense tiles (``ops/bsr``).
- ``hybrid``: tiles holding at least ``rest_thresh`` edges stay tiles; the
  sparse remainder rides chunk steps of the fused kernel (``ops/fused_agg``)
  or, with ``fuse=False``, a scatter-add after the tile kernel.
- ``pallas``: the edges sorted into (row block, column block) groups
  (``ops/pallas_spmm``, kernel K9). The only kind whose values can be
  substituted per call for the price of a gather
  (``agg_matmul_with_vals``).
- ``xla``: gather + scatter-add on the edge list (``ops/spmm``), the
  always-correct spec.

A rank-1 factored adjacency (sym-normalized, unweighted) stores its tiles
as {0,1} masks, 1-bit packed when tb is a multiple of 1024, with the two
diagonal scalings applied around the tile products.

``method="auto"`` prices every kind with the JAX package's cost model
(``_estimate_backend_costs``: the dense matrix's bytes, the edge path's
seconds an edge, the seconds of a live tile and of a remainder chunk and
slot over this graph's own tile populations at each candidate tile size,
K9's edge groups) and takes the cheapest, as the JAX ``prepare_adjacency``
does; ``method="hybrid"`` without ``tb`` takes the model's tile size and
threshold. ``for_gat=True`` also attaches the flash-GAT layout that
``GATConv`` reads (``flash_tiles``; ``gat_plan`` for the hybrid split),
chosen by ``_choose_flash_plan``: full cover or a hybrid split, at a tile
size and threshold, priced for training (forward and the K4 + K5
backward) or, with ``gat_train=False``, for serving. The model's structure
and formulas are the JAX package's; its constants are a ``CostTable``, by
default ``H100_COSTS``, the card's own (measured on an NVIDIA H100 80GB
HBM3 at 700.00 W by ``chip_smoke.phase_cost_model``, which re-measures
them). Every function of the model takes ``costs=``: a table holding the
JAX constants gives the JAX numbers and choices. The prep records what the
model priced and the host seconds it took (``PreparedAdjacency.choice``).

``map_adjacency_vals`` remaps the values of every representation (the
quantized layers' adjacency quantizer), each at its first read; it needs
value tiles, which ``prepare_from_config`` keeps for ``fake_quantization``
configs.

``agg_matmul`` is differentiable (``_Agg``): on fused preps the gradient
of ``H`` is K2 on the transposed plan ``fused_t``, with ``fuse=False`` K1
on the transposed tiles ``bsr_t``, on the ``pallas`` kind K9 on ``plan_t``; the rank-1 scalings and the remainder
scatter stay plain torch ops around the tile kernel, as in the JAX
package. A backward through a bsr or hybrid prep built with
``build_transpose=False`` raises (the ``pallas`` kind always holds
``plan_t``, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from sgracex1_tpu_torch._device import resolve_device
from sgracex1_tpu_torch.graph.csr import SparseMatrix, _np
from sgracex1_tpu_torch.graph.normalize import rank1_factor
from sgracex1_tpu_torch.ops.bsr import (
    BSRMatrix,
    bsr_bitmask_from_sparse,
    bsr_from_sparse,
    bsr_mask_from_sparse,
    bsr_spmm,
    bsr_tile_keys,
    bsr_transpose,
)
from sgracex1_tpu_torch.ops.fused_agg import (
    DEFAULT_K,
    FusedAggPlan,
    build_fused_plan,
    bsr_spmm_fused,
)
from sgracex1_tpu_torch.ops.pallas_spmm import SpMMPlan, plan_spmm, plan_with_vals, spmm_plan
from sgracex1_tpu_torch.ops.spmm import spmm, spmm_into
from sgracex1_tpu_torch.utils.profiling import span

DENSE_MAX_BYTES = 512 << 20  # dense adjacency budget
# the tile size of an explicit ``bsr`` kind, or of a flash layout given
# only a threshold, without ``tb`` (the JAX default)
DEFAULT_TB = 256


@dataclasses.dataclass(frozen=True)
class PreparedAdjacency:
    """An adjacency prepared for one aggregation backend, on one device.

    ``A`` (the edge list) is always present. ``plan``/``plan_t`` are the
    forward/transposed edge-group plans of the ``pallas`` kind.
    ``bsr``/``bsr_t`` are the
    forward/transposed tiles, ``rest`` the hybrid remainder, ``r1_row`` /
    ``r1_col`` the rank-1 factors when the tiles are masks, and
    ``fused``/``fused_t`` the fused schedules that ``agg_matmul`` prefers
    when present. ``gat_bsr`` holds flash-GAT mask tiles (``for_gat``);
    with the hybrid attention split, ``gat_plan`` is the value-mode fused
    schedule over them plus the remainder ``gat_rest`` as chunks."""

    A: SparseMatrix
    kind: str = "xla"
    dense: Optional[torch.Tensor] = None
    plan: Optional[SpMMPlan] = None
    plan_t: Optional[SpMMPlan] = None
    bsr: Optional[BSRMatrix] = None
    bsr_t: Optional[BSRMatrix] = None
    rest: Optional[SparseMatrix] = None
    r1_row: Optional[torch.Tensor] = None
    r1_col: Optional[torch.Tensor] = None
    fused: Optional[FusedAggPlan] = None
    fused_t: Optional[FusedAggPlan] = None
    gat_bsr: Optional[BSRMatrix] = None
    gat_rest: Optional[SparseMatrix] = None
    gat_plan: Optional[FusedAggPlan] = None
    # the attention runs on ``plan`` / ``plan_t`` (ops/plan_gat), no mask
    # tiles: a ``pallas`` prep whose plan attention the model priced cheaper
    # than any flash layout (``for_gat``)
    gat_on_plan: bool = False
    # what the cost model priced: {"costs": seconds by kind, "best_tb",
    # "best_hy": the bsr and hybrid kinds' best (auto, or hybrid without
    # tb), "split": (tb, threshold), "flash": (tb, packed, threshold),
    # "seconds": the model's host seconds; on a ``pallas`` prep for GAT
    # also "gat": "plan" or "flash" and "gat_costs": each one's seconds}
    choice: Optional[dict] = None

    @property
    def flash_tiles(self) -> Optional[BSRMatrix]:
        """Tiles for the flash-GAT kernels: the dedicated mask tiles when
        attached (``for_gat``), else a ``bsr`` prep's tiles, which hold the
        whole adjacency. The hybrid kind's partial ``bsr`` is not a valid
        mask, and with ``gat_plan`` set ``gat_bsr`` holds only the dense
        attention tiles (the remainder rides the plan's chunks)."""
        if self.gat_bsr is not None:
            return self.gat_bsr
        return self.bsr if self.kind == "bsr" else None


def split_by_tile_density(
    A: SparseMatrix, tb: int, thresh: int
) -> tuple[SparseMatrix, SparseMatrix]:
    """Split edges into (dense-tile population, remainder): an edge is
    dense when its (row//tb, col//tb) tile holds >= thresh edges."""
    r = _np(A.rows)[: A.nnz]
    c = _np(A.cols)[: A.nnz]
    v = _np(A.vals)[: A.nnz]
    key = (r // tb).astype(np.int64) * (1 << 32) + c // tb
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    m = counts[inv] >= thresh if len(counts) else np.zeros(0, bool)
    shape = (A.n_rows, A.n_cols)
    return (
        SparseMatrix.from_coo(r[m], c[m], v[m], shape),
        SparseMatrix.from_coo(r[~m], c[~m], v[~m], shape),
    )


def _drop_zero_val_edges(M: SparseMatrix) -> SparseMatrix:
    """Drop zero-valued edges (e.g. fill=0 self-loops): the rank-1
    remainder adds edges in mask space with unit values, where a
    zero-valued edge would wrongly count as 1."""
    v = _np(M.vals)[: M.nnz]
    keep = v != 0
    if keep.all():
        return M
    r = _np(M.rows)[: M.nnz][keep]
    c = _np(M.cols)[: M.nnz][keep]
    return SparseMatrix.from_coo(r, c, v[keep], (M.n_rows, M.n_cols))


def _packs(tb: int) -> bool:
    """Mask tiles pack to 1 bit at tb % 1024 == 0: the JAX package's rule,
    kept so both packages prepare identical layouts."""
    return tb % 8 == 0 and (tb // 8) % 128 == 0


# ------------------------------------------------------------ cost model


@dataclasses.dataclass(frozen=True)
class CostTable:
    """The constants of the backend and flash-layout cost model (the JAX
    module's ``_HBM_BPS`` ... ``_FLASH_HYBRID_FIXED_S`` under lower-case
    names, with its candidate sizes and ladders). ``tile_s``, ``chunk_s``,
    ``row_s``, ``call_s`` and ``pallas_edge_s`` are the card's additions
    (measured tile and chunk seconds by size, a kind's seconds a node row
    and a call: host work and launches, which the TPU's jitted step hid;
    K9's seconds an edge): each is empty or 0 in a table of the JAX
    constants, and every formula then gives the JAX number. Seconds are one
    call's at P = 128 (the JAX model's lane width)."""

    card: str  # where the constants were measured
    # a live tile of K1/K2: max(tile + H-block bytes / hbm_bps, the product
    # at mxu_flops + the 1-bit unpack at vpu_ops) + step_s, unless tile_s
    # holds its measured seconds at (tb, bytes a tile element)
    hbm_bps: float
    step_s: float  # the JAX grid step's fixed seconds (the card: in call_s)
    mxu_flops: float
    vpu_ops: float
    tile_s: Mapping[Tuple[int, float], float]
    tbs: Tuple[int, ...]  # candidate tile sizes of the bsr and hybrid kinds
    # K2's remainder: a full chunk's seconds at each slot width K that the
    # fused plan's chooser takes (its candidates, choose_chunk_k), and a
    # slot's seconds
    rest_chunk_s: Mapping[int, float]
    rest_slot_s: float
    # a table of the JAX package's constants: its model's fixed remainder
    # price (a chunk's seconds, a slot's, the width); None on the card,
    # whose model prices the remainder at the width the plan will take
    rest_fixed: Optional[Tuple[float, float, int]]
    # a chunk of DEFAULT_K slots at a tile size past the ring's, where
    # measured (the single-stage kernel), scaled to the width taken
    chunk_s: Mapping[int, float]
    dense_bps: float  # the dense kind's adjacency bytes a second
    xla_edge_s: float  # the edge path's seconds an edge
    pallas_group_s: float  # K9: an edge group of pallas_block slots
    pallas_edge_s: float  # K9: an edge
    pallas_block: int  # the pallas kind's rb = cb = be the model prices
    row_s: Mapping[str, float]  # a kind's seconds a node row and call (casts, pre-passes)
    call_s: Mapping[str, float]  # a kind's fixed seconds a call
    # the flash-GAT layout (K3/K6 forward, K4 + K5 backward): a live tile,
    # a row-block run, a chunk, each per head, times flash_heads
    flash_tile_s: Mapping[int, float]
    flash_run_s: Mapping[int, float]
    flash_elt_s: float  # a tile element, for sizes outside flash_tile_s
    flash_run_elt_s: float  # a run, a tile row, for sizes outside flash_run_s
    flash_packed_mult: float  # a 1-bit packed tile against an int8 one
    flash_tile_budget: float  # bytes of mask tiles a layout may hold
    flash_chunk_k: int
    flash_chunk_res_s: float  # a chunk while the chunks fit flash_resident_budget
    flash_chunk_stream_s: float  # a chunk past it
    flash_payload_f: int
    flash_resident_budget: float
    flash_heads: int  # the heads a price is for
    flash_train_passes: float  # (forward + backward) / forward tile seconds
    flash_edge_bwd_s: float  # a remainder edge's backward on the edge path
    flash_bwd_fixed_s: float
    flash_hybrid_fixed_s: float
    flash_tbs: Tuple[int, ...]
    flash_packed_tbs: Tuple[int, ...]  # candidate sizes also priced 1-bit packed
    flash_threshs: Tuple[int, ...]  # the hybrid split's threshold ladder
    flash_full_cover_n: int  # full cover at tb 256 up to this many nodes
    shard_tbs: Tuple[int, ...]  # candidate tile sizes of a shard's local block
    # the plan attention (ops/plan_gat, on a pallas prep's plans) at
    # flash_heads heads of flash_payload_f features, the unit of the flash
    # prices: the forward's and the backward's two passes' seconds a live
    # slot, and their fixed seconds a training (forward + backward) call.
    # Infinite where not measured (the JAX package has no such kernel): the
    # flash layout is then always kept.
    plan_gat_slot_s: float = float("inf")
    plan_gat_bwd_slot_s: float = float("inf")
    plan_gat_call_s: float = 0.0


# Measured on an NVIDIA H100 80GB HBM3 at 700.00 W: the mean of two runs
# of chip_smoke._measure_costs (pallas_group_s measured below 0 in both:
# 0), which chip_smoke.phase_cost_model re-measures in every full run,
# failing where a held entry is off by more than 2x. Seconds of one
# agg_matmul at P = 128 with f32 H. The ring kernels take tiles of height
# 64-256; 512 and the 1-bit packed 1024 run the single-stage kernels and
# are priced at those kernels' seconds, a chunk past 256 likewise
# (chunk_s, at 128 slots). rest_chunk_s is the ring's full chunk (its slots
# included) at each width the plan's chooser takes, tb 256, and rest_slot_s
# a slot alone (one chunk of 64 and of 512 slots a row block): these three
# entries from one later run of the measurement on the same card. The
# chunk's seconds grow with its width at about a slot's seconds
# a slot, so the chooser's rule (chunks x a chunk + chunks x K x a slot)
# takes 128 wherever a wider chunk would not save a chunk without adding
# dead slots. step_s is 0: the card's
# fixed seconds are per kind (call_s). hbm_bps, mxu_flops and vpu_ops only
# price a tile size outside tile_s: the published memory rate, the ring's
# effective product rate at tb 256, the measured f32 elementwise rate.
# flash_heads: the flash prices are for 4 heads (the GAT slice's and PPI's
# first layer), measured per head at H = 4 (H = 1 beside it in the phase's
# output). The plan attention's entries: its kernels at H = 4, F = 64 on the
# gat-products graph at 2^20 nodes (53.96 M slots; forward 10.45 ms, the
# backward's row and column passes 12.41 + 17.60 ms, CUDA events, median of
# 5), and the wrappers' fixed cost from a 1024-node graph: the forward, both
# passes and two stagings, 0.563 ms.
H100_COSTS = CostTable(
    card="NVIDIA H100 80GB HBM3, 700.00 W",
    hbm_bps=3.35e12,
    step_s=0.0,
    mxu_flops=2.6e14,
    vpu_ops=6.2e13,
    tile_s={(64, 1.0): 1.55e-08, (128, 1.0): 3.12e-08, (256, 1.0): 5.91e-08, (512, 1.0): 6.63e-07,
            (1024, 0.125): 2.72e-06, (64, 2.0): 1.04e-08, (128, 2.0): 2.37e-08, (256, 2.0): 5.83e-08,
            (512, 2.0): 6.40e-07, (1024, 2.0): 2.60e-06},
    tbs=(64, 128, 256, 512, 1024),
    rest_chunk_s={128: 5.48e-08, 256: 1.06e-07, 512: 2.19e-07},
    rest_slot_s=4.1e-10,
    rest_fixed=None,
    chunk_s={512: 1.63e-07, 1024: 3.41e-07},
    dense_bps=2.76e11,
    xla_edge_s=1.94e-09,
    pallas_group_s=0.0,
    pallas_edge_s=9.83e-11,
    pallas_block=1024,
    row_s={"xla": 8.38e-11, "bsr": 6.75e-10, "hybrid": 6.26e-10, "pallas": 4.66e-10},
    call_s={"dense": 8.43e-05, "xla": 1.0e-04, "bsr": 1.92e-04, "hybrid": 1.89e-04, "pallas": 1.2e-04},
    flash_tile_s={64: 2.21e-08, 128: 3.74e-08, 256: 7.48e-08, 512: 3.9e-07, 1024: 1.46e-06},
    flash_run_s={},
    flash_elt_s=3e-12,
    flash_run_elt_s=1.58e-10,
    flash_packed_mult=0.765,
    flash_tile_budget=8 << 30,
    flash_chunk_k=128,
    flash_chunk_res_s=2.75e-08,
    flash_chunk_stream_s=2.75e-08,
    flash_payload_f=64,
    flash_resident_budget=float("inf"),
    flash_heads=4,
    flash_train_passes=3.22,
    flash_edge_bwd_s=1.01e-08,
    flash_bwd_fixed_s=2.94e-04,
    flash_hybrid_fixed_s=1.08e-04,
    flash_tbs=(64, 128, 256, 512, 1024),
    flash_packed_tbs=(1024,),
    flash_threshs=(2, 4, 8, 16, 32, 64, 128, 256, 768, 1536, 3072),
    flash_full_cover_n=8192,
    shard_tbs=(64, 128, 256, 512, 1024),
    plan_gat_slot_s=1.94e-10,
    plan_gat_bwd_slot_s=5.56e-10,
    plan_gat_call_s=5.63e-04,
)


def _tile_itemsize(tb: int, rank1: bool, dense_itemsize: int, costs: CostTable = H100_COSTS) -> float:
    """Bytes a tile element: 1-bit packed masks at ``_packs(tb)``, int8
    masks otherwise under a rank-1 factorization; value tiles in the dense
    dtype. (``costs`` is taken for the model's one signature.)"""
    if not rank1:
        return float(dense_itemsize)
    return 0.125 if _packs(tb) else 1.0


def _chunk_cost_s(tb: int, K: int, costs: CostTable = H100_COSTS) -> float:
    """Seconds of one remainder chunk of K2 with ``K`` slots at ``tb``:
    ``chunk_s`` scaled to K slots where measured at this size, else the
    ring's ``rest_chunk_s[K]``."""
    if tb in costs.chunk_s:
        return costs.chunk_s[tb] * K / DEFAULT_K
    return costs.rest_chunk_s[K]


def choose_chunk_k(counts: np.ndarray, tb: int, costs: CostTable = H100_COSTS) -> int:
    """The fused plan's slot width, by the JAX package's rule
    (``build_fused_plan(K=None)``): among the widths ``rest_chunk_s`` prices,
    in increasing order, the first whose chunks cost least, chunks x a
    chunk's seconds + chunks x K x a slot's, for ``counts`` remainder edges
    a row block."""
    best = None
    for k in sorted(costs.rest_chunk_s):
        nck = -(-counts // k)
        cost = nck.sum() * _chunk_cost_s(tb, k, costs) + nck.sum() * k * costs.rest_slot_s
        if best is None or cost < best[0]:
            best = (cost, k)
    return best[1]


def _rest_slot_cost_s(tb: int, K: int = DEFAULT_K, costs: CostTable = H100_COSTS) -> float:
    """An edge's seconds on the remainder's chunk path at ``tb`` in chunks
    of ``K`` slots (``rest_fixed`` where the table fixes the price): its
    slot and its share of a full chunk."""
    if costs.rest_fixed is not None:
        chunk, slot, k = costs.rest_fixed
        return slot + chunk / k
    return costs.rest_slot_s + _chunk_cost_s(tb, K, costs) / K


def _hybrid_split(tb: int, uniq: np.ndarray, counts: np.ndarray, tc: float, costs: CostTable = H100_COSTS,
                  K: Optional[int] = None) -> tuple:
    """The hybrid split of a tile population at ``tb`` (sorted tile keys
    ``uniq``, their edge ``counts``; ``tc`` a live tile's seconds) and its
    remainder's price: (threshold, dense flags, remainder edges a row block,
    a chunk's seconds, a slot's, the chunk width). A tile stays dense where
    its edges' seconds on the chunk path reach a tile's (JAX's rule), in
    chunks of ``K`` slots (DEFAULT_K where None). The remainder is priced
    at ``rest_fixed`` where the table fixes the price, at ``K`` where given
    (a plan of fixed width), else at the width the plan's chooser takes for
    it (``choose_chunk_k``)."""
    thresh = int(np.ceil(tc / _rest_slot_cost_s(tb, DEFAULT_K if K is None else K, costs)))
    dense = counts >= thresh
    rest_by_rb = np.bincount(
        (uniq >> 32)[~dense].astype(np.int64), weights=counts[~dense].astype(np.float64),
    )
    if costs.rest_fixed is not None:
        chunk, slot, k = costs.rest_fixed
    else:
        k = choose_chunk_k(rest_by_rb, tb, costs) if K is None else K
        chunk, slot = _chunk_cost_s(tb, k, costs), costs.rest_slot_s
    return thresh, dense, rest_by_rb, chunk, slot, k


def _tile_cost_s(tb: int, itemsize: float, costs: CostTable = H100_COSTS) -> float:
    """Seconds of one live tile of K1/K2 (JAX ``_tile_cost_s``): the
    measured ``costs.tile_s`` where it holds this size and form, else the
    larger of the tile's bytes and its product (plus the 1-bit unpack) at
    the table's rates, plus the step."""
    measured = costs.tile_s.get((tb, float(itemsize)))
    if measured is not None:
        return measured
    dma = (tb * tb * itemsize + tb * 128 * 2 * 2) / costs.hbm_bps
    mxu = 2.0 * tb * tb * 128 / costs.mxu_flops
    vpu = (tb * tb * 4.0 / costs.vpu_ops) if itemsize < 1 else 0.0
    return max(dma, mxu + vpu) + costs.step_s


def _edge_keys(A: SparseMatrix) -> tuple:
    r = _np(A.rows)[: A.nnz].astype(np.int64)
    c = _np(A.cols)[: A.nnz].astype(np.int64)
    return r, c


def _tile_populations(r: np.ndarray, c: np.ndarray, tbs) -> dict:
    """``{tb: (keys, counts)}``: the sorted ``(row // tb) << 32 | col // tb``
    keys of the tiles holding an edge, and their edge counts. ``np.unique``
    runs over the edges once, at the finest size; each size that a smaller
    one divides is merged from that one's keys (far fewer than the edges)."""
    out, prev = {}, None
    for tb in sorted(set(tbs)):
        if prev is not None and tb % prev[0] == 0:
            f = tb // prev[0]
            keys = ((prev[1] >> 32) // f) << 32 | ((prev[1] & 0xFFFFFFFF) // f)
            uniq, inv = np.unique(keys, return_inverse=True)
            counts = np.bincount(inv, weights=prev[2], minlength=len(uniq)).astype(np.int64)
        else:
            uniq, counts = np.unique((r // tb) << 32 | (c // tb), return_counts=True)
        out[tb] = (uniq, counts)
        prev = (tb, uniq, counts)
    return out


def _estimate_backend_costs(
    A: SparseMatrix, dense_dtype=torch.bfloat16, tbs=None, rank1: bool = False,
    costs: CostTable = H100_COSTS,
):
    """Seconds of one ``agg_matmul`` at P = 128 on each kind (JAX
    ``_estimate_backend_costs``): the dense matrix's bytes; the edge path's
    edges; the bsr kind's tiles at its best tile size; the hybrid kind's
    dense tiles, chunks and slots at its best (tile size, threshold), the
    threshold where one tile's seconds equal its edges' on the chunk path;
    K9's groups (and, on the card, edges). ``rank1`` marks a rank-1
    factorization (mask tiles, ``_tile_itemsize``). Returns (costs by kind,
    the best bsr tile size, the best (tile size, threshold))."""
    itemsize = torch.empty((), dtype=dense_dtype).element_size()
    n = max(A.n_rows, A.n_cols)
    row = lambda kind: n * costs.row_s.get(kind, 0.0) + costs.call_s.get(kind, 0.0)
    tbs = costs.tbs if tbs is None else tuple(tbs)
    r, c = _edge_keys(A)
    pops = _tile_populations(r, c, tbs + (costs.pallas_block,))
    est = {
        "dense": n * n * itemsize / costs.dense_bps + costs.step_s + row("dense"),
        "xla": A.nnz * costs.xla_edge_s + costs.step_s + row("xla"),
    }
    best_tb, best_t = None, np.inf
    best_hy, best_hy_t = None, np.inf
    for tb in tbs:
        uniq, counts = pops[tb]
        if len(counts) == 0:
            uniq = np.zeros(1, np.int64)
            counts = np.ones(1, np.int64)
        tc = _tile_cost_s(tb, _tile_itemsize(tb, rank1, itemsize), costs)
        t = len(counts) * tc
        if t < best_t:
            best_tb, best_t = tb, t
        thresh, dense_tiles, rest_by_rb, chunk, slot, k = _hybrid_split(tb, uniq, counts, tc, costs)
        n_chunks = int(np.ceil(rest_by_rb / k).sum())
        t_hy = (
            int(dense_tiles.sum()) * tc
            + n_chunks * chunk
            + int(counts[~dense_tiles].sum()) * slot
            + costs.step_s
        )
        if t_hy < best_hy_t:
            best_hy, best_hy_t = (tb, thresh), t_hy
    est["bsr"] = best_t + row("bsr")
    est["hybrid"] = best_hy_t + row("hybrid")
    blk = costs.pallas_block
    counts = pops[blk][1]
    n_groups = int(np.sum(-(-counts // blk))) if len(counts) else 1
    est["pallas"] = n_groups * costs.pallas_group_s + A.nnz * costs.pallas_edge_s + row("pallas")
    return est, best_tb, best_hy


def _rest_thresh(tb: int, rank1: bool, dense_itemsize: int, costs: CostTable = H100_COSTS,
                 K: int = DEFAULT_K) -> int:
    """The hybrid split's threshold at ``tb``: the edges whose chunk-path
    seconds, in chunks of ``K`` slots, equal one tile's (JAX
    ``prepare_adjacency`` with an explicit ``tb``; ``_hybrid_split``)."""
    tc = _tile_cost_s(tb, _tile_itemsize(tb, rank1, dense_itemsize, costs), costs)
    return int(np.ceil(tc / _rest_slot_cost_s(tb, K, costs)))


def _flash_tile_s(tb: int, packed: bool, costs: CostTable = H100_COSTS) -> float:
    base = costs.flash_tile_s.get(tb, tb * tb * costs.flash_elt_s + costs.step_s)
    return base * (costs.flash_packed_mult if packed else 1.0) * costs.flash_heads


def _flash_run_s(tb: int, costs: CostTable = H100_COSTS) -> float:
    return costs.flash_run_s.get(tb, tb * costs.flash_run_elt_s) * costs.flash_heads


def _flash_chunk_s(tb: int, n_chunks: int = 1, K: Optional[int] = None, costs: CostTable = H100_COSTS) -> float:
    """Seconds of one flash chunk at this chunk population. The JAX table
    switches at a VMEM residency budget, which means nothing on the card:
    there the budget is infinite and a chunk is priced per head, times
    ``flash_heads``."""
    K = costs.flash_chunk_k if K is None else K
    payload = n_chunks * K * (costs.flash_payload_f + 9) * 4
    per = costs.flash_chunk_res_s if payload <= costs.flash_resident_budget else costs.flash_chunk_stream_s
    return per * costs.flash_heads


def _choose_flash_tb(A: SparseMatrix, n: int, costs: CostTable = H100_COSTS) -> tuple:
    """(tb, packed) of full-cover flash mask tiles."""
    tb, packed, _ = _choose_flash_plan(A, n, hybrid=False, costs=costs)
    return tb, packed


def _flash_layout_costs(
    A: SparseMatrix, *, hybrid: bool = True, train: bool = True, costs: CostTable = H100_COSTS,
) -> dict:
    """``{(tb, packed, rest_thresh): seconds}`` of every flash layout whose
    mask tiles fit ``flash_tile_budget``, in the JAX chooser's order: full
    cover (``rest_thresh`` None) and, with ``hybrid``, the split at each
    threshold of the ladder; the tiles ``flash_train_passes`` times for
    training (forward + backward) and once for serving, the hybrid's
    remainder backward on the edge path."""
    r, c = _edge_keys(A)
    K = costs.flash_chunk_k
    passes = costs.flash_train_passes if train else 1.0
    pops = _tile_populations(r, c, costs.flash_tbs)
    out = {}
    for tb in costs.flash_tbs:
        uniq, counts = pops[tb]
        T = len(uniq)
        rb, cb = uniq >> 32, uniq & 0xFFFFFFFF
        starts = np.flatnonzero(np.r_[True, rb[1:] != rb[:-1]]) if T else np.zeros(0, np.int64)
        n_rt = -(-A.n_rows // tb)
        n_ct = -(-A.n_cols // tb)
        splits = []  # (thresh, dense tiles, cover tiles, chunks, remainder edges)
        if hybrid and T:
            # a row block's run (keys sort by row block) and a column block
            # hold a tile that reaches a threshold where their fullest tile does
            top_r = np.sort(np.maximum.reduceat(counts, starts))
            top_c = np.zeros(int(cb.max()) + 1, counts.dtype)
            np.maximum.at(top_c, cb, counts)
            top_c = np.sort(top_c)
            # a tile is dense at the ladder's first `b` thresholds (those <= its
            # count), a remainder tile at the rest: one pass sums each row
            # block's edges by that bin, whose running sums are its remainder
            th = np.asarray(costs.flash_threshs, np.int64)
            nb = len(th) + 1
            b = np.searchsorted(th, counts, side="right")
            rest = np.cumsum(np.bincount(rb * nb + b, weights=counts.astype(np.float64),
                                         minlength=n_rt * nb).reshape(-1, nb), axis=1)
            n_rest = np.cumsum(np.bincount(b, minlength=nb))
            for j, thresh in enumerate(costs.flash_threshs):
                T_d = T - int(n_rest[j])
                if T_d == 0:
                    continue
                # a row or column block without a dense tile takes one zero
                # cover tile; a row block's rest rounds up to whole chunks
                runs_d = len(top_r) - int(np.searchsorted(top_r, thresh))
                cols_d = len(top_c) - int(np.searchsorted(top_c, thresh))
                splits.append((thresh, T_d, (n_rt - runs_d) + (n_ct - cols_d),
                               int(np.ceil(rest[:, j] / K).sum()), int(rest[:, j].sum())))
        for packed in ((False, True) if tb in costs.flash_packed_tbs else (False,)):
            tile_bytes = tb * tb / (8.0 if packed else 1.0)
            tc = _flash_tile_s(tb, packed, costs)
            if T * tile_bytes <= costs.flash_tile_budget:
                out[(tb, packed, None)] = passes * (T * tc + len(starts) * _flash_run_s(tb, costs))
            for thresh, T_d, cover, n_chunks, e_rest in splits:
                cc = _flash_chunk_s(tb, n_chunks, costs=costs)
                if (T_d + cover) * tile_bytes <= costs.flash_tile_budget:
                    out[(tb, packed, thresh)] = (
                        passes * ((T_d + cover) * tc + n_rt * _flash_run_s(tb, costs))
                        + n_chunks * cc
                        + costs.flash_hybrid_fixed_s
                        + (e_rest * costs.flash_edge_bwd_s + costs.flash_bwd_fixed_s if train else 0.0)
                    )
    return out


def _plan_gat_cost_s(nnz: int, train: bool = True, costs: CostTable = H100_COSTS) -> float:
    """Seconds of the plan attention (``ops/plan_gat``) over ``nnz`` live
    slots, forward and backward or, with ``train=False``, the forward alone,
    in the flash prices' unit (``flash_heads`` heads of ``flash_payload_f``)."""
    per = costs.plan_gat_slot_s + (costs.plan_gat_bwd_slot_s if train else 0.0)
    return nnz * per + costs.plan_gat_call_s


def _choose_flash_plan(
    A: SparseMatrix, n: int, *, hybrid: bool = True, train: bool = True, costs: CostTable = H100_COSTS,
) -> tuple:
    """(tb, packed, rest_thresh) of the flash-GAT layout (JAX
    ``_choose_flash_plan``): full cover at tb 256 up to
    ``flash_full_cover_n`` nodes, else the cheapest of
    ``_flash_layout_costs`` (full cover, ``rest_thresh`` None, or the
    hybrid split, whose tiles holding >= ``rest_thresh`` edges stay tiles
    and cover every row and column block while the rest rides chunk
    steps), the first of equal prices; 1-bit packed tb 1024 full cover
    where nothing fits the budget."""
    if n <= costs.flash_full_cover_n:
        return 256, False, None
    return _cheapest_flash(_flash_layout_costs(A, hybrid=hybrid, train=train, costs=costs))


def _cheapest_flash(est: dict) -> tuple:
    if not est:
        return 1024, True, None  # nothing fits as int8: packed capacity
    return min(est, key=est.get)


def prepare_adjacency(
    A: SparseMatrix,
    *,
    method: str = "auto",
    dense_max_bytes: int = DENSE_MAX_BYTES,
    dense_dtype: torch.dtype = torch.bfloat16,
    rb: int = 1024,
    cb: int = 1024,
    be: int = 1024,
    tb: Optional[int] = None,
    rest_thresh: Optional[int] = None,
    rank1: bool = True,
    rank1_factors=None,
    build_transpose: bool = True,
    fuse: bool = True,
    for_gat: bool = False,
    gat_tb: Optional[int] = None,
    gat_rest_thresh: Optional[int] = None,
    gat_train: bool = True,
    gat_self_loops: bool = False,
    costs: CostTable = H100_COSTS,
    fused_k: Optional[int] = None,
    device=None,
) -> PreparedAdjacency:
    """Prepare ``A`` for one backend, with its tensors on ``device``: the
    CUDA card by default (a ``RuntimeError`` where there is none), the CPU
    only with ``device="cpu"``.

    ``dense_dtype`` is the dense kind's matrix dtype, and sets the
    ``auto`` rule's budget ``n * n * itemsize``; ``agg_matmul`` reads H in
    it (so ``torch.float32`` keeps H unrounded).

    ``rb`` / ``cb`` / ``be`` are the ``pallas`` kind's row block, column
    block and edge-group size (``plan_spmm``; the JAX defaults).

    ``rank1`` detects a diagonal factorization of the edge values
    (``graph/normalize.rank1_factor``) and then stores mask tiles.
    ``rank1_factors`` gives the factorization ``(s_row, s_col)`` instead
    and skips the detection (the caller vouches for ``v(r, c) = s_row[r] *
    s_col[c]`` on every positive edge, e.g. a verified global factorization
    sliced to a block), whatever ``rank1`` says.
    ``build_transpose=False`` skips the transposed tiles and fused plans
    that only a backward reads; the ``pallas`` kind builds ``plan_t``
    whatever the flag, as the JAX package does. ``fuse=False`` runs the
    tile kernel K1 plus a remainder scatter instead of the fused kernel K2;
    it keeps f32 accumulation where K2 writes bf16. ``fused_k`` fixes the
    fused plans' chunk width; by default each plan takes the width the
    JAX package's rule prices cheapest on ``costs`` for its own remainder
    (``build_fused_plan(K=None)``), and the hybrid threshold is priced at
    DEFAULT_K slots (at ``fused_k`` where given).

    ``method="auto"`` takes the kind the cost model prices cheapest
    (``_estimate_backend_costs`` with ``costs``; ``dense`` only where the
    matrix fits ``dense_max_bytes``), at the model's tile size (``bsr``) or
    split (``hybrid``); ``method="hybrid"`` without ``tb`` takes the
    model's split, with ``tb`` the model's threshold at that size. An
    explicit ``tb`` / ``rest_thresh`` overrides the model's.

    ``for_gat`` chooses the attention's layout unless the prep's own tiles
    already serve (``flash_tiles``). There are three: the flash layouts,
    full-cover mask tiles or the hybrid split of dense mask tiles and a
    remainder edge list (``_choose_flash_plan`` with ``costs``, priced for
    training, or for serving alone with ``gat_train=False``); and, on the
    ``pallas`` kind, the plan attention on ``plan`` / ``plan_t``
    (``ops/plan_gat``, ``gat_on_plan``), priced by ``_plan_gat_cost_s``
    against the flash layout the chooser takes, the cheaper taken (no mask
    tiles are built where the plan attention wins; both prices are in
    ``prep.choice``). A prep with none of them runs the edge path. The edge
    path and the hybrid remainder's backward materialise a per-edge
    ``[E, H, F]`` tensor, the plan attention and the mask tiles do not.
    ``gat_tb`` / ``gat_rest_thresh`` override the choice: full cover at
    ``gat_tb`` without a threshold, the hybrid split at ``gat_rest_thresh``
    (at ``gat_tb``, else ``DEFAULT_TB``). ``gat_self_loops`` is for a model
    whose attention adds a self-loop a node (``GATConv(add_self_loops=True)``),
    which no mask tile holds: ``auto`` then prepares the ``pallas`` kind,
    which takes the plan attention unpriced; any other kind, or a
    ``gat_tb`` / ``gat_rest_thresh``, raises ``ValueError``."""
    with span("prepare") as s:
        device = resolve_device(device)
        n = max(A.n_rows, A.n_cols)
        if method not in ("auto", "dense", "bsr", "hybrid", "pallas", "xla"):
            raise ValueError(f"unknown method {method!r}")
        if for_gat and gat_self_loops and method == "auto":
            method = "pallas"  # the one kind whose attention holds self-loops
        itemsize = torch.empty((), dtype=dense_dtype).element_size()
        fac = None
        if method in ("auto", "hybrid", "bsr"):
            if rank1_factors is not None:
                fac = tuple(np.asarray(f, np.float32) for f in rank1_factors)
            elif rank1:
                with span("prepare.rank1"):
                    fac = rank1_factor(A)
        choice = None
        if method == "auto" or (method == "hybrid" and tb is None):
            t0 = time.perf_counter()
            with span("prepare.cost_model"):
                est, best_tb, best_hy = _estimate_backend_costs(A, dense_dtype, rank1=fac is not None, costs=costs)
            if method == "auto":
                if n * n * itemsize > dense_max_bytes:
                    est.pop("dense")
                method = min(est, key=est.get)
                if method == "bsr" and tb is None:
                    tb = best_tb
            if method == "hybrid" and tb is None:
                tb, rest_thresh = best_hy[0], (best_hy[1] if rest_thresh is None else rest_thresh)
            choice = dict(costs=est, best_tb=best_tb, best_hy=best_hy, seconds=time.perf_counter() - t0)
        if for_gat and gat_self_loops and (method != "pallas" or gat_tb is not None or gat_rest_thresh is not None):
            raise ValueError(
                f"gat_self_loops: the attention's self-loops run on the pallas kind's plans, not on "
                f"{method!r} with gat_tb={gat_tb}, gat_rest_thresh={gat_rest_thresh} (mask tiles hold none)"
            )
        with span("prepare.upload"):
            A_dev = A.to(device)

        def finish(prep: PreparedAdjacency) -> PreparedAdjacency:
            s.set(kind=prep.kind)
            if choice is not None:
                prep = dataclasses.replace(prep, choice=choice)
            if not for_gat or prep.flash_tiles is not None:
                return prep
            return dataclasses.replace(prep, **_gat_layout(
                A, n, gat_tb, gat_rest_thresh, gat_train, costs, choice, device, on_plan=prep.kind == "pallas",
                self_loops=gat_self_loops,
            ))

        if method == "xla":
            return finish(PreparedAdjacency(A=A_dev, kind="xla"))
        if method == "pallas":
            tiling = dict(rb=rb, cb=cb, be=be, device=device)
            return finish(PreparedAdjacency(
                A=A_dev, kind="pallas", plan=_traced_plan(A, False, tiling),
                plan_t=_traced_plan(A, True, tiling),
            ))
        if method == "dense":
            d = torch.from_numpy(A.to_dense().astype(np.float32))
            return finish(PreparedAdjacency(
                A=A_dev, kind="dense", dense=d.to(dense_dtype).to(device)
            ))

        tb = DEFAULT_TB if tb is None else tb

        def tiles_pair(M: SparseMatrix):
            """(forward, transposed) tiles: values, int8 masks, or packed
            masks (the packed transpose is built from the transposed edges)."""
            cover = dict(cover_rows=True, cover_cols=True, device=device)
            if fac is not None and _packs(tb):
                B = bsr_bitmask_from_sparse(M, tb=tb, **cover)
                Bt = (
                    bsr_bitmask_from_sparse(M.transpose(), tb=tb, **cover)
                    if build_transpose else None
                )
                return B, Bt
            if fac is not None:
                B = bsr_mask_from_sparse(M, tb=tb, **cover)
            else:
                B = bsr_from_sparse(M, tb=tb, **cover)
            return B, (bsr_transpose(B) if build_transpose else None)

        def fused_pair(B, Bt, src: SparseMatrix, rest_m):
            if not fuse:
                return None, None
            r1r, r1c = fac if fac is not None else (None, None)
            keys = lambda M: bsr_tile_keys(M, tb, cover_rows=True, cover_cols=True)
            fused = build_fused_plan(
                B, rest_m, r1_row=r1r, r1_col=r1c, tile_keys=keys(src),
                attach_chunks=True, K=fused_k, costs=costs,
            )
            fused_t = None
            if Bt is not None:
                fused_t = build_fused_plan(
                    Bt, rest_m.transpose() if rest_m is not None else None,
                    r1_row=r1c, r1_col=r1r, tile_keys=keys(src.transpose()),
                    attach_chunks=True, K=fused_k, costs=costs,
                )
            return fused, fused_t

        r1 = {}
        if fac is not None:
            r1 = dict(
                r1_row=torch.from_numpy(fac[0]).to(device),
                r1_col=torch.from_numpy(fac[1]).to(device),
            )
        if method == "hybrid":
            if rest_thresh is None:
                rest_thresh = _rest_thresh(tb, fac is not None, itemsize, costs, K=fused_k or DEFAULT_K)
            if choice is not None:
                choice["split"] = (tb, rest_thresh)
            part, rest = split_by_tile_density(A, tb, rest_thresh)
            if fac is not None and rest.nnz:
                rest = _drop_zero_val_edges(rest)
            rest = rest if rest.nnz else None
            B, Bt = tiles_pair(part)
            fused, fused_t = fused_pair(B, Bt, part, rest)
            return finish(PreparedAdjacency(
                A=A_dev, kind="hybrid", bsr=B, bsr_t=Bt,
                rest=rest.to(device) if rest is not None else None,
                fused=fused, fused_t=fused_t, **r1,
            ))
        B, Bt = tiles_pair(A)
        fused, fused_t = fused_pair(B, Bt, A, None)
        return finish(PreparedAdjacency(
            A=A_dev, kind="bsr", bsr=B, bsr_t=Bt, fused=fused, fused_t=fused_t,
            **r1,
        ))


def _traced_plan(A: SparseMatrix, transposed: bool, tiling: dict) -> SpMMPlan:
    """``plan_spmm`` of ``A`` (or of its transpose) in a ``prepare.plan``
    span that counts its groups, slots (groups x ``be``) and live slots."""
    with span("prepare.plan", transposed=int(transposed)) as s:
        plan = plan_spmm(A.transpose() if transposed else A, **tiling)
        s.set(groups=plan.num_groups, slots=plan.num_groups * plan.be, live_slots=plan.nnz)
    return plan


def _gat_layout(
    A: SparseMatrix, n: int, tb: Optional[int], thresh: Optional[int], train: bool,
    costs: CostTable, choice: Optional[dict], device, on_plan: bool = False, self_loops: bool = False,
) -> dict:
    """The flash-GAT fields of a prep (``_finish`` of the JAX prepare): the
    layout ``_choose_flash_plan`` prices cheapest, or the one ``tb`` /
    ``thresh`` ask for. With ``on_plan`` (a ``pallas`` prep) and neither
    asked for, the plan attention on the prep's own plans is priced beside
    the flash layout ``_choose_flash_plan`` takes (``_plan_gat_cost_s``
    against that layout's ``_flash_layout_costs`` entry), the cheaper taken
    and both recorded (``choice["gat"]``, ``choice["gat_costs"]``); where the
    plan attention wins no mask tile is built. With ``self_loops`` as well
    the plan attention is taken unpriced against the flash layouts, which
    cannot serve it (``choice["gat_costs"]`` holds its price alone).

    Hybrid split: the tiles holding >= ``thresh`` edges become int8 (or
    packed) mask tiles covering every row and column block; the remainder,
    without its zero-valued edges (GAT masks on val > 0), rides the chunks
    of a value-mode fused plan. Full cover (or a degenerate split): mask
    tiles of the whole adjacency."""
    if tb is None and thresh is None and on_plan and self_loops:
        return dict(gat_on_plan=True, choice=dict(choice or {}, gat="plan",
                                                   gat_costs=dict(plan=_plan_gat_cost_s(A.nnz, train, costs))))
    if tb is None and thresh is None and on_plan:
        t0 = time.perf_counter()
        est = _flash_layout_costs(A, train=train, costs=costs)
        key = (256, False, None) if n <= costs.flash_full_cover_n else _cheapest_flash(est)
        costs_s = dict(plan=_plan_gat_cost_s(A.nnz, train, costs), flash=est.get(key, float("inf")))
        choice = dict(choice or {}, gat_costs=costs_s,
                      seconds=(choice or {}).get("seconds", 0.0) + time.perf_counter() - t0)
        if costs_s["plan"] < costs_s["flash"]:
            return dict(gat_on_plan=True, choice=dict(choice, gat="plan"))
        choice["gat"] = "flash"
        tb, packed, thresh = key
    elif tb is None and thresh is None:
        t0 = time.perf_counter()
        tb, packed, thresh = _choose_flash_plan(A, n, train=train, costs=costs)
        choice = dict(choice or {}, seconds=(choice or {}).get("seconds", 0.0) + time.perf_counter() - t0)
    else:
        tb = DEFAULT_TB if tb is None else tb
        packed = _packs(tb)
    choice = dict(choice or {}, flash=(tb, packed, thresh))
    build = bsr_bitmask_from_sparse if packed else bsr_mask_from_sparse
    if thresh is not None:
        part, grest = split_by_tile_density(A, tb, thresh)
        grest = _drop_zero_val_edges(grest)
        if part.nnz and grest.nnz:
            cover = dict(cover_rows=True, cover_cols=True)
            tiles = build(part, tb=tb, device=device, **cover)
            plan = build_fused_plan(
                tiles, grest, K=costs.flash_chunk_k, attach_chunks=True,
                tile_keys=bsr_tile_keys(part, tb, **cover),
            )
            return dict(gat_bsr=tiles, gat_rest=grest.to(device), gat_plan=plan, choice=choice)
    return dict(gat_bsr=build(A, tb=tb, device=device), choice=choice)


def prepare_from_config(
    A: SparseMatrix, cfg, *, for_gat: bool = False, method: Optional[str] = None,
    gat_self_loops: bool = False, device=None,
) -> PreparedAdjacency:
    """``prepare_adjacency`` driven by an ``SGRACEConfig``: ``method`` when
    it names a backend, else the ``pallas`` kind with ``cfg.use_pallas``,
    else the cost model's choice (``method="auto"``). The config's tiling
    (``row_block`` / ``col_block`` / ``edge_block``) reaches the ``pallas``
    kind clamped as in the JAX package: at least 8 rows, 128 columns and
    1024 edges, the edge block rounded up to a multiple of 1024. Mask
    tiles with rank-1 scalings unless the config fake-quantizes the
    adjacency (QAT layers remap the adjacency values per call, which {0,1}
    mask tiles cannot hold: ``map_adjacency_vals``). ``gat_self_loops`` and
    ``device`` as in ``prepare_adjacency``."""
    be = (max(cfg.edge_block, 1024) + 1023) // 1024 * 1024
    return prepare_adjacency(
        A, method=method or ("pallas" if cfg.use_pallas else "auto"),
        rb=max(cfg.row_block, 8), cb=max(cfg.col_block, 128), be=be,
        for_gat=for_gat, gat_self_loops=gat_self_loops, rank1=not cfg.fake_quantization, device=device,
    )


class _Agg(torch.autograd.Function):
    """out = A @ H by ``kernel`` on ``op``; grad_H = A^T @ g by the same
    kernel on the transposed operand, cast to H's dtype and padded to H's
    rows (JAX ``dispatch._fused_agg`` with K2, ``_bsr_agg`` with K1,
    ``_pallas_agg`` with K9). The transposed operand is the field
    ``name_t`` of ``prep``, read in the backward only: a forward never
    touches it (a remapped prep computes it at that read)."""

    @staticmethod
    def forward(ctx, kernel, op, prep, name_t, H):
        ctx.kernel, ctx.prep, ctx.name_t = kernel, prep, name_t
        ctx.n_h, ctx.h_dtype = H.shape[0], H.dtype
        return kernel(op, H)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        with span("agg.backward") as s:
            if s:
                s.set(**_agg_attrs(ctx.prep, g, ctx.name_t))
            op_t = getattr(ctx.prep, ctx.name_t)
            if op_t is None:
                raise ValueError(
                    "backward through a prep built with build_transpose=False; "
                    "re-prepare with build_transpose=True for training"
                )
            gH = ctx.kernel(op_t, g.contiguous()).to(ctx.h_dtype)
            if gH.shape[0] < ctx.n_h:
                gH = torch.cat([gH, gH.new_zeros((ctx.n_h - gH.shape[0], gH.shape[1]))])
            return None, None, None, None, gH[: ctx.n_h]


def _split_attrs(plan: Optional[SpMMPlan]) -> dict:
    """K9's split rows in ``plan`` and the partial rows they leave."""
    if plan is None:
        return {}
    return dict(split_rows=plan.segments.n_fin, partials=plan.segments.n_part)


def _agg_attrs(prep: PreparedAdjacency, H: torch.Tensor, name: str = "plan") -> dict:
    """An ``agg`` span's counts: the kind, the edges and the width P; on the
    ``pallas`` kind also the split rows of the plan K9 runs on (``name``).
    The edge count is left out where the prep's edge list is a remapped one
    that no one has read yet (``map_adjacency_vals``): reading it would
    compute it."""
    A = object.__getattribute__(prep, "A")
    nnz = dict(nnz=A.nnz) if isinstance(A, SparseMatrix) else {}
    split = _split_attrs(getattr(prep, name)) if prep.kind == "pallas" else {}
    return dict(kind=prep.kind, P=H.shape[1], **nnz, **split)


def agg_matmul(prep: PreparedAdjacency, H: torch.Tensor) -> torch.Tensor:
    """out = A @ H through the prepared backend, in H's dtype
    (differentiable). On fused preps (bsr/hybrid default) the values round
    through bf16, forward and in grad_H. Runs in an ``agg`` span (its
    backward in ``agg.backward`` where the port's kernels take it)."""
    with span("agg") as s:
        if s:
            s.set(**_agg_attrs(prep, H))
        return _agg_matmul(prep, H)


def _agg_matmul(prep: PreparedAdjacency, H: torch.Tensor) -> torch.Tensor:
    if prep.kind == "dense":
        out = torch.matmul(
            prep.dense.to(torch.float32), H.to(prep.dense.dtype).to(torch.float32)
        )
        return out[: prep.A.n_rows].to(H.dtype)
    if prep.kind == "pallas":
        return _Agg.apply(spmm_plan, prep.plan, prep, "plan_t", H).to(H.dtype)
    if prep.kind in ("bsr", "hybrid"):
        if prep.fused is not None:
            return _Agg.apply(bsr_spmm_fused, prep.fused, prep, "fused_t", H).to(H.dtype)
        return _bsr_agg_scaled(prep, H, rest=prep.rest).to(H.dtype)
    return spmm(prep.A, H)


_SDDMM_EDGES = 1 << 20  # edges per batch of the cotangent SDDMM


class _AggVals(torch.autograd.Function):
    """out = A(vals) @ H by K9 on ``plan`` with the values substituted
    (JAX ``dispatch._pallas_agg_vals``): grad_H = A(vals)^T @ g by K9 on
    ``plan_t`` with the same values, grad_vals[e] = g[row_e] . H[col_e] in
    torch ops on the edge list."""

    @staticmethod
    def forward(ctx, A, plan, plan_t, vals, H):
        ctx.A, ctx.plan_t = A, plan_t
        ctx.save_for_backward(vals, H)
        return spmm_plan(plan_with_vals(plan, vals), H)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        with span("agg.backward", kind="pallas", nnz=ctx.A.nnz, P=g.shape[1]) as s:
            if s:
                s.set(**_split_attrs(ctx.plan_t))
            vals, H = ctx.saved_tensors
            A, g = ctx.A, g.contiguous()
            gH = gv = None
            if ctx.needs_input_grad[4]:
                gH = spmm_plan(plan_with_vals(ctx.plan_t, vals), g).to(H.dtype)
                if gH.shape[0] < H.shape[0]:
                    gH = torch.cat([gH, gH.new_zeros((H.shape[0] - gH.shape[0], gH.shape[1]))])
                gH = gH[: H.shape[0]]
            if ctx.needs_input_grad[3]:
                rows, cols = torch.as_tensor(A.rows).long(), torch.as_tensor(A.cols).long()
                gv = torch.empty(rows.shape[0], dtype=torch.float32, device=g.device)
                for e0 in range(0, rows.shape[0], _SDDMM_EDGES):  # bounded scratch
                    e = slice(e0, e0 + _SDDMM_EDGES)
                    gv[e] = (g.index_select(0, rows[e]) * H.index_select(0, cols[e])).sum(dim=1)
                gv = gv.to(vals.dtype)
            return None, None, None, gv, gH


def agg_matmul_with_vals(
    prep: PreparedAdjacency, vals: torch.Tensor, H: torch.Tensor
) -> torch.Tensor:
    """out = A(vals) @ H with runtime edge values (attention weights) in
    ``prep.A``'s edge order, differentiable in ``vals`` and ``H``.

    Only the ``pallas`` kind substitutes values for the price of a gather
    (the plan stores the edge values in its group layout, a permutation);
    rebuilding value tiles per call would write and read the whole tile
    set, so every other kind takes the edge path. Runs in an ``agg``
    span, as ``agg_matmul``."""
    with span("agg", kind=prep.kind, nnz=prep.A.nnz, P=H.shape[1]) as s:
        if prep.kind == "pallas":
            if s:
                s.set(**_split_attrs(prep.plan))
            return _AggVals.apply(prep.A, prep.plan, prep.plan_t, vals, H).to(H.dtype)
        return spmm(prep.A.with_vals(vals), H)


def _bsr_agg_scaled(
    prep: PreparedAdjacency, H: torch.Tensor,
    rest: Optional[SparseMatrix] = None,
) -> torch.Tensor:
    """Tile kernel K1 with the rank-1 scalings around it:
    ``A @ H == r1_row * (M @ (r1_col * H) + rest_mask @ (r1_col * H))``.
    The remainder is added in mask space (unit values) before the row
    scaling; in value mode it is a plain scatter-add. Returns f32."""
    # the remainder adds out of place: K1's output is a custom Function's
    # and may be a view, which autograd does not let an in-place op change
    if prep.r1_row is None:
        out = _Agg.apply(bsr_spmm, prep.bsr, prep, "bsr_t", H)
        if rest is not None:
            out = out + spmm_into(rest, H, torch.zeros_like(out))
        return out
    Hs = H * prep.r1_col[: H.shape[0], None].to(H.dtype)
    out = _Agg.apply(bsr_spmm, prep.bsr, prep, "bsr_t", Hs)
    if rest is not None:
        r = rest.rows[: rest.nnz]
        c = rest.cols[: rest.nnz]
        out = out.index_add(0, r, Hs.index_select(0, c).to(out.dtype))
    return out * prep.r1_row[: out.shape[0], None]


class _Pending:
    """A remapped representation that no one has read yet."""

    __slots__ = ("make",)

    def __init__(self, make: Callable):
        self.make = make


class _RemappedAdjacency(PreparedAdjacency):
    """The result of ``map_adjacency_vals``: every remapped representation
    is computed at its first read and kept. Eager PyTorch runs what it is
    told, so remapping all of them up front would rewrite tile sets that
    the call never reads (the transposed tiles in a forward, the
    aggregation tiles under a flash-GAT layer); traced JAX drops those."""

    def __getattribute__(self, name):
        v = object.__getattribute__(self, name)
        if type(v) is _Pending:
            with torch.no_grad():
                v = v.make()
            object.__setattr__(self, name, v)  # the dataclass is frozen
        return v


def map_adjacency_vals(
    prep: PreparedAdjacency, fn: Callable[[torch.Tensor], torch.Tensor]
) -> PreparedAdjacency:
    """Apply an elementwise function to the adjacency values of every
    backend representation (the layers fake-quantize the adjacency with
    it; ``fn`` must map 0 -> 0 so dense zeros and padding stay zero, and
    the tiles' ``live`` flags stay valid). It runs on each representation
    in that one's own dtype, bf16 tiles in bf16, without gradients: the
    adjacency is data. Each representation is remapped when it is first
    read from the result, and only then: a forward does not pay for the
    transposed tiles, which the backward reads.

    The fused schedules embed tile values and remainder slot scales, so
    they are dropped and aggregation runs K1 on the remapped value tiles
    plus the remapped remainder. Flash-GAT mask tiles stay as they are:
    any 0 -> 0 quantizer keeps ``tile > 0``. On a rank-1 mask-tile prep
    the remapped values cannot live in {0,1} tiles: this warns and
    degrades to the edge path for the call (prepare with ``rank1=False``,
    as ``prepare_from_config`` does for ``fake_quantization``)."""
    if prep.r1_row is not None:
        warnings.warn(
            "map_adjacency_vals on a rank-1 mask-tile backend: remapped "
            "values cannot live in {0,1} tiles, so plain aggregation falls "
            "back to the edge path for this layer. Prepare the adjacency "
            "with prepare_adjacency(..., rank1=False) (or "
            "prepare_from_config, which does this for fake_quantization "
            "configs) to keep the tile kernels.",
            stacklevel=2,
        )
        with torch.no_grad():
            A = prep.A.with_vals(fn(torch.as_tensor(prep.A.vals)))
        return dataclasses.replace(
            prep, A=A, dense=None, plan=None, plan_t=None, bsr=None,
            bsr_t=None, rest=None, r1_row=None, r1_col=None, fused=None,
            fused_t=None, kind="xla",
        )
    remap = {
        "A": lambda A: A.with_vals(fn(torch.as_tensor(A.vals))),
        "dense": fn,
        "plan": lambda p: p.with_val(fn(p.val)),
        "plan_t": lambda p: p.with_val(fn(p.val)),
        "bsr": lambda B: dataclasses.replace(B, tiles=fn(B.tiles)),
        "bsr_t": lambda B: dataclasses.replace(B, tiles=fn(B.tiles)),
        "rest": lambda r: r.with_vals(fn(torch.as_tensor(r.vals))),
    }
    fields = {f.name: object.__getattribute__(prep, f.name) for f in dataclasses.fields(prep)}
    for name, make in remap.items():
        if fields[name] is not None:
            # read from ``prep`` when asked: it may itself be pending there
            fields[name] = _Pending(lambda name=name, make=make: make(getattr(prep, name)))
    fields.update(fused=None, fused_t=None)
    return _RemappedAdjacency(**fields)
