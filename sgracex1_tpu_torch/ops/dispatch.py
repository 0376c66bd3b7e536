"""Aggregation backend dispatch: ``prepare_adjacency`` once per graph on the
host, ``agg_matmul`` per layer.

Kinds, as in ``sgracex1_tpu.ops.dispatch``:

- ``dense``: the adjacency as a dense bf16 matrix, one matmul.
- ``bsr``: nonempty dense tiles (``ops/bsr``).
- ``hybrid``: tiles holding at least ``rest_thresh`` edges stay tiles; the
  sparse remainder rides chunk steps of the fused kernel (``ops/fused_agg``)
  or, with ``fuse=False``, a scatter-add after the tile kernel.
- ``xla``: gather + scatter-add on the edge list (``ops/spmm``), the
  always-correct spec.

A rank-1 factored adjacency (sym-normalized, unweighted) stores its tiles
as {0,1} masks, 1-bit packed when tb is a multiple of 1024, with the two
diagonal scalings applied around the tile products.

The JAX package picks the backend and tile size with a cost model
calibrated on the TPU. Those constants do not carry over, so here
``method="auto"`` is a fixed rule: ``dense`` when the bf16 matrix fits
``dense_max_bytes``, else ``hybrid`` at ``DEFAULT_TB`` / ``DEFAULT_REST_THRESH``
— unmeasured starting points, to be calibrated on the H100.

``for_gat=True`` also attaches the flash-GAT layout that ``GATConv`` reads
(``flash_tiles``; ``gat_plan`` for the hybrid split). The JAX package picks
it with a TPU cost model (``_choose_flash_plan``); here it is a fixed rule:
full-cover int8 mask tiles at tb=256 up to 8192 nodes (the JAX rule
there), else the hybrid split at ``DEFAULT_GAT_TB`` /
``DEFAULT_GAT_REST_THRESH`` — unmeasured starting points.

``map_adjacency_vals`` remaps the values of every representation (the
quantized layers' adjacency quantizer); it needs value tiles, which
``prepare_from_config`` keeps for ``fake_quantization`` configs.

``agg_matmul`` is differentiable (``_Agg``): on fused preps the gradient
of ``H`` is K2 on the transposed plan ``fused_t``, with ``fuse=False`` K1
on the transposed tiles ``bsr_t``; the rank-1 scalings and the remainder
scatter stay plain torch ops around the tile kernel, as in the JAX
package. A backward through a prep built with
``build_transpose=False`` raises.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

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
from sgracex1_tpu_torch.ops.spmm import spmm, spmm_into

DENSE_MAX_BYTES = 512 << 20  # dense bf16 adjacency budget
DEFAULT_TB = 256  # hybrid/bsr tile size: unmeasured starting point
DEFAULT_REST_THRESH = 64  # edges a tile needs to stay a tile: unmeasured
GAT_FULL_COVER_MAX_N = 8192  # full-cover flash tiles up to here (JAX rule)
DEFAULT_GAT_TB = 256  # hybrid flash-GAT tile size: unmeasured starting point
DEFAULT_GAT_REST_THRESH = 64  # edges a flash tile needs to stay a tile


@dataclasses.dataclass(frozen=True)
class PreparedAdjacency:
    """An adjacency prepared for one aggregation backend, on one device.

    ``A`` (the edge list) is always present. ``bsr``/``bsr_t`` are the
    forward/transposed tiles, ``rest`` the hybrid remainder, ``r1_row`` /
    ``r1_col`` the rank-1 factors when the tiles are masks, and
    ``fused``/``fused_t`` the fused schedules that ``agg_matmul`` prefers
    when present. ``gat_bsr`` holds flash-GAT mask tiles (``for_gat``);
    with the hybrid attention split, ``gat_plan`` is the value-mode fused
    schedule over them plus the remainder ``gat_rest`` as chunks."""

    A: SparseMatrix
    kind: str = "xla"
    dense: Optional[torch.Tensor] = None
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


def prepare_adjacency(
    A: SparseMatrix,
    *,
    method: str = "auto",
    dense_max_bytes: int = DENSE_MAX_BYTES,
    tb: Optional[int] = None,
    rest_thresh: Optional[int] = None,
    rank1: bool = True,
    build_transpose: bool = True,
    fuse: bool = True,
    for_gat: bool = False,
    gat_tb: Optional[int] = None,
    gat_rest_thresh: Optional[int] = None,
    device=None,
) -> PreparedAdjacency:
    """Prepare ``A`` for one backend, with its tensors on ``device``: the
    CUDA card by default (a ``RuntimeError`` where there is none), the CPU
    only with ``device="cpu"``.

    ``rank1`` detects a diagonal factorization of the edge values
    (``graph/normalize.rank1_factor``) and then stores mask tiles.
    ``build_transpose=False`` skips the transposed plans that only a
    backward reads. ``fuse=False`` runs the tile kernel K1 plus a remainder
    scatter instead of the fused kernel K2; it keeps f32 accumulation where
    K2 writes bf16.

    ``for_gat`` attaches the flash-GAT layout unless the prep's own tiles
    already serve (``flash_tiles``). ``gat_tb`` / ``gat_rest_thresh``
    override the fixed rule; an explicit ``gat_rest_thresh`` asks for the
    hybrid split at any size."""
    device = resolve_device(device)
    n = max(A.n_rows, A.n_cols)
    if method == "auto":
        method = "dense" if n * n * 2 <= dense_max_bytes else "hybrid"
    if method not in ("dense", "bsr", "hybrid", "xla"):
        raise ValueError(f"unknown method {method!r}")
    A_dev = A.to(device)

    def finish(prep: PreparedAdjacency) -> PreparedAdjacency:
        if not for_gat or prep.flash_tiles is not None:
            return prep
        return dataclasses.replace(
            prep, **_gat_layout(A, n, gat_tb, gat_rest_thresh, device)
        )

    if method == "xla":
        return finish(PreparedAdjacency(A=A_dev, kind="xla"))
    if method == "dense":
        d = torch.from_numpy(A.to_dense().astype(np.float32))
        return finish(PreparedAdjacency(
            A=A_dev, kind="dense", dense=d.to(torch.bfloat16).to(device)
        ))

    tb = DEFAULT_TB if tb is None else tb
    fac = rank1_factor(A) if rank1 else None

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
            attach_chunks=True,
        )
        fused_t = None
        if Bt is not None:
            fused_t = build_fused_plan(
                Bt, rest_m.transpose() if rest_m is not None else None,
                r1_row=r1c, r1_col=r1r, tile_keys=keys(src.transpose()),
                attach_chunks=True,
            )
        return fused, fused_t

    r1 = {}
    if fac is not None:
        r1 = dict(
            r1_row=torch.from_numpy(fac[0]).to(device),
            r1_col=torch.from_numpy(fac[1]).to(device),
        )
    if method == "hybrid":
        thresh = DEFAULT_REST_THRESH if rest_thresh is None else rest_thresh
        part, rest = split_by_tile_density(A, tb, thresh)
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


def _gat_layout(
    A: SparseMatrix, n: int, tb: Optional[int], thresh: Optional[int], device
) -> dict:
    """The flash-GAT fields of a prep (``_finish`` of the JAX prepare).

    Hybrid split: the tiles holding >= ``thresh`` edges become int8 (or,
    at tb % 1024 == 0, packed) mask tiles covering every row and column
    block; the remainder, without its zero-valued edges (GAT masks on
    val > 0), rides the chunks of a value-mode fused plan. Full cover
    (small graphs, or a degenerate split): mask tiles of the whole
    adjacency."""
    hybrid = thresh is not None or n > GAT_FULL_COVER_MAX_N
    tb = tb if tb is not None else (DEFAULT_GAT_TB if hybrid else 256)
    build = bsr_bitmask_from_sparse if _packs(tb) else bsr_mask_from_sparse
    if hybrid:
        thresh = DEFAULT_GAT_REST_THRESH if thresh is None else thresh
        part, grest = split_by_tile_density(A, tb, thresh)
        grest = _drop_zero_val_edges(grest)
        if part.nnz and grest.nnz:
            cover = dict(cover_rows=True, cover_cols=True)
            tiles = build(part, tb=tb, device=device, **cover)
            plan = build_fused_plan(
                tiles, grest, K=DEFAULT_K, attach_chunks=True,
                tile_keys=bsr_tile_keys(part, tb, **cover),
            )
            return dict(gat_bsr=tiles, gat_rest=grest.to(device), gat_plan=plan)
    return dict(gat_bsr=build(A, tb=tb, device=device))


def prepare_from_config(
    A: SparseMatrix, cfg, *, for_gat: bool = False, method: Optional[str] = None,
    device=None,
) -> PreparedAdjacency:
    """``prepare_adjacency`` driven by an ``SGRACEConfig``: the port's fixed
    rule (``method="auto"``) unless ``method`` names a backend, mask tiles
    with rank-1 scalings unless the config fake-quantizes the adjacency
    (QAT layers remap the adjacency values per call, which {0,1} mask tiles
    cannot hold: ``map_adjacency_vals``). The ``pallas`` kind is not
    ported, so ``use_pallas`` raises. ``device`` as in
    ``prepare_adjacency``."""
    if cfg.use_pallas:
        raise NotImplementedError(
            "use_pallas selects the pallas kind, whose kernel K9 is not "
            "ported yet (ROADMAP queue 1, item 14)"
        )
    return prepare_adjacency(
        A, method=method or "auto", for_gat=for_gat,
        rank1=not cfg.fake_quantization, device=device,
    )


class _Agg(torch.autograd.Function):
    """out = A @ H by ``kernel`` on ``op``; grad_H = A^T @ g by the same
    kernel on the transposed ``op_t``, cast to H's dtype and padded to H's
    rows (JAX ``dispatch._fused_agg`` with K2, ``_bsr_agg`` with K1)."""

    @staticmethod
    def forward(ctx, kernel, op, op_t, H):
        ctx.kernel, ctx.op_t, ctx.n_h, ctx.h_dtype = kernel, op_t, H.shape[0], H.dtype
        return kernel(op, H)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if ctx.op_t is None:
            raise ValueError(
                "backward through a prep built with build_transpose=False; "
                "re-prepare with build_transpose=True for training"
            )
        gH = ctx.kernel(ctx.op_t, g.contiguous()).to(ctx.h_dtype)
        if gH.shape[0] < ctx.n_h:
            gH = torch.cat([gH, gH.new_zeros((ctx.n_h - gH.shape[0], gH.shape[1]))])
        return None, None, None, gH[: ctx.n_h]


def agg_matmul(prep: PreparedAdjacency, H: torch.Tensor) -> torch.Tensor:
    """out = A @ H through the prepared backend, in H's dtype
    (differentiable). On fused preps (bsr/hybrid default) the values round
    through bf16, forward and in grad_H."""
    if prep.kind == "dense":
        out = torch.matmul(
            prep.dense.to(torch.float32), H.to(torch.bfloat16).to(torch.float32)
        )
        return out[: prep.A.n_rows].to(H.dtype)
    if prep.kind in ("bsr", "hybrid"):
        if prep.fused is not None:
            return _Agg.apply(bsr_spmm_fused, prep.fused, prep.fused_t, H).to(H.dtype)
        return _bsr_agg_scaled(prep, H, rest=prep.rest).to(H.dtype)
    return spmm(prep.A, H)


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
        out = _Agg.apply(bsr_spmm, prep.bsr, prep.bsr_t, H)
        if rest is not None:
            out = out + spmm_into(rest, H, torch.zeros_like(out))
        return out
    Hs = H * prep.r1_col[: H.shape[0], None].to(H.dtype)
    out = _Agg.apply(bsr_spmm, prep.bsr, prep.bsr_t, Hs)
    if rest is not None:
        r = rest.rows[: rest.nnz]
        c = rest.cols[: rest.nnz]
        out = out.index_add(0, r, Hs.index_select(0, c).to(out.dtype))
    return out * prep.r1_row[: out.shape[0], None]


def map_adjacency_vals(
    prep: PreparedAdjacency, fn: Callable[[torch.Tensor], torch.Tensor]
) -> PreparedAdjacency:
    """Apply an elementwise function to the adjacency values of every
    backend representation (the layers fake-quantize the adjacency with
    it; ``fn`` must map 0 -> 0 so dense zeros and padding stay zero). It
    runs on each representation in that one's own dtype, bf16 tiles in
    bf16, without gradients: the adjacency is data.

    The fused schedules embed tile values and remainder slot scales, so
    they are dropped and aggregation runs K1 on the remapped value tiles
    plus the remapped remainder. Flash-GAT mask tiles stay as they are:
    any 0 -> 0 quantizer keeps ``tile > 0``. On a rank-1 mask-tile prep
    the remapped values cannot live in {0,1} tiles: this warns and
    degrades to the edge path for the call (prepare with ``rank1=False``,
    as ``prepare_from_config`` does for ``fake_quantization``)."""
    with torch.no_grad():
        A = prep.A.with_vals(fn(torch.as_tensor(prep.A.vals)))
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
            return dataclasses.replace(
                prep, A=A, dense=None, bsr=None, bsr_t=None, rest=None,
                r1_row=None, r1_col=None, fused=None, fused_t=None, kind="xla",
            )
        tiles = lambda B: None if B is None else dataclasses.replace(B, tiles=fn(B.tiles))
        rest = prep.rest
        if rest is not None:
            rest = rest.with_vals(fn(torch.as_tensor(rest.vals)))
        return dataclasses.replace(
            prep, A=A, dense=None if prep.dense is None else fn(prep.dense),
            bsr=tiles(prep.bsr), bsr_t=tiles(prep.bsr_t), rest=rest,
            fused=None, fused_t=None,
        )
