"""Block-sparse (BSR) aggregation: the nonempty ``tb x tb`` tiles of the
adjacency, and ``A @ H`` over them.

Host side (numpy, then one move to the device): ``bsr_from_sparse`` with
value tiles, int8 {0,1} mask tiles or 1-bit packed mask tiles, and
``bsr_transpose``. Layouts match ``sgracex1_tpu.ops.bsr`` exactly, so the
tests compare tiles element for element.

Kernel K1, ``bsr_spmm``: out = A @ H in f32 with bf16 operands, as
``sgracex1_tpu.ops.bsr.bsr_spmm_pallas``. On a CUDA tensor it launches a
hand-written kernel: the ring kernel ``csrc/bsr_spmm_ring.cu`` for int8 and
bf16 tiles at the shapes ``ring_shape_ok`` names (H staged once in bf16, only
the live tiles of ``BSRMatrix.ring``, a multi-stage shared-memory ring), else
the single-stage kernel ``csrc/bsr_spmm.cu``; on a CPU tensor it runs
``bsr_spmm_plain``, the plain PyTorch version of the same function.

Kernel K10, ``bsr_spmm_rowloop``: K1's product with every output row block
written once, as ``sgracex1_tpu.ops.bsr.bsr_spmm_rowloop``. On a CUDA tensor
it launches the cluster kernel ``csrc/bsr_spmm_cluster.cu`` at the shapes
``ring_shape_ok`` names (``cluster_schedule``: a hub row block's live tiles
split over the CTAs of a thread-block cluster and summed in distributed
shared memory), else the single-stage kernel ``csrc/bsr_spmm_rowloop.cu``;
on a CPU tensor it runs ``bsr_spmm_rowloop_plain``.

Kernel K7, ``bsr_spmm_int8``: the exact int32 ``Aq @ Hq`` over shifted-int8
value tiles (``quant/int8.bsr_int8_from_sparse``), as
``sgracex1_tpu.ops.bsr.bsr_spmm_int8``. On a CUDA tensor it launches the int8
ring kernel ``csrc/fused_agg_int8_ring.cu`` at the shapes
``int8_ring_shape_ok_k7`` names (u8 x s8 tensor-core products over the tiles
that carry an edge, ``BSRMatrix.edge_ring``, tiles taller than 256 rows cut
into row pieces), else the single-stage kernel ``csrc/bsr_spmm_int8.cu``; on
a CPU tensor it runs ``bsr_spmm_int8_plain``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from sgracex1_tpu_torch.graph.csr import SparseMatrix, _np, _round_up, unique_sorted
from sgracex1_tpu_torch.ops import _cuda

# schedule steps per CTA segment: bounds the work of one CTA so the long
# runs of hub row blocks spread over many CTAs (a starting point, not tuned)
SEG_STEPS = 16

# live steps per work item of the ring kernels (csrc/tile_ring.cuh): one
# persistent CTA per SM walks the work items, so this only bounds how far a
# hub row block's run spreads over the SMs (swept 8/16/32/64 on the H100 by
# chip_smoke.py)
RING_SEG_STEPS = 16

# tile batch bytes of the plain versions' f32 scratch
_PLAIN_BATCH_BYTES = 256 << 20


def _tensor(x, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class RunSegments:
    """Launch schedule of the GPU kernels over row-block runs.

    A run (the contiguous steps of one row block) is cut into segments of
    at most ``SEG_STEPS`` steps; one CTA row owns one segment. A run of one
    segment writes its output directly (``seg_part == -1``); the segments
    of a longer run write f32 partials ``seg_part`` that the finalize pass
    sums per run (``fin_rb``, first partial ``fin_p0``, count ``fin_np``).
    Every row block gets at least one segment, so every output row is
    written."""

    seg_rb: torch.Tensor  # int32[n_seg]
    seg_lo: torch.Tensor  # int32[n_seg]
    seg_hi: torch.Tensor  # int32[n_seg]
    seg_part: torch.Tensor  # int32[n_seg]
    fin_rb: torch.Tensor  # int32[n_fin]
    fin_p0: torch.Tensor  # int32[n_fin]
    fin_np: torch.Tensor  # int32[n_fin]
    n_part: int

    @property
    def n_seg(self) -> int:
        return self.seg_rb.shape[0]

    @property
    def n_fin(self) -> int:
        return self.fin_rb.shape[0]

    def tensors(self) -> dict:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self) if f.name != "n_part"
        }

    def to(self, device) -> "RunSegments":
        return dataclasses.replace(
            self, **{k: t.to(device) for k, t in self.tensors().items()}
        )


def run_segments(
    rb_of_step: np.ndarray, n_rt: int, device="cpu", seg_steps: int = SEG_STEPS
) -> RunSegments:
    """Segments of at most ``seg_steps`` steps of the runs of a
    row-block-sorted step array (host)."""
    rb_of_step = np.asarray(rb_of_step, np.int64)
    start = np.searchsorted(rb_of_step, np.arange(n_rt + 1))
    length = np.diff(start)
    m = np.maximum(1, -(-length // seg_steps))
    seg_rb = np.repeat(np.arange(n_rt), m)
    first = np.repeat(np.cumsum(m) - m, m)
    i = np.arange(len(seg_rb)) - first
    lo = start[seg_rb] + i * seg_steps
    hi = np.minimum(lo + seg_steps, start[seg_rb + 1])
    split = m > 1
    base = np.cumsum(np.where(split, m, 0)) - np.where(split, m, 0)
    part = np.where(split[seg_rb], base[seg_rb] + i, -1)
    i32 = lambda a: _tensor(a, device, torch.int32)
    return RunSegments(
        seg_rb=i32(seg_rb), seg_lo=i32(lo), seg_hi=i32(hi), seg_part=i32(part),
        fin_rb=i32(np.flatnonzero(split)), fin_p0=i32(base[split]),
        fin_np=i32(m[split]), n_part=int(m[split].sum()),
    )


@dataclasses.dataclass(frozen=True)
class LiveSchedule:
    """Launch schedule of the ring kernels: the steps that do work.

    ``step`` [n_live, 4] lists, in run order, every schedule step that
    has a live tile or a chunk: (tile id or -1, column block, chunk id or
    -1, the chunk's slots up to its last live one); ``rb`` [n_live] is the
    step's row block. A tile is live when an edge produced it
    (``BSRMatrix.live``); the zero cover tiles only mark a row or column
    block as visited, which the GPU kernels do not need, so their products
    are dropped here. The
    tiles themselves stay in the ``BSRMatrix``. ``segments`` cuts the runs
    of the live list (``seg_lo`` / ``seg_hi`` index ``step``), longest
    segment first; a row block without a live step keeps one empty segment,
    so its rows are still written (zeros, or the row-scaled chunk sums)."""

    step: torch.Tensor  # int32[n_live, 4]: tile, cb, chunk, chunk slots
    rb: torch.Tensor  # int32[n_live]
    segments: RunSegments
    n_tile_steps: int  # tile products kept
    n_dead_tile_steps: int  # tile products dropped (empty cover tiles)

    def to(self, device) -> "LiveSchedule":
        return dataclasses.replace(
            self, step=self.step.to(device), rb=self.rb.to(device),
            segments=self.segments.to(device),
        )


def live_schedule(
    rb_of_step: np.ndarray, tile: np.ndarray, cb: np.ndarray, chunk: np.ndarray,
    n_rt: int, device="cpu", seg_steps: Optional[int] = None,
    n_dead_tile_steps: int = 0, chunk_slots: Optional[np.ndarray] = None,
) -> LiveSchedule:
    """The ring kernels' schedule from per-step host arrays: row block,
    live tile id (-1: no tile product), column block, chunk id (-1: no
    chunk), and how many of the chunk's slots to read. Steps with neither
    a tile nor a chunk are dropped."""
    seg_steps = RING_SEG_STEPS if seg_steps is None else seg_steps
    tile, chunk = np.asarray(tile, np.int64), np.asarray(chunk, np.int64)
    keep = (tile >= 0) | (chunk >= 0)
    slots = np.zeros(len(tile), np.int64) if chunk_slots is None else np.asarray(chunk_slots)
    step = np.stack([tile[keep], np.asarray(cb)[keep], chunk[keep], slots[keep]], axis=1).astype(np.int32)
    rb = np.asarray(rb_of_step)[keep].astype(np.int32)
    return LiveSchedule(
        step=_tensor(step, device), rb=_tensor(rb, device),
        segments=_live_segments(rb, n_rt, device, seg_steps),
        n_tile_steps=int((tile >= 0).sum()), n_dead_tile_steps=n_dead_tile_steps,
    )


def _live_segments(rb_of_live: np.ndarray, n_rt: int, device, seg_steps: int) -> RunSegments:
    """Segments over the live list, longest first: the persistent CTAs take
    work items in turn, so the long ones should start early."""
    S = run_segments(rb_of_live, n_rt, "cpu", seg_steps=seg_steps)
    order = torch.argsort(S.seg_hi - S.seg_lo, descending=True, stable=True)
    S = dataclasses.replace(
        S, **{k: getattr(S, k)[order] for k in ("seg_rb", "seg_lo", "seg_hi", "seg_part")}
    )
    return S.to(device)


def recut_live_schedule(L: LiveSchedule, n_rt: int, seg_steps: int) -> LiveSchedule:
    """``L`` with its runs cut into segments of at most ``seg_steps`` live
    steps (the sweep of ``RING_SEG_STEPS``)."""
    return dataclasses.replace(
        L, segments=_live_segments(_np(L.rb), n_rt, L.step.device, seg_steps)
    )


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Nonempty dense tiles of a sparse matrix, sorted by (rb, cb).

    ``tiles`` is [T, tb, tb] (bf16/f32 values or int8 {0,1} masks) or
    uint8 [T, tb, tb/8] (1-bit packed masks: byte i, bit j of a row holds
    column ``j*(tb/8) + i``). ``segments`` is the launch schedule over
    the tile runs, every tile included (K3-K7, K10, K12 and the
    single-stage K1).

    ``live`` [T] marks the tiles an edge with a value produced; the others
    are the zero cover tiles of ``cover_rows`` / ``cover_cols``. A set flag
    promises nothing (values may cancel, a value map may send them to 0);
    a clear flag promises an all-zero tile, and stays true under any
    elementwise map with fn(0) == 0 (``map_adjacency_vals``). ``ring`` is
    the ring K1's schedule over the live tiles alone.

    ``col_perm`` lists the tiles in column order (stable argsort of
    ``tile_cb``, the walk of the TPU column pass ``_bwd_col_pass``) and
    ``col_segments`` cuts its column-block runs as ``segments`` cuts the
    row-block runs (``seg_rb`` there holds the column block). The
    single-stage flash backward K5 walks them on the tiles as they are; the
    ring K5 walks ``live_t``, the transposed live tiles, built at first use
    and kept with this object (the live tiles' bytes again; not for packed
    tiles). The ring K7 walks ``edge_ring``, likewise built at first use."""

    tiles: torch.Tensor
    tile_rb: torch.Tensor  # int32[T]
    tile_cb: torch.Tensor  # int32[T]
    n_rows: int
    n_cols: int
    tb: int
    segments: RunSegments
    col_perm: torch.Tensor  # int32[T]
    col_segments: RunSegments
    live: torch.Tensor  # bool[T]
    ring: LiveSchedule

    @property
    def num_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def n_row_tiles(self) -> int:
        return _round_up(self.n_rows, self.tb) // self.tb

    @property
    def packed(self) -> bool:
        return self.tiles.shape[-1] != self.tb

    @functools.cached_property
    def live_t(self) -> "BSRMatrix":
        """``live_transpose(self)``, built at first use and kept with this
        tile set (the ring K5 walks its ``ring``)."""
        return live_transpose(self)

    @functools.cached_property
    def edge_ring(self) -> LiveSchedule:
        """``int8_edge_schedule(self)``, built at first use and kept with
        this tile set (the ring K7 walks it; shifted-int8 tiles only)."""
        return int8_edge_schedule(self)

    def to(self, device) -> "BSRMatrix":
        return dataclasses.replace(
            self, tiles=self.tiles.to(device), tile_rb=self.tile_rb.to(device),
            tile_cb=self.tile_cb.to(device), segments=self.segments.to(device),
            col_perm=self.col_perm.to(device),
            col_segments=self.col_segments.to(device),
            live=self.live.to(device), ring=self.ring.to(device),
        )


def _schedules(tile_rb: np.ndarray, tile_cb: np.ndarray, live: np.ndarray, n_rows: int,
               n_cols: int, tb: int, device) -> dict:
    """The row-run and column-run launch schedules of a (rb, cb)-sorted
    tile set and the live-tile schedule of the ring K1 (host)."""
    col_perm = np.argsort(tile_cb, kind="stable")
    n_rt = _round_up(n_rows, tb) // tb
    live = np.asarray(live, bool)
    return dict(
        live=_tensor(live, device),
        ring=live_schedule(
            tile_rb, np.where(live, np.arange(len(tile_rb)), -1), tile_cb,
            np.full(len(tile_rb), -1), n_rt, device,
            n_dead_tile_steps=int((~live).sum()),
        ),
        segments=run_segments(tile_rb, n_rt, device),
        col_perm=_tensor(col_perm.astype(np.int32), device),
        col_segments=run_segments(
            tile_cb[col_perm], _round_up(n_cols, tb) // tb, device
        ),
    )


def bsr_tile_keys(
    A: SparseMatrix, tb: int, *, cover_rows: bool = False,
    cover_cols: bool = False,
) -> np.ndarray:
    """Sorted tile keys ``rb << 32 | cb`` of bsr_from_sparse's tile set,
    including the zero cover tiles (host)."""
    r = _np(A.rows)[: A.nnz]
    c = _np(A.cols)[: A.nnz]
    key = (r // tb).astype(np.int64) << 32 | (c // tb).astype(np.int64)
    uniq = unique_sorted(key)
    extra = []
    if cover_rows:
        n_rt = _round_up(A.n_rows, tb) // tb
        have_rb = np.unique((uniq >> 32).astype(np.int64))
        missing = np.setdiff1d(np.arange(n_rt, dtype=np.int64), have_rb)
        if len(missing):
            extra.append(missing << 32)
    if cover_cols:
        n_ct = _round_up(A.n_cols, tb) // tb
        have_cb = np.unique(uniq & 0xFFFFFFFF)
        missing = np.setdiff1d(np.arange(n_ct, dtype=np.int64), have_cb)
        if len(missing):
            extra.append(missing)
    if extra:
        uniq = np.unique(np.concatenate([uniq, *extra]))
    return uniq


def _bsr(tiles, uniq, live, A: SparseMatrix, tb: int, device) -> BSRMatrix:
    tile_rb = (uniq >> 32).astype(np.int32)
    tile_cb = (uniq & 0xFFFFFFFF).astype(np.int32)
    if len(uniq) == 0:
        tile_rb = np.zeros(1, np.int32)
        tile_cb = np.zeros(1, np.int32)
        live = np.zeros(1, bool)
    return BSRMatrix(
        tiles=tiles.to(device),
        tile_rb=_tensor(tile_rb, device),
        tile_cb=_tensor(tile_cb, device),
        n_rows=A.n_rows, n_cols=A.n_cols, tb=tb,
        **_schedules(tile_rb, tile_cb, live, A.n_rows, A.n_cols, tb, device),
    )


def bsr_from_sparse(
    A: SparseMatrix, *, tb: int = 256, dtype=torch.bfloat16,
    cover_rows: bool = False, cover_cols: bool = False, mask: bool = False,
    shift: float = 0.0, device="cpu",
) -> BSRMatrix:
    """Densify each nonempty (rb, cb) tile on the host: duplicate edges sum
    in f32, then cast to ``dtype``, or threshold ``> 0`` to int8 {0,1} with
    ``mask`` (zero-valued edges vanish from masks). ``shift`` is subtracted
    from every position of every tile, absent ones and cover tiles
    included, in f32 before the cast (the shifted-int8 form stores the
    0..255 grid minus 128).

    ``cover_rows`` adds a zero tile at (rb, 0) for every row block without
    nonzeros, so the kernel writes every output row; ``cover_cols`` does
    the same at (0, cb) for empty column blocks, so the transpose still
    covers its rows."""
    r = _np(A.rows)[: A.nnz]
    c = _np(A.cols)[: A.nnz]
    v = _np(A.vals)[: A.nnz].astype(np.float32)
    if mask:
        dtype = torch.int8
    key = (r // tb).astype(np.int64) << 32 | (c // tb).astype(np.int64)
    uniq = bsr_tile_keys(A, tb, cover_rows=cover_rows, cover_cols=cover_cols)
    T = max(len(uniq), 1)
    tiles = torch.full((T, tb, tb), -shift if shift else 0, dtype=dtype)
    # shifted tiles hold -shift everywhere: every one of them is live
    live = np.full(T, bool(shift))
    if len(v):
        # duplicate-safe scatter in bounded f32 batches of tiles
        inv = np.searchsorted(uniq, key)
        live[inv[v > 0 if mask else v != 0]] = True
        idx = (inv * tb + r % tb) * tb + (c % tb)
        order = np.argsort(idx, kind="stable")
        sidx, sv = idx[order], v[order]
        per_tile = tb * tb
        batch = max(1, (128 << 20) // (per_tile * 4))
        for b0 in range(0, T, batch):
            b1 = min(T, b0 + batch)
            lo = np.searchsorted(sidx, b0 * per_tile)
            hi = np.searchsorted(sidx, b1 * per_tile)
            if lo == hi:
                continue
            buf = np.zeros((b1 - b0) * per_tile, np.float32)
            bi = sidx[lo:hi] - b0 * per_tile
            st = np.flatnonzero(np.r_[True, bi[1:] != bi[:-1]])
            buf[bi[st]] = np.add.reduceat(sv[lo:hi], st)
            buf = torch.from_numpy(buf.reshape(b1 - b0, tb, tb))
            tiles[b0:b1] = (buf > 0).to(dtype) if mask else (buf - shift).to(dtype)
    return _bsr(tiles, uniq, live, A, tb, device)


def bsr_mask_from_sparse(
    A: SparseMatrix, *, tb: int = 256, cover_rows: bool = False,
    cover_cols: bool = False, device="cpu",
) -> BSRMatrix:
    """BSR of the edge mask: int8 {0,1} tiles (``tile > 0``)."""
    return bsr_from_sparse(
        A, tb=tb, mask=True, cover_rows=cover_rows, cover_cols=cover_cols,
        device=device,
    )


def bsr_bitmask_from_sparse(
    A: SparseMatrix, *, tb: int = 1024, cover_rows: bool = False,
    cover_cols: bool = False, device="cpu",
) -> BSRMatrix:
    """BSR of the edge mask packed to 1 bit per entry: uint8
    [T, tb, tb/8], byte i bit j of a row holds column ``j*(tb/8) + i``
    (bits scattered straight into the packed array on the host). The
    kernels read a packed row 16 bytes at a time, hence tb % 128 == 0."""
    if tb % 128:
        raise ValueError(f"packed tiles need tb % 128 == 0, got tb={tb}")
    r = _np(A.rows)[: A.nnz].astype(np.int64)
    c = _np(A.cols)[: A.nnz].astype(np.int64)
    keep = _np(A.vals)[: A.nnz] > 0
    r, c = r[keep], c[keep]
    uniq = bsr_tile_keys(A, tb, cover_rows=cover_rows, cover_cols=cover_cols)
    T = max(len(uniq), 1)
    nb = tb // 8
    packed = np.zeros((T, tb, nb), np.uint8)
    live = np.zeros(T, bool)
    if len(r):
        inv = np.searchsorted(uniq, (r // tb) << 32 | (c // tb))
        live[inv] = True
        lc = c % tb
        np.bitwise_or.at(
            packed, (inv, r % tb, lc % nb),
            (np.uint8(1) << (lc // nb).astype(np.uint8)),
        )
    return _bsr(torch.from_numpy(packed), uniq, live, A, tb, device)


def pack_mask_bsr(B: BSRMatrix, *, batch_tiles: Optional[int] = None) -> BSRMatrix:
    """int8 {0,1} mask tiles [T, tb, tb] -> 1-bit packed uint8 [T, tb, tb/8]
    on the tiles' device, in batches of ``batch_tiles`` tiles (default: 512
    MiB of int32 intermediates a batch), as JAX ``pack_mask_bsr``. Byte i,
    bit j of a row holds column ``j*(tb/8) + i``: the layout
    ``bsr_bitmask_from_sparse`` builds on the host, and needs tb % 128 == 0
    for the same reason. The tile layout and schedules are kept."""
    tb = B.tb
    if tb % 128 or B.packed:
        raise ValueError(f"pack_mask_bsr takes unpacked mask tiles with tb % 128 == 0, got tb={tb}")
    T = B.num_tiles
    if batch_tiles is None:
        batch_tiles = max(1, (512 << 20) // (tb * tb * 4))
    nb = tb // 8
    parts = []
    for b0 in range(0, T, batch_tiles):
        planes = B.tiles[b0 : b0 + batch_tiles].to(torch.int32).view(-1, tb, 8, nb)
        packed = planes[:, :, 0, :]
        for j in range(1, 8):
            packed = packed | (planes[:, :, j, :] << j)
        parts.append(packed.to(torch.uint8))
    return dataclasses.replace(B, tiles=torch.cat(parts))


def unpack_mask_tile(t: torch.Tensor, tb: int) -> torch.Tensor:
    """Packed mask tiles [..., tb, tb/8] -> bool [..., tb, tb]."""
    return unpack_mask01_tile(t, tb) > 0.5


def unpack_mask01_tile(t: torch.Tensor, tb: int, dtype=torch.float32) -> torch.Tensor:
    """Packed mask tiles [..., tb, tb/8] -> {0,1} [..., tb, tb] in ``dtype``
    (the eight bit planes concatenated along the columns)."""
    ti = t.to(torch.int32) & 0xFF
    return torch.cat([(ti >> j) & 1 for j in range(8)], dim=-1).to(dtype)


def pad_bsr_tile_count(B: BSRMatrix, T_pad: int) -> BSRMatrix:
    """``B`` padded to ``T_pad`` tiles with all-zero tiles, as JAX
    ``pad_bsr_tile_count``: a zero value or mask tile adds nothing, so
    only the tile count changes (re-prepared batches keep one shape). The
    pad tiles take the last tile's row block, extending its run (a run of
    its own at a visited row block would restart that block's sum in the
    single-stage kernels), and column block 0. They are dead (``live``
    False): the live schedules ``ring``, and ``live_t`` and ``edge_ring``
    where built, are carried over unchanged, so the ring kernels walk the
    same steps; ``segments`` and the column order take the pad tiles in."""
    T = B.num_tiles
    if T_pad <= T:
        return B
    pad = T_pad - T
    dev = B.tiles.device
    tiles = torch.cat([B.tiles, B.tiles.new_zeros((pad,) + tuple(B.tiles.shape[1:]))])
    tile_rb = torch.cat([B.tile_rb, B.tile_rb[-1:].expand(pad)])
    tile_cb = torch.cat([B.tile_cb, B.tile_cb.new_zeros(pad)])
    live = torch.cat([B.live, B.live.new_zeros(pad)])
    rb, cb = _np(tile_rb), _np(tile_cb)
    col_perm = np.argsort(cb, kind="stable")
    out = dataclasses.replace(
        B, tiles=tiles, tile_rb=tile_rb, tile_cb=tile_cb, live=live,
        segments=run_segments(rb, B.n_row_tiles, dev),
        col_perm=_tensor(col_perm.astype(np.int32), dev),
        col_segments=run_segments(cb[col_perm], _round_up(B.n_cols, B.tb) // B.tb, dev),
    )
    for name in ("live_t", "edge_ring"):  # cached schedules of the live tiles
        if name in B.__dict__:
            out.__dict__[name] = B.__dict__[name]
    return out


def bsr_transpose(B: BSRMatrix) -> BSRMatrix:
    """BSR of A^T: swap block coordinates, transpose each tile, resort by
    row block (stable). Packed tiles cannot be element-transposed; build
    the transposed plan from the transposed edge list instead."""
    if B.packed:
        raise ValueError(
            "bsr_transpose cannot transpose 1-bit packed tiles; build the "
            "transposed plan via bsr_bitmask_from_sparse(A.transpose(), ...)"
        )
    order = torch.argsort(B.tile_cb, stable=True)
    tile_rb = B.tile_cb[order]
    tile_cb = B.tile_rb[order]
    return BSRMatrix(
        tiles=B.tiles.transpose(1, 2)[order].contiguous(),
        tile_rb=tile_rb,
        tile_cb=tile_cb,
        n_rows=B.n_cols, n_cols=B.n_rows, tb=B.tb,
        **_schedules(_np(tile_rb), _np(tile_cb), _np(B.live[order]), B.n_cols, B.n_rows,
                     B.tb, B.tiles.device),
    )


def live_transpose(B: BSRMatrix) -> BSRMatrix:
    """``bsr_transpose`` of ``B``'s live tiles alone: A^T over the tiles an
    edge produced, the empty cover tiles dropped. Its ``ring`` walks A's
    column-block runs of live tiles (the ring K5's schedule), and a column
    block without one keeps an empty work item. A tile set without a live
    tile keeps its first (zero) tile."""
    keep = torch.nonzero(B.live).flatten()
    if keep.numel() == 0:
        keep = torch.zeros(1, dtype=torch.long, device=B.live.device)
    sub = dataclasses.replace(
        B, tiles=B.tiles[keep], tile_rb=B.tile_rb[keep], tile_cb=B.tile_cb[keep], live=B.live[keep],
    )
    return bsr_transpose(sub)


# ------------------------------------------------------------- kernel K1


def _tile_values(tiles: torch.Tensor, tb: int) -> torch.Tensor:
    """Tiles as f32 holding their bf16-rounded values (packed tiles
    unpacked), the operand both kernels feed the tensor cores."""
    if tiles.shape[-1] != tb:
        return unpack_mask01_tile(tiles, tb)
    return tiles.to(torch.bfloat16).to(torch.float32)


def _h_block_rows(H: torch.Tensor, rows: int) -> torch.Tensor:
    """bf16-rounded H as f32, zero-padded to ``rows`` rows."""
    Hb = torch.zeros((rows, H.shape[1]), dtype=torch.float32, device=H.device)
    Hb[: H.shape[0]] = H.to(torch.bfloat16).to(torch.float32)
    return Hb


def _tile_products(tiles, tb, tile_ids, rb, cb, Hblk, acc) -> None:
    """acc[rb] += tile @ Hblk[cb] for the listed tiles, in bounded f32
    batches (exact bf16 products, f32 sums)."""
    batch = max(1, _PLAIN_BATCH_BYTES // (tb * (tb + 2 * Hblk.shape[2]) * 4))
    for b0 in range(0, tile_ids.shape[0], batch):
        sl = slice(b0, b0 + batch)
        a = _tile_values(tiles[tile_ids[sl]], tb)
        acc.index_add_(0, rb[sl], torch.bmm(a, Hblk[cb[sl]]))


def bsr_spmm_plain(B: BSRMatrix, H: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: ``out[rb] += bf16(tile) @ bf16(H[cb])``, f32
    [n_rows, P]."""
    tb, P = B.tb, H.shape[1]
    n_ct = _round_up(B.n_cols, tb) // tb
    Hblk = _h_block_rows(H, n_ct * tb).view(n_ct, tb, P)
    acc = torch.zeros((B.n_row_tiles, tb, P), dtype=torch.float32, device=H.device)
    ids = torch.arange(B.num_tiles, device=H.device)
    _tile_products(
        B.tiles, tb, ids, B.tile_rb.long(), B.tile_cb.long(), Hblk, acc
    )
    return acc.view(-1, P)[: B.n_rows]


def bsr_spmm_xla(B: BSRMatrix, H: torch.Tensor) -> torch.Tensor:
    """out = A @ H by one batched product of every tile with its H block
    (bf16 operands, f32 sums) and a segment sum over the tiles' row blocks,
    f32 [n_rows, P]: JAX ``bsr_spmm_xla``, a plain XLA function there and
    torch ops here (``bmm`` + ``index_add_``)."""
    tb, P = B.tb, H.shape[1]
    n_ct = _round_up(B.n_cols, tb) // tb
    Hg = _h_block_rows(H, n_ct * tb).view(n_ct, tb, P)[B.tile_cb.long()]
    prod = torch.bmm(_tile_values(B.tiles, tb), Hg)
    out = torch.zeros((B.n_row_tiles, tb, P), dtype=torch.float32, device=H.device)
    out.index_add_(0, B.tile_rb.long(), prod)
    return out.view(-1, P)[: B.n_rows]


_TILE_MODES ={torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def _tile_mode(tiles: torch.Tensor, tb: int) -> int:
    if tiles.dim() != 3 or tiles.shape[1] != tb:
        raise ValueError(f"tiles must be [T, {tb}, *], got {tuple(tiles.shape)}")
    if tiles.shape[2] == tb // 8 and tiles.dtype == torch.uint8:
        if tb % 128:
            raise ValueError(f"packed tiles need tb % 128 == 0, got tb={tb}")
        return 3
    if tiles.shape[2] != tb or tiles.dtype not in _TILE_MODES:
        raise ValueError(
            f"tiles must be bf16/f32/int8 [T, tb, tb] or uint8 [T, tb, tb/8]; "
            f"got {tiles.dtype} {tuple(tiles.shape)} at tb={tb}"
        )
    return _TILE_MODES[tiles.dtype]


def _check_cuda_operands(tensors: dict, device: torch.device) -> None:
    """Every kernel operand lies on ``device`` and is contiguous."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, H on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _h_operand(H: torch.Tensor, n_cols: int, tb: int) -> tuple:
    """(is_bf16, vec) for a kernel launch on H: f32 or bf16 [>= n_cols, P],
    contiguous; ``vec`` allows 16-byte loads of a row's features."""
    if tb % 32:
        raise ValueError(f"the CUDA kernels need tb % 32 == 0, got tb={tb}")
    if H.dim() != 2 or H.shape[0] < n_cols:
        raise ValueError(f"H must be [>= {n_cols}, P], got {tuple(H.shape)}")
    if H.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"H must be float32 or bfloat16, got {H.dtype}")
    if not H.is_contiguous():
        raise ValueError("H must be contiguous")
    is_bf16 = H.dtype == torch.bfloat16
    vec = int(H.shape[1] % (8 if is_bf16 else 4) == 0 and H.data_ptr() % 16 == 0)
    return is_bf16, vec


def _seg_args(S: RunSegments) -> list:
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    return [
        S.n_seg, p(S.seg_rb), p(S.seg_lo), p(S.seg_hi), p(S.seg_part),
        S.n_fin, p(S.fin_rb), p(S.fin_p0), p(S.fin_np),
    ]


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def ring_shape_ok(mode: int, tb: int, P: int, K: Optional[int] = None) -> bool:
    """Whether the ring kernels (csrc/tile_ring.cuh) take these operands:
    int8 or bf16 tiles, a tile height of 64, 128, 192 or 256 (one CTA owns
    the whole height; a stage is 64 deep), feature rows of whole 16-byte
    pieces, chunks of whole stages. Everything else goes to the
    single-stage kernels. The rule reads shapes and the tile form only."""
    return (
        mode in (_TILE_MODES[torch.bfloat16], _TILE_MODES[torch.int8])
        and tb % 64 == 0 and tb <= 256 and P % 8 == 0
        and (K is None or K % 64 == 0)
    )


def stage_h_plain(
    H: torch.Tensor, colscale: Optional[torch.Tensor], rows: int, n_valid: int
) -> torch.Tensor:
    """Plain PyTorch version of the ring kernels' pre-pass: the B operand
    rounded once, ``Hs = bf16(bf16(H) * bf16(colscale))`` (``bf16(H)``
    without a column scale), bf16 [rows, P] with zero rows from
    ``n_valid`` on."""
    Hs = torch.zeros((rows, H.shape[1]), dtype=torch.bfloat16, device=H.device)
    h = H[:n_valid].to(torch.bfloat16)
    if colscale is not None:
        cs = colscale[:n_valid].to(torch.bfloat16).to(torch.float32)
        h = (h.to(torch.float32) * cs[:, None]).to(torch.bfloat16)
    Hs[:n_valid] = h
    return Hs


def _stage_h(H: torch.Tensor, colscale: Optional[torch.Tensor], rows: int, n_valid: int) -> torch.Tensor:
    """The ring kernels' B operand on the card: ``stage_h_plain``'s result
    by the pre-pass kernel of csrc/tile_ring.cuh, or H itself when it
    already is that matrix (bf16, unscaled, exactly ``rows`` valid rows)."""
    if H.dtype == torch.bfloat16 and colscale is None and n_valid == rows and H.shape[0] >= rows:
        return H
    if H.data_ptr() % 16:
        raise ValueError("the ring kernels need H aligned to 16 bytes")
    Hs = torch.empty((rows, H.shape[1]), dtype=torch.bfloat16, device=H.device)
    err = _cuda.library().sg_stage_h(
        _ptr(H), int(H.dtype == torch.bfloat16), n_valid, _ptr(colscale), _ptr(Hs), rows,
        H.shape[1], ctypes.c_void_p(torch.cuda.current_stream(H.device).cuda_stream),
    )
    _cuda.check(err, "stage_h")
    return Hs


def _launch_ring(
    name: str, B: BSRMatrix, L: LiveSchedule, H: torch.Tensor, out_dtype, *,
    colscale=None, rowscale=None, lrow=None, slot_col=None, slot_scale=None, K: int = 0,
    extra: tuple = (),
) -> torch.Tensor:
    """Stage H and launch the ring kernel ``sg_<name>`` over the live
    schedule ``L`` (K1: tiles only; K2: with the chunk arrays and
    scalings). With a column scale the chunk rows are ``Hs`` rows as they
    are (rank-1 mode: ``slot_scale == colscale[slot_col]``); without one
    they are scaled by ``slot_scale`` in the kernel. ``extra`` ints follow
    the SM count (the fused ring's slabs a stage and slab depth)."""
    mode = _tile_mode(B.tiles, B.tb)
    _h_operand(H, B.n_cols, B.tb)
    S = L.segments
    ints = dict(step=L.step, lrow=lrow, slot_col=slot_col, **S.tensors())
    floats = dict(colscale=colscale, rowscale=rowscale, slot_scale=slot_scale)
    _check_cuda_operands(dict(tiles=B.tiles, **ints, **floats), H.device)
    for k, t in ints.items():
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{k} must be int32, got {t.dtype}")
    for k, t in floats.items():
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{k} must be float32, got {t.dtype}")
    tb, P = B.tb, H.shape[1]
    n_ct = _round_up(B.n_cols, tb) // tb
    Hs = _stage_h(H, colscale, n_ct * tb, B.n_cols)
    out = torch.empty((B.n_rows, P), dtype=out_dtype, device=H.device)
    partial = torch.empty((max(S.n_part, 1), tb, P), dtype=torch.float32, device=H.device)
    err = getattr(_cuda.library(), "sg_" + name)(
        _ptr(B.tiles), mode, tb, B.tiles.shape[0], *_seg_args(S), _ptr(L.step),
        _ptr(lrow), _ptr(slot_col), _ptr(slot_scale if colscale is None else None), K,
        _ptr(rowscale), _ptr(Hs), Hs.shape[0], P, _ptr(out), _ptr(partial), B.n_rows,
        torch.cuda.get_device_properties(H.device).multi_processor_count, *extra,
        ctypes.c_void_p(torch.cuda.current_stream(H.device).cuda_stream),
    )
    _cuda.check(err, name)
    return out


def _bsr_spmm_single(B: BSRMatrix, H: torch.Tensor) -> torch.Tensor:
    """K1 by the single-stage kernel ``csrc/bsr_spmm.cu``: every tile form,
    every tile of ``B.segments``."""
    mode = _tile_mode(B.tiles, B.tb)
    is_bf16, vec = _h_operand(H, B.n_cols, B.tb)
    S = B.segments
    ints = dict(tile_cb=B.tile_cb, **S.tensors())
    _check_cuda_operands(dict(tiles=B.tiles, **ints), H.device)
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    P = H.shape[1]
    out = torch.empty((B.n_rows, P), dtype=torch.float32, device=H.device)
    partial = torch.empty(
        (max(S.n_part, 1), B.tb, P), dtype=torch.float32, device=H.device
    )
    err = _cuda.library().sg_bsr_spmm(
        _ptr(B.tiles), mode, B.tb, *_seg_args(S), _ptr(B.tile_cb), _ptr(H),
        int(is_bf16), B.n_cols, P, vec, _ptr(out), _ptr(partial), B.n_rows,
        ctypes.c_void_p(torch.cuda.current_stream(H.device).cuda_stream),
    )
    _cuda.check(err, "bsr_spmm")
    bsr_spmm.launches += 1
    bsr_spmm.launches_single += 1
    return out


def _bsr_spmm_ring(B: BSRMatrix, H: torch.Tensor) -> torch.Tensor:
    """K1 by the ring kernel ``csrc/bsr_spmm_ring.cu`` over ``B.ring``."""
    out = _launch_ring("bsr_spmm_ring", B, B.ring, H, torch.float32)
    bsr_spmm.launches += 1
    bsr_spmm.launches_ring += 1
    return out


def bsr_spmm(B: BSRMatrix, H: torch.Tensor) -> torch.Tensor:
    """K1: out = A @ H over the tiles of ``B``, f32 [n_rows, P] (bf16
    operands, f32 accumulation). A CPU tensor runs ``bsr_spmm_plain``; a
    CUDA tensor launches the ring kernel where ``ring_shape_ok`` holds,
    else the single-stage kernel, or raises. ``launches`` counts both;
    ``launches_ring`` / ``launches_single`` each one."""
    if H.device.type == "cpu":
        return bsr_spmm_plain(B, H)
    if H.device.type != "cuda":
        raise ValueError(f"bsr_spmm runs on cpu or cuda, not {H.device}")
    if H.dim() == 2 and ring_shape_ok(_tile_mode(B.tiles, B.tb), B.tb, H.shape[1]):
        return _bsr_spmm_ring(B, H)
    return _bsr_spmm_single(B, H)


bsr_spmm.launches = 0
bsr_spmm.launches_ring = 0
bsr_spmm.launches_single = 0


# ------------------------------------------------------------ kernel K10

# CTAs of a thread-block cluster for the cluster K10 (csrc/bsr_spmm_cluster.cu):
# 8 is the portable size, 16 needs the non-portable attribute; both measured
# by chip_smoke.py
ROWLOOP_CLUSTERS = (8, 16)
ROWLOOP_CLUSTER = 16


# item kinds of the cluster K10 (csrc/bsr_spmm_cluster.cu)
LIGHT, HEAVY, UPPER, LOWER = 0, 1, 2, 3
# estimated cost of a CTA's epilogue, in tile products (greedy balance only)
_EPILOGUE_COST = 0.25


@dataclasses.dataclass(frozen=True)
class ClusterSchedule:
    """Work list of the cluster K10: items of ``C`` CTA slots each, and the
    items of each cluster.

    A heavy item (kind ``HEAVY``) is one row block whose live steps
    (``BSRMatrix.ring``) are cut into ``C`` contiguous ranges, balanced by
    count, one per slot; the ranks' partial sums meet in distributed shared
    memory. A row block whose ranges would still hold more than
    ``heavy_min`` tiles a slot is two such items, ``UPPER`` and ``LOWER``,
    each over half the tile height (tb >= 128). A light item holds up to
    ``C`` row blocks, one per slot (``item_rb == -1``: an idle slot). Every
    row block appears, an empty one as a light slot with an empty range (its
    rows are written as zeros). ``item_lo`` / ``item_hi`` index
    ``ring.step``. Cluster ``c`` walks items ``cl_start[c] ..
    cl_start[c + 1]``: the items go, most costly first, each to the cluster
    with the least estimated work so far (a tile product per tile and row
    fraction, plus an epilogue)."""

    item_rb: torch.Tensor  # int32[n_items * C]
    item_lo: torch.Tensor  # int32[n_items * C]
    item_hi: torch.Tensor  # int32[n_items * C]
    item_kind: torch.Tensor  # int32[n_items]
    cl_start: torch.Tensor  # int32[n_clusters + 1]
    C: int
    heavy_min: int  # a row block with more live tiles than this is heavy

    @property
    def n_items(self) -> int:
        return self.item_kind.shape[0]

    @property
    def n_clusters(self) -> int:
        return self.cl_start.shape[0] - 1

    @property
    def n_heavy(self) -> int:
        """Items that split one row block over the cluster."""
        return int((self.item_kind != LIGHT).sum())


def rowloop_heavy_min(n_live: int, n_sm: int, C: int) -> int:
    """The live tile count above which a row block is heavy: an SM's fair
    share of the live tiles, and at least ``C`` (every rank gets a tile)."""
    return max(C, -(-n_live // max(n_sm, 1)))


def cluster_schedule(B: BSRMatrix, C: int, heavy_min: int, n_clusters: int) -> ClusterSchedule:
    """The cluster K10's work list over ``B.ring``'s live steps, spread
    over ``n_clusters`` clusters (host)."""
    rb = _np(B.ring.rb).astype(np.int64)
    tb, n_rt = B.tb, B.n_row_tiles
    start = np.searchsorted(rb, np.arange(n_rt + 1))
    count = np.diff(start)
    heavy = np.flatnonzero(count > heavy_min)
    heavy = heavy[np.argsort(-count[heavy], kind="stable")]
    halves = (count[heavy] > C * heavy_min) & (tb >= 128)
    light = np.flatnonzero(count <= heavy_min)
    light = light[np.argsort(-count[light], kind="stable")]
    n_light = -(-len(light) // C)
    # heavy items: C balanced contiguous ranges of the block's live steps,
    # a block of two halves listed twice
    hb = np.repeat(heavy, np.where(halves, 2, 1))
    h_kind = np.where(np.repeat(halves, np.where(halves, 2, 1)), UPPER, HEAVY)
    h_kind[1:][(h_kind[1:] == UPPER) & (h_kind[:-1] == UPPER) & (hb[1:] == hb[:-1])] = LOWER
    cuts = start[hb][:, None] + (count[hb][:, None] * np.arange(C + 1)) // C
    h_lo, h_hi = cuts[:, :-1].reshape(-1), cuts[:, 1:].reshape(-1)
    # light items: one row block a slot, idle slots at the end
    l_rb = np.full(n_light * C, -1, np.int64)
    l_rb[: len(light)] = light
    l_lo = np.where(l_rb >= 0, start[np.maximum(l_rb, 0)], 0)
    l_hi = np.where(l_rb >= 0, start[np.maximum(l_rb, 0) + 1], 0)
    item_rb = np.r_[np.repeat(hb, C), l_rb]
    item_lo, item_hi = np.r_[h_lo, l_lo], np.r_[h_hi, l_hi]
    kind = np.r_[h_kind, np.full(n_light, LIGHT)]
    n_items = len(kind)
    # greedy: most costly first, each to the least loaded cluster
    frac = np.where(kind >= UPPER, 0.5, 1.0)
    cost = ((item_hi - item_lo).reshape(n_items, C).max(axis=1) if n_items else np.zeros(0)) * frac + _EPILOGUE_COST
    n_cl = max(1, min(n_clusters, n_items))
    load = np.zeros(n_cl)
    owner = np.empty(n_items, np.int64)
    for i in np.argsort(-cost, kind="stable"):
        c = int(np.argmin(load))
        owner[i] = c
        load[c] += cost[i]
    order = np.argsort(owner, kind="stable")  # each cluster's items, in list order
    slots = (order[:, None] * C + np.arange(C)).reshape(-1)
    cl_start = np.r_[0, np.cumsum(np.bincount(owner, minlength=n_cl))] if n_items else np.zeros(1)
    dev = B.ring.step.device
    i32 = lambda a: _tensor(np.asarray(a, np.int64).astype(np.int32), dev)
    return ClusterSchedule(
        item_rb=i32(item_rb[slots]), item_lo=i32(item_lo[slots]), item_hi=i32(item_hi[slots]),
        item_kind=i32(kind[order]), cl_start=i32(cl_start), C=C, heavy_min=heavy_min,
    )


def _cluster_sched(B: BSRMatrix, C: int, n_sm: int, n_clusters: int) -> ClusterSchedule:
    """``cluster_schedule`` at the heavy rule's threshold for ``n_sm`` SMs
    over ``n_clusters`` clusters, built at first use and kept with the tile
    set."""
    heavy_min = rowloop_heavy_min(B.ring.n_tile_steps, n_sm, C)
    cache = B.__dict__.setdefault("_cluster_schedules", {})
    key = (C, heavy_min, n_clusters)
    if key not in cache:
        cache[key] = cluster_schedule(B, C, heavy_min, n_clusters)
    return cache[key]


def _row_start(B: BSRMatrix) -> torch.Tensor:
    """int32 [n_rt + 1]: the first tile of every row block (tiles are
    sorted by row block)."""
    blocks = torch.arange(B.n_row_tiles + 1, dtype=B.tile_rb.dtype, device=B.tile_rb.device)
    return torch.searchsorted(B.tile_rb.contiguous(), blocks).to(torch.int32)


def bsr_spmm_rowloop_plain(B: BSRMatrix, H: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K10: K1's arithmetic with each tile's output block
    read from the row-start offsets the row-loop kernel walks, f32
    [n_rows, P]."""
    tb, P = B.tb, H.shape[1]
    n_ct = _round_up(B.n_cols, tb) // tb
    start = _row_start(B).to(H.device).long()
    rb = torch.repeat_interleave(
        torch.arange(B.n_row_tiles, device=H.device), start[1:] - start[:-1]
    )
    Hblk = _h_block_rows(H, n_ct * tb).view(n_ct, tb, P)
    acc = torch.zeros((B.n_row_tiles, tb, P), dtype=torch.float32, device=H.device)
    ids = torch.arange(rb.shape[0], device=H.device)
    _tile_products(B.tiles, tb, ids, rb, B.tile_cb[: rb.shape[0]].long(), Hblk, acc)
    return acc.view(-1, P)[: B.n_rows]


def bsr_spmm_rowloop_cluster_plain(B: BSRMatrix, H: torch.Tensor, sched: ClusterSchedule) -> torch.Tensor:
    """Plain PyTorch version of the cluster K10 on ``sched``: each slot's
    live tiles summed in f32 (a light slot straight into its row block), a
    heavy item's ``C`` partials over its rows summed in rank order, f32
    [n_rows, P]."""
    tb, P, C = B.tb, H.shape[1], sched.C
    n_ct = _round_up(B.n_cols, tb) // tb
    dev = H.device
    Hs = stage_h_plain(H, None, n_ct * tb, B.n_cols).float().view(n_ct, tb, P)
    step = B.ring.step.to(dev).long()
    lo, hi = sched.item_lo.to(dev).long(), sched.item_hi.to(dev).long()
    kind = sched.item_kind.to(dev).long()
    slot = torch.repeat_interleave(torch.arange(lo.shape[0], device=dev), hi - lo)
    g = torch.arange(slot.shape[0], device=dev) - (torch.cumsum(hi - lo, 0) - (hi - lo))[slot] + lo[slot]
    acc = torch.zeros((lo.shape[0], tb, P), dtype=torch.float32, device=dev)
    _tile_products(B.tiles, tb, step[g, 0], slot, step[g, 1], Hs, acc)
    out = torch.zeros((B.n_row_tiles, tb, P), dtype=torch.float32, device=dev)
    rb = sched.item_rb.to(dev).long()
    light = (kind.repeat_interleave(C) == LIGHT) & (rb >= 0)
    out[rb[light]] = acc[light]
    parts, rbi = acc.view(-1, C, tb, P), rb.view(-1, C)[:, 0]
    for i in torch.nonzero(kind != LIGHT).flatten().tolist():
        r0, r1 = {HEAVY: (0, tb), UPPER: (0, tb // 2), LOWER: (tb // 2, tb)}[int(kind[i])]
        total = parts[i, 0, r0:r1].clone()
        for r in range(1, C):
            total += parts[i, r, r0:r1]
        out[rbi[i], r0:r1] = total
    return out.view(-1, P)[: B.n_rows]


@functools.lru_cache(maxsize=None)
def rowloop_cluster_occupancy(mode: int, C: int) -> int:
    """The clusters of ``C`` CTAs of the cluster K10 the card holds at once
    (``cudaOccupancyMaxActiveClusters`` at its shared memory); the kernel
    launches that many, each with its own list of items."""
    n = _cuda.library().sg_bsr_spmm_cluster_occupancy(mode, C)
    _cuda.check(-n if n < 0 else 0, "bsr_spmm_cluster occupancy")
    if n < 1:
        raise RuntimeError(f"no cluster of {C} CTAs of the cluster K10 fits the card")
    return n


def _bsr_spmm_rowloop_cluster(B: BSRMatrix, H: torch.Tensor, C: int = ROWLOOP_CLUSTER,
                              sched: Optional[ClusterSchedule] = None) -> torch.Tensor:
    """K10 by the cluster kernel ``csrc/bsr_spmm_cluster.cu`` over the live
    tiles: on ``_cluster_sched``'s schedule for this card, or on ``sched``
    (``cluster_schedule`` of ``B`` with ``C``, as many clusters as the card
    holds at most: a measurement of the schedule's choices)."""
    if C not in ROWLOOP_CLUSTERS:
        raise ValueError(f"the cluster K10 takes clusters of {ROWLOOP_CLUSTERS}, got {C}")
    mode = _tile_mode(B.tiles, B.tb)
    _h_operand(H, B.n_cols, B.tb)
    if sched is None:
        sched = _cluster_sched(B, C, torch.cuda.get_device_properties(H.device).multi_processor_count,
                               rowloop_cluster_occupancy(mode, C))
    elif sched.C != C:
        raise ValueError(f"the schedule has clusters of {sched.C}, the kernel runs clusters of {C}")
    elif sched.n_clusters > rowloop_cluster_occupancy(mode, C):
        raise ValueError(f"the schedule has {sched.n_clusters} clusters, the card holds "
                         f"{rowloop_cluster_occupancy(mode, C)} of {C} CTAs")
    ints = dict(step=B.ring.step, cl_start=sched.cl_start, item_rb=sched.item_rb, item_lo=sched.item_lo,
                item_hi=sched.item_hi, item_kind=sched.item_kind)
    _check_cuda_operands(dict(tiles=B.tiles, **ints), H.device)
    tb, P = B.tb, H.shape[1]
    n_ct = _round_up(B.n_cols, tb) // tb
    Hs = _stage_h(H, None, n_ct * tb, B.n_cols)
    out = torch.empty((B.n_rows, P), dtype=torch.float32, device=H.device)
    err = _cuda.library().sg_bsr_spmm_cluster(
        _ptr(B.tiles), mode, tb, B.tiles.shape[0], C, sched.n_clusters, _ptr(sched.cl_start),
        _ptr(sched.item_rb), _ptr(sched.item_lo), _ptr(sched.item_hi), _ptr(sched.item_kind),
        _ptr(B.ring.step), _ptr(Hs), Hs.shape[0], P, _ptr(out), B.n_rows,
        ctypes.c_void_p(torch.cuda.current_stream(H.device).cuda_stream),
    )
    _cuda.check(err, "bsr_spmm_cluster")
    bsr_spmm_rowloop.launches += 1
    bsr_spmm_rowloop.launches_cluster += 1
    return out


def _bsr_spmm_rowloop_single(B: BSRMatrix, H: torch.Tensor) -> torch.Tensor:
    """K10 by the single-stage kernel ``csrc/bsr_spmm_rowloop.cu``: every
    tile form, every tile, one CTA per (row block, 128-row group,
    128-feature slice)."""
    mode = _tile_mode(B.tiles, B.tb)
    is_bf16, vec = _h_operand(H, B.n_cols, B.tb)
    ints = dict(tile_rb=B.tile_rb, tile_cb=B.tile_cb)
    _check_cuda_operands(dict(tiles=B.tiles, **ints), H.device)
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    row_start = _row_start(B)
    P = H.shape[1]
    out = torch.empty((B.n_rows, P), dtype=torch.float32, device=H.device)
    err = _cuda.library().sg_bsr_spmm_rowloop(
        _ptr(B.tiles), mode, B.tb, B.n_row_tiles, _ptr(row_start), _ptr(B.tile_cb),
        _ptr(H), int(is_bf16), B.n_cols, P, vec, _ptr(out), B.n_rows,
        ctypes.c_void_p(torch.cuda.current_stream(H.device).cuda_stream),
    )
    _cuda.check(err, "bsr_spmm_rowloop")
    bsr_spmm_rowloop.launches += 1
    bsr_spmm_rowloop.launches_single += 1
    return out


def bsr_spmm_rowloop(B: BSRMatrix, H: torch.Tensor) -> torch.Tensor:
    """K10: K1's product with every output row block written once (JAX
    ``bsr_spmm_rowloop``). Same tile forms and result as ``bsr_spmm``. A CPU
    tensor runs ``bsr_spmm_rowloop_plain``; a CUDA tensor launches the
    cluster kernel (a hub row block split over the CTAs of a
    ``ROWLOOP_CLUSTER`` cluster, its partials summed in distributed shared
    memory) where ``ring_shape_ok`` holds, else the single-stage kernel, or
    raises. ``launches`` counts both; ``launches_cluster`` /
    ``launches_single`` each one."""
    if H.device.type == "cpu":
        return bsr_spmm_rowloop_plain(B, H)
    if H.device.type != "cuda":
        raise ValueError(f"bsr_spmm_rowloop runs on cpu or cuda, not {H.device}")
    if H.dim() == 2 and ring_shape_ok(_tile_mode(B.tiles, B.tb), B.tb, H.shape[1]):
        return _bsr_spmm_rowloop_cluster(B, H)
    return _bsr_spmm_rowloop_single(B, H)


bsr_spmm_rowloop.launches = 0
bsr_spmm_rowloop.launches_cluster = 0
bsr_spmm_rowloop.launches_single = 0


# ------------------------------------------------------------- kernel K7


def _hq_blocks(Hq: torch.Tensor, n_ct: int, tb: int) -> tuple:
    """Signed int8 Hq as float [n_ct, tb, P] (zero rows past its own), and
    the int32 column sums [n_ct, P] of its blocks. The float type holds
    every partial sum of one shifted tile product exactly:
    ``tb * 128 * 128 <= 2**24`` up to tb = 1024, float64 beyond."""
    dt = torch.float32 if tb <= 1024 else torch.float64
    Hb = torch.zeros((n_ct * tb, Hq.shape[1]), dtype=dt, device=Hq.device)
    Hb[: Hq.shape[0]] = Hq[: n_ct * tb].to(dt)
    Hb = Hb.view(n_ct, tb, -1)
    return Hb, Hb.sum(dim=1).to(torch.int32)


def _tile_products_int8(tiles, tb, tile_ids, rb, cb, Hblk, colsum, acc) -> None:
    """acc[rb] += (tile + 128) @ Hq[cb] for the listed shifted tiles, as
    ``tile @ Hq[cb] + 128 * colsum[cb]``: each tile product in float (exact,
    see ``_hq_blocks``; CUDA has no integer matmul in torch), cast to int32
    and summed in int32."""
    batch = max(1, _PLAIN_BATCH_BYTES // (tb * (tb + 2 * Hblk.shape[2]) * Hblk.element_size()))
    for b0 in range(0, tile_ids.shape[0], batch):
        sl = slice(b0, b0 + batch)
        prod = torch.bmm(tiles[tile_ids[sl]].to(Hblk.dtype), Hblk[cb[sl]]).to(torch.int32)
        acc.index_add_(0, rb[sl], prod + 128 * colsum[cb[sl]][:, None, :])


def _check_int8_operands(B: BSRMatrix, Hq: torch.Tensor) -> None:
    if B.tiles.dtype != torch.int8 or B.packed or B.tiles.dim() != 3 or B.tiles.shape[1] != B.tb:
        raise ValueError(
            f"tiles must be shifted int8 [T, tb, tb], got {B.tiles.dtype} {tuple(B.tiles.shape)}"
        )
    if Hq.dim() != 2 or Hq.dtype != torch.int8:
        raise ValueError(f"Hq must be int8 [N, P], got {Hq.dtype} {tuple(Hq.shape)}")


def bsr_spmm_int8_plain(B: BSRMatrix, Hq: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7: exact ``Aq @ Hq``, int32 [n_rt * tb, P] (not
    sliced to ``n_rows``, as the JAX kernel)."""
    _check_int8_operands(B, Hq)
    tb, P = B.tb, Hq.shape[1]
    n_ct = _round_up(B.n_cols, tb) // tb
    Hblk, colsum = _hq_blocks(Hq, n_ct, tb)
    acc = torch.zeros((B.n_row_tiles, tb, P), dtype=torch.int32, device=Hq.device)
    ids = torch.arange(B.num_tiles, device=Hq.device)
    _tile_products_int8(
        B.tiles, tb, ids, B.tile_rb.long(), B.tile_cb.long(), Hblk, colsum, acc
    )
    return acc.view(-1, P)


def _int8_launch_args(B: BSRMatrix, S: RunSegments, Hq: torch.Tensor, n_out: int) -> tuple:
    """Checks and scratch shared by the K7 and K8 launches: (vec, vec4,
    colsum, out, partial). The kernels guard the feature dimension: any P
    runs, 16-byte loads of Hq rows when P % 16 == 0."""
    _check_int8_operands(B, Hq)
    if B.tb % 32:
        raise ValueError(f"the CUDA kernels need tb % 32 == 0, got tb={B.tb}")
    if not Hq.is_contiguous():
        raise ValueError("Hq must be contiguous")
    P, dev = Hq.shape[1], Hq.device
    n_ct = _round_up(B.n_cols, B.tb) // B.tb
    aligned = lambda m: int(P % m == 0 and Hq.data_ptr() % m == 0)
    i32 = lambda *shape: torch.empty(shape, dtype=torch.int32, device=dev)
    return (
        aligned(16), aligned(4), i32(n_ct, P), i32(n_out, P),
        i32(max(S.n_part, 1), B.tb, P),
    )


def int8_ring_shape_ok_k7(tb: int, P: int, data_ptr: int = 0) -> bool:
    """Whether the int8 ring kernel (csrc/fused_agg_int8_ring.cu) takes K7's
    operands: a tile height that is a multiple of 64 (a slab is 64 deep;
    tiles taller than 256 rows are walked in row pieces, ``k7_row_piece``),
    Hq rows of whole 16-byte pieces at a 16-byte-aligned address (the B
    operand is staged transposed by 16-byte loads). Everything else goes to
    the single-stage kernel. The rule reads shapes and the address only."""
    return tb > 0 and tb % 64 == 0 and P % 16 == 0 and data_ptr % 16 == 0


def k7_row_piece(tb: int) -> int:
    """Rows of one work item of the ring K7: the largest multiple of 64 up
    to 256 that divides ``tb`` (one CTA owns at most 256 rows), so a tile
    of height 512 is two work items over its row halves, 256 and below one."""
    return next(th for th in (256, 192, 128, 64) if tb % th == 0)


def int8_edge_schedule(B: BSRMatrix) -> LiveSchedule:
    """The ring K7's schedule over shifted-int8 tiles: each tile cut into
    ``tb / th`` row pieces of ``th = k7_row_piece(tb)`` rows (piece ``i`` of
    tile ``t`` is ``t * (tb / th) + i``), and a tile step for every piece
    that holds a byte other than -128, i.e. a nonzero value on the unsigned
    grid. A piece of -128 bytes only is Aq = 0 and adds nothing once the
    kernel flips bit 7, so it is dropped (``BSRMatrix.live`` keeps every
    shifted tile: K1 reads the bytes as they are). The row blocks of the
    schedule count pieces, ``tb / th`` of them a tile row block, and every
    one keeps a work item, so rows whose pieces are all dropped are written
    as zeros. The flags come from the tiles: one max a piece on their
    device, then the host build."""
    tb, T = B.tb, B.num_tiles
    th = k7_row_piece(tb)
    nh = tb // th
    edge = _np(B.tiles.reshape(T * nh, th * tb).amax(dim=1) > -128)
    prb = (_np(B.tile_rb).astype(np.int64)[:, None] * nh + np.arange(nh)).reshape(-1)
    order = np.argsort(prb, kind="stable")
    piece = np.arange(T * nh)[order]
    return live_schedule(
        prb[order], np.where(edge[order], piece, -1), np.repeat(_np(B.tile_cb), nh)[order],
        np.full(T * nh, -1), B.n_row_tiles * nh, B.tiles.device,
        n_dead_tile_steps=int((~edge).sum()),
    )


def stage_hqt_plain(Hq: torch.Tensor, rows: int, n_valid: int) -> torch.Tensor:
    """Plain PyTorch version of the int8 ring's pre-pass: Hq transposed,
    int8 [P, rows], zero columns from ``n_valid`` on. The tensor cores take
    an int8 B operand K-major only, and a tile step's B is a block of node
    rows, so K7 and K8 read it from here."""
    HqT = torch.zeros((Hq.shape[1], rows), dtype=torch.int8, device=Hq.device)
    HqT[:, :n_valid] = Hq[:n_valid].t()
    return HqT


def _stage_hqt(Hq: torch.Tensor, rows: int, n_valid: int) -> torch.Tensor:
    """``stage_hqt_plain``'s result by the pre-pass kernel of
    csrc/fused_agg_int8_ring.cu."""
    HqT = torch.empty((Hq.shape[1], rows), dtype=torch.int8, device=Hq.device)
    err = _cuda.library().sg_stage_hqt(
        _ptr(Hq), n_valid, Hq.shape[1], _ptr(HqT), rows,
        ctypes.c_void_p(torch.cuda.current_stream(Hq.device).cuda_stream),
    )
    _cuda.check(err, "stage_hqt")
    return HqT


def _bsr_spmm_int8_single(B: BSRMatrix, Hq: torch.Tensor) -> torch.Tensor:
    """K7 by the single-stage kernel ``csrc/bsr_spmm_int8.cu``: every tile
    of ``B.segments``, the shift undone by column sums."""
    S = B.segments
    n_out = B.n_row_tiles * B.tb
    vec, vec4, colsum, out, partial = _int8_launch_args(B, S, Hq, n_out)
    ints = dict(tile_cb=B.tile_cb, **S.tensors())
    _check_cuda_operands(dict(tiles=B.tiles, **ints), Hq.device)
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    err = _cuda.library().sg_bsr_spmm_int8(
        _ptr(B.tiles), B.tb, *_seg_args(S), _ptr(B.tile_cb), _ptr(Hq),
        Hq.shape[0], colsum.shape[0], Hq.shape[1], vec, vec4, _ptr(colsum),
        _ptr(out), _ptr(partial), n_out,
        ctypes.c_void_p(torch.cuda.current_stream(Hq.device).cuda_stream),
    )
    _cuda.check(err, "bsr_spmm_int8")
    bsr_spmm_int8.launches += 1
    bsr_spmm_int8.launches_single += 1
    return out


def _bsr_spmm_int8_ring(B: BSRMatrix, Hq: torch.Tensor) -> torch.Tensor:
    """K7 by the int8 ring kernel ``csrc/fused_agg_int8_ring.cu`` over
    ``B.edge_ring`` (tile steps only): Hq staged transposed once, u8 x s8
    products, a work item a row piece of ``k7_row_piece(tb)`` rows."""
    _check_int8_operands(B, Hq)
    tb, P = B.tb, Hq.shape[1]
    if not int8_ring_shape_ok_k7(tb, P, Hq.data_ptr()):
        raise ValueError(f"the int8 ring kernel does not take K7 at tb={tb}, P={P}")
    if not Hq.is_contiguous():
        raise ValueError("Hq must be contiguous")
    L = B.edge_ring
    S = L.segments
    _check_cuda_operands(dict(tiles=B.tiles, step=L.step, **S.tensors()), Hq.device)
    th = k7_row_piece(tb)
    n_pad, n_out = _round_up(B.n_cols, tb), B.n_row_tiles * tb
    HqT = _stage_hqt(Hq, n_pad, min(Hq.shape[0], B.n_cols))
    out = torch.empty((n_out, P), dtype=torch.int32, device=Hq.device)
    partial = torch.empty((max(S.n_part, 1), th, P), dtype=torch.int32, device=Hq.device)
    err = _cuda.library().sg_fused_agg_int8_ring(
        _ptr(B.tiles), th, tb, B.num_tiles * (tb // th), *_seg_args(S), _ptr(L.step), _ptr(None),
        _ptr(None), _ptr(None), 0, _ptr(HqT), n_pad, _ptr(Hq), P, _ptr(out), _ptr(partial), n_out,
        torch.cuda.get_device_properties(Hq.device).multi_processor_count,
        ctypes.c_void_p(torch.cuda.current_stream(Hq.device).cuda_stream),
    )
    _cuda.check(err, "bsr_spmm_int8_ring")
    bsr_spmm_int8.launches += 1
    bsr_spmm_int8.launches_ring += 1
    return out


def bsr_spmm_int8(B: BSRMatrix, Hq: torch.Tensor) -> torch.Tensor:
    """K7: the exact int32 ``Aq @ Hq`` over shifted-int8 value tiles
    (the 0..255 grid stored minus 128; absent positions and cover tiles
    hold -128). ``Hq`` is signed int8 [N, P], rows past N read as zero; any
    P runs. Returns int32 [n_rt * tb, P]. A CPU tensor runs
    ``bsr_spmm_int8_plain``; a CUDA tensor launches the int8 ring kernel
    where ``int8_ring_shape_ok_k7`` holds, else the single-stage kernel, or
    raises. ``launches`` counts both; ``launches_ring`` /
    ``launches_single`` each one."""
    if Hq.device.type == "cpu":
        return bsr_spmm_int8_plain(B, Hq)
    if Hq.device.type != "cuda":
        raise ValueError(f"bsr_spmm_int8 runs on cpu or cuda, not {Hq.device}")
    if Hq.dim() == 2 and int8_ring_shape_ok_k7(B.tb, Hq.shape[1], Hq.data_ptr()):
        return _bsr_spmm_int8_ring(B, Hq)
    return _bsr_spmm_int8_single(B, Hq)


bsr_spmm_int8.launches = 0
bsr_spmm_int8.launches_ring = 0
bsr_spmm_int8.launches_single = 0
