"""Block-sparse (BSR) aggregation: the nonempty ``tb x tb`` tiles of the
adjacency, and ``A @ H`` over them.

Host side (numpy, then one move to the device): ``bsr_from_sparse`` with
value tiles, int8 {0,1} mask tiles or 1-bit packed mask tiles, and
``bsr_transpose``. Layouts match ``sgracex1_tpu.ops.bsr`` exactly, so the
tests compare tiles element for element.

Kernel K1, ``bsr_spmm``: out = A @ H in f32 with bf16 operands, as
``sgracex1_tpu.ops.bsr.bsr_spmm_pallas``. On a CUDA tensor it launches the
hand-written kernel in ``csrc/bsr_spmm.cu``; on a CPU tensor it runs
``bsr_spmm_plain``, the plain PyTorch version of the same function.

Kernel K7, ``bsr_spmm_int8``: the exact int32 ``Aq @ Hq`` over shifted-int8
value tiles (``quant/int8.bsr_int8_from_sparse``), as
``sgracex1_tpu.ops.bsr.bsr_spmm_int8``: ``csrc/bsr_spmm_int8.cu`` on a CUDA
tensor, ``bsr_spmm_int8_plain`` on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from sgracex1_tpu_torch.graph.csr import SparseMatrix, _np, _round_up
from sgracex1_tpu_torch.ops import _cuda

# schedule steps per CTA segment: bounds the work of one CTA so the long
# runs of hub row blocks spread over many CTAs (a starting point, not tuned)
SEG_STEPS = 16

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


def run_segments(rb_of_step: np.ndarray, n_rt: int, device="cpu") -> RunSegments:
    """Segments of the runs of a row-block-sorted step array (host)."""
    rb_of_step = np.asarray(rb_of_step, np.int64)
    start = np.searchsorted(rb_of_step, np.arange(n_rt + 1))
    length = np.diff(start)
    m = np.maximum(1, -(-length // SEG_STEPS))
    seg_rb = np.repeat(np.arange(n_rt), m)
    first = np.repeat(np.cumsum(m) - m, m)
    i = np.arange(len(seg_rb)) - first
    lo = start[seg_rb] + i * SEG_STEPS
    hi = np.minimum(lo + SEG_STEPS, start[seg_rb + 1])
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
class BSRMatrix:
    """Nonempty dense tiles of a sparse matrix, sorted by (rb, cb).

    ``tiles`` is [T, tb, tb] (bf16/f32 values or int8 {0,1} masks) or
    uint8 [T, tb, tb/8] (1-bit packed masks: byte i, bit j of a row holds
    column ``j*(tb/8) + i``). ``segments`` is the K1 launch schedule over
    the tile runs.

    ``col_perm`` lists the tiles in column order (stable argsort of
    ``tile_cb``, the walk of the TPU column pass ``_bwd_col_pass``) and
    ``col_segments`` cuts its column-block runs as ``segments`` cuts the
    row-block runs (``seg_rb`` there holds the column block). The flash
    backward K5 walks them. It reads the tiles as they are: the transposed
    tile set (``bsr_transpose``) would double the tile memory and cannot
    be built from packed tiles."""

    tiles: torch.Tensor
    tile_rb: torch.Tensor  # int32[T]
    tile_cb: torch.Tensor  # int32[T]
    n_rows: int
    n_cols: int
    tb: int
    segments: RunSegments
    col_perm: torch.Tensor  # int32[T]
    col_segments: RunSegments

    @property
    def num_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def n_row_tiles(self) -> int:
        return _round_up(self.n_rows, self.tb) // self.tb

    @property
    def packed(self) -> bool:
        return self.tiles.shape[-1] != self.tb

    def to(self, device) -> "BSRMatrix":
        return dataclasses.replace(
            self, tiles=self.tiles.to(device), tile_rb=self.tile_rb.to(device),
            tile_cb=self.tile_cb.to(device), segments=self.segments.to(device),
            col_perm=self.col_perm.to(device),
            col_segments=self.col_segments.to(device),
        )


def _schedules(tile_rb: np.ndarray, tile_cb: np.ndarray, n_rows: int, n_cols: int,
               tb: int, device) -> dict:
    """The row-run and column-run launch schedules of a (rb, cb)-sorted
    tile set (host)."""
    col_perm = np.argsort(tile_cb, kind="stable")
    return dict(
        segments=run_segments(tile_rb, _round_up(n_rows, tb) // tb, device),
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
    uniq = np.unique(key)
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


def _bsr(tiles, uniq, A: SparseMatrix, tb: int, device) -> BSRMatrix:
    tile_rb = (uniq >> 32).astype(np.int32)
    tile_cb = (uniq & 0xFFFFFFFF).astype(np.int32)
    if len(uniq) == 0:
        tile_rb = np.zeros(1, np.int32)
        tile_cb = np.zeros(1, np.int32)
    return BSRMatrix(
        tiles=tiles.to(device),
        tile_rb=_tensor(tile_rb, device),
        tile_cb=_tensor(tile_cb, device),
        n_rows=A.n_rows, n_cols=A.n_cols, tb=tb,
        **_schedules(tile_rb, tile_cb, A.n_rows, A.n_cols, tb, device),
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
    if len(v):
        # duplicate-safe scatter in bounded f32 batches of tiles
        inv = np.searchsorted(uniq, key)
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
    return _bsr(tiles, uniq, A, tb, device)


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
    if len(r):
        inv = np.searchsorted(uniq, (r // tb) << 32 | (c // tb))
        lc = c % tb
        np.bitwise_or.at(
            packed, (inv, r % tb, lc % nb),
            (np.uint8(1) << (lc // nb).astype(np.uint8)),
        )
    return _bsr(torch.from_numpy(packed), uniq, A, tb, device)


def unpack_mask01_tile(t: torch.Tensor, tb: int, dtype=torch.float32) -> torch.Tensor:
    """Packed mask tiles [..., tb, tb/8] -> {0,1} [..., tb, tb] in ``dtype``
    (the eight bit planes concatenated along the columns)."""
    ti = t.to(torch.int32) & 0xFF
    return torch.cat([(ti >> j) & 1 for j in range(8)], dim=-1).to(dtype)


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
        **_schedules(_np(tile_rb), _np(tile_cb), B.n_cols, B.n_rows, B.tb, B.tiles.device),
    )


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


_TILE_MODES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


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


def bsr_spmm(B: BSRMatrix, H: torch.Tensor) -> torch.Tensor:
    """K1: out = A @ H over the tiles of ``B``, f32 [n_rows, P] (bf16
    operands, f32 accumulation). A CPU tensor runs ``bsr_spmm_plain``; a
    CUDA tensor launches ``csrc/bsr_spmm.cu`` or raises."""
    if H.device.type == "cpu":
        return bsr_spmm_plain(B, H)
    if H.device.type != "cuda":
        raise ValueError(f"bsr_spmm runs on cpu or cuda, not {H.device}")
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
    return out


bsr_spmm.launches = 0


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


def bsr_spmm_int8(B: BSRMatrix, Hq: torch.Tensor) -> torch.Tensor:
    """K7: the exact int32 ``Aq @ Hq`` over shifted-int8 value tiles
    (the 0..255 grid stored minus 128; absent positions and cover tiles
    hold -128). ``Hq`` is signed int8 [N, P], rows past N read as zero; any
    P runs (the kernel guards the feature dimension, nothing is padded).
    Returns int32 [n_rt * tb, P]. A CPU tensor runs
    ``bsr_spmm_int8_plain``; a CUDA tensor launches
    ``csrc/bsr_spmm_int8.cu`` or raises."""
    if Hq.device.type == "cpu":
        return bsr_spmm_int8_plain(B, Hq)
    if Hq.device.type != "cuda":
        raise ValueError(f"bsr_spmm_int8 runs on cpu or cuda, not {Hq.device}")
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
    return out


bsr_spmm_int8.launches = 0
