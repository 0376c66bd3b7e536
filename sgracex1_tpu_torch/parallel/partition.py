"""1-D row partition of a graph, as ``sgracex1_tpu.parallel.partition``.

Node i belongs to shard i // n_local with ``n_pad`` the node count rounded
up to a multiple of ``8 * n_shards``. Each shard owns the edges whose
destination row it holds (so its aggregation output is local), with
shard-local rows and global columns, padded to one length. Node-wise
arrays are padded to ``n_pad`` rows with ``pad_nodes``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sgracex1_tpu_torch._device import resolve_device
from sgracex1_tpu_torch.graph.csr import SparseMatrix, _np, _round_up


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Row-partitioned adjacency, shard-major ``[S, E_s]`` tensors:
    ``rows_local`` within the shard, ``cols`` global; padding has val 0."""

    rows_local: torch.Tensor  # int32[S, E_s]
    cols: torch.Tensor  # int32[S, E_s]
    vals: torch.Tensor  # float[S, E_s]
    n_shards: int
    n_local: int
    n_pad: int

    @property
    def e_shard(self) -> int:
        return self.vals.shape[1]


def partition_graph(
    A: SparseMatrix, n_shards: int, *, pad_to: int = 128, device=None
) -> Tuple[ShardedGraph, int]:
    """Partition the rows of ``A`` into ``n_shards`` contiguous blocks:
    ``(sharded graph, n_pad)``, the arrays on ``device`` (the CUDA card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    n_pad = _round_up(A.n_rows, n_shards * 8)
    n_local = n_pad // n_shards
    r = _np(A.rows)[: A.nnz]
    c = _np(A.cols)[: A.nnz]
    v = _np(A.vals)[: A.nnz]
    shard_of = r // n_local
    counts = np.bincount(shard_of, minlength=n_shards)
    e_shard = max(_round_up(int(counts.max(initial=0)), pad_to), pad_to)
    rows_l = np.zeros((n_shards, e_shard), np.int32)
    cols = np.zeros((n_shards, e_shard), np.int32)
    vals = np.zeros((n_shards, e_shard), v.dtype)
    for s in range(n_shards):
        m = shard_of == s
        k = int(m.sum())
        rows_l[s, :k] = r[m] - s * n_local
        cols[s, :k] = c[m]
        vals[s, :k] = v[m]
    t = lambda a: torch.from_numpy(a).to(device)
    return ShardedGraph(t(rows_l), t(cols), t(vals), n_shards, n_local, n_pad), n_pad


def pad_nodes(x: np.ndarray, n_pad: int) -> np.ndarray:
    """Zero-pad a node-wise host array to ``n_pad`` rows."""
    if x.shape[0] == n_pad:
        return x
    out = np.zeros((n_pad,) + x.shape[1:], x.dtype)
    out[: x.shape[0]] = x
    return out
