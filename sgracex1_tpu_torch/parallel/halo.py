"""Halo (boundary) exchange for row-partitioned graphs, as
``sgracex1_tpu.parallel.halo``.

Instead of replicating the whole hidden matrix (``spmm_dist``), each shard
receives only the rows its remote edges read: ``build_halo`` lists, per
(owner, reader) shard pair, the owner-local rows to ship; one
``all_to_all`` ships them; local and remote edges aggregate apart.

- shard s owns rows [s*n_local, (s+1)*n_local); its edges split into local
  (column owned by s) and remote;
- ``send_idx[t, s, :]`` holds the owner-local rows shard t ships to shard
  s, padded with 0 (an unread slot);
- a remote edge's column is relabeled to its halo slot ``t*L + l``: row l
  of the block from owner t.

The local block runs on a tile kernel in ``dist_spmm_halo_bsr`` (K1,
forward and on the shard's transposed tiles) and ``dist_gat_layer_halo_flash``
(K3 forward, K4/K5 backward: ``ops/flash_gat.flash_gat_halo_agg``), on the
edge list in ``dist_spmm_halo`` and ``dist_gat_layer_halo``. The remote
edges always take the edge path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from sgracex1_tpu_torch._device import resolve_device
from sgracex1_tpu_torch.graph.csr import SparseMatrix, _np, _round_up
from sgracex1_tpu_torch.ops import flash_gat as FG
from sgracex1_tpu_torch.ops.bsr import bsr_bitmask_from_sparse, bsr_from_sparse, bsr_mask_from_sparse
from sgracex1_tpu_torch.ops.dispatch import PreparedAdjacency, _packs, agg_matmul
from sgracex1_tpu_torch.ops.fused_gnn import relu_hw
from sgracex1_tpu_torch.ops.sddmm import edge_softmax
from sgracex1_tpu_torch.ops.spmm import spmm
from sgracex1_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class HaloGraph:
    """Row-partitioned graph with its boundary-exchange plan: shard-major
    edge tensors [S, E] and ``send_idx`` [S (owner), S (reader), L]."""

    rows_loc: torch.Tensor  # int32[S, E_loc] local-edge destination (shard-local)
    cols_loc: torch.Tensor  # int32[S, E_loc] local-edge source (shard-local)
    vals_loc: torch.Tensor  # float[S, E_loc]
    rows_rem: torch.Tensor  # int32[S, E_rem] remote-edge destination (shard-local)
    cols_halo: torch.Tensor  # int32[S, E_rem] slot of the halo buffer
    vals_rem: torch.Tensor  # float[S, E_rem]
    send_idx: torch.Tensor  # int32[S, S, L] owner-local rows to ship
    n_shards: int
    n_local: int
    n_pad: int

    @property
    def halo_len(self) -> int:
        return self.send_idx.shape[2]

    def local_edges(self, s: int) -> SparseMatrix:
        """Shard s's local edges: [n_local, n_local], shard-local columns."""
        return _edges_of(self.rows_loc[s], self.cols_loc[s], self.vals_loc[s], (self.n_local, self.n_local))

    def remote_edges(self, s: int) -> SparseMatrix:
        """Shard s's remote edges: [n_local, S*L], columns the halo slots."""
        return _edges_of(self.rows_rem[s], self.cols_halo[s], self.vals_rem[s],
                         (self.n_local, self.n_shards * self.halo_len))


def _edges_of(rows, cols, vals, shape) -> SparseMatrix:
    """A shard's padded edge tensors as a SparseMatrix (padding: value 0)."""
    return SparseMatrix(rows=rows, cols=cols, vals=vals, shape=shape, nnz=vals.shape[0])


def _grouped_fill(dst_rows, values_list, group, n_groups):
    """Scatter per-group value streams into padded [n_groups, E] arrays;
    ``group`` must be sorted. Returns the per-group counts."""
    counts = np.bincount(group, minlength=n_groups)
    start = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(group)) - start[group]
    for dst, val in zip(dst_rows, values_list):
        dst[group, pos] = val
    return counts


def build_halo(
    A: SparseMatrix, n_shards: int, *, pad_to: int = 128, device=None
) -> Tuple[HaloGraph, int]:
    """Partition the rows of ``A`` and build the boundary-exchange plan on
    the host (one lexsort and one unique over the remote edges):
    ``(halo graph, n_pad)``, the tensors on ``device`` (the CUDA card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    N = A.n_rows
    n_pad = _round_up(N, n_shards * 8)
    n_local = n_pad // n_shards
    S = n_shards

    r = _np(A.rows)[: A.nnz].astype(np.int64)
    c = _np(A.cols)[: A.nnz].astype(np.int64)
    v = _np(A.vals)[: A.nnz]
    s_of_r = r // n_local
    s_of_c = c // n_local
    local_m = s_of_r == s_of_c

    # send lists: unique (reader, owner, col) over the remote edges
    rr, cc, vv = r[~local_m], c[~local_m], v[~local_m]
    readers, owners = s_of_r[~local_m], s_of_c[~local_m]
    pair = readers * S + owners
    uk, inv = np.unique(pair * n_pad + cc, return_inverse=True)
    pair_u = uk // n_pad
    col_u = uk % n_pad
    owner_u = pair_u % S
    reader_u = pair_u // S
    cnt_pair = np.bincount(pair_u, minlength=S * S)
    L = max(_round_up(int(cnt_pair.max(initial=0)), 8), 8)
    start_pair = np.concatenate([[0], np.cumsum(cnt_pair)])
    pos_u = np.arange(len(uk)) - start_pair[pair_u]  # slot within (reader, owner)
    send_idx = np.zeros((S, S, L), np.int32)
    send_idx.reshape(-1)[(owner_u * S + reader_u) * L + pos_u] = col_u - owner_u * n_local

    # remote edges grouped by reader shard (stable in pair order)
    order = np.argsort(readers, kind="stable")
    halo_slot = (owners * L)[order] + pos_u[inv][order]
    e_rem = max(_round_up(int(np.bincount(readers, minlength=S).max(initial=1)), pad_to), pad_to)
    rows_rem = np.zeros((S, e_rem), np.int32)
    cols_halo = np.zeros((S, e_rem), np.int32)
    vals_rem = np.zeros((S, e_rem), v.dtype)
    _grouped_fill(
        (rows_rem, cols_halo, vals_rem),
        ((rr - readers * n_local)[order], halo_slot, vv[order]),
        readers[order], S,
    )

    # local edges grouped by shard
    rl, cl, vl = r[local_m], c[local_m], v[local_m]
    sl = s_of_r[local_m]
    order = np.argsort(sl, kind="stable")
    e_loc = max(_round_up(int(np.bincount(sl, minlength=S).max(initial=1)), pad_to), pad_to)
    rows_loc = np.zeros((S, e_loc), np.int32)
    cols_loc = np.zeros((S, e_loc), np.int32)
    vals_loc = np.zeros((S, e_loc), v.dtype)
    _grouped_fill(
        (rows_loc, cols_loc, vals_loc),
        ((rl - sl * n_local)[order], (cl - sl * n_local)[order], vl[order]),
        sl[order], S,
    )
    t = lambda a: torch.from_numpy(a).to(device)
    return HaloGraph(
        rows_loc=t(rows_loc), cols_loc=t(cols_loc), vals_loc=t(vals_loc),
        rows_rem=t(rows_rem), cols_halo=t(cols_halo), vals_rem=t(vals_rem),
        send_idx=t(send_idx), n_shards=n_shards, n_local=n_local, n_pad=n_pad,
    ), n_pad


@dataclasses.dataclass(frozen=True)
class HaloBSRPlan:
    """Each shard's local block prepared as the ``bsr`` kind: ``preps[s].bsr``
    its tiles, ``preps[s].bsr_t`` those of its transpose (built from the
    transposed edges) -- the JAX plan's rows of shard s, without the zero
    tiles that pad every shard to one count."""

    preps: List[PreparedAdjacency]
    tb: int


def build_halo_bsr(
    G: HaloGraph, *, tb: int = 256, dtype=torch.bfloat16, mask: bool = False
) -> HaloBSRPlan:
    """Densify each shard's local block into BSR tiles, forward and
    transposed, on ``G``'s device. Every row block holds a tile: a block
    whose rows have no local edge gets an explicit zero tile at column
    block 0 (the flash stats merge reads it as "no local edge": m at the
    running-max start, l = 0). ``mask`` builds int8 {0,1} edge tiles,
    1-bit packed at tb % 1024 == 0: all the flash GAT layer reads of the
    adjacency. GCN aggregation needs the values: ``dtype`` tiles."""
    device = G.send_idx.device
    n_local = G.n_local
    if mask:
        build = bsr_bitmask_from_sparse if _packs(tb) else bsr_mask_from_sparse
    else:
        build = lambda M, **kw: bsr_from_sparse(M, dtype=dtype, **kw)
    preps = []
    for s in range(G.n_shards):
        r = _np(G.rows_loc[s])
        c = _np(G.cols_loc[s])
        v = _np(G.vals_loc[s]).astype(np.float32)
        B, Bt = (build(SparseMatrix.from_coo(rr, cc, v, (n_local, n_local)), tb=tb, cover_rows=True, device=device)
                 for rr, cc in ((r, c), (c, r)))
        preps.append(PreparedAdjacency(A=G.local_edges(s), kind="bsr", bsr=B, bsr_t=Bt))
    return HaloBSRPlan(preps=preps, tb=tb)


def _exchange(mesh: Mesh, G: HaloGraph, Hs: List[torch.Tensor], exchange: bool = True):
    """Each local shard's [S*L, F] halo buffer: slot t*L + l holds row
    ``send_idx[t, s, l]`` of owner t. ``exchange=False`` keeps each shard's
    own send buffer (the benchmark ablation: same shapes, wrong values)."""
    sends = [
        H_l.index_select(0, G.send_idx[s].reshape(-1)).view(G.n_shards, G.halo_len, H_l.shape[1])
        for s, H_l in zip(mesh.local_shards, Hs)
    ]
    halos = mesh.all_to_all(sends) if exchange else sends
    return [h.reshape(-1, h.shape[-1]) for h in halos]


def dist_spmm_halo(mesh: Mesh, G: HaloGraph, H: torch.Tensor, *, exchange: bool = True) -> torch.Tensor:
    """out = A @ H with the boundary-only exchange, H row-sharded.

    ``exchange=False`` is a benchmark ablation: the all_to_all is replaced
    by the local send buffer (same shapes and local compute, wrong values),
    so ``t_full - t_no_exchange`` isolates the collective's cost."""
    Hs = mesh.split(H)
    outs = []
    for s, H_l, halo in zip(mesh.local_shards, Hs, _exchange(mesh, G, Hs, exchange)):
        outs.append(spmm(G.local_edges(s), H_l) + spmm(G.remote_edges(s), halo))
    return mesh.concat(outs)


def dist_gnn_layer_halo(
    mesh: Mesh, G: HaloGraph, x: torch.Tensor, W: torch.Tensor, *, relu: bool = False,
    exchange: bool = True,
) -> torch.Tensor:
    """GCN layer ReLU?(A @ (x @ W)) with the halo exchange of x @ W
    (``exchange=False``: the ablation of ``dist_spmm_halo``)."""
    out = dist_spmm_halo(mesh, G, torch.matmul(x, mesh.replicated(W)), exchange=exchange)
    return relu_hw(out) if relu else out


def dist_spmm_halo_bsr(mesh: Mesh, G: HaloGraph, BP: HaloBSRPlan, H: torch.Tensor) -> torch.Tensor:
    """out = A @ H: each shard's local block on K1 (``agg_matmul`` of its
    ``bsr`` prep; its gradient K1 on the shard's transposed tiles), the
    boundary edges through the all_to_all and the edge path."""
    Hs = mesh.split(H)
    outs = []
    for s, H_l, halo in zip(mesh.local_shards, Hs, _exchange(mesh, G, Hs)):
        outs.append(agg_matmul(BP.preps[s], H_l) + spmm(G.remote_edges(s), halo))
    return mesh.concat(outs)


def dist_gnn_layer_halo_bsr(
    mesh: Mesh, G: HaloGraph, BP: HaloBSRPlan, x: torch.Tensor, W: torch.Tensor, *,
    relu: bool = False,
) -> torch.Tensor:
    """GCN layer ReLU?(A @ (x @ W)), the local blocks on K1."""
    out = dist_spmm_halo_bsr(mesh, G, BP, torch.matmul(x, mesh.replicated(W)))
    return relu_hw(out) if relu else out


def _head_agg(A: SparseMatrix, W: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    """out[r] = sum over A's edges (r, c) of att[e] * W[c], per head (W
    [n, H, F], att [E, H])."""
    msg = W.index_select(0, A.cols) * att[..., None]
    return msg.new_zeros((A.n_rows, *W.shape[1:])).index_add(0, A.rows, msg)


def _heads(H_l, halo, a, nheads: int):
    """Per-head scores of a shard, all heads batched ([n, H] each), from
    the hidden rows with their gradient stopped: (s1, s2, s2h)."""
    FH = H_l.shape[1]
    F = FH // nheads
    Hsg = H_l.detach().view(-1, nheads, F)
    halo_sg = halo.detach().view(-1, nheads, F)
    a_src, a_dst = a[:FH].view(nheads, F), a[FH:].view(nheads, F)
    return tuple(
        torch.einsum("nhf,hf->nh", h, a_).contiguous()  # the kernels read them as [n, H] rows
        for h, a_ in ((Hsg, a_src), (Hsg, a_dst), (halo_sg, a_dst))
    )


def dist_gat_layer_halo_flash(
    mesh: Mesh, G: HaloGraph, BP: HaloBSRPlan, x: torch.Tensor, W: torch.Tensor,
    attention: torch.Tensor, *, alpha: float = 0.2, relu: bool = False, nheads: int = 1,
) -> torch.Tensor:
    """GAT layer with each shard's local block on the flash kernels (K3
    forward, K4/K5 backward; every head in one launch a pass) and its
    remote edges merged through the softmax stats
    (``ops/flash_gat.flash_gat_halo_agg``). ``BP`` holds the local tiles
    (``build_halo_bsr``, mask or value tiles; ``> 0`` is the mask).
    Gradient semantics of ``dist_gat_layer_halo``: the scores read the
    hidden rows with their gradient stopped; the aggregation
    differentiates through the kernels, the halo edges and the
    all_to_all."""
    FH = W.shape[1]
    if FH % nheads:
        raise ValueError(f"W's {FH} columns do not split into {nheads} heads")
    F = FH // nheads
    a = mesh.replicated(attention.reshape(-1))
    Hs = mesh.split(torch.matmul(x, mesh.replicated(W)))
    outs = []
    for s, H_l, halo in zip(mesh.local_shards, Hs, _exchange(mesh, G, Hs)):
        s1, s2, s2h = _heads(H_l, halo, a, nheads)
        out = FG.flash_gat_halo_agg(
            BP.preps[s].flash_tiles, s1, s2, s2h, H_l.view(-1, nheads, F), halo.view(-1, nheads, F),
            G.rows_rem[s], G.cols_halo[s], G.vals_rem[s] > 0, alpha,
        )
        outs.append(out.reshape(-1, FH))
    out = mesh.concat(outs)
    return relu_hw(out) if relu else out


def dist_gat_layer_halo(
    mesh: Mesh, G: HaloGraph, x: torch.Tensor, W: torch.Tensor, attention: torch.Tensor, *,
    alpha: float = 0.2, relu: bool = False, nheads: int = 1,
) -> torch.Tensor:
    """Multi-head GAT layer with the boundary-only exchange, on the edge
    list. A row's edges (and its softmax) lie in one shard; the scores of
    remote columns read the received halo rows. One exchange serves every
    head. ``W`` [F_in, F*H], ``attention`` [2*F*H, 1]; output [rows, F*H]
    (heads concatenated). The scores read the hidden rows with their
    gradient stopped (the reference's backward approximation)."""
    FH = W.shape[1]
    if FH % nheads:
        raise ValueError(f"W's {FH} columns do not split into {nheads} heads")
    F = FH // nheads
    a = mesh.replicated(attention.reshape(-1))
    Hs = mesh.split(torch.matmul(x, mesh.replicated(W)))
    outs = []
    for s, H_l, halo in zip(mesh.local_shards, Hs, _exchange(mesh, G, Hs)):
        loc, rem = G.local_edges(s), G.remote_edges(s)
        s1, s2, s2h = _heads(H_l, halo, a, nheads)
        e = torch.cat([
            s1.index_select(0, loc.rows) + s2.index_select(0, loc.cols),
            s1.index_select(0, rem.rows) + s2h.index_select(0, rem.cols),
        ])
        # local and remote edges share each row's softmax (columns unread)
        both = _edges_of(*(torch.cat([getattr(loc, f), getattr(rem, f)]) for f in ("rows", "cols", "vals")),
                         loc.shape)
        att = edge_softmax(both, torch.where(e > 0, e, alpha * e))
        n_loc = loc.nnz
        out = _head_agg(loc, H_l.view(-1, nheads, F), att[:n_loc]) + _head_agg(rem, halo.view(-1, nheads, F),
                                                                               att[n_loc:])
        outs.append(out.reshape(-1, FH))
    out = mesh.concat(outs)
    return relu_hw(out) if relu else out
