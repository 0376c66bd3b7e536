"""Each shard's local block on the fused one-pass kernel K2, as
``sgracex1_tpu.parallel.halo_fused``: the single-device hybrid treatment
per shard (dense tiles plus remainder chunks; {0,1} mask tiles under the
rank-1 factorization, whose global form restricted to a shard's rows and
columns is exact for its local block), forward and on the transposed
plan. The boundary edges keep the halo all_to_all and the edge path of
``parallel/halo``.

The JAX package stacks the shards' plans into padded ``[S, ...]`` arrays
for ``shard_map``. Here each shard keeps its own prep (its fused plan
pair: the rows of the JAX stack for that shard, with their ring
schedules), made by the single-device ``prepare_adjacency`` with the
sliced global factors as ``rank1_factors``. The tile size is the JAX
package's choice (``_choose_shard_tb``: the single-device model's hybrid
price summed over every shard's tile population, on ``ops/dispatch``'s
``CostTable``), the split threshold the same model's at that size, the
chunk width ``ops/fused_agg.DEFAULT_K``.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from sgracex1_tpu_torch.graph.csr import SparseMatrix, _np
from sgracex1_tpu_torch.graph.normalize import rank1_factor
from sgracex1_tpu_torch.ops import dispatch as D
from sgracex1_tpu_torch.ops.fused_gnn import relu_hw
from sgracex1_tpu_torch.ops.spmm import spmm
from sgracex1_tpu_torch.parallel.halo import HaloGraph, _exchange
from sgracex1_tpu_torch.parallel.mesh import Mesh


def _choose_shard_tb(A_ls, rank1: bool, tbs=None, costs: D.CostTable = D.H100_COSTS) -> int:
    """Tile size of the shards' local blocks (JAX ``_choose_shard_tb``):
    the hybrid kind's price at each candidate (its dense tiles, chunks and
    slots at the model's threshold) summed over every shard's tile
    population. A shard's block has S-fold fewer rows than the graph, so
    the best size is often smaller than the single-device choice."""
    tbs = costs.shard_tbs if tbs is None else tuple(tbs)
    tots = {tb: 0.0 for tb in tbs}
    for A_l in A_ls:
        r, c = D._edge_keys(A_l)
        pops = D._tile_populations(r, c, tbs)
        for tb in tbs:
            uniq, counts = pops[tb]
            if len(counts) == 0:
                continue
            tc = D._tile_cost_s(tb, D._tile_itemsize(tb, rank1, 2, costs), costs)
            thresh = int(np.ceil(tc / D._rest_slot_cost_s(tb, costs)))
            dense = counts >= thresh
            rest_by_rb = np.bincount(
                (uniq >> 32)[~dense].astype(np.int64), weights=counts[~dense].astype(np.float64),
            )
            tots[tb] += (
                int(dense.sum()) * tc
                + np.ceil(rest_by_rb / costs.rest_k).sum() * D._chunk_cost_s(tb, costs)
                + counts[~dense].sum() * costs.rest_slot_s
            )
    return min(tots, key=tots.get)


@dataclasses.dataclass(frozen=True)
class HaloFusedPlan:
    """Each shard's local block prepared as the ``hybrid`` kind, one common
    tile mode (all masks with rank-1 scalings, or all value tiles):
    ``preps[s].fused`` its fused plan, ``preps[s].fused_t`` its transpose's."""

    preps: List[D.PreparedAdjacency]
    tb: int
    n_local: int

    @property
    def K(self) -> int:
        return self.preps[0].fused.K

    @property
    def rank1(self) -> bool:
        return self.preps[0].r1_row is not None


def build_halo_fused(
    G: HaloGraph, *, tb="auto", rank1_factors=None, threads: Optional[int] = None,
    costs: D.CostTable = D.H100_COSTS,
) -> HaloFusedPlan:
    """Per-shard fused plans of the local blocks of ``G``, on ``G``'s
    device: each block through ``prepare_adjacency(method="hybrid")``.

    ``rank1_factors``: the GLOBAL ``(s_row, s_col)`` of
    ``graph/normalize.rank1_factor`` on the whole adjacency, sliced per
    shard here and handed to each prepare. Without them each shard's block
    is factored on its own, and one common mode is forced: a shard without
    a factorization turns every shard to value tiles (mask tiles beside
    value tiles would corrupt the mask shards' output).

    ``tb="auto"`` takes ``_choose_shard_tb`` on ``costs``; the threshold
    is the model's at that size (the prepare's, on ``costs``) and the chunk
    width ``DEFAULT_K``. The S prepares run on ``threads`` threads
    (default min(S, 8); numpy's sorts release the interpreter lock in
    stretches)."""
    S, n_local = G.n_shards, G.n_local
    device = G.send_idx.device
    A_ls, facs = [], []
    for s in range(S):
        r = _np(G.rows_loc[s])
        c = _np(G.cols_loc[s])
        v = _np(G.vals_loc[s]).astype(np.float32)
        keep = v != 0  # padding slots and fill-0 loops add nothing
        A_l = SparseMatrix.from_coo(r[keep], c[keep], v[keep], (n_local, n_local))
        A_ls.append(A_l)
        if rank1_factors is not None:
            sl = slice(s * n_local, (s + 1) * n_local)
            rr = np.ones(n_local, np.float32)
            cc = np.ones(n_local, np.float32)
            src = np.asarray(rank1_factors[0], np.float32)[sl]
            dst = np.asarray(rank1_factors[1], np.float32)[sl]
            rr[: len(src)] = src
            cc[: len(dst)] = dst
            facs.append((rr, cc))
        else:
            facs.append(rank1_factor(A_l))
    if any(f is None for f in facs):
        facs = [None] * S  # one mode for every shard: value tiles
    if tb == "auto":
        tb = _choose_shard_tb(A_ls, facs[0] is not None, costs=costs)
    threads = min(S, 8) if threads is None else threads
    prep = lambda af: D.prepare_adjacency(af[0], method="hybrid", tb=tb, rank1=False, rank1_factors=af[1],
                                        costs=costs, device=device)
    with cf.ThreadPoolExecutor(max_workers=max(threads, 1)) as ex:
        preps = list(ex.map(prep, zip(A_ls, facs)))
    return HaloFusedPlan(preps=preps, tb=tb, n_local=n_local)


def dist_spmm_halo_fused(mesh: Mesh, G: HaloGraph, FP: HaloFusedPlan, H: torch.Tensor) -> torch.Tensor:
    """out = A @ H: each shard's local block on K2 (``agg_matmul`` of its
    prep; its gradient K2 on the shard's transposed plan), the boundary
    edges through the all_to_all and the edge path. K2 writes bf16, cast
    back to H's dtype."""
    Hs = mesh.split(H)
    outs = []
    for s, H_l, halo in zip(mesh.local_shards, Hs, _exchange(mesh, G, Hs)):
        outs.append(D.agg_matmul(FP.preps[s], H_l) + spmm(G.remote_edges(s), halo))
    return mesh.concat(outs)


def dist_gnn_layer_halo_fused(
    mesh: Mesh, G: HaloGraph, FP: HaloFusedPlan, x: torch.Tensor, W: torch.Tensor, *,
    relu: bool = False,
) -> torch.Tensor:
    """GCN layer ReLU?(A @ (x @ W)), the local blocks on K2."""
    out = dist_spmm_halo_fused(mesh, G, FP, torch.matmul(x, mesh.replicated(W)))
    return relu_hw(out) if relu else out
