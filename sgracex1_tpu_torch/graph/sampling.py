"""Neighbor-sampled subgraph batches, as ``sgracex1_tpu.graph.sampling``.

The reference trains Amazon Photo/Computers through PyG's NeighborLoader
(``demo_sgrace.py:112-125``): batches of seed nodes, a fixed fanout of
sampled neighbors per hop, and the full model on each sampled subgraph
with the loss on the seeds only. The sampler draws the same numpy stream
in the same order as the JAX package's (``rng.permutation`` of the seeds,
then one ``rng.choice(..., replace=False)`` for each node with more
in-neighbours than the fanout), so one ``default_rng(seed)`` gives the
identical batches in both packages. Batches of an epoch share one node
and one edge padding; the pad floors carry them over to later epochs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sgracex1_tpu_torch.graph.csr import SparseMatrix, _round_up
from sgracex1_tpu_torch.graph.normalize import sym_norm_edges


@dataclasses.dataclass(frozen=True)
class SampledBatch:
    """One sampled subgraph, padded.

    ``A`` is the sym-normalized subgraph adjacency over the padded local
    node space; ``x`` / ``y`` the gathered features and labels;
    ``seed_mask`` marks the rows whose predictions count (seeds come
    first)."""

    A: SparseMatrix
    x: np.ndarray  # [n_pad, F]
    y: np.ndarray  # int[n_pad]
    seed_mask: np.ndarray  # bool[n_pad]
    node_ids: np.ndarray  # int[n_pad], global ids (padding -> 0)


class NeighborSampler:
    """Uniform per-hop neighbor sampling on a host CSR.

    ``sample(seeds, fanouts, rng)`` walks ``len(fanouts)`` hops out from
    the seeds, keeping at most ``fanouts[k]`` sampled in-neighbours per
    node per hop (aggregation pulls from neighbours), and returns the
    edges among the kept nodes with the seeds numbered first."""

    def __init__(self, edge_index: np.ndarray, num_nodes: int):
        edge_index = np.asarray(edge_index, dtype=np.int64)
        self.num_nodes = num_nodes
        # CSR over destination rows: for node i, its in-neighbours
        order = np.argsort(edge_index[0], kind="stable")
        self.dst = edge_index[0][order]
        self.src = edge_index[1][order]
        counts = np.bincount(self.dst, minlength=num_nodes)
        self.rowptr = np.concatenate([[0], np.cumsum(counts)])

    def _neighbors(self, v: int) -> np.ndarray:
        return self.src[self.rowptr[v] : self.rowptr[v + 1]]

    def sample(
        self,
        seeds: np.ndarray,
        fanouts: Sequence[int],
        rng: np.random.Generator,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(sub_edge_index [2, E'] in local ids, node_ids) with
        ``node_ids[:len(seeds)] == seeds``."""
        seeds = np.asarray(seeds, dtype=np.int64)
        local = {int(v): i for i, v in enumerate(seeds)}
        node_ids = list(seeds)
        frontier = list(seeds)
        rows, cols = [], []
        for fanout in fanouts:
            nxt = []
            for v in frontier:
                nbrs = self._neighbors(v)
                if len(nbrs) > fanout:
                    nbrs = rng.choice(nbrs, size=fanout, replace=False)
                for u in nbrs:
                    u = int(u)
                    if u not in local:
                        local[u] = len(node_ids)
                        node_ids.append(u)
                        nxt.append(u)
                    rows.append(local[int(v)])
                    cols.append(local[u])
            frontier = nxt
        ei = np.array([rows, cols], dtype=np.int64).reshape(2, -1)
        return ei, np.asarray(node_ids, dtype=np.int64)


def make_neighbor_batches(
    edge_index: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    train_nodes: np.ndarray,
    *,
    batch_size: int,
    fanouts: Sequence[int] = (10, 10),
    rng: Optional[np.random.Generator] = None,
    pad_to: int = 128,
    n_pad: int = 0,
    e_pad: int = 0,
) -> List[SampledBatch]:
    """One epoch of NeighborLoader-style batches over ``train_nodes``.

    ``n_pad`` / ``e_pad`` are pad floors, so later epochs keep the shapes
    of the first; they grow if a later epoch samples a bigger batch."""
    rng = rng or np.random.default_rng(0)
    sampler = NeighborSampler(edge_index, x.shape[0])

    seeds_perm = rng.permutation(np.asarray(train_nodes))
    chunks = [seeds_perm[i : i + batch_size] for i in range(0, len(seeds_perm), batch_size)]
    raw = [sampler.sample(c, fanouts, rng) for c in chunks]

    n_pad = max(n_pad, _round_up(max(len(ids) for _, ids in raw), pad_to))
    e_pad = max(e_pad, _round_up(max(ei.shape[1] + n_pad for ei, _ in raw), pad_to))

    batches = []
    for (ei, ids), seeds in zip(raw, chunks):
        k = len(ids)
        ei_n, ew = sym_norm_edges(ei, k)
        A = (
            SparseMatrix.from_coo(ei_n[0], ei_n[1], ew, (n_pad, n_pad), pad_to=pad_to, sort=False)
            .pad_edges_to(e_pad)
            .with_uniform_nnz()
        )
        xb = np.zeros((n_pad,) + x.shape[1:], x.dtype)
        xb[:k] = x[ids]
        yb = np.zeros(n_pad, np.int32)
        yb[:k] = y[ids]
        sm = np.zeros(n_pad, bool)
        sm[: len(seeds)] = True
        idb = np.zeros(n_pad, np.int64)
        idb[:k] = ids
        batches.append(SampledBatch(A=A, x=xb, y=yb, seed_mask=sm, node_ids=idb))
    return batches
