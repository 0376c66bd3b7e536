"""Graph batching for graph-level tasks (the block-diagonal batch), as
``sgracex1_tpu.graph.batch``.

The molecule notebook batches MUTAG graphs block-diagonally, with a graph
id per node for ``global_mean_pool``. Every batch of a dataset is padded
to the same node and edge counts: padding nodes have no edges and zero
features and belong to a spare graph slot whose label mask is False.
The arrays stay numpy on the host; the training loop moves them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.graph.normalize import sym_norm_edges


@dataclasses.dataclass(frozen=True)
class GraphSample:
    """One graph: COO edge_index [2, E], node features [n, F], int label."""

    edge_index: np.ndarray
    x: np.ndarray
    y: int

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A padded block-diagonal batch of graphs."""

    A: SparseMatrix  # [n_pad, n_pad] normalized block-diagonal adjacency
    x: np.ndarray  # [n_pad, F]
    graph_ids: np.ndarray  # int32[n_pad]; padding nodes map to num_graphs - 1
    y: np.ndarray  # int32[g_pad]
    label_mask: np.ndarray  # bool[g_pad]; False for the padding slot
    num_graphs: int


def batch_graphs(
    graphs: Sequence[GraphSample],
    *,
    n_pad: int,
    g_pad: int,
    normalize: bool = True,
    pad_to: int = 128,
) -> GraphBatch:
    """Assemble graphs into one padded block-diagonal batch."""
    if len(graphs) >= g_pad:
        raise ValueError("need one spare graph slot for padding nodes")
    F = graphs[0].x.shape[1]
    x = np.zeros((n_pad, F), dtype=np.float32)
    gid = np.full(n_pad, g_pad - 1, dtype=np.int32)
    y = np.zeros(g_pad, dtype=np.int32)
    mask = np.zeros(g_pad, dtype=bool)

    rows, cols, offset = [], [], 0
    for i, g in enumerate(graphs):
        n = g.num_nodes
        if offset + n > n_pad:
            raise ValueError("batch exceeds n_pad")
        x[offset : offset + n] = g.x
        gid[offset : offset + n] = i
        y[i] = g.y
        mask[i] = True
        rows.append(g.edge_index[0] + offset)
        cols.append(g.edge_index[1] + offset)
        offset += n

    edge_index = np.stack([np.concatenate(rows), np.concatenate(cols)]).astype(np.int64)

    if normalize:
        # self-loops for the real nodes only: sym_norm over the occupied
        # prefix, embedded in the padded index space
        ei, ew = sym_norm_edges(edge_index, offset)
        A = SparseMatrix.from_coo(ei[0], ei[1], ew, (n_pad, n_pad), pad_to=pad_to, sort=False)
    else:
        A = SparseMatrix.from_coo(
            edge_index[0], edge_index[1], np.ones(edge_index.shape[1], np.float32),
            (n_pad, n_pad), pad_to=pad_to,
        )
    return GraphBatch(A=A, x=x, graph_ids=gid, y=y, label_mask=mask, num_graphs=g_pad)


def make_batches(
    graphs: Sequence[GraphSample],
    batch_size: int,
    *,
    rng: Optional[np.random.Generator] = None,
    pad_to: int = 128,
) -> List[GraphBatch]:
    """Split a dataset into batches of one shape (shuffled if ``rng`` is
    given): one node padding, ``batch_size + 1`` graph slots, and one edge
    padding with ``nnz == e_pad`` (the JAX package keeps one compiled
    program that way; the arrays are the same here)."""
    idx = np.arange(len(graphs))
    if rng is not None:
        rng.shuffle(idx)
    chunks = [idx[i : i + batch_size] for i in range(0, len(idx), batch_size)]
    max_nodes = max(sum(graphs[i].num_nodes for i in c) for c in chunks)
    n_pad = ((max_nodes + pad_to - 1) // pad_to) * pad_to
    g_pad = batch_size + 1
    batches = [
        batch_graphs([graphs[i] for i in c], n_pad=n_pad, g_pad=g_pad, pad_to=pad_to)
        for c in chunks
    ]
    e_pad = max(b.A.e_pad for b in batches)
    return [
        dataclasses.replace(b, A=b.A.pad_edges_to(e_pad).with_uniform_nnz())
        for b in batches
    ]
