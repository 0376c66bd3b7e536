"""Distributed GNN layers with a replicated hidden matrix, as
``sgracex1_tpu.parallel.spmm_dist``.

Row-parallel: ``x`` and the output are row-sharded over the mesh, ``W``
and the attention vector replicated. Each shard computes its rows of
``x @ W``, all-gathers the hidden matrix, and aggregates its own rows'
edges on the edge list (``ops/spmm``, no kernel). Autograd transposes the
all-gather into a reduce-scatter of the cotangent.
"""

from __future__ import annotations

import torch

from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.ops.fused_gnn import relu_hw
from sgracex1_tpu_torch.ops.sddmm import edge_softmax
from sgracex1_tpu_torch.ops.spmm import spmm
from sgracex1_tpu_torch.parallel.mesh import Mesh
from sgracex1_tpu_torch.parallel.partition import ShardedGraph


def _shard_edges(G: ShardedGraph, s: int) -> SparseMatrix:
    """Shard s's edges: [n_local, n_pad], shard-local rows, global columns."""
    return SparseMatrix(rows=G.rows_local[s], cols=G.cols[s], vals=G.vals[s], shape=(G.n_local, G.n_pad),
                        nnz=G.e_shard)


def dist_spmm(mesh: Mesh, G: ShardedGraph, H: torch.Tensor) -> torch.Tensor:
    """out = A @ H with A and H row-sharded (``H`` [n_pad, P] in-process)."""
    fulls = mesh.all_gather(mesh.split(H))
    return mesh.concat([spmm(_shard_edges(G, s), Hf) for s, Hf in zip(mesh.local_shards, fulls)])


def dist_gnn_layer(
    mesh: Mesh, G: ShardedGraph, x: torch.Tensor, W: torch.Tensor, *, relu: bool = False
) -> torch.Tensor:
    """GCN layer ReLU?(A @ (x @ W)), ``x`` row-sharded."""
    out = dist_spmm(mesh, G, torch.matmul(x, mesh.replicated(W)))
    return relu_hw(out) if relu else out


def dist_gat_layer(
    mesh: Mesh, G: ShardedGraph, x: torch.Tensor, W: torch.Tensor, attention: torch.Tensor, *,
    alpha: float = 0.2, relu: bool = False,
) -> torch.Tensor:
    """Single-head GAT layer with the row softmax on each shard (a row's
    edges all lie in its shard); only the hidden rows are exchanged. The
    scores read the gathered hidden matrix with its gradient stopped (the
    reference's backward approximation)."""
    F = W.shape[1]
    a = mesh.replicated(attention.reshape(-1))
    H = torch.matmul(x, mesh.replicated(W))
    outs = []
    for s, Hf in zip(mesh.local_shards, mesh.all_gather(mesh.split(H))):
        A = _shard_edges(G, s)
        Hsg = Hf.detach()
        s1, s2 = torch.matmul(Hsg, a[:F]), torch.matmul(Hsg, a[F:])
        e = s1.index_select(0, A.rows + s * G.n_local) + s2.index_select(0, A.cols)
        outs.append(spmm(A.with_vals(edge_softmax(A, torch.where(e > 0, e, alpha * e))), Hf))
    out = mesh.concat(outs)
    return relu_hw(out) if relu else out
