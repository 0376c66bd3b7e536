"""Distributed GNN layers over a 1-D mesh of graph shards, as
``sgracex1_tpu.parallel``: the row partition, the replicated-H layers,
the halo exchange with the local blocks on the tile kernels (K1, K2,
K3-K5), its communication model, and ``dryrun`` (one training step
through every layer kind)."""

from sgracex1_tpu_torch.parallel.comm_model import allgather_comm, halo_comm, predicted_efficiency
from sgracex1_tpu_torch.parallel.mesh import Mesh, global_mesh, init_multihost, make_mesh
from sgracex1_tpu_torch.parallel.partition import ShardedGraph, pad_nodes, partition_graph
from sgracex1_tpu_torch.parallel.spmm_dist import dist_gat_layer, dist_gnn_layer, dist_spmm

__all__ = [
    "Mesh",
    "make_mesh",
    "init_multihost",
    "global_mesh",
    "ShardedGraph",
    "partition_graph",
    "pad_nodes",
    "dist_spmm",
    "dist_gnn_layer",
    "dist_gat_layer",
    "halo_comm",
    "allgather_comm",
    "predicted_efficiency",
]
