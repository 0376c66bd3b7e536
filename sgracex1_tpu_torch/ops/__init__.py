from sgracex1_tpu_torch.ops.dispatch import (
    PreparedAdjacency,
    agg_matmul,
    map_adjacency_vals,
    prepare_adjacency,
    prepare_from_config,
)
from sgracex1_tpu_torch.ops.fused_gnn import gnn_layer, relu_hw
from sgracex1_tpu_torch.ops.spmm import spmm, spmm_into, spmm_t

__all__ = [
    "PreparedAdjacency",
    "agg_matmul",
    "map_adjacency_vals",
    "prepare_adjacency",
    "prepare_from_config",
    "gnn_layer",
    "relu_hw",
    "spmm",
    "spmm_into",
    "spmm_t",
]
