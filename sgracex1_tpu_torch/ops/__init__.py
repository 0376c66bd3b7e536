from sgracex1_tpu_torch.ops.dispatch import (
    PreparedAdjacency,
    agg_matmul,
    agg_matmul_with_vals,
    map_adjacency_vals,
    prepare_adjacency,
    prepare_from_config,
)
from sgracex1_tpu_torch.ops.fused_gnn import gat_attention, gnn_layer, relu_hw
from sgracex1_tpu_torch.ops.spmm import spmm, spmm_dense_rhs, spmm_into, spmm_t, spmv

__all__ = [
    "PreparedAdjacency",
    "agg_matmul",
    "agg_matmul_with_vals",
    "map_adjacency_vals",
    "prepare_adjacency",
    "prepare_from_config",
    "gat_attention",
    "gnn_layer",
    "relu_hw",
    "spmm",
    "spmm_dense_rhs",
    "spmm_into",
    "spmm_t",
    "spmv",
]
