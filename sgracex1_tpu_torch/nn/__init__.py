from sgracex1_tpu_torch.nn.convert import int8_layer_from_jax, params_from_jax
from sgracex1_tpu_torch.nn.layers import GATConv, GCNConv, ReluHW
from sgracex1_tpu_torch.nn.models import GATModel, GCNModel, MoleculeGCN, global_mean_pool

__all__ = ["GATConv", "GCNConv", "ReluHW", "GATModel", "GCNModel", "MoleculeGCN",
           "global_mean_pool", "params_from_jax", "int8_layer_from_jax"]
