from sgracex1_tpu_torch.nn.convert import params_from_jax
from sgracex1_tpu_torch.nn.layers import GATConv, GCNConv, ReluHW
from sgracex1_tpu_torch.nn.models import GATModel, GCNModel

__all__ = ["GATConv", "GCNConv", "ReluHW", "GATModel", "GCNModel", "params_from_jax"]
