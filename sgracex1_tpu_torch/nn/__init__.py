from sgracex1_tpu_torch.nn.convert import params_from_jax
from sgracex1_tpu_torch.nn.layers import GCNConv, ReluHW
from sgracex1_tpu_torch.nn.models import GCNModel

__all__ = ["GCNConv", "ReluHW", "GCNModel", "params_from_jax"]
