"""sgracex1_tpu_torch: the GNN message-passing framework in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (``sm_90a``).

A port of ``sgracex1_tpu`` (JAX/Pallas), which stays the reference: the
same host preprocessing (numpy), the same layouts at the public functions
(weights ``[in, out]``, features ``[N, P]``, padded row-sorted COO), and one
hand-written CUDA kernel per Pallas kernel on the ported path:

- ``ops/bsr.bsr_spmm`` (K1, ``csrc/bsr_spmm.cu``): tile SpMM;
- ``ops/fused_agg.bsr_spmm_fused`` (K2, ``csrc/fused_agg.cu``): tiles +
  remainder chunks + rank-1 scalings in one pass;
- ``ops/flash_gat.flash_gat_forward`` (K3) and ``flash_gat_hybrid_forward``
  (K6, both ``csrc/flash_gat.cu``): GAT attention aggregation over mask
  tiles, K6 with remainder chunk steps in the same row softmax.

Kernels build with nvcc at first use; on CPU tensors each wrapper runs its
plain PyTorch version. This package never imports jax.
"""

__version__ = "0.1.0"

from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.nn.models import GATModel, GCNModel
from sgracex1_tpu_torch.ops.dispatch import agg_matmul, prepare_adjacency
from sgracex1_tpu_torch.ops.fused_gnn import gnn_layer

__all__ = [
    "SparseMatrix",
    "sym_norm",
    "gnn_layer",
    "GCNModel",
    "GATModel",
    "prepare_adjacency",
    "agg_matmul",
]
