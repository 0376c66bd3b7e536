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
  tiles, K6 with remainder chunk steps in the same row softmax;
- ``ops/flash_gat.flash_gat_bwd_row`` (K4) and ``flash_gat_bwd_col`` (K5,
  both ``csrc/flash_gat_bwd.cu``): the attention backward's row and
  column passes;
- ``ops/bsr.bsr_spmm_int8`` (K7) and ``ops/fused_agg.bsr_spmm_int8_fused``
  (K8), both on the int8 ring kernel ``csrc/fused_agg_int8_ring.cu`` where
  their shape rules hold (else ``csrc/bsr_spmm_int8.cu`` /
  ``csrc/fused_agg_int8.cu``): the exact int32 ``Aq @ Hq`` of full-integer
  inference, on a full tile cover and on the hybrid split;
- ``ops/pallas_spmm.spmm_plan`` (K9, ``csrc/plan_spmm_gather.cu`` at every
  width, H padded with zero columns to a multiple of 8 where it needs it):
  the ``pallas`` kind's aggregation over edge groups, whose values can be
  replaced per call (``ops/dispatch.agg_matmul_with_vals``);
- the three variants the JAX package keeps as experiments, each under its
  JAX name: ``ops/bsr.bsr_spmm_rowloop`` (K10, ``csrc/bsr_spmm_rowloop.cu``),
  ``ops/fused_agg.bsr_spmm_fused_k`` (K11, ``csrc/fused_agg_k.cu``) and
  ``ops/flash_gat.flash_gat_forward_subskip`` (K12, the flash ring kernel
  ``csrc/flash_gat_ring.cu`` where its rule holds, else ``csrc/flash_gat.cu``).

Aggregations and attention are differentiable (K1/K2/K9 on the transposed
plans, K4/K5). ``train`` holds the JAX package's four loops: full-graph
and neighbor-sampled node classification (``graph.sampling``), graph
classification of block-diagonal batches (``graph.batch``,
``MoleculeGCN``) and inductive multi-label training over whole graphs
(PPI). ``quant`` holds the adaptive quantization (8/4/2/1 bit):
the affine math, calibration tables and automatic calibration, the
fake-quant datapath of the layers (``GCNModel(..., calibration=cal)``) and
int8 serving (``quant.int8``). ``parallel`` holds the distributed layers:
the row partition, the halo exchange with each shard's local block on K1,
K2 or K3-K5, on an in-process mesh of shards (one card) or one shard a
rank over ``torch.distributed``. ``graph.io`` and the ``graph.datasets``
parsers read the reference's text files and the public datasets' raw
files; ``runtime.native`` (a g++ build of ``csrc/sgrace_host.cpp``) runs
the parsers, ``sym_norm``, ``rcm_order`` and ``plan_spmm``'s planner
natively, their numpy versions the fallback. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``. Kernels build with nvcc at first use;
on CPU tensors each wrapper runs its plain PyTorch version. This package
never imports jax.
"""

__version__ = "0.1.0"

from sgracex1_tpu_torch import quant
from sgracex1_tpu_torch.config import SGRACEConfig
from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.nn.models import GATModel, GATSkipModel, GCNModel, MoleculeGCN
from sgracex1_tpu_torch.ops.dispatch import agg_matmul, prepare_adjacency, prepare_from_config
from sgracex1_tpu_torch.ops.fused_gnn import gnn_layer
from sgracex1_tpu_torch.train import (
    train_graph_classifier,
    train_multilabel_inductive,
    train_node_classifier,
    train_node_classifier_sampled,
)

__all__ = [
    "SparseMatrix",
    "sym_norm",
    "gnn_layer",
    "GCNModel",
    "GATModel",
    "GATSkipModel",
    "MoleculeGCN",
    "prepare_adjacency",
    "prepare_from_config",
    "agg_matmul",
    "SGRACEConfig",
    "train_node_classifier",
    "train_node_classifier_sampled",
    "train_graph_classifier",
    "train_multilabel_inductive",
    "quant",
]
