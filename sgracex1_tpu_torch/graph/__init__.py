from sgracex1_tpu_torch.graph.batch import GraphBatch, GraphSample, batch_graphs, make_batches
from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.graph.normalize import add_self_loops, sym_norm
from sgracex1_tpu_torch.graph.sampling import NeighborSampler, SampledBatch, make_neighbor_batches

__all__ = [
    "SparseMatrix", "sym_norm", "add_self_loops", "GraphSample", "GraphBatch", "batch_graphs",
    "make_batches", "SampledBatch", "NeighborSampler", "make_neighbor_batches",
]
