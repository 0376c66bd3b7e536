from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.graph.normalize import add_self_loops, sym_norm

__all__ = ["SparseMatrix", "sym_norm", "add_self_loops"]
