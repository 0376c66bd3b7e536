// The flash backward ring kernels' fast_exp variant (flash_gat_bwd_ring.cuh,
// FAST): Schraudolph's exp (fast_ex2) for p, the option of the TPU passes
// (sgracex1_tpu/ops/flash_gat.py:_bwd_row_pass / _bwd_col_pass, fast_exp).
// Compiled in a source of its own, so the kernels of the main path
// (flash_gat_bwd_ring.cu) keep their code and the build runs both at once.
#include "flash_gat_bwd_ring.cuh"

namespace sgfb {

int launch_fast(bool col, int mode, int H, const void* tiles, long n_tiles, int n_seg, const void* op, long n_op,
                int n_sm, const BArgs& a, cudaStream_t stream) {
  if (mode == TILE_I8)
    return col ? launch_heads<TILE_I8, true, true>(H, tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream)
               : launch_heads<TILE_I8, false, true>(H, tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream);
  if (mode == TILE_BF16)
    return col ? launch_heads<TILE_BF16, true, true>(H, tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream)
               : launch_heads<TILE_BF16, false, true>(H, tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace sgfb
