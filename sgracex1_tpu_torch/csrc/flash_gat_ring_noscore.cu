// The flash ring kernel's VAR 2 (flash_gat_ring.cuh), an ablation of its
// consumer work that the JAX package's kernels offer:
// K6's noscore chunks: a chunk slab adds onehot(lrow) @ bf16(Wh) to the
// sums with no score, max or l (sgracex1_tpu/ops/flash_gat.py:
// flash_gat_hybrid_forward(_chunk_mode="noscore")).
// Compiled in a source of its own, so the kernel of the main path
// (flash_gat_ring.cu) keeps its code and the build runs both at once.
#include "flash_gat_ring.cuh"

namespace sgfr {

int launch_noscore(int mode, int H, const void* tiles, long n_tiles, int n_seg, int n_wh, int n_sm,
                   const FArgs& args, cudaStream_t stream) {
  if (mode != TILE_I8 && mode != TILE_BF16) return (int)cudaErrorInvalidValue;
  const bool i8 = mode == TILE_I8;
  switch (H) {
    case 1: return i8 ? launch<TILE_I8, 1, false, 2>(tiles, n_tiles, n_seg, n_wh, n_sm, args, stream)
                      : launch<TILE_BF16, 1, false, 2>(tiles, n_tiles, n_seg, n_wh, n_sm, args, stream);
    case 2: return i8 ? launch<TILE_I8, 2, false, 2>(tiles, n_tiles, n_seg, n_wh, n_sm, args, stream)
                      : launch<TILE_BF16, 2, false, 2>(tiles, n_tiles, n_seg, n_wh, n_sm, args, stream);
    case 4: return i8 ? launch<TILE_I8, 4, false, 2>(tiles, n_tiles, n_seg, n_wh, n_sm, args, stream)
                      : launch<TILE_BF16, 4, false, 2>(tiles, n_tiles, n_seg, n_wh, n_sm, args, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sgfr
