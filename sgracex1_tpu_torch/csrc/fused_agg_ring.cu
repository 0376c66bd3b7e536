// Fused block-sparse aggregation on Hopper, ring design: tiles + remainder
// chunks + rank-1 scalings in one pass,
// out = rowscale * (M @ (colscale * H) + rest) written in bf16.
//
// Replaces sgracex1_tpu/ops/fused_agg.py:bsr_spmm_fused (Pallas kernel
// _fused_kernel), as fused_agg.cu does, for int8 and bf16 tiles of height
// 64..256, P % 8 == 0 and K % 64 == 0 (ops/bsr.ring_shape_ok); the other
// forms stay on fused_agg.cu.
//
// Bound on the H100: bytes. The live tiles (64 KB of int8 mask each), one
// bf16 H block a tile, the gathered chunk rows and the output move about
// 0.9 GB at the 2^20-node slice, against 84 GFLOP of tile products (0.09 ms
// at the bf16 peak). So the design (tile_ring.cuh) moves fewer bytes and
// keeps them in flight: the host schedule lists only steps that do work
// (an empty cover tile costs the TPU a visit, here nothing), H is scaled
// and rounded to bf16 once by sg_stage_h and read by both step kinds, one
// CTA owns a tile's whole height so every tile and H block is read once,
// and a producer warp feeds a four-stage TMA / mbarrier ring that eight
// mma.sync consumer warps drain, persistent over the work list so that an
// epilogue overlaps the next item's loads. Split runs leave f32 partials
// that a second kernel sums in a fixed order. No atomics, deterministic.
//
// The same kernel is K11 (sgracex1_tpu/ops/fused_agg.py:bsr_spmm_fused_k,
// Pallas kernel _fused_kernel_k) at ``slabs`` = k slabs a ring stage: the
// TPU kernel takes k schedule entries per grid step to spread its per-step
// bookkeeping, whose counterpart here is the ring's handshake, one
// full-barrier wait and one empty-barrier arrive a stage. A stage then holds
// k consecutive slabs of a work item (never two items), with one expect_tx
// a slab and one wait / arrive pair for all of them. What fits in shared
// memory sets the depth: k = 2 keeps 64-deep slabs (three stages of 66 KB
// for int8 tiles, two of 106 KB for bf16), k = 4 takes 32-deep slabs (three
// stages of 68 KB, int8 only). It walks K2's ring schedule: the k-plan's pad
// steps do no work and are not on it. At k = 2 the consumers run the same
// products in the same order as at k = 1, so the outputs are equal bit for
// bit; at k = 4 a 16-deep product groups other reduction indices.
#include "tile_ring.cuh"

namespace {

template <int MODE, int NSLAB, int SD>
int launch_fused(const void* tiles, int n_tiles, int n_seg, int n_fin, const int* fin_rb,
                 const int* fin_p0, const int* fin_np, int hs_rows, int n_sm, sgr::RingArgs a,
                 cudaStream_t stream) {
  return sgr::launch_ring<MODE, true, __nv_bfloat16, NSLAB, SD>(
      tiles, n_tiles, n_seg, n_fin, fin_rb, fin_p0, fin_np, hs_rows, n_sm, a, stream);
}

}  // namespace

// ``slabs`` slabs a ring stage, each ``depth`` deep: (1, 64) is K2, (2, 64)
// and (4, 32) are K11 (int8 tiles; bf16 tiles at (2, 64) only). Returns 0,
// the cudaError_t of the launches, or 10000 + the CUresult of the
// tensor-map encoder.
extern "C" int sg_fused_agg_ring(const void* tiles, int tile_mode, int tb, int n_tiles, int n_seg,
                                 const int* seg_rb, const int* seg_lo, const int* seg_hi,
                                 const int* seg_part, int n_fin, const int* fin_rb,
                                 const int* fin_p0, const int* fin_np, const void* step,
                                 const int* lrow, const int* slot_col, const float* slot_scale,
                                 int K, const float* rowscale, const void* Hs, int hs_rows, int P,
                                 void* out, float* partial, int n_rows, int n_sm, int slabs,
                                 int depth, void* stream_ptr) {
  using namespace sgr;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  RingArgs a{};
  a.tb = tb;
  a.seg_rb = seg_rb; a.seg_lo = seg_lo; a.seg_hi = seg_hi; a.seg_part = seg_part;
  a.step = static_cast<const int4*>(step);
  a.lrow = lrow; a.slot_col = slot_col; a.slot_scale = slot_scale; a.K = K;
  a.rowscale = rowscale;
  a.Hs = static_cast<const __nv_bfloat16*>(Hs);
  a.P = P; a.out = out; a.partial = partial; a.n_rows = n_rows;
  if (tb % 64 || tb > RM || P % 8 || K % KS) return (int)cudaErrorInvalidValue;
#define SG_FUSED_RING(MODE, NSLAB, SD)                                                     \
  if (tile_mode == MODE && slabs == NSLAB && depth == SD)                                \
    return launch_fused<MODE, NSLAB, SD>(tiles, n_tiles, n_seg, n_fin, fin_rb, fin_p0, fin_np, \
                                         hs_rows, n_sm, a, stream);
  SG_FUSED_RING(TILE_I8, 1, 64)
  SG_FUSED_RING(TILE_BF16, 1, 64)
  SG_FUSED_RING(TILE_I8, 2, 64)
  SG_FUSED_RING(TILE_I8, 4, 32)
  SG_FUSED_RING(TILE_BF16, 2, 64)
#undef SG_FUSED_RING
  return (int)cudaErrorInvalidValue;
}
