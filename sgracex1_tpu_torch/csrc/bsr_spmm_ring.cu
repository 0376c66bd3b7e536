// Block-sparse tile SpMM on Hopper, ring design: out = A @ H over the live
// tb x tb tiles of A, bf16 operands, f32 accumulation and f32 output; and
// the pre-pass sg_stage_h that both ring kernels read H through.
//
// Replaces sgracex1_tpu/ops/bsr.py:bsr_spmm_pallas (Pallas kernel
// _bsr_kernel), as bsr_spmm.cu does, for int8 and bf16 tiles of height
// 64..256 and P % 8 == 0 (ops/bsr.ring_shape_ok); f32 and 1-bit packed
// tiles and the other shapes stay on bsr_spmm.cu.
//
// Bound on the H100: bytes (tiles, one bf16 H block a tile, the f32
// output), far above the tensor-core time of the tile products. The
// pipeline is the one of fused_agg_ring.cu without chunk steps and scalings
// (tile_ring.cuh): only tiles that an edge produced, H rounded to bf16
// once, one CTA per tile height, a TMA / mbarrier ring of four 64-deep
// stages feeding eight mma.sync warps, persistent over the work list; split
// runs are summed by a second kernel in a fixed order. No atomics.
#include "tile_ring.cuh"

// Returns 0, the cudaError_t of the launches, or 10000 + the CUresult of
// the tensor-map encoder. The chunk and scale arguments are unused (the
// signature is the one of sg_fused_agg_ring).
extern "C" int sg_bsr_spmm_ring(const void* tiles, int tile_mode, int tb, int n_tiles, int n_seg,
                                const int* seg_rb, const int* seg_lo, const int* seg_hi,
                                const int* seg_part, int n_fin, const int* fin_rb,
                                const int* fin_p0, const int* fin_np, const void* step,
                                const int* lrow, const int* slot_col, const float* slot_scale,
                                int K, const float* rowscale, const void* Hs, int hs_rows, int P,
                                void* out, float* partial, int n_rows, int n_sm,
                                void* stream_ptr) {
  using namespace sgr;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  RingArgs a{};
  a.tb = tb;
  a.seg_rb = seg_rb; a.seg_lo = seg_lo; a.seg_hi = seg_hi; a.seg_part = seg_part;
  a.step = static_cast<const int4*>(step);
  a.Hs = static_cast<const __nv_bfloat16*>(Hs);
  a.P = P; a.out = out; a.partial = partial; a.n_rows = n_rows;
  if (tb % 64 || tb > RM || P % 8) return (int)cudaErrorInvalidValue;
  switch (tile_mode) {
    case TILE_I8:
      return launch_ring<TILE_I8, false, float>(tiles, n_tiles, n_seg, n_fin, fin_rb, fin_p0,
                                                fin_np, hs_rows, n_sm, a, stream);
    case TILE_BF16:
      return launch_ring<TILE_BF16, false, float>(tiles, n_tiles, n_seg, n_fin, fin_rb, fin_p0,
                                                  fin_np, hs_rows, n_sm, a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Hs = the rounded (and column-scaled) bf16 copy of H, [rows, P] with zero
// rows from n_valid on. Returns the cudaError_t of the launch.
extern "C" int sg_stage_h(const void* H, int h_bf16, int n_valid, const float* colscale, void* Hs,
                          int rows, int P, void* stream_ptr) {
  using namespace sgr;
  if (P % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long total = (long)rows * (P >> 3);
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(Hs);
  if (h_bf16)
    stage_h_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(H), n_valid, colscale, o, rows, P);
  else
    stage_h_kernel<float><<<blocks, 256, 0, stream>>>(static_cast<const float*>(H), n_valid,
                                                      colscale, o, rows, P);
  return (int)cudaGetLastError();
}
