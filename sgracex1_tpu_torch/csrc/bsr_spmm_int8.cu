// Full-integer block-sparse tile SpMM on Hopper: out = Aq @ Hq over the
// nonempty tb x tb tiles of the quantized adjacency, int8 operands on the
// tensor cores, int32 accumulation and int32 output, exact.
//
// Replaces sgracex1_tpu/ops/bsr.py:bsr_spmm_int8 (Pallas kernel
// _bsr_int8_kernel), which revisits one resident int32 output block across
// the run of tiles that share a row block and adds 128 * colsum(Hq[cb]) at
// every tile. Here the host cuts each run into segments
// (ops/bsr.RunSegments); a CTA owns one (segment, 128-row group,
// 128-feature slice), loops over its tiles and adds the precomputed column
// sums of the tiles it walked once, in its epilogue; split runs leave
// int32 partials that a second kernel sums in a fixed order. No atomics.
//
// Bound on the H100 by bytes: the int8 tiles are read once per feature
// slice (tb*tb bytes a tile against 2*tb*tb*P int8 operations, far below
// the int8 tensor-core ridge at P = 128), plus the tb*P Hq block a tile
// and row group. A first, simple kernel: no TMA, no wgmma, one stage.
#include "tile_gemm_i8.cuh"

// Returns the cudaError_t of the launches (0 on success). ``out`` is
// [n_out, P] with n_out = n_rt * tb: every row of every row block is
// written (cover tiles hold -128 and add exactly 0).
extern "C" int sg_bsr_spmm_int8(const void* tiles, int tb, int n_seg, const int* seg_rb,
                                const int* seg_lo, const int* seg_hi, const int* seg_part,
                                int n_fin, const int* fin_rb, const int* fin_p0,
                                const int* fin_np, const int* tile_cb, const void* Hq, int n_h,
                                int n_ct, int P, int vec, int vec4, int* colsum, int* out,
                                int* partial, int n_out, void* stream_ptr) {
  return sg8::launch_agg_int8<false>(
      static_cast<const int8_t*>(tiles), tb, n_seg, seg_rb, seg_lo, seg_hi, seg_part, n_fin,
      fin_rb, fin_p0, fin_np, tile_cb, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
      static_cast<const int8_t*>(Hq), n_h, n_ct, P, vec, vec4, colsum, out, partial, (long)n_out,
      static_cast<cudaStream_t>(stream_ptr));
}
