// Block-sparse tile SpMM on Hopper: out = A @ H over the nonempty tb x tb
// tiles of A, bf16 operands, f32 accumulation and f32 output.
//
// Replaces sgracex1_tpu/ops/bsr.py:bsr_spmm_pallas (Pallas kernel
// _bsr_kernel), which revisits one resident output block across the run of
// tiles that share a row block. Here the host cuts each run into segments
// (ops/bsr.RunSegments); a CTA owns one (segment, 128-row group,
// 128-feature slice) and loops over its tiles, so the long runs of hub row
// blocks spread over many CTAs; split runs are summed by a second kernel in
// a fixed order. No atomics.
//
// Bound on the H100: tensor-core throughput on 2*tb*tb*P flops per tile
// and the tb*P H-block reads per tile and row group. Tiles arrive as bf16
// or f32 values, int8 {0,1} masks or 1-bit packed masks (8x fewer tile
// bytes).
#include "tile_gemm.cuh"

namespace sg {

template <int MODE, typename TH>
__global__ void __launch_bounds__(NTHREADS)
    bsr_spmm_kernel(const void* tiles, int tb, int n_rg, const int* seg_rb,
                    const int* seg_lo, const int* seg_hi, const int* seg_part,
                    const int* tile_cb, const TH* H, int n_cols, int P, int vec, float* out,
                    float* partial, int n_rows) {
  __shared__ Smem s;
  const int seg = blockIdx.x / n_rg;
  const int row0 = (blockIdx.x % n_rg) * BM;
  const int p0 = blockIdx.y * BN;
  AccFrag acc[2][4];
  zero_acc(acc);
  for (int t = seg_lo[seg]; t < seg_hi[seg]; ++t)
    tile_step<MODE>(s, acc, tiles, t, tile_cb[t], tb, row0, H, n_cols, P, vec != 0,
                    nullptr, p0);
  store_block(s, acc, seg_rb[seg], tb, row0, p0, P, n_rows, nullptr, out, partial,
              seg_part[seg]);
}

template <int MODE, typename TH>
static void launch(const void* tiles, int tb, int n_seg, const int* seg_rb,
                   const int* seg_lo, const int* seg_hi, const int* seg_part,
                   const int* tile_cb, const void* H, int n_cols, int P, int vec, float* out,
                   float* partial, int n_rows, cudaStream_t stream) {
  const int n_rg = (tb + BM - 1) / BM;
  dim3 grid(n_seg * n_rg, (P + BN - 1) / BN);
  bsr_spmm_kernel<MODE, TH><<<grid, NTHREADS, 0, stream>>>(
      tiles, tb, n_rg, seg_rb, seg_lo, seg_hi, seg_part, tile_cb,
      static_cast<const TH*>(H), n_cols, P, vec, out, partial, n_rows);
}

}  // namespace sg

// Returns the cudaError_t of the launches (0 on success).
extern "C" int sg_bsr_spmm(const void* tiles, int tile_mode, int tb, int n_seg,
                           const int* seg_rb, const int* seg_lo, const int* seg_hi,
                           const int* seg_part, int n_fin, const int* fin_rb,
                           const int* fin_p0, const int* fin_np, const int* tile_cb,
                           const void* H, int h_bf16, int n_cols, int P, int vec, float* out,
                           float* partial, int n_rows, void* stream_ptr) {
  using namespace sg;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define SG_LAUNCH(MODE, TH)                                                             \
  launch<MODE, TH>(tiles, tb, n_seg, seg_rb, seg_lo, seg_hi, seg_part, tile_cb, H, n_cols, \
                   P, vec, out, partial, n_rows, stream)
#define SG_BY_H(MODE)                                 \
  if (h_bf16) SG_LAUNCH(MODE, __nv_bfloat16); \
  else SG_LAUNCH(MODE, float)
  switch (tile_mode) {
    case TILE_BF16: SG_BY_H(TILE_BF16); break;
    case TILE_F32: SG_BY_H(TILE_F32); break;
    case TILE_I8: SG_BY_H(TILE_I8); break;
    case TILE_BITS: SG_BY_H(TILE_BITS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SG_BY_H
#undef SG_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_fin == 0) return (int)err;
  const long total = (long)n_fin * tb * P;
  const int blocks = (int)((total + 255) / 256 < 65536 ? (total + 255) / 256 : 65536);
  finalize_runs<float><<<blocks, 256, 0, stream>>>(partial, fin_rb, fin_p0, fin_np, n_fin, tb,
                                                   P, n_rows, nullptr, out);
  return (int)cudaGetLastError();
}
