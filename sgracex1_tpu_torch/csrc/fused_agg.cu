// Fused block-sparse aggregation on Hopper: tiles + remainder chunks +
// rank-1 scalings in one pass, out = rowscale * (M @ (colscale * H) + rest)
// written in bf16.
//
// Replaces sgracex1_tpu/ops/fused_agg.py:bsr_spmm_fused (Pallas kernel
// _fused_kernel). The TPU version walks the whole schedule on one core and
// keeps the output block resident across a row block's run of steps. Here
// the host cuts every run into segments of at most a few steps
// (ops/bsr.RunSegments); a CTA owns one (segment, 128-row group, 128-feature
// slice) and loops over the segment's steps, so hub row blocks with
// thousands of tiles spread over many CTAs. A run that fits one segment is
// written directly; a split run leaves f32 partials that a second kernel
// sums in a fixed order. No atomics, deterministic.
//
// Bound on the H100: tensor-core throughput on the dense tile products
// (2*tb*tb*P flops per tile) and the H-block reads (tb*P elements per tile
// per row group). The design keeps
// the operands in bf16 in shared memory, reads each tile byte once per row
// group, and gathers remainder rows straight from H instead of
// materializing G. A first, simple kernel: no TMA, no wgmma, one stage.
#include "tile_gemm.cuh"

namespace sg {

template <int MODE, typename TH>
__global__ void __launch_bounds__(NTHREADS)
    fused_agg_kernel(const void* tiles, int tb, int n_rg, const int* seg_rb,
                     const int* seg_lo, const int* seg_hi, const int* seg_part,
                     const int* step_cb, const int* step_tile, const int* step_chunk,
                     const int* step_kind, const int* lrow, const int* slot_col,
                     const float* slot_scale, int K, const float* colscale,
                     const float* rowscale, const TH* H, int n_cols, int P, int vec,
                     __nv_bfloat16* out, float* partial, int n_rows) {
  __shared__ Smem s;
  const int seg = blockIdx.x / n_rg;
  const int row0 = (blockIdx.x % n_rg) * BM;
  const int p0 = blockIdx.y * BN;
  const int rb = seg_rb[seg];
  AccFrag acc[2][4];
  zero_acc(acc);
  for (int g = seg_lo[seg]; g < seg_hi[seg]; ++g) {
    const int kind = step_kind[g];  // 0 tile, 1 chunk, 3 tile + chunk
    if (kind != 1)
      tile_step<MODE>(s, acc, tiles, step_tile[g], step_cb[g], tb, row0, H, n_cols, P,
                      vec != 0, colscale, p0);
    if (kind >= 1)
      chunk_step(s, acc, lrow, slot_col, slot_scale, step_chunk[g], K, tb, row0, H, P,
                 vec != 0, p0);
  }
  store_block(s, acc, rb, tb, row0, p0, P, n_rows, rowscale, out, partial, seg_part[seg]);
}

template <int MODE, typename TH>
static void launch(const void* tiles, int tb, int n_seg, const int* seg_rb,
                   const int* seg_lo, const int* seg_hi, const int* seg_part,
                   const int* step_cb, const int* step_tile, const int* step_chunk,
                   const int* step_kind, const int* lrow, const int* slot_col,
                   const float* slot_scale, int K, const float* colscale,
                   const float* rowscale, const void* H, int n_cols, int P, int vec,
                   __nv_bfloat16* out, float* partial, int n_rows, cudaStream_t stream) {
  const int n_rg = (tb + BM - 1) / BM;
  dim3 grid(n_seg * n_rg, (P + BN - 1) / BN);
  fused_agg_kernel<MODE, TH><<<grid, NTHREADS, 0, stream>>>(
      tiles, tb, n_rg, seg_rb, seg_lo, seg_hi, seg_part, step_cb, step_tile, step_chunk,
      step_kind, lrow, slot_col, slot_scale, K, colscale, rowscale,
      static_cast<const TH*>(H), n_cols, P, vec, out, partial, n_rows);
}

}  // namespace sg

// Returns the cudaError_t of the launches (0 on success).
extern "C" int sg_fused_agg(const void* tiles, int tile_mode, int tb, int n_seg,
                            const int* seg_rb, const int* seg_lo, const int* seg_hi,
                            const int* seg_part, int n_fin, const int* fin_rb,
                            const int* fin_p0, const int* fin_np, const int* step_cb,
                            const int* step_tile, const int* step_chunk,
                            const int* step_kind, const int* lrow, const int* slot_col,
                            const float* slot_scale, int K, const float* colscale,
                            const float* rowscale, const void* H, int h_bf16, int n_cols,
                            int P, int vec, void* out, float* partial, int n_rows,
                            void* stream_ptr) {
  using namespace sg;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
#define SG_LAUNCH(MODE, TH)                                                              \
  launch<MODE, TH>(tiles, tb, n_seg, seg_rb, seg_lo, seg_hi, seg_part, step_cb, step_tile, \
                   step_chunk, step_kind, lrow, slot_col, slot_scale, K, colscale,         \
                   rowscale, H, n_cols, P, vec, o, partial, n_rows, stream)
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
  finalize_runs<__nv_bfloat16><<<blocks, 256, 0, stream>>>(partial, fin_rb, fin_p0, fin_np,
                                                           n_fin, tb, P, n_rows, rowscale, o);
  return (int)cudaGetLastError();
}
