// Fused block-sparse aggregation, KS schedule entries per loop iteration:
// K2's function (csrc/fused_agg.cu) on a plan whose row-block runs are
// padded to multiples of KS with dead chunk steps
// (ops/fused_agg.build_fused_plan(k_steps=KS)).
//
// Replaces sgracex1_tpu/ops/fused_agg.py:bsr_spmm_fused_k (Pallas kernel
// _fused_kernel_k), which takes k entries per grid step to spread the
// TPU's per-step bookkeeping. The counterpart of that cost here is the
// pair of block barriers around every 32-deep operand stage. A CTA owns a
// (segment, 128-row group, 128-feature slice) as in K2, with segments cut
// on multiples of KS; per iteration it stages one slice of each of the KS
// entries' tile operands in KS operand buffers, passes one barrier, and
// runs the KS products; then the same for the entries' chunk operands.
// Sums are f32 in another order than K2's, nothing else differs.
//
// Bound on the H100: as K2. Shared memory: KS operand buffers of 27 KiB.
#include "tile_gemm.cuh"

namespace sg {
namespace fusedk {

template <int MODE, typename TH, int KS>
__global__ void __launch_bounds__(NTHREADS)
    fused_agg_k_kernel(const void* tiles, int tb, int n_rg, const int* seg_rb, const int* seg_lo,
                       const int* seg_hi, const int* seg_part, const int* step_cb,
                       const int* step_tile, const int* step_chunk, const int* step_kind,
                       const int* lrow, const int* slot_col, const float* slot_scale, int K,
                       const float* colscale, const float* rowscale, const TH* H, int n_cols,
                       int P, int vec, __nv_bfloat16* out, float* partial, int n_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem* s = reinterpret_cast<Smem*>(smem);  // KS operand buffers
  const int seg = blockIdx.x / n_rg;
  const int row0 = (blockIdx.x % n_rg) * BM;
  const int p0 = blockIdx.y * BN;
  AccFrag acc[2][4];
  zero_acc(acc);
  for (int g = seg_lo[seg]; g < seg_hi[seg]; g += KS) {
    int kind[KS];  // 0 tile, 1 chunk, 3 tile + chunk
    bool any_tile = false, any_chunk = false;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      kind[i] = step_kind[g + i];
      any_tile |= kind[i] != 1;
      any_chunk |= kind[i] >= 1;
    }
    if (any_tile) {
      for (int k0 = 0; k0 < tb; k0 += BK) {
#pragma unroll
        for (int i = 0; i < KS; ++i) {
          if (kind[i] == 1) continue;
          load_a_tile<MODE>(s[i], tiles, step_tile[g + i], tb, row0, k0);
          load_b_tile(s[i], H, n_cols, P, vec != 0, colscale, step_cb[g + i], tb, k0, p0);
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < KS; ++i)
          if (kind[i] != 1) mma_stage(s[i], acc);
        __syncthreads();
      }
    }
    if (any_chunk) {
      for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
        for (int i = 0; i < KS; ++i) {
          if (kind[i] < 1) continue;
          load_a_chunk(s[i], lrow, step_chunk[g + i], K, tb, row0, k0);
          load_b_chunk(s[i], H, P, vec != 0, slot_col, slot_scale, step_chunk[g + i], K, k0, p0);
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < KS; ++i)
          if (kind[i] >= 1) mma_stage(s[i], acc);
        __syncthreads();
      }
    }
  }
  store_block(s[0], acc, seg_rb[seg], tb, row0, p0, P, n_rows, rowscale, out, partial,
              seg_part[seg]);
}

template <int MODE, typename TH, int KS>
static cudaError_t launch(const void* tiles, int tb, int n_seg, const int* seg_rb,
                          const int* seg_lo, const int* seg_hi, const int* seg_part,
                          const int* step_cb, const int* step_tile, const int* step_chunk,
                          const int* step_kind, const int* lrow, const int* slot_col,
                          const float* slot_scale, int K, const float* colscale,
                          const float* rowscale, const void* H, int n_cols, int P, int vec,
                          __nv_bfloat16* out, float* partial, int n_rows, cudaStream_t stream) {
  constexpr int bytes = KS * (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(fused_agg_k_kernel<MODE, TH, KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_rg = (tb + BM - 1) / BM;
  dim3 grid(n_seg * n_rg, (P + BN - 1) / BN);
  fused_agg_k_kernel<MODE, TH, KS><<<grid, NTHREADS, bytes, stream>>>(
      tiles, tb, n_rg, seg_rb, seg_lo, seg_hi, seg_part, step_cb, step_tile, step_chunk,
      step_kind, lrow, slot_col, slot_scale, K, colscale, rowscale, static_cast<const TH*>(H),
      n_cols, P, vec, out, partial, n_rows);
  return cudaGetLastError();
}

}  // namespace fusedk
}  // namespace sg

// k_steps is 2 or 4; every segment [seg_lo, seg_hi) is a multiple of it
// long. Returns the cudaError_t of the launches (0 on success).
extern "C" int sg_fused_agg_k(const void* tiles, int tile_mode, int tb, int k_steps, int n_seg,
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
  using namespace sg::fusedk;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaError_t err = cudaErrorInvalidValue;
#define SG_LAUNCH(MODE, TH, KS)                                                             \
  err = launch<MODE, TH, KS>(tiles, tb, n_seg, seg_rb, seg_lo, seg_hi, seg_part, step_cb,   \
                             step_tile, step_chunk, step_kind, lrow, slot_col, slot_scale, \
                             K, colscale, rowscale, H, n_cols, P, vec, o, partial, n_rows, \
                             stream)
#define SG_BY_H(MODE, KS)                         \
  if (h_bf16) SG_LAUNCH(MODE, __nv_bfloat16, KS); \
  else SG_LAUNCH(MODE, float, KS)
#define SG_BY_K(MODE)                       \
  if (k_steps == 2) { SG_BY_H(MODE, 2); }   \
  else if (k_steps == 4) { SG_BY_H(MODE, 4); }
  switch (tile_mode) {
    case TILE_BF16: SG_BY_K(TILE_BF16); break;
    case TILE_F32: SG_BY_K(TILE_F32); break;
    case TILE_I8: SG_BY_K(TILE_I8); break;
    case TILE_BITS: SG_BY_K(TILE_BITS); break;
    default: break;
  }
#undef SG_BY_K
#undef SG_BY_H
#undef SG_LAUNCH
  if (err != cudaSuccess || n_fin == 0) return (int)err;
  const long total = (long)n_fin * tb * P;
  const int blocks = (int)((total + 255) / 256 < 65536 ? (total + 255) / 256 : 65536);
  finalize_runs<__nv_bfloat16><<<blocks, 256, 0, stream>>>(partial, fin_rb, fin_p0, fin_np,
                                                           n_fin, tb, P, n_rows, rowscale, o);
  return (int)cudaGetLastError();
}
