// Plan SpMM on Hopper: out = A @ H over the edge groups of an SpMMPlan
// (ops/pallas_spmm.py): slot s of group g is the edge (tile_rb[g] * rb +
// lrow[s], tile_cb[g] * cb + lcol[s]) with value val[s].
//
// Replaces sgracex1_tpu/ops/pallas_spmm.py:spmm_pallas (Pallas kernel
// _spmm_kernel), which gathers and scatters with one-hot matmuls on the
// TPU's matrix unit, one edge group a grid step, and keeps a row block's
// rb x P output resident across its run of groups. That block does not
// fit a CTA's shared memory (512 KiB at rb = 1024, P = 128), one-hots are
// wasted work on a card that gathers rows directly, and most slots are
// padding. Here the host lists the live slots by output row
// (plan.slot_idx) and cuts every row's run of slots into pieces
// (plan.segments, ops/bsr.RunSegments with the row in seg_rb); a worker of
// LPR lanes owns one piece and sums it in registers in slot order, four
// features a lane and pass. A row of one piece is written directly; a
// split row (a hub) leaves f32 partials that sum_split_rows (plan_rows.cuh)
// adds in a fixed order. No atomics, every output row written once.
//
// Rounding points follow the TPU kernel: H rounds to bf16, the weighted
// row f32(bf16(H)) * val rounds to bf16 again, sums are f32.
//
// Bound on the H100: bytes. Per live slot 12 bytes of plan (slot_idx,
// lcol, val) and a P-wide row of H that is gathered from anywhere in H,
// so the reads are latency-bound until enough rows are in flight. A first,
// simple kernel: the slot loop's three dependent loads are not software
// pipelined. Its successor, plan_spmm_gather.cu, takes every H whose rows are
// whole 16-byte bf16 pieces (ops/pallas_spmm.gather_shape_ok); this kernel
// keeps the other widths.
#include "plan_rows.cuh"
#include "tile_gemm.cuh"

namespace sg {
namespace planspmm {

constexpr int NTHREADS = 256;

template <typename TH, bool VEC>
__device__ __forceinline__ void load4(const TH* H, long base, int f, int stride, int P,
                                      float (&h)[4]) {
  if constexpr (VEC) {
    if (f >= P) {
      h[0] = h[1] = h[2] = h[3] = 0.f;
    } else if constexpr (sizeof(TH) == 4) {
      const float4 v = *reinterpret_cast<const float4*>(H + base + f);
      h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(H + base + f);
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int q = 0; q < 4; ++q) h[q] = __bfloat162float(b[q]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) h[q] = (f + q * stride < P) ? h_load(H, base + f + q * stride) : 0.f;
  }
}

// LPR lanes a worker. Per pass a worker covers 4 * LPR features: with VEC
// lane `sub` holds features f0 + 4 * sub .. + 4, else f0 + sub + q * LPR.
template <typename TH, int LPR, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
    plan_spmm_kernel(const int* lcol, const float* val, const int* tile_cb, int be, int cb,
                     const int* slot_idx, int n_seg, const int* seg_row, const int* seg_lo,
                     const int* seg_hi, const int* seg_part, const TH* H, int n_h, int P,
                     float* out, float* partial) {
  const long worker = (blockIdx.x * (long)NTHREADS + threadIdx.x) / LPR;
  const int sub = threadIdx.x % LPR;
  if (worker >= n_seg) return;
  const int lo = seg_lo[worker], hi = seg_hi[worker], part = seg_part[worker];
  float* dst = part >= 0 ? partial + (long)part * P : out + (long)seg_row[worker] * P;
  const int stride = VEC ? 1 : LPR;
  for (int f0 = 0; f0 < P; f0 += 4 * LPR) {
    const int f = f0 + (VEC ? 4 * sub : sub);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = lo; s < hi; ++s) {
      const int slot = slot_idx[s];
      const long col = (long)tile_cb[slot / be] * cb + lcol[slot];
      const float v = val[slot];
      if (col >= n_h) continue;  // H has no such row: it reads as zero
      float h[4];
      load4<TH, VEC>(H, col * (long)P, f, stride, P, h);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += bf16r(bf16r(h[q]) * v);
    }
    if constexpr (VEC) {
      if (f < P) *reinterpret_cast<float4*>(dst + f) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (f + q * stride < P) dst[f + q * stride] = acc[q];
    }
  }
}

template <typename TH, int LPR>
static void launch(const int* lcol, const float* val, const int* tile_cb, int be, int cb,
                   const int* slot_idx, int n_seg, const int* seg_row, const int* seg_lo,
                   const int* seg_hi, const int* seg_part, const void* H, int n_h, int P, int vec,
                   float* out, float* partial, cudaStream_t stream) {
  const long threads = (long)n_seg * LPR;
  const unsigned blocks = (unsigned)((threads + NTHREADS - 1) / NTHREADS);
  const TH* h = static_cast<const TH*>(H);
  if (vec)
    plan_spmm_kernel<TH, LPR, true><<<blocks, NTHREADS, 0, stream>>>(
        lcol, val, tile_cb, be, cb, slot_idx, n_seg, seg_row, seg_lo, seg_hi, seg_part, h, n_h,
        P, out, partial);
  else
    plan_spmm_kernel<TH, LPR, false><<<blocks, NTHREADS, 0, stream>>>(
        lcol, val, tile_cb, be, cb, slot_idx, n_seg, seg_row, seg_lo, seg_hi, seg_part, h, n_h,
        P, out, partial);
}

}  // namespace planspmm
}  // namespace sg

// Returns the cudaError_t of the launches (0 on success). out and the
// partials are 16-byte aligned rows when vec is set (P % 4 == 0).
extern "C" int sg_plan_spmm(const int* lcol, const float* val, const int* tile_cb, int be, int cb,
                            const int* slot_idx, int n_seg, const int* seg_row,
                            const int* seg_lo, const int* seg_hi, const int* seg_part, int n_fin,
                            const int* fin_row, const int* fin_p0, const int* fin_np,
                            const void* H, int h_bf16, int n_h, int P, int vec, float* out,
                            float* partial, int n_rows, void* stream_ptr) {
  using namespace sg;
  using namespace sg::planspmm;
  if (be < 1 || cb < 1 || P < 1) return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // lanes a worker: the power of two that covers P in one pass of four
  // features a lane, at most a warp
  const int want = (P + 3) / 4;
#define SG_LAUNCH(TH, LPR)                                                                   \
  launch<TH, LPR>(lcol, val, tile_cb, be, cb, slot_idx, n_seg, seg_row, seg_lo, seg_hi,      \
                  seg_part, H, n_h, P, vec, out, partial, stream)
#define SG_BY_LPR(TH)                        \
  if (want <= 4) SG_LAUNCH(TH, 4);           \
  else if (want <= 8) SG_LAUNCH(TH, 8);      \
  else if (want <= 16) SG_LAUNCH(TH, 16);    \
  else SG_LAUNCH(TH, 32)
  if (h_bf16) { SG_BY_LPR(__nv_bfloat16); }
  else { SG_BY_LPR(float); }
#undef SG_BY_LPR
#undef SG_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  (void)n_rows;  // a split row is a row of the matrix: fin_row < n_rows
  return (int)launch_sum_split_rows(partial, fin_row, fin_p0, fin_np, n_fin, P, out, stream);
}
