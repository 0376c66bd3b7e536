// The split rows of the plan SpMM kernels K9 (plan_spmm.cu and
// plan_spmm_gather.cu): a row whose run of slots is cut into several pieces
// (ops/bsr.RunSegments over rows) leaves one f32 partial row a piece, which
// finalize_rows sums in a fixed order.
#pragma once

#include <cuda_runtime.h>

namespace sg {
namespace planspmm {

// Sums the partials of each split row in a fixed order: a block owns
// (split row, 32 features); its 8 warps sum every 8th partial each, then
// warp 0 adds the 8 sums in warp order. A hub row's thousands of partials
// are a chain 8 times shorter than one thread's, and a warp keeps four of
// its loads in flight ahead of the adds.
constexpr int FIN_WARPS = 8;

static __global__ void __launch_bounds__(32 * FIN_WARPS)
    finalize_rows(const float* partial, const int* fin_row, const int* fin_p0, const int* fin_np,
                  int P, float* out) {
  __shared__ float sums[FIN_WARPS][32];
  const int f = blockIdx.x;
  const int p = blockIdx.y * 32 + (threadIdx.x & 31);
  const int w = threadIdx.x >> 5;
  const int q0 = fin_p0[f], np = fin_np[f];
  float acc = 0.f;
  if (p < P) {
    const float* src = partial + (long)q0 * P + p;
    int q = w;
    for (; q + 3 * FIN_WARPS < np; q += 4 * FIN_WARPS) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = src[(long)(q + j * FIN_WARPS) * P];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc += v[j];
    }
    for (; q < np; q += FIN_WARPS) acc += src[(long)q * P];
  }
  sums[w][threadIdx.x & 31] = acc;
  __syncthreads();
  if (w == 0 && p < P) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < FIN_WARPS; ++i) total += sums[i][threadIdx.x];
    out[(long)fin_row[f] * P + p] = total;
  }
}

}  // namespace planspmm
}  // namespace sg
