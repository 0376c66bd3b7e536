// The split rows of the plan SpMM kernel K9 (plan_spmm_gather.cu): a row
// whose run of slots is cut into several pieces (ops/bsr.RunSegments over
// rows) leaves one f32 partial row a piece, and sum_split_rows adds each split
// row's partials into its output row.
//
// The sum's order is fixed, so a row comes out the same bits on every run:
// for each feature, the partials q of residue w (q = w mod FIN_RESIDUES) are summed in increasing q from 0.f, for w = 0 ..
// FIN_RESIDUES - 1, and the residues' sums are added in w order to a total
// that starts at 0.f. Adds only: there is no product for FMA contraction to
// fuse.
//
// Bound on the H100: bytes, each partial read once and each split row written
// once. On a power-law graph most split rows hold 2-4 partials, so a row is
// little work and many rows must be in flight: a warp owns one split row and
// all its features (8 rows a block), lane l holding features
// f0 + 8 l .. + 8 of each 256-wide slice, read as two 16-byte loads where P %
// 4 == 0 and the rows are 16-byte aligned (eight scalar loads of features f0 +
// l + 32 e otherwise), so a partial row is one coalesced read of the warp; and
// the warp starts the loads of FIN_AHEAD partials before it adds any of them,
// so a hub's partials are a short chain of round trips. On an H100 at the
// 2^20-node products graph (158 K split rows, 503 K partials, P = 256): 0.27 ms
// a launch against 0.20 for its bytes (a block a (row, 32 features): 1.80).
// The plan attention's backward (plan_gat.cu) sums its split rows with the same
// kernel; its forward merges them with merge_split_attention, below.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sg {
namespace planspmm {

constexpr int FIN_WARPS = 8;     // split rows a block, one a warp
constexpr int FIN_RESIDUES = 8;  // the sum's order: partials by their index mod 8
constexpr int FIN_AHEAD = 8;     // partial rows a warp loads before it adds them
constexpr int FIN_SLICE = 256;   // features a warp covers in one pass: 8 a lane

// Reads a lane's 8 features of ``row`` from slice f0; features past P read as
// zero. VEC: features f0 + 8 lane + e in two 16-byte loads (P % 4 == 0 keeps a
// group of four wholly inside the row or wholly past it); else f0 + lane + 32 e.
template <bool VEC>
__device__ __forceinline__ void fin_load(const float* __restrict__ row, int f0, int lane, int P,
                                         float (&v)[8]) {
  if constexpr (VEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + 8 * lane + 4 * h;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (f < P) x = *reinterpret_cast<const float4*>(row + f);
      v[4 * h] = x.x;
      v[4 * h + 1] = x.y;
      v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int f = f0 + lane + 32 * e;
      v[e] = f < P ? row[f] : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void fin_store(float* __restrict__ row, int f0, int lane, int P,
                                          const float (&v)[8]) {
  if constexpr (VEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + 8 * lane + 4 * h;
      if (f < P)
        *reinterpret_cast<float4*>(row + f) =
            make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int f = f0 + lane + 32 * e;
      if (f < P) row[f] = v[e];
    }
  }
}

// Warp i of block b sums split row b * FIN_WARPS + i: its fin_np partials from
// partial row fin_p0, into out row fin_row. The walk takes the partials in the
// sum's order, residue by residue; a partial q opens its residue's sum where q
// < FIN_RESIDUES and closes it where q + FIN_RESIDUES >= np.
template <bool VEC>
static __global__ void __launch_bounds__(32 * FIN_WARPS)
    sum_split_rows(const float* __restrict__ partial, const int* __restrict__ fin_row,
                   const int* __restrict__ fin_p0, const int* __restrict__ fin_np, int n_fin, int P,
                   float* __restrict__ out) {
  const int i = blockIdx.x * FIN_WARPS + (threadIdx.x >> 5);
  if (i >= n_fin) return;
  const int lane = threadIdx.x & 31;
  const int np = fin_np[i];
  const float* src = partial + (long)fin_p0[i] * P;
  float* dst = out + (long)fin_row[i] * P;
  for (int f0 = 0; f0 < P; f0 += FIN_SLICE) {
    float total[8], acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) total[e] = acc[e] = 0.f;
    int q = 0;  // the next partial in the sum's order
    for (int left = np; left > 0; left -= FIN_AHEAD) {
      float v[FIN_AHEAD][8];
      int qs[FIN_AHEAD];
#pragma unroll
      for (int u = 0; u < FIN_AHEAD; ++u) {
        qs[u] = q;
        if (u < left) {
          fin_load<VEC>(src + (long)q * P, f0, lane, P, v[u]);
          q += FIN_RESIDUES;
          if (q >= np) q = q % FIN_RESIDUES + 1;  // the next residue's first
        }
      }
#pragma unroll
      for (int u = 0; u < FIN_AHEAD; ++u) {
        if (u >= left) break;
        if (qs[u] < FIN_RESIDUES) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += v[u][e];
        if (qs[u] + FIN_RESIDUES >= np) {
#pragma unroll
          for (int e = 0; e < 8; ++e) total[e] += acc[e];
        }
      }
    }
    // a residue without a partial (np < FIN_RESIDUES) would add 0.f: that
    // changes no total, which starts at 0.f and so is never -0.f
    fin_store<VEC>(dst, f0, lane, P, total);
  }
}

// Launches sum_split_rows over the n_fin split rows (none: nothing), with the
// 16-byte loads where the widths and addresses allow them.
static cudaError_t launch_sum_split_rows(const float* partial, const int* fin_row,
                                         const int* fin_p0, const int* fin_np, int n_fin, int P,
                                         float* out, cudaStream_t stream) {
  if (n_fin == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n_fin + FIN_WARPS - 1) / FIN_WARPS);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(partial) | reinterpret_cast<uintptr_t>(out);
  const bool vec = P % 4 == 0 && addr % 16 == 0;
  if (vec)
    sum_split_rows<true><<<blocks, 32 * FIN_WARPS, 0, stream>>>(partial, fin_row, fin_p0, fin_np,
                                                                n_fin, P, out);
  else
    sum_split_rows<false><<<blocks, 32 * FIN_WARPS, 0, stream>>>(partial, fin_row, fin_p0, fin_np,
                                                                 n_fin, P, out);
  return cudaGetLastError();
}

// The split rows of the plan attention's forward (plan_gat.cu): each piece of
// a split row leaves its running softmax per head, an unnormalised f32 sum
// acc [H, Fp] with its max m and denominator l, and merge_split_attention
// combines them as the flash kernels combine their blocks: M = max_q m_q,
// then in piece order from q = 0, L += l_q e^(m_q - M) and ACC += acc_q
// e^(m_q - M), out = ACC / L (0 where L is 0), with M and L kept as the row's
// statistics for the backward. A piece without an attended slot has m = -inf
// and adds nothing. A warp per split row, lane l holding features f0 + 8 l ..
// + 8 of each 256-wide slice (two 16-byte loads: Fp % 8 == 0 keeps a lane's
// features inside one head and the rows 32-byte aligned).
static __global__ void __launch_bounds__(32 * FIN_WARPS)
    merge_split_attention(const float* __restrict__ pacc, const float* __restrict__ pm,
                          const float* __restrict__ pl, const int* __restrict__ fin_row,
                          const int* __restrict__ fin_p0, const int* __restrict__ fin_np,
                          int n_fin, int H, int Fp, float* __restrict__ out,
                          float* __restrict__ m_out, float* __restrict__ l_out) {
  const int i = blockIdx.x * FIN_WARPS + (threadIdx.x >> 5);
  if (i >= n_fin) return;
  const int lane = threadIdx.x & 31;
  const int np = fin_np[i], p0 = fin_p0[i], row = fin_row[i];
  const int P = H * Fp;
  for (int f0 = 0; f0 < P; f0 += FIN_SLICE) {
    const int f = f0 + 8 * lane;
    const bool mine = f < P;
    const int h = mine ? f / Fp : 0;
    float M = -INFINITY;
    for (int q = 0; q < np; ++q) M = fmaxf(M, pm[(long)(p0 + q) * H + h]);
    float L = 0.f, acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int q = 0; q < np; ++q) {
      const long p = p0 + q;
      const float a = M == -INFINITY ? 0.f : __expf(pm[p * H + h] - M);
      L += a * pl[p * H + h];
      if (mine) {
        const float4 x0 = *reinterpret_cast<const float4*>(pacc + p * P + f);
        const float4 x1 = *reinterpret_cast<const float4*>(pacc + p * P + f + 4);
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(a, x[e], acc[e]);
      }
    }
    if (!mine) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = L > 0.f ? acc[e] / L : 0.f;
    float* dst = out + (long)row * P + f;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
    if (f == h * Fp) {  // the head's first lane
      m_out[(long)row * H + h] = M;
      l_out[(long)row * H + h] = L;
    }
  }
}

static cudaError_t launch_merge_split_attention(const float* pacc, const float* pm,
                                                const float* pl, const int* fin_row,
                                                const int* fin_p0, const int* fin_np, int n_fin,
                                                int H, int Fp, float* out, float* m_out,
                                                float* l_out, cudaStream_t stream) {
  if (n_fin == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n_fin + FIN_WARPS - 1) / FIN_WARPS);
  merge_split_attention<<<blocks, 32 * FIN_WARPS, 0, stream>>>(pacc, pm, pl, fin_row, fin_p0,
                                                              fin_np, n_fin, H, Fp, out, m_out,
                                                              l_out);
  return cudaGetLastError();
}

}  // namespace planspmm
}  // namespace sg
