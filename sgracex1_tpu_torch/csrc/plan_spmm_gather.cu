// Plan SpMM on Hopper, gather design: out = A @ H over the live slots of an
// SpMMPlan (ops/pallas_spmm.py), each slot an edge (row, col, val).
//
// Replaces sgracex1_tpu/ops/pallas_spmm.py:spmm_pallas (Pallas kernel
// _spmm_kernel) at every width. It reads H as bf16 rows of whole 16-byte
// pieces (P % 8 == 0, 16-byte aligned); the host pads any other H with zero
// columns to a multiple of 8 first (ops/pallas_spmm._gather_operand), which
// leaves the other columns' bits as they are.
//
// Bound on the H100: bytes, and before that latency. At the 2^20-node slice
// a row holds ~5 slots, so a worker's time is its chain of memory round
// trips, not its arithmetic. Read through the padded group arrays, a slot
// is three dependent loads (slot_idx, then lcol / val / tile_cb, then the H
// row), and an f32 row is 512 bytes at P = 128. Here:
//  * the host compacts every live slot into one 8-byte (column, value) pair
//    in row order (SpMMPlan.slot_cv), so the indices are one coalesced read
//    that depends on nothing;
//  * a block stages the bounds of 256 consecutive row pieces in shared
//    memory in one pass, and a worker of G lanes (G * 8 >= P, at most a warp)
//    walks the slots of G consecutive pieces as one contiguous run: it loads
//    a window of pairs in one read, hands them out by shuffle, loads the next
//    window while it issues the row gathers of U slots, and only then sums
//    them, so a worker keeps U rows and a window of pairs in flight across
//    row boundaries (a worker of one piece waits out that piece's chain of
//    bounds, pairs and rows at every piece: on an H100 at the 2^20-node
//    slice, P = 128, 0.77 ms a call against 0.54 for this walk);
//  * H is rounded to bf16 once by the ring kernels' pre-pass (sg_stage_h):
//    bf16(H) is the TPU kernel's first rounding, so the output is the same,
//    and a gathered row is 256 bytes at P = 128, 16 bytes a lane.
// Sums stay in slot order in each lane, so a row's result is the same on
// every run. A row of one piece is written directly; the pieces of a split
// row (a hub) leave f32 partials that sum_split_rows (plan_rows.cuh) adds in
// a fixed order.
//
// Rounding points are those of the TPU kernel: H to bf16, the weighted row
// f32(bf16(H)) * val to bf16 again, sums in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "plan_rows.cuh"

namespace sg {
namespace plangather {

constexpr int NTHREADS = 256;
constexpr int SEGS = 256;  // row pieces a block: each worker walks SEGS / (NTHREADS / G) = G of them
constexpr int U = 8;       // row gathers in flight per worker

// Stores a worker lane's 8 sums (features f .. f + 8) to dst where the lane
// holds features (``mine``). With ``pair`` (P % 16 == 0: an even/odd lane
// pair holds features together or not at all), the pair swaps halves first,
// every lane of the worker taking part, so that each store instruction fills
// whole 32-byte sectors: the even lane writes f .. f + 4 and f + 8 .. f + 12,
// the odd one the rest.
__device__ __forceinline__ void store8(float* dst, int f, const float (&a)[8], bool pair, bool odd,
                                       bool mine, unsigned mask) {
  if (pair) {
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = __shfl_xor_sync(mask, odd ? a[e] : a[4 + e], 1);
    if (!mine) return;
    if (odd) {
      *reinterpret_cast<float4*>(dst + f - 4) = make_float4(r[0], r[1], r[2], r[3]);
      *reinterpret_cast<float4*>(dst + f + 4) = make_float4(a[4], a[5], a[6], a[7]);
    } else {
      *reinterpret_cast<float4*>(dst + f) = make_float4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<float4*>(dst + f + 8) = make_float4(r[0], r[1], r[2], r[3]);
    }
  } else if (mine) {
    *reinterpret_cast<float4*>(dst + f) = make_float4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<float4*>(dst + f + 4) = make_float4(a[4], a[5], a[6], a[7]);
  }
}

// G lanes a worker; lane ``sub`` holds features f0 + 8 sub .. + 8 of each
// 8G-wide feature slice. A block owns SEGS consecutive row pieces, whose
// bounds, rows and partial slots it stages in shared memory in one pass; a
// worker owns G consecutive pieces, whose slots are one contiguous run of
// slot_cv. It walks that run in windows of ROUND slots (R pairs a lane,
// lane sub holding slots sub, sub + G, ...), loading the next window's pairs
// before it gathers the current one's rows, U at a time, and sums them in
// slot order, writing a piece's row (or partial) when the walk passes its end.
template <int G>
__global__ void __launch_bounds__(NTHREADS)
    plan_gather_kernel(const int2* __restrict__ cv, int n_seg, const int* __restrict__ seg_row,
                       const int* __restrict__ seg_lo, const int* __restrict__ seg_hi,
                       const int* __restrict__ seg_part, const __nv_bfloat16* __restrict__ Hs, int P,
                       float* __restrict__ out, float* __restrict__ partial) {
  constexpr int R = U / G > 0 ? U / G : 1;
  constexpr int ROUND = G * R;
  __shared__ int s_hi[SEGS], s_dst[SEGS];  // s_dst: partial slot, or -1 - row
  const long seg0 = (long)blockIdx.x * SEGS;
  for (int i = threadIdx.x; i < SEGS; i += NTHREADS) {
    const long s = seg0 + i;
    if (s < n_seg) {
      s_hi[i] = seg_hi[s];
      s_dst[i] = seg_part[s] >= 0 ? seg_part[s] : -1 - seg_row[s];
    }
  }
  const int w = threadIdx.x / G;
  const int j0 = w * G;  // the worker's first piece in the block
  const int jend = (int)min((long)j0 + G, (long)n_seg - seg0);
  const int lo = j0 < jend ? seg_lo[seg0 + j0] : 0;
  __syncthreads();
  if (j0 >= jend) return;  // the lanes of one worker leave together
  const int end = s_hi[jend - 1];
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const unsigned mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
  const bool pair = G > 1 && P % 16 == 0;
  const bool odd = (sub & 1) != 0;
  for (int f0 = 0; f0 < P; f0 += 8 * G) {
    const int f = f0 + 8 * sub;
    const bool mine = f < P;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    int cur = j0, cur_hi = s_hi[j0];
    // the piece ``cur`` is summed: write it, go to the next
    auto flush = [&]() {
      const int d = s_dst[cur];
      float* dst = d >= 0 ? partial + (long)d * P : out + (long)(-1 - d) * P;
      store8(dst, f, acc, pair, odd, mine, mask);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
      ++cur;
      cur_hi = cur < jend ? s_hi[cur] : 0x7fffffff;
    };
    int2 nx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = lo + sub + G * r;
      nx[r] = s < end ? cv[s] : make_int2(0, 0);
    }
    for (int s0 = lo; s0 < end; s0 += ROUND) {
      int2 pr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pr[r] = nx[r];
        const int s = s0 + ROUND + sub + G * r;  // the next window's pairs, loaded ahead
        nx[r] = s < end ? cv[s] : make_int2(0, 0);
      }
#pragma unroll
      for (int b = 0; b < ROUND; b += U) {
        if (s0 + b >= end) break;  // the same for every lane of the worker
        uint4 h[U];
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int idx = b + u;
          const int col = __shfl_sync(mask, pr[idx / G].x, idx % G, G);
          v[u] = __int_as_float(__shfl_sync(mask, pr[idx / G].y, idx % G, G));
          h[u] = make_uint4(0u, 0u, 0u, 0u);
          if (mine && s0 + idx < end)
            h[u] = __ldg(reinterpret_cast<const uint4*>(Hs + (long)col * P + f));
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int s = s0 + b + u;
          if (s >= end) break;
          while (s >= cur_hi) flush();  // the pieces that end before this slot
          const uint32_t wd[4] = {h[u].x, h[u].y, h[u].z, h[u].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // bf16 pair -> f32 exactly, times the value in f32, rounded to bf16
            const float lo_f = __uint_as_float(wd[q] << 16);
            const float hi_f = __uint_as_float(wd[q] & 0xffff0000u);
            const __nv_bfloat162 p2 = __floats2bfloat162_rn(lo_f * v[u], hi_f * v[u]);
            acc[2 * q] += __low2float(p2);
            acc[2 * q + 1] += __high2float(p2);
          }
        }
      }
    }
    while (cur < jend) flush();  // the last piece, and pieces without a slot
  }
}

template <int G>
static cudaError_t launch(const int2* cv, int n_seg, const int* seg_row, const int* seg_lo,
                          const int* seg_hi, const int* seg_part, const __nv_bfloat16* Hs, int P,
                          float* out, float* partial, cudaStream_t stream) {
  const unsigned blocks = (unsigned)(((long)n_seg + SEGS - 1) / SEGS);
  plan_gather_kernel<G><<<blocks, NTHREADS, 0, stream>>>(cv, n_seg, seg_row, seg_lo, seg_hi,
                                                         seg_part, Hs, P, out, partial);
  return cudaGetLastError();
}

}  // namespace plangather
}  // namespace sg

// ``cv`` is the plan's slot_cv ([nnz] pairs of column and f32 value bits, in
// row order), ``Hs`` bf16 [>= n_cols, P] with P % 8 == 0 and 16-byte-aligned
// rows. Returns the cudaError_t of the launches (0 on success).
extern "C" int sg_plan_spmm_gather(const void* cv, int n_seg, const int* seg_row,
                                   const int* seg_lo, const int* seg_hi, const int* seg_part,
                                   int n_fin, const int* fin_row, const int* fin_p0,
                                   const int* fin_np, const void* Hs, int P, float* out,
                                   float* partial, void* stream_ptr) {
  using namespace sg;
  if (P < 8 || P % 8) return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int2* c = static_cast<const int2*>(cv);
  const __nv_bfloat16* h = static_cast<const __nv_bfloat16*>(Hs);
  // lanes a worker: the power of two whose 16-byte pieces cover P, at most a
  // warp (wider rows take several 256-feature slices)
  const int pieces = P / 8;
  cudaError_t err;
#define SG_GATHER(G) \
  plangather::launch<G>(c, n_seg, seg_row, seg_lo, seg_hi, seg_part, h, P, out, partial, stream)
  if (pieces <= 1) err = SG_GATHER(1);
  else if (pieces <= 2) err = SG_GATHER(2);
  else if (pieces <= 4) err = SG_GATHER(4);
  else if (pieces <= 8) err = SG_GATHER(8);
  else if (pieces <= 16) err = SG_GATHER(16);
  else err = SG_GATHER(32);
#undef SG_GATHER
  if (err != cudaSuccess) return (int)err;
  return (int)planspmm::launch_sum_split_rows(partial, fin_row, fin_p0, fin_np, n_fin, P, out,
                                              stream);
}
