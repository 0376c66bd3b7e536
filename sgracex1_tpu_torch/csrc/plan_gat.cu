// GAT attention on the plan SpMM's edge schedule (ops/plan_gat.py): the
// forward and the backward's row and column passes over the live slots of an
// SpMMPlan, with no tile mask, so a graph without id locality costs its edges
// and nothing more.
//
//     out[r, h] = sum_c p[r, c, h] Wh[c, h],   p = softmax_c(LeakyReLU(s1[r, h] + s2[c, h]))
//
// over the slots (r, c) that the attention takes: a slot whose value is > 0
// and, with self_loops, not on the diagonal, plus one virtual self slot (r, r)
// a row where self_loops is set (a graph's stored self-loops are replaced by
// one a node, whatever their values, as PyTorch Geometric's GATConv adds them).
//
// Schedule: the plan's compacted slots (SpMMPlan.slot_cv, (column, value) in
// row order) cut into row pieces of at most ROW_SEG_SLOTS slots
// (ops/bsr.RunSegments). A warp owns one piece and covers the row's features
// H * Fp in slices of 256, lane l holding features f0 + 8 l .. + 8 of a slice
// (Fp, the staged head width, is a multiple of 8, so a lane's features lie in
// one head, and the host keeps every head inside one slice). Per slice the warp
// reads a window of 32 (column, value) pairs in one load, hands them out by
// shuffle, issues the 16-byte row gathers of U slots, then folds them in, so U
// rows are in flight a warp. The virtual self slot opens the row's first piece
// (the first piece is the one whose predecessor holds another row).
//
// Forward (plan): a running softmax per lane and head (max m, denominator l,
// f32 accumulator), the rows of Wh staged once as bf16 (the gathered operand),
// scores and exponentials in f32. A row of one piece writes out = acc / l and
// its (m, l); the pieces of a split row write (acc, m, l) partials that
// merge_split_attention (plan_rows.cuh) combines in piece order.
//
// Backward, the softmax-Jacobian identity of flash_gat_backward, with p
// recomputed from the forward's (m, l) and q = gO[r, h] . Wh[c, h] (bf16 rows,
// f32 products summed over the head's lanes in a fixed tree):
//  * rows (plan): per row, t = sum p q, u1 = sum p q lr', u2 = sum p lr'
//    (lr' the LeakyReLU's slope at the score), so ds1 = u1 - t u2;
//  * columns (plan_t, whose rows are the columns): per column c,
//    dWh[c] = sum_r p gO[r] and ds2[c] = sum_r p (q - t[r]) lr'.
// Their split rows leave f32 partials that sum_split_rows adds in its fixed
// order. No per-edge tensor exists: each pass reads a slot's pair, one row of
// bf16 features and a few per-row scalars.
//
// Bound on the H100: bytes, the gathered rows (2 H Fp bytes a slot a pass).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "plan_rows.cuh"

namespace sg {
namespace plangat {

constexpr int WARPS = 8;    // row pieces a block, one a warp
constexpr int SLICE = 256;  // features a warp covers in one walk: 8 a lane
constexpr int U = 8;        // row gathers in flight a warp
constexpr unsigned FULL = 0xffffffffu;

// A lane's features in one slice: the first of its 8 (f), whether they exist
// (mine), their head (h) and the lanes [g0, gend) that hold that head.
struct Lane {
  int f, h, g0, gend;
  bool mine;
};

__device__ __forceinline__ Lane lane_of(int f0, int lane, int H, int Fp) {
  Lane g;
  g.f = f0 + 8 * lane;
  g.mine = g.f < H * Fp;
  if (g.mine) {
    g.h = g.f / Fp;
    g.g0 = (max(g.h * Fp, f0) - f0) / 8;
    g.gend = (min((g.h + 1) * Fp, f0 + SLICE) - f0) / 8;
  } else {
    g.h = 0;
    g.g0 = lane;
    g.gend = lane + 1;
  }
  return g;
}

// The sum of x over the lanes of this lane's head, on every lane of the head:
// a tree clipped at the head's end (lane i ends with lanes i .. gend - 1), then
// the head's first lane's sum broadcast. Every lane of the warp takes part.
__device__ __forceinline__ float head_sum(float x, const Lane& g, int lane, int lph) {
  for (int off = 1; off < lph; off <<= 1) {
    const float y = __shfl_down_sync(FULL, x, off);
    if (lane + off < g.gend) x += y;
  }
  return __shfl_sync(FULL, x, g.g0);
}

__device__ __forceinline__ void unpack8(const uint4 w, float (&x)[8]) {
  const uint32_t wd[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    x[2 * q] = __uint_as_float(wd[q] << 16);
    x[2 * q + 1] = __uint_as_float(wd[q] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 row8(const __nv_bfloat16* base, long row, int P, const Lane& g) {
  if (!g.mine) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(base + row * P + g.f));
}

__device__ __forceinline__ void store8(float* dst, const float (&a)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(a[4], a[5], a[6], a[7]);
}

// Walks one piece's attended slots: the virtual self slot first where
// ``self_first``, then slots lo .. hi of ``cv`` in order, skipping those the
// attention does not take. ``gather(u, col)`` issues slot u's loads (u < U;
// the self slot is u = 0 alone), ``fold(u, col)`` consumes them, after every
// gather of its batch. All lanes of the warp call both with the same slots.
template <class Gather, class Fold>
__device__ __forceinline__ void walk(const int2* __restrict__ cv, int lo, int hi, int row,
                                     bool self_first, bool self_loops, int lane, Gather&& gather,
                                     Fold&& fold) {
  if (self_first) {
    gather(0, row);
    fold(0, row);
  }
  int2 nx = lo + lane < hi ? cv[lo + lane] : make_int2(0, 0);
  for (int s0 = lo; s0 < hi; s0 += 32) {
    const int2 pr = nx;
    nx = s0 + 32 + lane < hi ? cv[s0 + 32 + lane] : make_int2(0, 0);  // the next window's pairs
    const int nwin = min(32, hi - s0);
    for (int b = 0; b < nwin; b += U) {
      int col[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = (b + u) & 31;
        col[u] = __shfl_sync(FULL, pr.x, idx);
        const float val = __int_as_float(__shfl_sync(FULL, pr.y, idx));
        ok[u] = b + u < nwin && val > 0.f && !(self_loops && col[u] == row);
        if (ok[u]) gather(u, col[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) fold(u, col[u]);
    }
  }
}

__device__ __forceinline__ bool first_piece(const int* seg_row, int w, int row) {
  return w == 0 || seg_row[w - 1] != row;
}

__device__ __forceinline__ float lrelu(float x, float alpha) { return x > 0.f ? x : alpha * x; }

__global__ void __launch_bounds__(32 * WARPS)
    plan_gat_fwd_kernel(const int2* __restrict__ cv, int n_seg, const int* __restrict__ seg_row,
                        const int* __restrict__ seg_lo, const int* __restrict__ seg_hi,
                        const int* __restrict__ seg_part, const __nv_bfloat16* __restrict__ Whs,
                        const float* __restrict__ s1, const float* __restrict__ s2, int H, int Fp,
                        float alpha, int self_loops, float* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ pacc, float* __restrict__ pm,
                        float* __restrict__ pl) {
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= n_seg) return;  // the lanes of one warp leave together
  const int lane = threadIdx.x & 31;
  const int row = seg_row[w], part = seg_part[w];
  const bool self_first = self_loops && first_piece(seg_row, w, row);
  const int P = H * Fp;
  for (int f0 = 0; f0 < P; f0 += SLICE) {
    const Lane g = lane_of(f0, lane, H, Fp);
    const float s1r = g.mine ? s1[(long)row * H + g.h] : 0.f;
    float m = -INFINITY, l = 0.f, acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    uint4 wv[U];
    float s2c[U];
    auto gather = [&](int u, int col) {
      wv[u] = row8(Whs, col, P, g);
      s2c[u] = g.mine ? __ldg(s2 + (long)col * H + g.h) : 0.f;
    };
    auto fold = [&](int u, int) {
      const float e = lrelu(s1r + s2c[u], alpha);
      if (e > m) {  // a new running max: rescale what is summed
        const float a = __expf(m - e);
        l *= a;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] *= a;
        m = e;
      }
      const float p = __expf(e - m);
      l += p;
      float x[8];
      unpack8(wv[u], x);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = fmaf(p, x[k], acc[k]);
    };
    walk(cv, seg_lo[w], seg_hi[w], row, self_first, self_loops != 0, lane, gather, fold);
    if (!g.mine) continue;
    const bool head_lane = lane == g.g0;
    if (part < 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = l > 0.f ? acc[k] / l : 0.f;
      store8(out + (long)row * P + g.f, acc);
      if (head_lane) {
        m_out[(long)row * H + g.h] = m;
        l_out[(long)row * H + g.h] = l;
      }
    } else {
      store8(pacc + (long)part * P + g.f, acc);
      if (head_lane) {
        pm[(long)part * H + g.h] = m;
        pl[(long)part * H + g.h] = l;
      }
    }
  }
}

__global__ void __launch_bounds__(32 * WARPS)
    plan_gat_bwd_rows_kernel(const int2* __restrict__ cv, int n_seg,
                             const int* __restrict__ seg_row, const int* __restrict__ seg_lo,
                             const int* __restrict__ seg_hi, const int* __restrict__ seg_part,
                             const __nv_bfloat16* __restrict__ Whs,
                             const __nv_bfloat16* __restrict__ gOs, const float* __restrict__ s1,
                             const float* __restrict__ s2, const float* __restrict__ m,
                             const float* __restrict__ l, int H, int Fp, float alpha,
                             int self_loops, float* __restrict__ tuu,
                             float* __restrict__ ptuu) {
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= n_seg) return;
  const int lane = threadIdx.x & 31;
  const int row = seg_row[w], part = seg_part[w];
  const bool self_first = self_loops && first_piece(seg_row, w, row);
  const int P = H * Fp, lph = Fp / 8;
  for (int f0 = 0; f0 < P; f0 += SLICE) {
    const Lane g = lane_of(f0, lane, H, Fp);
    float go[8];
    unpack8(row8(gOs, row, P, g), go);
    const long rh = (long)row * H + g.h;
    const float s1r = g.mine ? s1[rh] : 0.f;
    const float mr = g.mine ? m[rh] : 0.f;
    const float lr = g.mine ? l[rh] : 0.f;
    const float il = lr > 0.f ? 1.f / lr : 0.f;
    float t = 0.f, u1 = 0.f, u2 = 0.f;
    uint4 wv[U];
    float s2c[U];
    auto gather = [&](int u, int col) {
      wv[u] = row8(Whs, col, P, g);
      s2c[u] = g.mine ? __ldg(s2 + (long)col * H + g.h) : 0.f;
    };
    auto fold = [&](int u, int) {
      float x[8];
      unpack8(wv[u], x);
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) dot = fmaf(go[k], x[k], dot);
      const float q = head_sum(dot, g, lane, lph);
      const float pre = s1r + s2c[u];
      const float d = pre > 0.f ? 1.f : alpha;
      const float p = __expf(lrelu(pre, alpha) - mr) * il;
      const float pq = p * q;
      t += pq;
      u1 = fmaf(pq, d, u1);
      u2 = fmaf(p, d, u2);
    };
    walk(cv, seg_lo[w], seg_hi[w], row, self_first, self_loops != 0, lane, gather, fold);
    if (!g.mine || lane != g.g0) continue;
    float* dst = part < 0 ? tuu + (long)row * 3 * H : ptuu + (long)part * 3 * H;
    dst[g.h] = t;
    dst[H + g.h] = u1;
    dst[2 * H + g.h] = u2;
  }
}

// st: [n, H] float4 of the rows' (s1, m, 1 / l or 0, t), one 16-byte load a
// gathered row and head.
__global__ void __launch_bounds__(32 * WARPS)
    plan_gat_bwd_cols_kernel(const int2* __restrict__ cv, int n_seg,
                             const int* __restrict__ seg_row, const int* __restrict__ seg_lo,
                             const int* __restrict__ seg_hi, const int* __restrict__ seg_part,
                             const __nv_bfloat16* __restrict__ Whs,
                             const __nv_bfloat16* __restrict__ gOs,
                             const float4* __restrict__ st, const float* __restrict__ s2, int H,
                             int Fp, float alpha, int self_loops, float* __restrict__ dwh,
                             float* __restrict__ ds2, float* __restrict__ pdwh,
                             float* __restrict__ pds2) {
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= n_seg) return;
  const int lane = threadIdx.x & 31;
  const int col = seg_row[w], part = seg_part[w];  // plan_t's rows are the columns
  const bool self_first = self_loops && first_piece(seg_row, w, col);
  const int P = H * Fp, lph = Fp / 8;
  for (int f0 = 0; f0 < P; f0 += SLICE) {
    const Lane g = lane_of(f0, lane, H, Fp);
    float wh[8];
    unpack8(row8(Whs, col, P, g), wh);
    const float s2c = g.mine ? s2[(long)col * H + g.h] : 0.f;
    float acc[8], ds = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    uint4 gv[U];
    float4 sr[U];
    auto gather = [&](int u, int r) {
      gv[u] = row8(gOs, r, P, g);
      sr[u] = g.mine ? __ldg(st + (long)r * H + g.h) : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    auto fold = [&](int u, int) {
      float x[8];
      unpack8(gv[u], x);
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) dot = fmaf(x[k], wh[k], dot);
      const float q = head_sum(dot, g, lane, lph);
      const float pre = sr[u].x + s2c;
      const float d = pre > 0.f ? 1.f : alpha;
      const float p = __expf(lrelu(pre, alpha) - sr[u].y) * sr[u].z;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = fmaf(p, x[k], acc[k]);
      ds = fmaf(p * (q - sr[u].w), d, ds);
    };
    walk(cv, seg_lo[w], seg_hi[w], col, self_first, self_loops != 0, lane, gather, fold);
    if (!g.mine) continue;
    store8((part < 0 ? dwh + (long)col * P : pdwh + (long)part * P) + g.f, acc);
    if (lane == g.g0) (part < 0 ? ds2 + (long)col * H : pds2 + (long)part * H)[g.h] = ds;
  }
}

// The host's layout rule: Fp % 8 == 0, at most one slice a head, no head
// across two slices.
static bool shape_ok(int H, int Fp) {
  return H >= 1 && Fp >= 8 && Fp % 8 == 0 && Fp <= SLICE && (H * Fp <= SLICE || SLICE % Fp == 0);
}

static unsigned blocks_of(int n_seg) { return (unsigned)(((long)n_seg + WARPS - 1) / WARPS); }

}  // namespace plangat
}  // namespace sg

// Each entry takes a plan's slot_cv and RunSegments arrays (seg_row is the
// segments' seg_rb, fin_row their fin_rb), bf16 operands of [n, H * Fp]
// and f32 scores [n, H]; partial buffers hold n_part rows (at least one).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int sg_plan_gat_fwd(const void* cv, int n_seg, const int* seg_row, const int* seg_lo,
                               const int* seg_hi, const int* seg_part, int n_fin,
                               const int* fin_row, const int* fin_p0, const int* fin_np,
                               const void* Whs, const float* s1, const float* s2, int H, int Fp,
                               float alpha, int self_loops, float* out, float* m_out,
                               float* l_out, float* pacc, float* pm, float* pl,
                               void* stream_ptr) {
  using namespace sg;
  if (!plangat::shape_ok(H, Fp)) return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  plangat::plan_gat_fwd_kernel<<<plangat::blocks_of(n_seg), 32 * plangat::WARPS, 0, stream>>>(
      static_cast<const int2*>(cv), n_seg, seg_row, seg_lo, seg_hi, seg_part,
      static_cast<const __nv_bfloat16*>(Whs), s1, s2, H, Fp, alpha, self_loops, out, m_out, l_out,
      pacc, pm, pl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)planspmm::launch_merge_split_attention(pacc, pm, pl, fin_row, fin_p0, fin_np, n_fin,
                                                     H, Fp, out, m_out, l_out, stream);
}

extern "C" int sg_plan_gat_bwd_rows(const void* cv, int n_seg, const int* seg_row,
                                    const int* seg_lo, const int* seg_hi, const int* seg_part,
                                    int n_fin, const int* fin_row, const int* fin_p0,
                                    const int* fin_np, const void* Whs, const void* gOs,
                                    const float* s1, const float* s2, const float* m,
                                    const float* l, int H, int Fp, float alpha, int self_loops,
                                    float* tuu, float* ptuu, void* stream_ptr) {
  using namespace sg;
  if (!plangat::shape_ok(H, Fp)) return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  plangat::plan_gat_bwd_rows_kernel<<<plangat::blocks_of(n_seg), 32 * plangat::WARPS, 0,
                                      stream>>>(
      static_cast<const int2*>(cv), n_seg, seg_row, seg_lo, seg_hi, seg_part,
      static_cast<const __nv_bfloat16*>(Whs), static_cast<const __nv_bfloat16*>(gOs), s1, s2, m,
      l, H, Fp, alpha, self_loops, tuu, ptuu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)planspmm::launch_sum_split_rows(ptuu, fin_row, fin_p0, fin_np, n_fin, 3 * H, tuu,
                                              stream);
}

extern "C" int sg_plan_gat_bwd_cols(const void* cv, int n_seg, const int* seg_row,
                                    const int* seg_lo, const int* seg_hi, const int* seg_part,
                                    int n_fin, const int* fin_row, const int* fin_p0,
                                    const int* fin_np, const void* Whs, const void* gOs,
                                    const void* st, const float* s2, int H, int Fp, float alpha,
                                    int self_loops, float* dwh, float* ds2, float* pdwh,
                                    float* pds2, void* stream_ptr) {
  using namespace sg;
  if (!plangat::shape_ok(H, Fp)) return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  plangat::plan_gat_bwd_cols_kernel<<<plangat::blocks_of(n_seg), 32 * plangat::WARPS, 0,
                                      stream>>>(
      static_cast<const int2*>(cv), n_seg, seg_row, seg_lo, seg_hi, seg_part,
      static_cast<const __nv_bfloat16*>(Whs), static_cast<const __nv_bfloat16*>(gOs),
      static_cast<const float4*>(st), s2, H, Fp, alpha, self_loops, dwh, ds2, pdwh, pds2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = planspmm::launch_sum_split_rows(pdwh, fin_row, fin_p0, fin_np, n_fin, H * Fp, dwh, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)planspmm::launch_sum_split_rows(pds2, fin_row, fin_p0, fin_np, n_fin, H, ds2,
                                              stream);
}
