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
//
// The column pass stages its gathered operands in shared memory. Per slot it
// reads a whole gO row (H Fp bf16: 1 KB at 4 x 128) and the row's (s1, m,
// 1 / l, t) a head (16 B each), and its fold is the longest of the three (the
// head's dot-product tree of shuffles, an exponential, 8 FMAs a lane into
// dWh and one into ds2). Held in registers, a batch of gathers waits for the
// fold of the last, the arrays cap occupancy, and a row wider than one slice
// takes one walk a slice, each reading slot_cv again. So each warp keeps a
// ring of ``stages`` slots in shared memory, one mbarrier a slot: a lane
// fills a slot with two 1-D bulk copies (cp.async.bulk: the walk's part of
// the row, then its heads' st), which cost no registers, and the warp folds
// the oldest slots from shared memory while the rest stay in flight. A walk
// covers NS slices (lane l holds features 8 l .. + 8 of each): one where the
// row fits a slice, else two, so a row of up to 4 x 128 is staged whole and
// its piece walked once; a wider row (H Fp > 512) takes one walk a 512
// features, since the sums of dWh live in registers. The depth follows from a
// slot's bytes, 2 gf + 16 gf / Fp for the gf = min(H Fp, 512) features of a
// walk, so that a block's eight rings fit the shared memory that lets three
// blocks of at most 80 registers a thread share an SM (ops/plan_gat.
// bwd_cols_ring: the host's rule, passed in; at most MAX_STAGES). What bounds
// the pass then is the fold's chain of dependent shuffles and arithmetic a
// slot: at one slice a walk a fold takes two slots, whose chains interleave
// (at two, the registers of a second slot spill). The kernel is persistent
// (as many blocks as fit the card, a warp striding over the pieces), so a
// warp's ring and barriers are set up once. The sums keep one order whatever
// the depth: a lane folds its 8 features of each slice in slot order, the
// head's dot product over the same tree of lanes, so dWh and ds2 come out the
// same bits on every launch. On an H100 at the products graph (2^20 nodes,
// 54 M slots): 24.8 ms at 4 x 128 and 13.2 ms at 4 x 48, 75% and 57% of the
// bytes' bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "plan_rows.cuh"
#include "tile_ring.cuh"

namespace sg {
namespace plangat {

constexpr int WARPS = 8;    // row pieces a block, one a warp
constexpr int SLICE = 256;  // features a warp covers in one walk: 8 a lane
constexpr int U = 8;        // row gathers in flight a warp (forward and row pass)
constexpr int WALK = 2 * SLICE;  // features the column pass stages a slot at most: two slices
constexpr int MAX_STAGES = 16;   // slots a warp's ring of the column pass holds at most
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
// UNROLLED: the tree's five possible steps written out (the column pass, whose
// folds interleave two trees); else a loop (the row pass, which runs slower
// unrolled). The same adds in the same order either way.
template <bool UNROLLED = false>
__device__ __forceinline__ float head_sum(float x, const Lane& g, int lane, int lph) {
  auto step = [&](int off) {
    const float y = __shfl_down_sync(FULL, x, off);
    if (lane + off < g.gend) x += y;
  };
  if constexpr (UNROLLED) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      if (off < lph) step(off);
  } else {
    for (int off = 1; off < lph; off <<= 1) step(off);
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

// Bytes of one slot of the column pass's ring: the first walk's features of a
// gathered gO row, then its heads' st. A multiple of 16, as are its parts.
__host__ __device__ __forceinline__ int cols_slot_bytes(int H, int Fp) {
  const int gf = min(H * Fp, WALK);
  return 2 * gf + 16 * (gf / Fp);
}

// A block's shared memory: each warp's barriers, then each warp's slots.
static size_t cols_smem_bytes(int H, int Fp, int stages) {
  return (size_t)WARPS * stages * (8 + cols_slot_bytes(H, Fp));
}

// st: [n, H] float4 of the rows' (s1, m, 1 / l or 0, t), one 16-byte copy a
// gathered row and head. Persistent: warp w of the grid walks pieces w, w +
// the grid's warps, ...; ``stages`` slots a warp (the host's ring rule). NS:
// the slices a walk covers, 1 where the row fits one (H Fp <= 256), else 2.
template <int NS>
__global__ void __launch_bounds__(32 * WARPS, 3)
    plan_gat_bwd_cols_kernel(const int2* __restrict__ cv, int n_seg,
                             const int* __restrict__ seg_row, const int* __restrict__ seg_lo,
                             const int* __restrict__ seg_hi, const int* __restrict__ seg_part,
                             const __nv_bfloat16* __restrict__ Whs,
                             const __nv_bfloat16* __restrict__ gOs,
                             const float4* __restrict__ st, const float* __restrict__ s2, int H,
                             int Fp, float alpha, int self_loops, float* __restrict__ dwh,
                             float* __restrict__ ds2, float* __restrict__ pdwh,
                             float* __restrict__ pds2, int stages) {
  // slots a fold takes: two where the registers allow (one slice a walk),
  // so that the two slots' chains of shuffles and arithmetic interleave
  constexpr int FOLD = NS == 1 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = H * Fp, lph = Fp / 8, slot = cols_slot_bytes(H, Fp);
  const uint32_t bar0 = sgr::smem_u32(smem) + 8 * warp * stages;
  const unsigned char* ring = smem + 8 * WARPS * stages + warp * stages * slot;
  const uint32_t ring0 = sgr::smem_u32(ring);
  if (lane < stages) sgr::mbar_init(bar0 + 8 * lane, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();
  // The ring's state over all of the warp's walks: slots held (filled, not
  // yet folded), the next slot to fill and to fold, and the phase that the
  // next fold waits for (it flips each time the fold wraps around).
  int held = 0, fill_b = 0, fold_b = 0;
  uint32_t fold_ph = 0;
  for (int w = blockIdx.x * WARPS + warp; w < n_seg; w += gridDim.x * WARPS) {
    const int col = seg_row[w], part = seg_part[w];  // plan_t's rows are the columns
    const int lo = seg_lo[w], hi = seg_hi[w];
    const bool self_first = self_loops && first_piece(seg_row, w, col);
    for (int f0 = 0; f0 < P; f0 += NS * SLICE) {
      const int gf = min(P - f0, NS * SLICE), h0 = f0 / Fp;
      const uint32_t row_bytes = 2 * gf, bytes = row_bytes + 16 * (gf / Fp);
      const bool two = NS == 2 && gf > SLICE;  // the walk's second slice exists
      Lane g[NS];
      float wh[NS][8];
      float s2c[NS], acc[NS][8], ds[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        g[k] = lane_of(f0 + k * SLICE, lane, H, Fp);
        unpack8(row8(Whs, col, P, g[k]), wh[k]);
        s2c[k] = g[k].mine ? s2[(long)col * H + g[k].h] : 0.f;
        ds[k] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;
      }
      // slot b <- gO[r]'s features f0 .. f0 + gf and st[r]'s heads h0 .., by one lane
      auto fill = [&](int b, int r) {
        const uint32_t bar = bar0 + 8 * b, dst = ring0 + b * slot;
        sgr::mbar_expect_tx(bar, bytes);
        sgr::bulk_load(dst, gOs + (long)r * P + f0, row_bytes, bar);
        sgr::bulk_load(dst + row_bytes, st + (long)r * H + h0, bytes - row_bytes, bar);
      };
      // Folds the N oldest slots in slot order; their chains interleave.
      auto fold = [&](auto n_slots) {
        constexpr int N = decltype(n_slots)::value;
        const unsigned char* e[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          int b = fold_b + i;
          uint32_t ph = fold_ph;
          if (b >= stages) {
            b -= stages;
            ph ^= 1u;
          }
          sgr::mbar_wait(bar0 + 8 * b, ph);
          e[i] = ring + b * slot;
        }
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          if (k == 1 && !two) break;
          float x[N][8], q[N], p[N], d[N];
          float4 sr[N];
#pragma unroll
          for (int i = 0; i < N; ++i) {
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            sr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (g[k].mine) {
              v = *reinterpret_cast<const uint4*>(e[i] + 2 * (g[k].f - f0));
              sr[i] = *reinterpret_cast<const float4*>(e[i] + row_bytes + 16 * (g[k].h - h0));
            }
            unpack8(v, x[i]);
            float dot = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) dot = fmaf(x[i][j], wh[k][j], dot);
            q[i] = head_sum<true>(dot, g[k], lane, lph);
            const float pre = sr[i].x + s2c[k];
            d[i] = pre > 0.f ? 1.f : alpha;
            p[i] = __expf(lrelu(pre, alpha) - sr[i].y) * sr[i].z;
          }
#pragma unroll
          for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[k][j] = fmaf(p[i], x[i][j], acc[k][j]);
            ds[k] = fmaf(p[i] * (q[i] - sr[i].w), d[i], ds[k]);
          }
        }
        __syncwarp();  // every lane has read the slots before they are filled again
        fold_b += N;
        if (fold_b >= stages) {
          fold_b -= stages;
          fold_ph ^= 1u;
        }
        held -= N;
      };
      if (self_first) {  // the virtual self slot opens the column's first piece
        if (lane == 0) fill(fill_b, col);
        if (++fill_b == stages) fill_b = 0;
        ++held;
      }
      int2 nx = lo + lane < hi ? cv[lo + lane] : make_int2(0, 0);
      for (int s0 = lo; s0 < hi; s0 += 32) {
        const int2 pr = nx;
        nx = s0 + 32 + lane < hi ? cv[s0 + 32 + lane] : make_int2(0, 0);  // the next window's pairs
        const bool ok = s0 + lane < hi && __int_as_float(pr.y) > 0.f && !(self_loops && pr.x == col);
        // the window's attended slots, filled in slot order as the ring frees
        unsigned rest = __ballot_sync(FULL, ok);
        while (rest) {
          if (held == stages) {
            fold(std::integral_constant<int, FOLD>{});
            continue;
          }
          const int rank = __popc(rest & ((1u << lane) - 1u));
          const bool take = (rest >> lane & 1u) && rank < stages - held;
          if (take) fill(fill_b + rank < stages ? fill_b + rank : fill_b + rank - stages, pr.x);
          const unsigned took = __ballot_sync(FULL, take);
          const int k = __popc(took);
          fill_b = fill_b + k < stages ? fill_b + k : fill_b + k - stages;
          held += k;
          rest &= ~took;
        }
      }
      while (held >= FOLD) fold(std::integral_constant<int, FOLD>{});
      while (held) fold(std::integral_constant<int, 1>{});
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        if (!g[k].mine) continue;
        store8((part < 0 ? dwh + (long)col * P : pdwh + (long)part * P) + g[k].f, acc[k]);
        if (lane == g[k].g0) (part < 0 ? ds2 + (long)col * H : pds2 + (long)part * H)[g[k].h] = ds[k];
      }
    }
  }
}

// The host's layout rule: Fp % 8 == 0, at most one slice a head, no head
// across two slices.
static bool shape_ok(int H, int Fp) {
  return H >= 1 && Fp >= 8 && Fp % 8 == 0 && Fp <= SLICE && (H * Fp <= SLICE || SLICE % Fp == 0);
}

static unsigned blocks_of(int n_seg) { return (unsigned)(((long)n_seg + WARPS - 1) / WARPS); }

// The column pass's launch: its shared memory (above the default 48 KB only
// once the kernel's attribute allows it) and a grid of as many blocks as the
// card holds at once, at most one a WARPS pieces.
using ColsKernel = decltype(&plan_gat_bwd_cols_kernel<1>);

// The instantiation for a row of H Fp features: one slice a walk where it fits.
static ColsKernel cols_kernel(int H, int Fp) {
  return H * Fp <= SLICE ? plan_gat_bwd_cols_kernel<1> : plan_gat_bwd_cols_kernel<2>;
}

static cudaError_t cols_launch_shape(int H, int Fp, int stages, size_t* smem, int* per_sm,
                                     int* n_sm) {
  *smem = cols_smem_bytes(H, Fp, stages);
  cudaError_t err = cudaFuncSetAttribute(cols_kernel(H, Fp),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, cols_kernel(H, Fp), 32 * WARPS,
                                                      *smem);
  if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

static bool cols_ring_ok(int H, int Fp, int stages) {
  return shape_ok(H, Fp) && stages >= 2 && stages <= MAX_STAGES &&
         cols_smem_bytes(H, Fp, stages) <= 232448;  // a block's most on the H100 (227 KB)
}

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
                                    float* pds2, int stages, void* stream_ptr) {
  using namespace sg;
  if (!plangat::cols_ring_ok(H, Fp, stages)) return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  size_t smem;
  int per_sm, n_sm;
  cudaError_t err = plangat::cols_launch_shape(H, Fp, stages, &smem, &per_sm, &n_sm);
  if (err != cudaSuccess) return (int)err;
  const unsigned fit = (unsigned)(per_sm * n_sm), grid = plangat::blocks_of(n_seg);
  const plangat::ColsKernel kernel = plangat::cols_kernel(H, Fp);
  kernel<<<grid < fit ? grid : fit, 32 * plangat::WARPS, smem, stream>>>(
      static_cast<const int2*>(cv), n_seg, seg_row, seg_lo, seg_hi, seg_part,
      static_cast<const __nv_bfloat16*>(Whs), static_cast<const __nv_bfloat16*>(gOs),
      static_cast<const float4*>(st), s2, H, Fp, alpha, self_loops, dwh, ds2, pdwh, pds2, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = planspmm::launch_sum_split_rows(pdwh, fin_row, fin_p0, fin_np, n_fin, H * Fp, dwh, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)planspmm::launch_sum_split_rows(pds2, fin_row, fin_p0, fin_np, n_fin, H, ds2,
                                              stream);
}

// What the column pass gets on this card at (H, Fp, stages): out[0] its
// registers a thread, out[1] its blocks an SM, out[2] its shared memory a
// block, out[3] its local memory a thread (spills). Returns the cudaError_t.
extern "C" int sg_plan_gat_bwd_cols_occupancy(int H, int Fp, int stages, int* out) {
  using namespace sg;
  if (!plangat::cols_ring_ok(H, Fp, stages)) return (int)cudaErrorInvalidValue;
  size_t smem;
  int per_sm, n_sm;
  cudaError_t err = plangat::cols_launch_shape(H, Fp, stages, &smem, &per_sm, &n_sm);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, plangat::cols_kernel(H, Fp))) != cudaSuccess)
    return (int)err;
  out[0] = attr.numRegs;
  out[1] = per_sm;
  out[2] = (int)smem;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}
