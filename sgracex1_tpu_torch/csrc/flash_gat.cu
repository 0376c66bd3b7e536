// Flash-GAT forward on Hopper: masked online-softmax attention aggregation
// over block-sparse adjacency tiles (K3), optionally with remainder chunk
// steps in the same row softmax (K6). Per row r and head h:
//
//   out[r] = sum_c softmax_c(LeakyReLU(s1[r] + s2[c]) | edge(r, c)) * Wh[c]
//
// Replaces sgracex1_tpu/ops/flash_gat.py:flash_gat_forward (Pallas kernel
// _flash_gat_kernel) and :flash_gat_hybrid_forward (_flash_hybrid_kernel).
// Each step follows the TPU kernel's arithmetic: e = LeakyReLU(s1 + s2)
// plus the additive mask (m01 * 1e9 - 1e9), m_new = max(m_old, rowmax e)
// with m starting at -1e5, p = exp(e - m_new), corr = exp(m_old - m_new),
// l = l * corr + sum p (f32 p), acc = acc * corr + bf16(p) @ bf16(Wh).
// A masked entry's p underflows to exactly 0 there, so here it is skipped:
// p is computed on edges only, and a 64-column chunk without an edge in the
// CTA's rows adds nothing and is skipped whole. The row max comes from the
// max of s2 over each row's edges (LeakyReLU(s1 + x) rounds monotonically
// in x), so m matches the TPU kernel's bit for bit.
// A chunk step (kind >= 1) scores its K slots as a one-hot [rows, K] grid:
// slot k is the edge (lrow[k], slot_col[k]) with s2 and Wh read straight
// from slot_col; dead slots (lrow == tb) match no row.
//
// The TPU grid walks a row block's whole run of steps in order. Here the
// host cuts runs into segments (ops/bsr.RunSegments); a CTA owns one
// (segment, 64-row group, head, 64-feature slice) and keeps its rows'
// (m, l, acc) from step to step. A run of one segment writes acc / l and
// the stats directly; a split run leaves (m, l, acc) partials that the
// merge kernel combines in a fixed order (M = max m_i, weights
// exp(m_i - M)). No atomics.
//
// Runtime flags (Args::flags; warp-uniform, no template axis): fast_exp
// (K3) takes Schraudolph's exp (fast_exp of tile_gemm.cuh) for p; K6's
// chunk mode noscore adds onehot(lrow) @ Wh to the sums with no score, max
// or l (p = 1 on each slot's row), and off skips the chunk steps: the JAX
// package's ablations (flash_gat_forward(fast_exp=),
// flash_gat_hybrid_forward(_chunk_mode=)).
//
// K12 (sgracex1_tpu/ops/flash_gat.py:flash_gat_forward_subskip, Pallas
// kernel _flash_gat_kernel_subskip) is K3 with a host-built population
// bitmap pop[T, nw] (subblock.cuh): bit (i * ns + j) of tile t says whether
// the sb x sb sub-block (i, j) holds an edge, for any sb that divides tb.
// The TPU kernel predicates each sub-block's score math on its bit. Here a
// tile with no populated sub-block in the CTA's rows is left at the step's
// first barrier, before s2 is loaded; a thread reads the mask bytes of its
// row's 8 columns only where a populated sub-block meets them, and clears
// the bits of the empty sub-blocks among them; a 64-column chunk whose
// cleared bits are all 0 in the CTA's rows is skipped, as in K3. This is
// the route of K12 for the shapes the ring kernel (flash_gat_ring.cu) does
// not take.
//
// Bound on the H100: the score work (an add, LeakyReLU, mask, max, exp and
// sum per tile entry, twice read: a row-max pass and a probability pass)
// and the tensor-core products 2 * tb * tb * F per tile and head. A first,
// simple kernel: WMMA bf16 with f32 accumulation, one stage, scores
// recomputed instead of kept. Wh arrives in bf16 (the wrapper rounds it
// once, where the TPU kernel rounds it per tile); each 64-column chunk's
// rows are copied into shared memory with cp.async, started before the
// chunk's probabilities are computed so the copy overlaps them.
#include "subblock.cuh"
#include "tile_gemm.cuh"

namespace sg {
namespace flash {

constexpr int ROWS = 64;       // rows per CTA (4 warps x 16)
constexpr int COLS = 64;       // columns per score chunk
constexpr int FS = 64;         // features per CTA slice
constexpr int NTHREADS = 128;
constexpr int MAX_TB = 1024;   // tile size bound (shared-memory staging)
constexpr int MAX_K = 512;     // chunk slots bound
constexpr int P_LD = COLS + 8;
constexpr int W_LD = FS + 8;
constexpr int S_LD = FS + 4;
constexpr float M_INIT = -1e5f;

constexpr int PW_BYTES = 2 * (ROWS * P_LD + COLS * W_LD);
static_assert(PW_BYTES >= 4 * ROWS * S_LD, "the stage reuses the p and w bytes");

struct alignas(32) Smem {
  // bf16(p) and bf16(Wh) of one column chunk; after a step's last chunk
  // the same bytes stage the step's f32 product
  alignas(32) unsigned char pw[PW_BYTES];
  float s2[MAX_TB];                 // s2 of the step's columns or slots
  int col[MAX_K];                   // chunk step: slot columns
  int lrow[MAX_K];                  // chunk step: slot local rows
  uint8_t mbits[ROWS][MAX_TB / 8];  // the step's edge mask, 8 columns a byte
  int live[MAX_TB / COLS];          // a 64-column chunk holds an edge
  float corr[ROWS];
  float l[ROWS];

  __device__ __nv_bfloat16* p() { return reinterpret_cast<__nv_bfloat16*>(pw); }
  __device__ __nv_bfloat16* w() { return p() + ROWS * P_LD; }
  __device__ float* stage() { return reinterpret_cast<float*>(pw); }
};

struct Args {
  const void* tiles; int tb;
  int n_rg, n_fs, H, F;
  const int* seg_rb; const int* seg_lo; const int* seg_hi; const int* seg_part;
  const int* tile_cb;                                    // K3: step g is tile g
  const int* step_cb; const int* step_tile; const int* step_chunk; const int* step_kind;
  const int* lrow; const int* slot_col; int K;
  sgsub::Pop pop;                                        // K12: sub-block bitmap
  const float* s1; int n_s1; const float* s2; int n_s2;
  const __nv_bfloat16* Wh; int wvec;  // wvec: rows copy as 16-byte pieces
  float alpha;
  float* out; int n_rows; float* m_out; float* l_out;
  float* pm; float* pl; float* pacc;
  // runtime flags, warp-uniform (ops/flash_gat._kernel_flags): bit 0 the
  // scores' exps by fast_exp (K3); bits 1-2 K6's chunk mode, 0 full, 1
  // noscore (onehot(lrow) @ Wh into the sums, no score, max or l), 2 off
  int flags;
};

using namespace nvcuda;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// Lane mapping of the score passes: warp w owns rows 16w..16w+15; lane
// handles rows 16w + (lane >> 3) + 4i (i < 4) and the 8 columns
// (lane & 7) * 8 of each 64-column chunk. The accumulator mapping: lane
// owns row 16w + (lane >> 1), features (lane & 1) * 32 .. +32.
struct Lane {
  int w, g, rr[4];
};

// One step (a tile when CHUNK is false, a remainder chunk otherwise).
template <int MODE, bool CHUNK, bool SUB = false>
__device__ __forceinline__ void step(Smem& s, const Args& a, const Lane& ln, long id, int cb,
                                     int rb, int row0, int h, int f0, int nf,
                                     const float (&s1r)[4], float (&m)[4], float (&l)[4],
                                     float (&acc)[32]) {
  const int tb = a.tb;
  const int ncols = CHUNK ? a.K : tb;
  constexpr bool subskip = SUB && !CHUNK;  // K12: compiled into K12 only
  // the previous step is done with s.s2 / s.col / s.lrow; K12 leaves a tile
  // without a populated sub-block in this CTA's rows here
  if constexpr (subskip) {
    if (!__syncthreads_or(sgsub::any_row(a.pop, id, row0, min(row0 + ROWS, tb), threadIdx.x, NTHREADS)))
      return;
  } else {
    __syncthreads();
  }
  if (threadIdx.x < MAX_TB / COLS) s.live[threadIdx.x] = 0;
  for (int c = threadIdx.x; c < ncols; c += NTHREADS) {
    if constexpr (CHUNK) {
      const long slot = id * a.K + c;
      const int col = a.slot_col[slot];
      s.col[c] = col;
      s.lrow[c] = a.lrow[slot];
      s.s2[c] = a.s2[(long)col * a.H + h];
    } else {
      const long col = (long)cb * tb + c;
      s.s2[c] = col < a.n_s2 ? a.s2[col * a.H + h] : 0.f;
    }
  }
  __syncthreads();

  // pass 1: each row's mask bits, kept for pass 2, and its row max. As
  // LeakyReLU(s1 + x) rounds monotonically in x, the max of the masked
  // scores is LeakyReLU(s1 + the max of s2 over the row's edges), bit for
  // bit. A row without an edge here keeps m (the TPU kernel's masked
  // scores, ~-1e9, lose to m >= -1e5 as well). Chunks of 64 columns with
  // no edge in the CTA's rows are marked dead for pass 2.
  const int nchunk = (ncols + COLS - 1) / COLS;
  const bool noscore = CHUNK && (a.flags >> 1) == 1;  // m and l stay, corr is 1
  const bool fast = (a.flags & 1) != 0;
  float smax[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int kc = 0; kc < nchunk; ++kc) {
    const int c = kc * COLS + ln.g * 8;
    unsigned any = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = row0 + ln.rr[i];
      unsigned bits = 0;
      if (lr < tb && c < ncols) {
        if constexpr (CHUNK) {
#pragma unroll
          for (int q = 0; q < 8; ++q) bits |= (unsigned)(s.lrow[c + q] == lr) << q;
        } else {
          // K12: only the columns of populated sub-blocks
          unsigned kp = 0xffu;
          if constexpr (subskip) kp = sgsub::keep<8>(a.pop, id, lr, c);
          if (kp) bits = tile_mask8<MODE>(a.tiles, id, tb, lr, c) & kp;
        }
      }
      if (bits && !noscore) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if ((bits >> q) & 1u) smax[i] = fmaxf(smax[i], s.s2[c + q]);
      }
      s.mbits[ln.rr[i]][c >> 3] = (uint8_t)bits;
      any |= bits;
    }
    if (__any_sync(0xffffffffu, any != 0) && (threadIdx.x & 31) == 0) atomicOr(&s.live[kc], 1);
  }
  float mnew[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x = smax[i];
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
    if (x > -INFINITY) {
      x = s1r[i] + x;
      x = fmaxf(x, a.alpha * x);
    }
    mnew[i] = fmaxf(m[i], x);
    if (ln.g == 0) s.corr[ln.rr[i]] = expf(m[i] - mnew[i]);
  }
  __syncthreads();  // s.live complete

  // pass 2: p, its row sums, and bf16(p) @ bf16(Wh) on the tensor cores
  Acc pf[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(pf[j], 0.f);
  float psum[4] = {0.f, 0.f, 0.f, 0.f};
  const int nfeat = min(FS, a.F - f0);
  for (int kc = 0; kc < nchunk; ++kc) {
    if (!s.live[kc]) continue;  // all of p is 0 here: nothing to add
    const int k0 = kc * COLS;
    // bf16 Wh rows of the chunk's columns, features f0 .. f0 + FS
    auto wcol = [&](int c) -> long {
      if (c >= ncols) return -1;
      const long col = CHUNK ? (long)s.col[c] : (long)cb * tb + c;
      return col < a.n_s2 ? col : -1;
    };
    if (a.wvec) {
#pragma unroll
      for (int u = 0; u < COLS * FS / 8 / NTHREADS; ++u) {
        const int idx = threadIdx.x + u * NTHREADS;
        const int k = idx / (FS / 8), ff = (idx % (FS / 8)) * 8;
        const long col = wcol(k0 + k);
        const bool ok = col >= 0 && ff < nfeat;
        cp_async16(s.w() + k * W_LD + ff, ok ? a.Wh + (col * a.H + h) * a.F + f0 + ff : a.Wh, ok);
      }
      cp_async_commit();
    } else {
      for (int idx = threadIdx.x; idx < COLS * FS; idx += NTHREADS) {
        const int k = idx / FS, ff = idx % FS;
        const long col = wcol(k0 + k);
        s.w()[k * W_LD + ff] = (col >= 0 && ff < nfeat) ? a.Wh[(col * a.H + h) * a.F + f0 + ff]
                                                      : __float2bfloat16_rn(0.f);
      }
    }
    // p = exp(LeakyReLU(s1 + s2) - m_new) on edges; the masked entries'
    // exp(x - 1e9 - m_new) of the TPU kernel is exactly 0
    const int c = k0 + ln.g * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      alignas(16) __nv_bfloat16 pb[8];
      const unsigned bits = s.mbits[ln.rr[i]][c >> 3];
#pragma unroll
      for (int q = 0; q < 8; ++q) pb[q] = __float2bfloat16_rn(0.f);
      if (bits) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if ((bits >> q) & 1u) {
            if (noscore) {
              pb[q] = __float2bfloat16_rn(1.f);
              continue;
            }
            float x = s1r[i] + s.s2[c + q];
            x = fmaxf(x, a.alpha * x);
            const float p = fast ? fast_exp(x - mnew[i]) : __expf(x - mnew[i]);
            psum[i] += p;
            pb[q] = __float2bfloat16_rn(p);
          }
        }
      }
      *reinterpret_cast<uint4*>(s.p() + ln.rr[i] * P_LD + ln.g * 8) =
          *reinterpret_cast<const uint4*>(pb);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < COLS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, s.p() + (16 * ln.w) * P_LD + kk, P_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nf) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, s.w() + kk * W_LD + 16 * j, W_LD);
          wmma::mma_sync(pf[j], fa, fb, pf[j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x = psum[i];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    x += __shfl_xor_sync(0xffffffffu, x, 4);
    l[i] = l[i] * expf(m[i] - mnew[i]) + x;
    m[i] = mnew[i];
  }
  float* st = s.stage() + (16 * ln.w) * S_LD;
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(st + 16 * j, pf[j], S_LD, wmma::mem_row_major);
  __syncwarp();
  const int ar = 16 * ln.w + (threadIdx.x & 31) / 2;
  const float cr = s.corr[ar];
  const float* src = s.stage() + ar * S_LD + ((threadIdx.x & 1) * 32);
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = acc[q] * cr + src[q];
  __syncwarp();
}

// 4 CTAs an SM: at most 128 registers a thread (80 bytes spill). The
// kernel waits on loads more than it computes, and measured 8.6-8.9 ms
// against 9.2-9.3 ms at 162 registers and 3 CTAs (K6 at the 2^20 slice).
template <int MODE, bool SUB>
__global__ void __launch_bounds__(NTHREADS, 4) flash_gat_kernel(Args a) {
  __shared__ Smem s;
  long bid = blockIdx.x;
  const int fs = (int)(bid % a.n_fs); bid /= a.n_fs;
  const int h = (int)(bid % a.H); bid /= a.H;
  const int row0 = (int)(bid % a.n_rg) * ROWS;
  const int seg = (int)(bid / a.n_rg);
  const int rb = a.seg_rb[seg];
  const int tb = a.tb;
  const int f0 = fs * FS;
  const int nf = (min(FS, a.F - f0) + 15) / 16;  // 16-wide fragments in use

  Lane ln;
  const int lane = threadIdx.x & 31;
  ln.w = threadIdx.x >> 5;
  ln.g = lane & 7;
  float s1r[4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ln.rr[i] = 16 * ln.w + (lane >> 3) + 4 * i;
    const int lr = row0 + ln.rr[i];
    const long grow = (long)rb * tb + lr;
    s1r[i] = (lr < tb && grow < a.n_s1) ? a.s1[grow * a.H + h] : 0.f;
    m[i] = M_INIT;
    l[i] = 0.f;
  }
  float acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.f;

  for (int g = a.seg_lo[seg]; g < a.seg_hi[seg]; ++g) {
    if (SUB || a.step_kind == nullptr) {
      step<MODE, false, SUB>(s, a, ln, g, a.tile_cb[g], rb, row0, h, f0, nf, s1r, m, l, acc);
      continue;
    }
    const int kind = a.step_kind[g];  // 0 tile, 1 chunk, 3 tile then chunk
    if (kind != 1)
      step<MODE, false>(s, a, ln, a.step_tile[g], a.step_cb[g], rb, row0, h, f0, nf, s1r, m,
                        l, acc);
    if (kind >= 1 && (a.flags >> 1) != 2)  // chunk mode off: chunks skipped
      step<MODE, true>(s, a, ln, a.step_chunk[g], 0, rb, row0, h, f0, nf, s1r, m, l, acc);
  }

  // epilogue: the run's result, or this segment's partial state
  const int part = a.seg_part[seg];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (ln.g != 0) continue;
    const int lr = row0 + ln.rr[i];
    if (lr >= tb) continue;
    s.l[ln.rr[i]] = l[i];
    if (part >= 0) {
      if (fs == 0) {
        const long o = ((long)part * tb + lr) * a.H + h;
        a.pm[o] = m[i];
        a.pl[o] = l[i];
      }
    } else if (fs == 0 && a.m_out != nullptr) {
      const long o = ((long)rb * tb + lr) * a.H + h;
      a.m_out[o] = m[i];
      a.l_out[o] = l[i];
    }
  }
  __syncwarp();
  const int ar = 16 * ln.w + lane / 2;
  const int lr = row0 + ar;
  if (lr >= tb) return;
  const int fb = f0 + (lane & 1) * 32;
  if (part >= 0) {
    float* dst = a.pacc + (((long)part * tb + lr) * a.H + h) * a.F;
#pragma unroll
    for (int q = 0; q < 32; ++q)
      if (fb + q < a.F && fb + q < f0 + FS) dst[fb + q] = acc[q];
    return;
  }
  const long grow = (long)rb * tb + lr;
  if (grow >= a.n_rows) return;
  const float inv = 1.f / fmaxf(s.l[ar], 1e-30f);
  float* dst = a.out + (grow * a.H + h) * a.F;
#pragma unroll
  for (int q = 0; q < 32; ++q)
    if (fb + q < a.F && fb + q < f0 + FS) dst[fb + q] = acc[q] * inv;
}

// One warp per (split run, row, head): M = max m_i, L = sum l_i e^{m_i-M},
// out = sum acc_i e^{m_i-M} / max(L, 1e-30), partials in their fixed order.
__global__ void merge_runs(const float* pm, const float* pl, const float* pacc,
                           const int* fin_rb, const int* fin_p0, const int* fin_np, int n_fin,
                           int tb, int H, int F, int n_rows, float* out, float* m_out,
                           float* l_out) {
  const long warp = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)n_fin * tb * H) return;
  const int h = (int)(warp % H);
  const int lr = (int)((warp / H) % tb);
  const int f = (int)(warp / ((long)H * tb));
  const int q0 = fin_p0[f], np = fin_np[f];
  auto at = [&](int i) { return ((long)(q0 + i) * tb + lr) * H + h; };
  float M = -INFINITY;
  for (int i = lane; i < np; i += 32) M = fmaxf(M, pm[at(i)]);
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  float L = 0.f;
  for (int i = lane; i < np; i += 32) L += pl[at(i)] * expf(pm[at(i)] - M);
  for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
  const long grow = (long)fin_rb[f] * tb + lr;
  if (lane == 0 && m_out != nullptr) {
    m_out[grow * H + h] = M;
    l_out[grow * H + h] = L;
  }
  if (grow >= n_rows) return;
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int fc = lane; fc < F; fc += 32) {
    float sum = 0.f;
    for (int i = 0; i < np; ++i) sum += pacc[at(i) * F + fc] * expf(pm[at(i)] - M);
    out[(grow * H + h) * F + fc] = sum * inv;
  }
}

template <int MODE>
static cudaError_t launch(const Args& a, int n_seg, cudaStream_t stream) {
  const long blocks = (long)n_seg * a.n_rg * a.H * a.n_fs;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  if constexpr (MODE != TILE_BITS) {  // K12 takes unpacked tiles only
    if (a.pop.bits != nullptr) {
      flash_gat_kernel<MODE, true><<<(unsigned)blocks, NTHREADS, 0, stream>>>(a);
      return cudaGetLastError();
    }
  }
  flash_gat_kernel<MODE, false><<<(unsigned)blocks, NTHREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace flash
}  // namespace sg

// K3 (step_kind == nullptr: step g is tile g, column block tile_cb[g]), K12
// (K3 with the sub-block bitmap pop) and K6 (steps of a fused plan), with
// the runtime flags of Args. Returns the cudaError_t of the launches.
extern "C" int sg_flash_gat(const void* tiles, int tile_mode, int tb, int n_seg,
                            const int* seg_rb, const int* seg_lo, const int* seg_hi,
                            const int* seg_part, int n_fin, const int* fin_rb,
                            const int* fin_p0, const int* fin_np, const int* tile_cb,
                            const int* step_cb, const int* step_tile, const int* step_chunk,
                            const int* step_kind, const int* lrow, const int* slot_col, int K,
                            const int* pop, int sb, const float* s1, int n_s1, const float* s2, int n_s2,
                            const void* Wh, int wvec, int H, int F, float alpha,
                            float* out, int n_rows, float* m_out, float* l_out, float* pm,
                            float* pl, float* pacc, int flags, void* stream_ptr) {
  using namespace sg;
  using namespace sg::flash;
  if (tb % 32 || tb > MAX_TB || K > MAX_K || H < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  if (pop != nullptr && (sb < 1 || tb % sb || step_kind != nullptr || tile_mode == TILE_BITS))
    return (int)cudaErrorInvalidValue;
  const int ns = pop != nullptr ? tb / sb : 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args a{tiles, tb, (tb + ROWS - 1) / ROWS, (F + FS - 1) / FS, H, F,
         seg_rb, seg_lo, seg_hi, seg_part, tile_cb,
         step_cb, step_tile, step_chunk, step_kind, lrow, slot_col, K,
         {pop, sb, ns, (ns * ns + 31) / 32}, s1, n_s1, s2, n_s2, static_cast<const __nv_bfloat16*>(Wh), wvec, alpha,
         out, n_rows, m_out, l_out, pm, pl, pacc, flags};
  cudaError_t err;
  switch (tile_mode) {
    case TILE_BF16: err = launch<TILE_BF16>(a, n_seg, stream); break;
    case TILE_F32: err = launch<TILE_F32>(a, n_seg, stream); break;
    case TILE_I8: err = launch<TILE_I8>(a, n_seg, stream); break;
    case TILE_BITS: err = launch<TILE_BITS>(a, n_seg, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || n_fin == 0) return (int)err;
  const long threads = (long)n_fin * tb * H * 32;
  merge_runs<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      pm, pl, pacc, fin_rb, fin_p0, fin_np, n_fin, tb, H, F, n_rows, out, m_out, l_out);
  return (int)cudaGetLastError();
}
