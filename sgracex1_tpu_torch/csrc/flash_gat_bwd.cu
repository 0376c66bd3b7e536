// Flash-GAT backward on Hopper: the two tile passes of the softmax-Jacobian
// identity, recomputing the attention probabilities from the forward's row
// stats (m, l) instead of storing them. Per head, for tile entries (r, c)
// with an edge:
//
//   p  = exp(LeakyReLU(s1[r] + s2[c]) - m[r]) / max(l[r], 1e-30)
//   lr = 1 if s1[r] + s2[c] > 0 else alpha           (LeakyReLU')
//   q  = bf16(gO[r]) . bf16(Wh[c])                   (f32 sums)
//
// K4, the row pass (replaces sgracex1_tpu/ops/flash_gat.py:_bwd_row_pass,
// Pallas kernel _flash_bwd_row_kernel): t = sum_c p q, u1 = sum_c p q lr,
// u2 = sum_c p lr per row, so ds1 = u1 - t u2 on the host.
// K5, the column pass (replaces :_bwd_col_pass, _flash_bwd_col_kernel):
// dWh[c] = sum_r bf16(p) bf16(gO[r]) and ds2[c] = sum_r p (q - t[r]) lr.
// Masked entries have p = 0 in the TPU kernel (exp of a score 1e9 below m
// underflows); here they are never computed, and a 64 x 64 chunk of a tile
// with no edge in it is skipped whole (one block-wide vote on the mask
// bits). Rows without an edge (m = -1e5, l = 0) add exactly 0. With the
// runtime flag fast_exp (warp-uniform) p takes Schraudolph's exp
// (fast_exp of tile_gemm.cuh), the TPU passes' fast_exp option.
//
// The TPU grid walks runs of tiles in order and keeps the sums resident.
// Here K4 walks the row-block runs of ops/bsr.RunSegments as K1 and K3 do:
// a CTA owns (segment, 64-row group, head) and loops over the segment's
// tiles and their 64-column chunks. K5 walks the column-block runs of the
// tile set's column order (BSRMatrix.col_perm / col_segments): a CTA owns
// (segment, 64-column group, head, 64-feature slice of dWh) and loops over
// the tiles and their 64-row chunks, reading the stats and t of each tile's
// row block. Split runs leave f32 partials that finalize_runs sums in a
// fixed order. No atomics: the result is the same run to run.
//
// Bound on the H100: per tile and head, K4 does one tensor-core product
// (q, 2 tb^2 F flops) and K5 two (q and the dWh product), around per-entry
// exp work on edges only. A first, simple kernel, as K3: WMMA bf16 with f32
// accumulation, one stage, operands copied with cp.async into shared memory;
// q is staged through shared memory to meet the per-entry work. Its limit,
// like K3's, is the latency of the per-chunk chain of loads and barriers.
#include "tile_gemm.cuh"

namespace sg {
namespace flash_bwd {

constexpr int ROWS = 64;        // K4: rows per CTA; K5: rows per chunk
constexpr int COLS = 64;        // K4: columns per chunk; K5: columns per CTA
constexpr int FS = 64;          // feature slice: the depth step of q, K5's dWh slice
constexpr int NTHREADS = 128;   // 4 warps; warp w owns rows 16w .. 16w + 15 of q
constexpr int LD = FS + 8;      // bf16 operand rows (16-byte aligned, staggered banks)
constexpr int Q_LD = COLS + 4;  // f32 q rows

using namespace nvcuda;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

struct Args {
  const void* tiles; int tb;
  const int* seg_rb; const int* seg_lo; const int* seg_hi; const int* seg_part;
  const int* tile_rb; const int* tile_cb; const int* col_perm;
  // head-last, padded to the tile grid: s1/m/l/t [n_rt*tb, H], s2 [n_ct*tb, H],
  // Wh [n_ct*tb, H, F] and gO [n_rt*tb, H, F] in bf16
  const float* s1; const float* s2; const float* m; const float* l; const float* t;
  const __nv_bfloat16* Wh; const __nv_bfloat16* gO;
  int H, F, n_fs, wvec;  // wvec: rows copy as 16-byte pieces
  float alpha;
  int fast;  // the probabilities' exps by fast_exp (warp-uniform)
  float* out; float* partial;    // K4 [*, 3H] (t | u1 | u2); K5 dWh [*, H*F]
  float* out2; float* partial2;  // K5 ds2 [*, H]
};

// Rows grow0 .. grow0 + 64 of X (bf16 [*, H, F]), head h, features f0 ..
// f0 + 64, into dst [64][LD]; rows from nvalid on and features past F are
// zero. With wvec the copy is asynchronous: cp_async_wait_all() before use.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* X,
                                           long grow0, int nvalid, const Args& a, int h,
                                           int f0) {
  const int nfeat = min(FS, a.F - f0);
  if (a.wvec) {
#pragma unroll
    for (int u = 0; u < ROWS * FS / 8 / NTHREADS; ++u) {
      const int idx = threadIdx.x + u * NTHREADS;
      const int r = idx / (FS / 8), ff = (idx % (FS / 8)) * 8;
      const bool ok = r < nvalid && ff < nfeat;
      cp_async16(dst + r * LD + ff, ok ? X + ((grow0 + r) * a.H + h) * (long)a.F + f0 + ff : X,
                 ok);
    }
    cp_async_commit();
  } else {
    for (int idx = threadIdx.x; idx < ROWS * FS; idx += NTHREADS) {
      const int r = idx / FS, ff = idx % FS;
      dst[r * LD + ff] = (r < nvalid && ff < nfeat)
                             ? X[((grow0 + r) * a.H + h) * (long)a.F + f0 + ff]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

// q[64 x 64] += sA (rows) . sB (columns) over the features of one slice
// (depth nk, a multiple of 16); warp w: rows 16w .. 16w + 15.
__device__ __forceinline__ void q_mma(Acc (&qf)[4], const __nv_bfloat16* sA,
                                      const __nv_bfloat16* sB, int nk) {
  const int w = threadIdx.x >> 5;
  for (int kk = 0; kk < nk; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, sA + (16 * w) * LD + kk, LD);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, sB + (16 * j) * LD + kk, LD);
      wmma::mma_sync(qf[j], fa, fb, qf[j]);
    }
  }
}

__device__ __forceinline__ int depth(const Args& a, int f0) {
  return (min(FS, a.F - f0) + 15) / 16 * 16;
}

// K4. Lane mapping as in K3: lane handles rows 16w + (lane >> 3) + 4i
// (i < 4) and the 8 columns (lane & 7) * 8 of each 64-column chunk, so a
// warp reads back only the q rows it computed. 3 CTAs an SM (at most 168
// registers a thread; unbounded it took 246, 2 CTAs): 6.40-6.44 ms against
// 8.33-8.43 ms at the 2^20 GAT slice, H=4, on an H100 80GB HBM3 at 700 W
// (128 registers and 4 CTAs: 6.39-6.45 ms with 208 bytes of stack).
template <int MODE>
__global__ void __launch_bounds__(NTHREADS, 3) bwd_row_kernel(Args a) {
  __shared__ __align__(128) __nv_bfloat16 sA[ROWS * LD];  // bf16 gO of the CTA's rows
  __shared__ __align__(128) __nv_bfloat16 sB[COLS * LD];  // bf16 Wh of the chunk's columns
  __shared__ __align__(128) float qst[ROWS * Q_LD];
  __shared__ float s2c[COLS];
  const int tb = a.tb;
  const int n_rg = (tb + ROWS - 1) / ROWS;
  long bid = blockIdx.x;
  const int h = (int)(bid % a.H); bid /= a.H;
  const int row0 = (int)(bid % n_rg) * ROWS;
  const int seg = (int)(bid / n_rg);
  const int rb = a.seg_rb[seg];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane & 7;

  int rr[4];
  float s1r[4], mr[4], linv[4], t[4], u1[4], u2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rr[i] = 16 * w + (lane >> 3) + 4 * i;
    const int lr = row0 + rr[i];
    const long o = ((long)rb * tb + lr) * a.H + h;
    const bool ok = lr < tb;
    s1r[i] = ok ? a.s1[o] : 0.f;
    mr[i] = ok ? a.m[o] : 0.f;
    linv[i] = ok ? 1.f / fmaxf(a.l[o], 1e-30f) : 0.f;
    t[i] = u1[i] = u2[i] = 0.f;
  }
  const long growA = (long)rb * tb + row0;
  const int nvalid_r = min(ROWS, tb - row0);
  if (a.n_fs == 1) stage_rows(sA, a.gO, growA, nvalid_r, a, h, 0);

  for (int gi = a.seg_lo[seg]; gi < a.seg_hi[seg]; ++gi) {
    const int cb = a.tile_cb[gi];
    for (int c0 = 0; c0 < tb; c0 += COLS) {
      const int c = c0 + g * 8;
      unsigned bits[4], any = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lr = row0 + rr[i];
        bits[i] = (lr < tb && c < tb) ? tile_mask8<MODE>(a.tiles, gi, tb, lr, c) : 0u;
        any |= bits[i];
      }
      // one vote: an edgeless chunk adds nothing (and the barrier retires
      // the previous chunk's reads of sB and s2c)
      if (!__syncthreads_or(any != 0)) continue;
      if (threadIdx.x < COLS) {
        const int cc = c0 + threadIdx.x;
        s2c[threadIdx.x] = cc < tb ? a.s2[((long)cb * tb + cc) * a.H + h] : 0.f;
      }
      const int nvalid_c = min(COLS, tb - c0);
      Acc qf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(qf[j], 0.f);
      for (int fs = 0; fs < a.n_fs; ++fs) {
        if (a.n_fs > 1) stage_rows(sA, a.gO, growA, nvalid_r, a, h, fs * FS);
        stage_rows(sB, a.Wh, (long)cb * tb + c0, nvalid_c, a, h, fs * FS);
        cp_async_wait_all();
        __syncthreads();
        q_mma(qf, sA, sB, depth(a, fs * FS));
        if (fs + 1 < a.n_fs) __syncthreads();
      }
      float* st = qst + (16 * w) * Q_LD;
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(st + 16 * j, qf[j], Q_LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!bits[i]) continue;
        const float* qrow = qst + rr[i] * Q_LD + g * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (!((bits[i] >> e) & 1u)) continue;
          const float x = s1r[i] + s2c[g * 8 + e];
          const float lrv = x > 0.f ? 1.f : a.alpha;
          const float y = fmaxf(x, a.alpha * x) - mr[i];
          const float p = (a.fast ? fast_exp(y) : __expf(y)) * linv[i];
          const float pq = p * qrow[e];
          t[i] += pq;
          u1[i] += pq * lrv;
          u2[i] += p * lrv;
        }
      }
    }
  }
  cp_async_wait_all();

  // the 8 lanes of a row hold its partial sums
  const int part = a.seg_part[seg];
  const int P = 3 * a.H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      t[i] += __shfl_xor_sync(0xffffffffu, t[i], o);
      u1[i] += __shfl_xor_sync(0xffffffffu, u1[i], o);
      u2[i] += __shfl_xor_sync(0xffffffffu, u2[i], o);
    }
    const int lr = row0 + rr[i];
    if (g != 0 || lr >= tb) continue;
    float* dst = part >= 0 ? a.partial + ((long)part * tb + lr) * P
                           : a.out + ((long)rb * tb + lr) * P;
    dst[h] = t[i];
    dst[a.H + h] = u1[i];
    dst[2 * a.H + h] = u2[i];
  }
}

// K5. Thread mapping of the per-entry pass: column c = tid & 63 of the
// CTA's group, rows (tid >> 6) * 32 .. + 32 of the chunk, so ds2 sums in a
// register; warp w accumulates dWh of columns 16w .. 16w + 15.
template <int MODE>
__global__ void __launch_bounds__(NTHREADS) bwd_col_kernel(Args a) {
  __shared__ __align__(128) __nv_bfloat16 sA[ROWS * LD];  // bf16 gO of the chunk's rows
  __shared__ __align__(128) __nv_bfloat16 sB[COLS * LD];  // bf16 Wh of the CTA's columns
  __shared__ __align__(128) __nv_bfloat16 sP[ROWS * LD];  // bf16(p) [row][column]
  __shared__ __align__(128) float qst[ROWS * Q_LD];       // q [row][column]; then the dWh stage
  __shared__ uint8_t mb[ROWS][COLS / 8];                  // the chunk's edge bits
  __shared__ float rs1[ROWS], rm[ROWS], rli[ROWS], rt[ROWS];
  __shared__ float red[NTHREADS];
  const int tb = a.tb;
  const int n_cg = (tb + COLS - 1) / COLS;
  long bid = blockIdx.x;
  const int fs = (int)(bid % a.n_fs); bid /= a.n_fs;
  const int h = (int)(bid % a.H); bid /= a.H;
  const int col0 = (int)(bid % n_cg) * COLS;
  const int seg = (int)(bid / n_cg);
  const int cb = a.seg_rb[seg];  // the column block of this run
  const int f0 = fs * FS;
  const int w = threadIdx.x >> 5;
  const int c = threadIdx.x & (COLS - 1), rh = threadIdx.x / COLS;
  const int lc = col0 + c;
  const float s2c = lc < tb ? a.s2[((long)cb * tb + lc) * a.H + h] : 0.f;
  const long growB = (long)cb * tb + col0;
  const int nvalid_c = min(COLS, tb - col0);
  const int nfj = (min(FS, a.F - f0) + 15) / 16;
  float ds2 = 0.f;
  Acc dw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(dw[j], 0.f);
  if (a.n_fs == 1) stage_rows(sB, a.Wh, growB, nvalid_c, a, h, 0);

  for (int gi = a.seg_lo[seg]; gi < a.seg_hi[seg]; ++gi) {
    const int tile = a.col_perm[gi];
    const int rb = a.tile_rb[tile];
    for (int r0 = 0; r0 < tb; r0 += ROWS) {
      {  // edge bits: thread -> row tid >> 1, 32 columns
        const int r = threadIdx.x >> 1, b0 = (threadIdx.x & 1) * 4;
        unsigned any = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int cc = col0 + (b0 + b) * 8;
          const unsigned bits =
              (r0 + r < tb && cc < tb) ? tile_mask8<MODE>(a.tiles, tile, tb, r0 + r, cc) : 0u;
          mb[r][b0 + b] = (uint8_t)bits;
          any |= bits;
        }
        if (!__syncthreads_or(any != 0)) continue;
      }
      const long grow0 = (long)rb * tb + r0;
      const int nvalid_r = min(ROWS, tb - r0);
      if (threadIdx.x < ROWS) {
        const int r = threadIdx.x;
        const long o = (grow0 + r) * a.H + h;
        const bool ok = r < nvalid_r;
        rs1[r] = ok ? a.s1[o] : 0.f;
        rm[r] = ok ? a.m[o] : 0.f;
        rli[r] = ok ? 1.f / fmaxf(a.l[o], 1e-30f) : 0.f;
        rt[r] = ok ? a.t[o] : 0.f;
      }
      Acc qf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(qf[j], 0.f);
      for (int qs = 0; qs < a.n_fs; ++qs) {
        stage_rows(sA, a.gO, grow0, nvalid_r, a, h, qs * FS);
        if (a.n_fs > 1) stage_rows(sB, a.Wh, growB, nvalid_c, a, h, qs * FS);
        cp_async_wait_all();
        __syncthreads();
        q_mma(qf, sA, sB, depth(a, qs * FS));
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(qst + (16 * w) * Q_LD + 16 * j, qf[j], Q_LD, wmma::mem_row_major);
      if (a.n_fs > 1 && fs != a.n_fs - 1) {  // sA holds the last slice: stage this CTA's
        stage_rows(sA, a.gO, grow0, nvalid_r, a, h, f0);
        cp_async_wait_all();
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < ROWS / 2; ++i) {
        const int r = rh * (ROWS / 2) + i;
        __nv_bfloat16 pb = __float2bfloat16_rn(0.f);
        if ((mb[r][c >> 3] >> (c & 7)) & 1u) {
          const float x = rs1[r] + s2c;
          const float lrv = x > 0.f ? 1.f : a.alpha;
          const float y = fmaxf(x, a.alpha * x) - rm[r];
          const float p = (a.fast ? fast_exp(y) : __expf(y)) * rli[r];
          ds2 += p * (qst[r * Q_LD + c] - rt[r]) * lrv;
          pb = __float2bfloat16_rn(p);
        }
        sP[r * LD + c] = pb;
      }
      __syncthreads();
      // dWh[columns, slice] += bf16(p)^T @ bf16(gO[rows, slice])
#pragma unroll
      for (int kk = 0; kk < ROWS; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, sP + kk * LD + 16 * w, LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nfj) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, sA + kk * LD + 16 * j, LD);
            wmma::mma_sync(dw[j], fa, fb, dw[j]);
          }
        }
      }
    }
  }
  cp_async_wait_all();

  // epilogue: the run's result, or this segment's partial
  const int part = a.seg_part[seg];
  red[threadIdx.x] = ds2;
  __syncthreads();  // also retires the last chunk's reads of qst
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(qst + (16 * w) * Q_LD + 16 * j, dw[j], Q_LD, wmma::mem_row_major);
  if (rh == 0 && fs == 0 && lc < tb) {
    const float v = red[c] + red[c + COLS];
    if (part >= 0) a.partial2[((long)part * tb + lc) * a.H + h] = v;
    else a.out2[((long)cb * tb + lc) * a.H + h] = v;
  }
  __syncthreads();
  const int nfeat = min(FS, a.F - f0);
  for (int idx = threadIdx.x; idx < COLS * FS; idx += NTHREADS) {
    const int cc = idx / FS, ff = idx % FS;
    if (col0 + cc >= tb || ff >= nfeat) continue;
    const long row = part >= 0 ? (long)part * tb + col0 + cc : (long)cb * tb + col0 + cc;
    float* dst = part >= 0 ? a.partial : a.out;
    dst[(row * a.H + h) * a.F + f0 + ff] = qst[cc * Q_LD + ff];
  }
}

template <int MODE>
static cudaError_t launch(bool col, const Args& a, int n_seg, cudaStream_t stream) {
  const long groups = (a.tb + 63) / 64;
  const long blocks = (long)n_seg * groups * a.H * (col ? a.n_fs : 1);
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  if (col) bwd_col_kernel<MODE><<<(unsigned)blocks, NTHREADS, 0, stream>>>(a);
  else bwd_row_kernel<MODE><<<(unsigned)blocks, NTHREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

static cudaError_t run(bool col, int tile_mode, const Args& a, int n_seg, cudaStream_t stream) {
  switch (tile_mode) {
    case TILE_BF16: return launch<TILE_BF16>(col, a, n_seg, stream);
    case TILE_F32: return launch<TILE_F32>(col, a, n_seg, stream);
    case TILE_I8: return launch<TILE_I8>(col, a, n_seg, stream);
    case TILE_BITS: return launch<TILE_BITS>(col, a, n_seg, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Sums the split runs' partials [n_part, tb, P] into out [*, P], in order.
static cudaError_t finalize(const float* partial, const int* fin_rb, const int* fin_p0,
                            const int* fin_np, int n_fin, int tb, int P, int n_rows, float* out,
                            cudaStream_t stream) {
  const long total = (long)n_fin * tb * P;
  const int blocks = (int)((total + 255) / 256 < 65536 ? (total + 255) / 256 : 65536);
  finalize_runs<float><<<blocks, 256, 0, stream>>>(partial, fin_rb, fin_p0, fin_np, n_fin, tb,
                                                   P, n_rows, nullptr, out);
  return cudaGetLastError();
}

}  // namespace flash_bwd
}  // namespace sg

// K4 over the row-block runs (segments of B.segments): tuu [n_rt*tb, 3H]
// holds t | u1 | u2; fast_exp != 0 takes fast_exp for the probabilities'
// exps. Returns the cudaError_t of the launches.
extern "C" int sg_flash_gat_bwd_row(const void* tiles, int tile_mode, int tb, int n_seg,
                                    const int* seg_rb, const int* seg_lo, const int* seg_hi,
                                    const int* seg_part, int n_fin, const int* fin_rb,
                                    const int* fin_p0, const int* fin_np, const int* tile_cb,
                                    const float* s1, const float* s2, const float* m,
                                    const float* l, const void* Wh, const void* gO, int wvec,
                                    int H, int F, float alpha, int fast_exp, float* tuu, int n_rows_pad,
                                    float* partial, void* stream_ptr) {
  using namespace sg::flash_bwd;
  if (tb % 32 || tb > 1024 || H < 1 || F < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args a{tiles, tb, seg_rb, seg_lo, seg_hi, seg_part, nullptr, tile_cb, nullptr,
         s1, s2, m, l, nullptr,
         static_cast<const __nv_bfloat16*>(Wh), static_cast<const __nv_bfloat16*>(gO),
         H, F, (F + FS - 1) / FS, wvec, alpha, fast_exp, tuu, partial, nullptr, nullptr};
  cudaError_t err = run(false, tile_mode, a, n_seg, stream);
  if (err != cudaSuccess || n_fin == 0) return (int)err;
  return (int)finalize(partial, fin_rb, fin_p0, fin_np, n_fin, tb, 3 * H, n_rows_pad, tuu,
                       stream);
}

// K5 over the column-block runs (segments of B.col_segments, steps index
// col_perm): dwh [n_ct*tb, H*F], ds2 [n_ct*tb, H]. Returns the cudaError_t.
extern "C" int sg_flash_gat_bwd_col(const void* tiles, int tile_mode, int tb, int n_seg,
                                    const int* seg_cb, const int* seg_lo, const int* seg_hi,
                                    const int* seg_part, int n_fin, const int* fin_cb,
                                    const int* fin_p0, const int* fin_np, const int* col_perm,
                                    const int* tile_rb, const float* s1, const float* s2,
                                    const float* m, const float* l, const float* t,
                                    const void* Wh, const void* gO, int wvec, int H, int F,
                                    float alpha, int fast_exp, float* dwh, float* ds2, int n_cols_pad,
                                    float* pdwh, float* pds2, void* stream_ptr) {
  using namespace sg::flash_bwd;
  if (tb % 32 || tb > 1024 || H < 1 || F < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args a{tiles, tb, seg_cb, seg_lo, seg_hi, seg_part, tile_rb, nullptr, col_perm,
         s1, s2, m, l, t,
         static_cast<const __nv_bfloat16*>(Wh), static_cast<const __nv_bfloat16*>(gO),
         H, F, (F + FS - 1) / FS, wvec, alpha, fast_exp, dwh, pdwh, ds2, pds2};
  cudaError_t err = run(true, tile_mode, a, n_seg, stream);
  if (err != cudaSuccess || n_fin == 0) return (int)err;
  err = finalize(pdwh, fin_cb, fin_p0, fin_np, n_fin, tb, H * F, n_cols_pad, dwh, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)finalize(pds2, fin_cb, fin_p0, fin_np, n_fin, tb, H, n_cols_pad, ds2, stream);
}
