// Shared device code of the full-integer aggregation kernels
// (bsr_spmm_int8.cu, fused_agg_int8.cu): a CTA computes one BM x BN block
// of the exact int32 product ``Aq @ Hq`` over a segment of schedule steps.
//
// Adjacency tiles hold the unsigned 0..255 grid stored shifted by -128
// (``As = Aq - 128``, int8); Hq is signed int8. A tile step multiplies
// ``As @ Hq[cb]`` on the int8 tensor cores (WMMA s8 x s8 16x16x16 with int
// accumulators, which lowers to mma.sync) and undoes the shift with
//
//     Aq @ Hq[cb] = As @ Hq[cb] + 128 * colsum(Hq[cb])        per present tile,
//
// where the column sums of every tb-row block of Hq come from one small
// first kernel (``colsum_kernel``), so a CTA only adds ``colsum[cb]`` for
// each tile it walks. A chunk step of the fused kernel adds, for each live
// remainder slot, ``v * Hq[slot_col]`` (v the edge's 0..255 value) into a
// shared-memory int32 block with integer atomics: integer sums do not
// depend on their order, so the result is the same run to run. The
// accumulator is int32 from the first product to the store; sums wrap
// modulo 2^32 on the way exactly as the reference's int32 sums do.
//
// Shared-memory operands are laid out as 16-byte-wide panels (A: one panel
// per 16 k-columns, B: one per 16 feature columns) so that every WMMA
// fragment pointer is 32-byte aligned with a leading dimension of 16 bytes.
#pragma once

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace sg8 {

using namespace nvcuda;

constexpr int BM = 128;        // output rows per CTA
constexpr int BN = 128;        // feature columns per CTA
constexpr int BK = 32;         // reduction depth per shared-memory stage
constexpr int NTHREADS = 256;  // 8 warps: 4 along rows x 2 along columns
constexpr int PW = 16;         // panel width in bytes

struct alignas(32) Smem {
  int8_t a[(BK / PW) * BM * PW];  // [k panel][row][16]
  int8_t b[(BN / PW) * BK * PW];  // [feature panel][k][16]
  int stage[NTHREADS / 32][16 * 16];
  int corr[BN];  // 128 * sum of colsum[cb] over the CTA's tile steps
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> AccFrag;

// A stage from a shifted tile: rows row0..row0+BM, columns k0..k0+BK.
// Thread t loads row t/2, columns (t%2)*16 .. +16 (rows past tb: zeros).
__device__ __forceinline__ void load_a_tile(Smem& s, const int8_t* tiles, long tile, int tb,
                                            int row0, int k0) {
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int lr = row0 + r;
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (lr < tb)
    u = *reinterpret_cast<const uint4*>(tiles + (tile * tb + lr) * (long)tb + k0 + half * PW);
  *reinterpret_cast<uint4*>(s.a + (half * BM + r) * PW) = u;
}

// B stage from the Hq block of column block cb: rows k0..k0+BK, features
// p0..p0+BN (zeros past n_h rows and past P). Thread t loads row t/8,
// features (t%8)*16 .. +16.
__device__ __forceinline__ void load_b_tile(Smem& s, const int8_t* H, int n_h, int P, bool vec,
                                            int cb, int tb, int k0, int p0) {
  const int kr = threadIdx.x >> 3;
  const int j = threadIdx.x & 7;
  const long grow = (long)cb * tb + k0 + kr;
  const int p = p0 + j * PW;
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (grow < n_h && p < P) {
    const int8_t* src = H + grow * (long)P + p;
    if (vec && p + PW <= P) {
      u = *reinterpret_cast<const uint4*>(src);
    } else {
      alignas(16) int8_t v[PW];
#pragma unroll
      for (int e = 0; e < PW; ++e) v[e] = (p + e < P) ? src[e] : (int8_t)0;
      u = *reinterpret_cast<const uint4*>(v);
    }
  }
  *reinterpret_cast<uint4*>(s.b + (j * BK + kr) * PW) = u;
}

// acc += s.a (BM x BK) @ s.b (BK x BN); warp w owns rows (w%4)*32 .. +32
// and columns (w/4)*64 .. +64 of the block.
__device__ __forceinline__ void mma_stage(const Smem& s, AccFrag (&acc)[2][4]) {
  const int warp = threadIdx.x >> 5;
  const int wr = (warp & 3) * 32;
  const int wc = (warp >> 2) * 64;
#pragma unroll
  for (int kp = 0; kp < BK / PW; ++kp) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], reinterpret_cast<const signed char*>(s.a) +
                                       (kp * BM + wr + 16 * i) * PW, PW);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::load_matrix_sync(b[j], reinterpret_cast<const signed char*>(s.b) +
                                       ((wc / PW + j) * BK + kp * 16) * PW, PW);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

// acc += As_tile @ Hq[cb block] over the whole tile depth tb.
__device__ __forceinline__ void tile_step(Smem& s, AccFrag (&acc)[2][4], const int8_t* tiles,
                                          long tile, int cb, int tb, int row0, const int8_t* H,
                                          int n_h, int P, bool vec, int p0) {
  for (int k0 = 0; k0 < tb; k0 += BK) {
    load_a_tile(s, tiles, tile, tb, row0, k0);
    load_b_tile(s, H, n_h, P, vec, cb, tb, k0, p0);
    __syncthreads();
    mma_stage(s, acc);
    __syncthreads();
  }
}

// cacc[lrow - row0] += v * Hq[slot_col] for the live slots of one chunk
// whose local row falls in this CTA's row group. Warp w takes slots
// w, w+8, ...; lane l the features l, l+32, l+64, l+96 of the slice.
__device__ __forceinline__ void chunk_step(int* cacc, const int* lrow, const int* slot_col,
                                           const float* slot_val, long chunk, int K, int tb,
                                           int row0, const int8_t* H, int n_h, int P, int p0) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = warp; j < K; j += NTHREADS / 32) {
    const long slot = chunk * K + j;
    const int l = lrow[slot];  // tb marks a dead slot
    const int r = l - row0;
    const long hrow = slot_col[slot];
    if (l >= tb || r < 0 || r >= BM || hrow >= n_h) continue;
    const int v = (int)slot_val[slot];  // integers 0..255 held in f32
    const int8_t* src = H + hrow * (long)P + p0;
#pragma unroll
    for (int e = 0; e < BN / 32; ++e) {
      const int c = e * 32 + lane;
      if (p0 + c < P) {
        const int h = (int)src[c];
        if (h != 0) atomicAdd(cacc + r * BN + c, v * h);
      }
    }
  }
}

// Epilogue: out = acc + corr (+ cacc). part < 0: the segment covers its
// whole row-block run, so write the rows below n_out; part >= 0: write the
// int32 partial sum to partial[part] for the finalize pass.
__device__ __forceinline__ void store_block(Smem& s, AccFrag (&acc)[2][4], const int* cacc, int rb,
                                            int tb, int row0, int p0, int P, long n_out, int* out,
                                            int* partial, int part) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = (warp & 3) * 32;
  const int wc = (warp >> 2) * 64;
  int* st = s.stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane >> 1;
      const int br = wr + 16 * i + r;  // row inside the CTA's block
      const int lr = row0 + br;
      const int bc = wc + 16 * j + (lane & 1) * 8;  // first of 8 block columns
      if (lr < tb) {
        const long grow = (long)rb * tb + lr;
        int* dst = nullptr;
        if (part >= 0) dst = partial + ((long)part * tb + lr) * P + p0;
        else if (grow < n_out) dst = out + grow * P + p0;
        if (dst != nullptr) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int c = bc + e;
            if (p0 + c < P) {
              unsigned o = (unsigned)st[r * 16 + (lane & 1) * 8 + e] + (unsigned)s.corr[c];
              if (cacc != nullptr) o += (unsigned)cacc[br * BN + c];
              dst[c] = (int)o;
            }
          }
        }
      }
      __syncwarp();
    }
  }
}

// One CTA per (segment, 128-row group, 128-feature slice). FUSED: the
// steps are those of a fused plan (step_tile/step_cb/step_chunk/step_kind;
// kind 0 tile, 1 chunk, 3 both) and ``cacc`` lives in dynamic shared
// memory; else step g is tile g with column block step_cb[g].
template <bool FUSED>
__global__ void __launch_bounds__(NTHREADS)
    agg_int8_kernel(const int8_t* tiles, int tb, int n_rg, const int* seg_rb, const int* seg_lo,
                    const int* seg_hi, const int* seg_part, const int* step_cb,
                    const int* step_tile, const int* step_chunk, const int* step_kind,
                    const int* lrow, const int* slot_col, const float* slot_val, int K,
                    const int8_t* H, int n_h, int P, int vec, const int* colsum, int* out,
                    int* partial, long n_out) {
  __shared__ Smem s;
  extern __shared__ int cacc_dyn[];
  int* cacc = FUSED ? cacc_dyn : nullptr;
  const int seg = blockIdx.x / n_rg;
  const int row0 = (blockIdx.x % n_rg) * BM;
  const int p0 = blockIdx.y * BN;
  if (FUSED) {
    for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) cacc[i] = 0;
    __syncthreads();
  }
  AccFrag acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);
  unsigned corr = 0u;  // thread c < BN: sum of colsum[cb][p0 + c] over the tile steps
  const bool my_col = threadIdx.x < BN && p0 + (int)threadIdx.x < P;
  for (int g = seg_lo[seg]; g < seg_hi[seg]; ++g) {
    const int kind = FUSED ? step_kind[g] : 0;
    if (kind != 1) {
      const int cb = step_cb[g];
      const long tile = FUSED ? step_tile[g] : g;
      tile_step(s, acc, tiles, tile, cb, tb, row0, H, n_h, P, vec != 0, p0);
      if (my_col) corr += (unsigned)colsum[(long)cb * P + p0 + threadIdx.x];
    }
    if (FUSED && kind >= 1)
      chunk_step(cacc, lrow, slot_col, slot_val, step_chunk[g], K, tb, row0, H, n_h, P, p0);
  }
  if (threadIdx.x < BN) s.corr[threadIdx.x] = (int)(corr * 128u);
  __syncthreads();
  store_block(s, acc, cacc, seg_rb[seg], tb, row0, p0, P, n_out, out, partial, seg_part[seg]);
}

// colsum[cb][p] = sum of Hq[cb*tb + k][p] over k < tb (rows past n_h add
// nothing). Grid (n_ct, ceil(P / 128)); warp w sums rows w, w+8, ...
static __global__ void __launch_bounds__(NTHREADS)
    colsum_kernel(const int8_t* H, int n_h, int P, int tb, int vec4, int* colsum) {
  __shared__ int part[NTHREADS / 32][BN];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cb = blockIdx.x;
  const int p0 = blockIdx.y * BN;
  int acc[4] = {0, 0, 0, 0};
  // vec4: lane holds features 4*lane .. +4 (one 32-bit load); else l + 32*e
  for (int k = warp; k < tb; k += NTHREADS / 32) {
    const long grow = (long)cb * tb + k;
    if (grow >= n_h) break;
    const int8_t* src = H + grow * (long)P + p0;
    if (vec4 && p0 + 4 * lane + 4 <= P) {
      const int w = *reinterpret_cast<const int*>(src + 4 * lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += (int)(int8_t)((w >> (8 * e)) & 0xFF);
    } else if (vec4) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (p0 + 4 * lane + e < P) acc[e] += (int)src[4 * lane + e];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (p0 + e * 32 + lane < P) acc[e] += (int)src[e * 32 + lane];
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) part[warp][vec4 ? 4 * lane + e : e * 32 + lane] = acc[e];
  __syncthreads();
  if (threadIdx.x < BN && p0 + (int)threadIdx.x < P) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < NTHREADS / 32; ++w) sum += part[w][threadIdx.x];
    colsum[(long)cb * P + p0 + threadIdx.x] = sum;
  }
}

// Sums the int32 partials of each split run in a fixed order.
static __global__ void finalize_runs_i32(const int* partial, const int* fin_rb, const int* fin_p0,
                                  const int* fin_np, int n_fin, int tb, int P, long n_out,
                                  int* out) {
  const long total = (long)n_fin * tb * P;
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const int f = (int)(idx / ((long)tb * P));
    const long rem = idx - (long)f * tb * P;
    const int lr = (int)(rem / P);
    const int p = (int)(rem - (long)lr * P);
    const long grow = (long)fin_rb[f] * tb + lr;
    if (grow >= n_out) continue;
    unsigned acc = 0u;
    const int q0 = fin_p0[f];
    for (int q = q0; q < q0 + fin_np[f]; ++q) acc += (unsigned)partial[((long)q * tb + lr) * P + p];
    out[grow * P + p] = (int)acc;
  }
}

// The three launches of one aggregation: column sums, the segment CTAs,
// the split runs' sums. Returns the first cudaError_t (0 on success).
template <bool FUSED>
static int launch_agg_int8(const int8_t* tiles, int tb, int n_seg, const int* seg_rb,
                           const int* seg_lo, const int* seg_hi, const int* seg_part, int n_fin,
                           const int* fin_rb, const int* fin_p0, const int* fin_np,
                           const int* step_cb, const int* step_tile, const int* step_chunk,
                           const int* step_kind, const int* lrow, const int* slot_col,
                           const float* slot_val, int K, const int8_t* H, int n_h, int n_ct, int P,
                           int vec, int vec4, int* colsum, int* out, int* partial, long n_out,
                           cudaStream_t stream) {
  const int n_ps = (P + BN - 1) / BN;
  colsum_kernel<<<dim3(n_ct, n_ps), NTHREADS, 0, stream>>>(H, n_h, P, tb, vec4, colsum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_rg = (tb + BM - 1) / BM;
  const size_t dyn = FUSED ? sizeof(int) * BM * BN : 0;
  if (FUSED) {
    err = cudaFuncSetAttribute(agg_int8_kernel<FUSED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  agg_int8_kernel<FUSED><<<dim3(n_seg * n_rg, n_ps), NTHREADS, dyn, stream>>>(
      tiles, tb, n_rg, seg_rb, seg_lo, seg_hi, seg_part, step_cb, step_tile, step_chunk,
      step_kind, lrow, slot_col, slot_val, K, H, n_h, P, vec, colsum, out, partial, n_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_fin == 0) return (int)err;
  const long total = (long)n_fin * tb * P;
  const int blocks = (int)((total + 255) / 256 < 65536 ? (total + 255) / 256 : 65536);
  finalize_runs_i32<<<blocks, 256, 0, stream>>>(partial, fin_rb, fin_p0, fin_np, n_fin, tb, P,
                                                n_out, out);
  return (int)cudaGetLastError();
}

}  // namespace sg8
