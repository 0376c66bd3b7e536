// Shared device code of the block-sparse kernels: the decoding of the tile
// layouts (tile_mask8 and the cp.async copies serve flash_gat.cu and
// flash_gat_bwd.cu) and, for the aggregation
// kernels (bsr_spmm.cu, fused_agg.cu), a CTA that computes one BM x BN
// block of ``acc = sum of A_step @ B_step`` over a segment of schedule
// steps, with bf16 operands staged in shared memory and f32 accumulation
// on the tensor cores (WMMA 16x16x16, which lowers to mma.sync). A step is
// either a dense adjacency
// tile times a tb-row block of H, or a one-hot remainder chunk times K
// gathered rows of H.
//
// Rounding points follow the JAX package exactly: H rounds to bf16; a
// column scale rounds to bf16 and the scaled row rounds to bf16 again; tile
// values round to bf16; products are exact in f32 and summed in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace sg {

constexpr int BM = 128;        // output rows per CTA
constexpr int BN = 128;        // feature columns per CTA
constexpr int BK = 32;         // reduction depth per shared-memory stage
constexpr int NTHREADS = 256;  // 8 warps: 4 along rows x 2 along columns
constexpr int A_LD = BK + 8;   // +8 bf16 keeps rows 16-byte aligned and staggers banks
constexpr int B_LD = BN + 8;

enum TileMode { TILE_BF16 = 0, TILE_F32 = 1, TILE_I8 = 2, TILE_BITS = 3 };

struct alignas(32) Smem {
  __nv_bfloat16 a[BM * A_LD];
  __nv_bfloat16 b[BK * B_LD];
  float stage[NTHREADS / 32][16 * 16];
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Schraudolph's exp, the flash kernels' fast_exp (ops/flash_gat._fast_exp):
// bitcast_f32(int32(max(A x + B, 0))), A = 2^23 / ln 2, B = 127 * 2^23 - 366400.
// The _rn intrinsics keep nvcc from contracting A x + B into an FMA, so the
// bits are the plain version's (one rounding after the product, one after
// the sum).
__device__ __forceinline__ float fast_exp(float x) {
  return __int_as_float(__float2int_rz(fmaxf(__fadd_rn(__fmul_rn(12102203.161561485f, x), 1064986816.f), 0.f)));
}

__device__ __forceinline__ float h_load(const float* H, long i) { return H[i]; }
__device__ __forceinline__ float h_load(const __nv_bfloat16* H, long i) {
  return __bfloat162float(H[i]);
}

// 16 consecutive features of one H row, as f32 (zeros past P).
template <typename TH>
__device__ __forceinline__ void h_load16(const TH* H, long row, int P, int p,
                                         bool vec, float* v) {
  const TH* src = H + row * (long)P + p;
  if (vec && p + 16 <= P) {
    if constexpr (sizeof(TH) == 4) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float4 f = s4[q];
        v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
      }
    } else {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint4 u = s4[q];
        const __nv_bfloat16* hb = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[8 * q + e] = __bfloat162float(hb[e]);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = (p + e < P) ? h_load(H, row * (long)P + p + e) : 0.f;
  }
}

__device__ __forceinline__ void store16_bf16(__nv_bfloat16* dst, const float* v) {
  alignas(16) __nv_bfloat16 t[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) t[e] = __float2bfloat16_rn(v[e]);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  const uint4* t4 = reinterpret_cast<const uint4*>(t);
  d4[0] = t4[0];
  d4[1] = t4[1];
}

// A stage from an adjacency tile: rows row0..row0+BM, columns k0..k0+BK.
// Thread t loads row t/2, columns (t%2)*16 .. +16.
template <int MODE>
__device__ __forceinline__ void load_a_tile(Smem& s, const void* tiles, long tile,
                                            int tb, int row0, int k0) {
  const int r = threadIdx.x >> 1;
  const int c0 = (threadIdx.x & 1) * 16;
  const int lr = row0 + r;
  float v[16];
  if (lr >= tb) {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = 0.f;
  } else if constexpr (MODE == TILE_I8) {
    const int8_t* src = static_cast<const int8_t*>(tiles) + (tile * tb + lr) * (long)tb + k0 + c0;
    uint4 u = *reinterpret_cast<const uint4*>(src);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = (float)b[e];
  } else if constexpr (MODE == TILE_BF16) {
    const __nv_bfloat16* src =
        static_cast<const __nv_bfloat16*>(tiles) + (tile * tb + lr) * (long)tb + k0 + c0;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(s.a + r * A_LD + c0);
    d4[0] = s4[0];
    d4[1] = s4[1];
    return;
  } else if constexpr (MODE == TILE_F32) {
    const float4* s4 = reinterpret_cast<const float4*>(
        static_cast<const float*>(tiles) + (tile * tb + lr) * (long)tb + k0 + c0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4 f = s4[q];
      v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
    }
  } else {  // TILE_BITS: byte i, bit j of a row holds column j*(tb/8) + i
    const int nb = tb >> 3;
    const int c = k0 + c0;  // 16 columns inside one bit plane (nb % 16 == 0)
    const int plane = c / nb;
    const uint8_t* src = static_cast<const uint8_t*>(tiles) + (tile * tb + lr) * (long)nb + (c % nb);
    uint4 u = *reinterpret_cast<const uint4*>(src);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&u);
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = (float)((b[e] >> plane) & 1);
  }
  store16_bf16(s.a + r * A_LD + c0, v);
}

// The edge mask of eight consecutive entries (columns c .. c+8, c % 8 == 0)
// of local row lr of a tile, as bits (bit q: column c + q), in the layouts
// load_a_tile reads: int8 masks hold {0,1}; packed tiles hold byte i,
// bit j of a row at column j*(tb/8) + i (needs tb % 64 == 0); value tiles
// mask on > 0.
template <int MODE>
__device__ __forceinline__ unsigned tile_mask8(const void* tiles, long tile, int tb, int lr,
                                               int c) {
  const long row = tile * tb + lr;
  unsigned bits = 0;
  if constexpr (MODE == TILE_I8) {
    uint2 u = *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(tiles) + row * tb + c);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) bits |= (unsigned)(b[e] != 0) << e;
  } else if constexpr (MODE == TILE_BF16) {
    uint4 u = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(tiles) + row * tb + c);
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) bits |= (unsigned)(__bfloat162float(b[e]) > 0.f) << e;
  } else if constexpr (MODE == TILE_F32) {
    const float4* s4 = reinterpret_cast<const float4*>(static_cast<const float*>(tiles) + row * tb + c);
    float4 a = s4[0], b = s4[1];
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) bits |= (unsigned)(v[e] > 0.f) << e;
  } else {  // TILE_BITS
    const int nb = tb >> 3;
    const int plane = c / nb;
    uint2 u = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(tiles) + row * nb + (c % nb));
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) bits |= (unsigned)((b[e] >> plane) & 1) << e;
  }
  return bits;
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// B stage from the H block of column block cb: rows k0..k0+BK, features
// p0..p0+BN, optionally column-scaled. Thread t loads row t/8, features
// (t%8)*16 .. +16.
template <typename TH>
__device__ __forceinline__ void load_b_tile(Smem& s, const TH* H, int n_cols, int P,
                                            bool vec, const float* colscale, int cb,
                                            int tb, int k0, int p0) {
  const int kr = threadIdx.x >> 3;
  const int c0 = (threadIdx.x & 7) * 16;
  const long grow = (long)cb * tb + k0 + kr;
  float v[16];
  if (grow < n_cols) {
    h_load16(H, grow, P, p0 + c0, vec, v);
    if (colscale != nullptr) {
      const float cs = bf16r(colscale[grow]);
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = bf16r(bf16r(v[e]) * cs);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = 0.f;
  }
  store16_bf16(s.b + kr * B_LD + c0, v);
}

// A stage of a remainder chunk: the one-hot of the chunk's local rows,
// onehot[r][k] = (lrow[k] == row0 + r); dead slots hold lrow == tb.
__device__ __forceinline__ void load_a_chunk(Smem& s, const int* lrow, long chunk, int K,
                                             int tb, int row0, int k0) {
  const int r = threadIdx.x >> 1;
  const int c0 = (threadIdx.x & 1) * 16;
  const int lr = row0 + r;
  const int* l = lrow + chunk * K + k0 + c0;
  float v[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = (lr < tb && l[e] == lr) ? 1.f : 0.f;
  store16_bf16(s.a + r * A_LD + c0, v);
}

// B stage of a remainder chunk: G = bf16(bf16(H[slot_col]) * bf16(slot_scale)).
template <typename TH>
__device__ __forceinline__ void load_b_chunk(Smem& s, const TH* H, int P, bool vec,
                                             const int* slot_col, const float* slot_scale,
                                             long chunk, int K, int k0, int p0) {
  const int kr = threadIdx.x >> 3;
  const int c0 = (threadIdx.x & 7) * 16;
  const long slot = chunk * K + k0 + kr;
  const float sc = bf16r(slot_scale[slot]);
  float v[16];
  h_load16(H, (long)slot_col[slot], P, p0 + c0, vec, v);
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = bf16r(bf16r(v[e]) * sc);
  store16_bf16(s.b + kr * B_LD + c0, v);
}

using namespace nvcuda;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// acc += s.a (BM x BK) @ s.b (BK x BN); warp w owns rows (w%4)*32 .. +32
// and columns (w/4)*64 .. +64 of the block.
__device__ __forceinline__ void mma_stage(const Smem& s, AccFrag (&acc)[2][4]) {
  const int warp = threadIdx.x >> 5;
  const int wr = (warp & 3) * 32;
  const int wc = (warp >> 2) * 64;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], s.a + (wr + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(b[j], s.b + kk * B_LD + wc + 16 * j, B_LD);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero_acc(AccFrag (&acc)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// acc += tile @ (colscale * H[cb block]) over the whole tile depth tb.
template <int MODE, typename TH>
__device__ __forceinline__ void tile_step(Smem& s, AccFrag (&acc)[2][4], const void* tiles,
                                          long tile, int cb, int tb, int row0, const TH* H,
                                          int n_cols, int P, bool vec, const float* colscale,
                                          int p0) {
  for (int k0 = 0; k0 < tb; k0 += BK) {
    load_a_tile<MODE>(s, tiles, tile, tb, row0, k0);
    load_b_tile(s, H, n_cols, P, vec, colscale, cb, tb, k0, p0);
    __syncthreads();
    mma_stage(s, acc);
    __syncthreads();
  }
}

// acc += onehot(lrow[chunk]) @ G[chunk] over the chunk's K slots.
template <typename TH>
__device__ __forceinline__ void chunk_step(Smem& s, AccFrag (&acc)[2][4], const int* lrow,
                                           const int* slot_col, const float* slot_scale,
                                           long chunk, int K, int tb, int row0, const TH* H,
                                           int P, bool vec, int p0) {
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a_chunk(s, lrow, chunk, K, tb, row0, k0);
    load_b_chunk(s, H, P, vec, slot_col, slot_scale, chunk, K, k0, p0);
    __syncthreads();
    mma_stage(s, acc);
    __syncthreads();
  }
}

// Epilogue. part < 0: the segment covers its whole row-block run, so write
// out[row] = rowscale[row] * acc (or acc) in TO. part >= 0: write the f32
// partial sum to partial[part] for the finalize pass.
template <typename TO>
__device__ __forceinline__ void store_block(Smem& s, AccFrag (&acc)[2][4], int rb, int tb,
                                            int row0, int p0, int P, int n_rows,
                                            const float* rowscale, TO* out, float* partial,
                                            int part) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = (warp & 3) * 32;
  const int wc = (warp >> 2) * 64;
  float* st = s.stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane >> 1;
      const int lr = row0 + wr + 16 * i + r;
      const int pb = p0 + wc + 16 * j + (lane & 1) * 8;
      if (lr < tb) {
        const long grow = (long)rb * tb + lr;
        if (part >= 0) {
          float* dst = partial + ((long)part * tb + lr) * P;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (pb + e < P) dst[pb + e] = st[r * 16 + (lane & 1) * 8 + e];
        } else if (grow < n_rows) {
          const float rs = rowscale != nullptr ? rowscale[grow] : 1.f;
          TO* dst = out + grow * P;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (pb + e < P) {
              float o = st[r * 16 + (lane & 1) * 8 + e];
              if (rowscale != nullptr) o *= rs;
              if constexpr (sizeof(TO) == 2) dst[pb + e] = __float2bfloat16_rn(o);
              else dst[pb + e] = o;
            }
          }
        }
      }
      __syncwarp();
    }
  }
}

// Sums the partials of each split run in a fixed order and writes
// out[row] = rowscale[row] * sum (or sum) in TO.
template <typename TO>
__global__ void finalize_runs(const float* partial, const int* fin_rb, const int* fin_p0,
                              const int* fin_np, int n_fin, int tb, int P, int n_rows,
                              const float* rowscale, TO* out) {
  const long total = (long)n_fin * tb * P;
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const int f = (int)(idx / ((long)tb * P));
    const long rem = idx - (long)f * tb * P;
    const int lr = (int)(rem / P);
    const int p = (int)(rem - (long)lr * P);
    const long grow = (long)fin_rb[f] * tb + lr;
    if (grow >= n_rows) continue;
    float acc = 0.f;
    const int q0 = fin_p0[f];
    for (int q = q0; q < q0 + fin_np[f]; ++q) acc += partial[((long)q * tb + lr) * P + p];
    if (rowscale != nullptr) acc *= rowscale[grow];
    if constexpr (sizeof(TO) == 2) out[grow * P + p] = __float2bfloat16_rn(acc);
    else out[grow * P + p] = acc;
  }
}

}  // namespace sg
