// Row-loop tile SpMM on Hopper: K1's product, out = A @ H over the
// nonempty tb x tb tiles, with one CTA per (output row block, 128-row
// group, 128-feature slice) that walks all of the row block's tiles
// through a two-stage ring, so every output block is written exactly once
// and no second kernel sums partials.
//
// Replaces sgracex1_tpu/ops/bsr.py:bsr_spmm_rowloop (Pallas kernel
// _bsr_rowloop_kernel): one grid step per output row block and a
// two-deep buffer of (tile, H block) pairs filled by manual async copies.
// Two whole pairs do not fit a CTA's shared memory here (a 256 x 256 int8
// tile and a 256 x 128 bf16 H block are 128 KiB), so the ring holds slices
// of the reduction dimension: stage i + 1's raw bytes (BM x BK of the tile
// in its stored form, BK x BN of H in its own type) travel by cp.async
// while stage i is converted to bf16 operands and multiplied. H rows
// whose width or address does not allow 16-byte copies are stored into the
// ring synchronously instead.
//
// Bound on the H100: as K1, the tile bytes and the tb x P H block a tile
// and row group. What this variant adds is the serial walk: a hub row
// block with thousands of tiles is one CTA's work while other SMs idle.
#include "tile_gemm.cuh"

namespace sg {
namespace rowloop {

// bytes of one tile row inside a BK-wide slice, as stored
template <int MODE>
__host__ __device__ constexpr int a_row_bytes() {
  return MODE == TILE_F32 ? BK * 4 : MODE == TILE_BF16 ? BK * 2 : BK;
}

template <int MODE, typename TH>
struct Ring {
  static constexpr int A_BYTES = BM * a_row_bytes<MODE>();
  static constexpr int B_BYTES = BK * BN * (int)sizeof(TH);
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int TOTAL = (int)sizeof(Smem) + 2 * STAGE;
};

__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Start the copies of one stage: rows row0 .. row0 + BM, columns
// k0 .. k0 + BK of `tile`, and rows k0 .. k0 + BK of H block cb, features
// p0 .. p0 + BN. Rows past the tile or past H, and features past P, fill
// with zeros.
template <int MODE, typename TH>
__device__ __forceinline__ void start_stage(unsigned char* ra, unsigned char* rb_,
                                            const void* tiles, long tile, int tb, int row0,
                                            int k0, const TH* H, int n_cols, int P, bool vec,
                                            int cb, int p0) {
  constexpr int ARB = a_row_bytes<MODE>();
  constexpr int PPR = ARB / 16;  // 16-byte pieces a row
  const unsigned char* base = static_cast<const unsigned char*>(tiles);
  for (int idx = threadIdx.x; idx < BM * PPR; idx += NTHREADS) {
    const int r = idx / PPR, q = idx % PPR;
    const int lr = row0 + r;
    const bool ok = lr < tb;
    long off;
    if constexpr (MODE == TILE_BITS) {
      // byte i, bit j of a packed row holds column j * (tb/8) + i: the 16
      // columns k0 + 16q .. lie in one bit plane, at bytes (k0 + 16q) % nb
      const int nb = tb >> 3;
      off = (tile * tb + lr) * (long)nb + (k0 + 16 * q) % nb;
    } else {
      constexpr int ES = MODE == TILE_F32 ? 4 : MODE == TILE_BF16 ? 2 : 1;
      off = ((tile * tb + lr) * (long)tb + k0) * ES + 16 * q;
    }
    cp_async16(ra + r * ARB + 16 * q, ok ? base + off : base, ok);
  }
  constexpr int W = 16 / (int)sizeof(TH);  // features a 16-byte piece
  if (vec) {
    for (int idx = threadIdx.x; idx < BK * BN / W; idx += NTHREADS) {
      const int kr = idx / (BN / W), f = (idx % (BN / W)) * W;
      const long grow = (long)cb * tb + k0 + kr;
      const bool ok = grow < n_cols && p0 + f < P;
      cp_async16(rb_ + (kr * BN + f) * sizeof(TH), ok ? H + grow * P + p0 + f : H, ok);
    }
  } else {
    TH* dst = reinterpret_cast<TH*>(rb_);
    for (int idx = threadIdx.x; idx < BK * BN; idx += NTHREADS) {
      const int kr = idx / BN, f = idx % BN;
      const long grow = (long)cb * tb + k0 + kr;
      TH x;
      if (grow < n_cols && p0 + f < P) x = H[grow * P + p0 + f];
      else if constexpr (sizeof(TH) == 4) x = 0.f;
      else x = __float2bfloat16_rn(0.f);
      dst[idx] = x;
    }
  }
  cp_async_commit();
}

// Raw stage -> bf16 operands. Thread t converts tile row t/2, columns
// (t%2)*16 .. +16, and H row t/8, features (t%8)*16 .. +16.
template <int MODE, typename TH>
__device__ __forceinline__ void convert(Smem& s, const unsigned char* ra,
                                        const unsigned char* rb_, int tb, int k0) {
  constexpr int ARB = a_row_bytes<MODE>();
  {
    const int r = threadIdx.x >> 1;
    const int c0 = (threadIdx.x & 1) * 16;
    float v[16];
    if constexpr (MODE == TILE_BF16) {
      const uint4* s4 = reinterpret_cast<const uint4*>(ra + r * ARB + c0 * 2);
      uint4* d4 = reinterpret_cast<uint4*>(s.a + r * A_LD + c0);
      d4[0] = s4[0];
      d4[1] = s4[1];
    } else {
      if constexpr (MODE == TILE_F32) {
        const float* src = reinterpret_cast<const float*>(ra + r * ARB) + c0;
#pragma unroll
        for (int e = 0; e < 16; ++e) v[e] = src[e];
      } else if constexpr (MODE == TILE_I8) {
        const int8_t* src = reinterpret_cast<const int8_t*>(ra + r * ARB) + c0;
#pragma unroll
        for (int e = 0; e < 16; ++e) v[e] = (float)src[e];
      } else {
        const uint8_t* src = ra + r * ARB + c0;
        const int plane = (k0 + c0) / (tb >> 3);
#pragma unroll
        for (int e = 0; e < 16; ++e) v[e] = (float)((src[e] >> plane) & 1);
      }
      store16_bf16(s.a + r * A_LD + c0, v);
    }
  }
  {
    const int kr = threadIdx.x >> 3;
    const int c0 = (threadIdx.x & 7) * 16;
    const TH* src = reinterpret_cast<const TH*>(rb_) + kr * BN + c0;
    float v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = h_load(src, e);
    store16_bf16(s.b + kr * B_LD + c0, v);
  }
}

template <int MODE, typename TH>
__global__ void __launch_bounds__(NTHREADS)
    rowloop_kernel(const void* tiles, int tb, int n_rg, const int* row_start, const int* tile_cb,
                   const TH* H, int n_cols, int P, int vec, float* out, int n_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  using R = Ring<MODE, TH>;
  Smem& s = *reinterpret_cast<Smem*>(smem);
  unsigned char* ring = smem + sizeof(Smem);
  const int rb = blockIdx.x / n_rg;
  const int row0 = (blockIdx.x % n_rg) * BM;
  const int p0 = blockIdx.y * BN;
  const int t0 = row_start[rb];
  const int nk = tb / BK;
  const int total = (row_start[rb + 1] - t0) * nk;  // (tile, slice) stages
  AccFrag acc[2][4];
  zero_acc(acc);
  auto start = [&](int i) {
    const int t = t0 + i / nk;
    unsigned char* st = ring + (i & 1) * R::STAGE;
    start_stage<MODE, TH>(st, st + R::A_BYTES, tiles, t, tb, row0, (i % nk) * BK, H, n_cols, P,
                          vec != 0, tile_cb[t], p0);
  };
  if (total > 0) start(0);
  for (int i = 0; i < total; ++i) {
    // stage i + 1 overwrites the bytes stage i - 1 was converted from,
    // which every thread left before the barrier ahead of its product
    if (i + 1 < total) start(i + 1);
    else cp_async_commit();
    cp_async_wait_1();  // all but the newest group: stage i has landed
    __syncthreads();
    const unsigned char* st = ring + (i & 1) * R::STAGE;
    convert<MODE, TH>(s, st, st + R::A_BYTES, tb, (i % nk) * BK);
    __syncthreads();
    mma_stage(s, acc);
  }
  __syncthreads();
  store_block<float>(s, acc, rb, tb, row0, p0, P, n_rows, nullptr, out, nullptr, -1);
}

template <int MODE, typename TH>
static cudaError_t launch(const void* tiles, int tb, int n_rt, const int* row_start,
                          const int* tile_cb, const void* H, int n_cols, int P, int vec,
                          float* out, int n_rows, cudaStream_t stream) {
  constexpr int bytes = Ring<MODE, TH>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(rowloop_kernel<MODE, TH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_rg = (tb + BM - 1) / BM;
  dim3 grid(n_rt * n_rg, (P + BN - 1) / BN);
  rowloop_kernel<MODE, TH><<<grid, NTHREADS, bytes, stream>>>(
      tiles, tb, n_rg, row_start, tile_cb, static_cast<const TH*>(H), n_cols, P, vec, out,
      n_rows);
  return cudaGetLastError();
}

}  // namespace rowloop
}  // namespace sg

// row_start[n_rt + 1]: first tile of every row block (tiles are sorted by
// row block). Returns the cudaError_t of the launch (0 on success).
extern "C" int sg_bsr_spmm_rowloop(const void* tiles, int tile_mode, int tb, int n_rt,
                                   const int* row_start, const int* tile_cb, const void* H,
                                   int h_bf16, int n_cols, int P, int vec, float* out,
                                   int n_rows, void* stream_ptr) {
  using namespace sg;
  using namespace sg::rowloop;
  if (tb % 32 || n_rt < 1 || P < 1) return (int)cudaErrorInvalidValue;
  if (tile_mode == TILE_BITS && tb % 128) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define SG_LAUNCH(MODE, TH) \
  launch<MODE, TH>(tiles, tb, n_rt, row_start, tile_cb, H, n_cols, P, vec, out, n_rows, stream)
#define SG_BY_H(MODE) return (int)(h_bf16 ? SG_LAUNCH(MODE, __nv_bfloat16) : SG_LAUNCH(MODE, float))
  switch (tile_mode) {
    case TILE_BF16: SG_BY_H(TILE_BF16);
    case TILE_F32: SG_BY_H(TILE_F32);
    case TILE_I8: SG_BY_H(TILE_I8);
    case TILE_BITS: SG_BY_H(TILE_BITS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SG_BY_H
#undef SG_LAUNCH
}
