// The ring pipeline of the tile-aggregation kernels K1 (bsr_spmm_ring.cu),
// K2 and K11 (fused_agg_ring.cu, K11 with k slabs a stage) and the cluster
// K10 (bsr_spmm_cluster.cu) on Hopper.
//
// acc[tb x 128] = sum over the live steps of a work item of
//   tile step:  tile[tb x tb] @ Hs[cb*tb .. +tb, p0 .. +128]
//   chunk step: onehot(lrow)[tb x K] @ Hs[slot_col, p0 .. +128]
// with bf16 operands and f32 sums on the tensor cores.
//
// What differs from the single-stage pipeline of tile_gemm.cuh:
//  * H is rounded (and column-scaled) to bf16 once, by stage_h_kernel, so the
//    B operand of both step kinds is a plain bf16 matrix Hs that the copy
//    engine can move; nothing is converted in the inner loop but the int8
//    mask bytes, in registers.
//  * One persistent CTA per SM walks work items (segment, 128-feature slice)
//    and owns the whole tile height, so a tile and its Hs block are read
//    once per feature slice.
//  * A producer warp keeps a ring of STAGES k-slabs (64 deep) in flight: per
//    slab one TMA tensor copy of the tile's columns and one of the Hs rows
//    (chunk steps: the gathered Hs rows by cp.async, 16 bytes a lane, and a
//    bulk copy of the slab's lrow), completing on an mbarrier. Eight
//    consumer warps (4 along rows x 2 along features, 64 x 64 each) wait for
//    a slab, run mma.sync m16n8k16 on it (B through ldmatrix.trans, A
//    through ldmatrix for bf16 tiles or converted from the int8 bytes in
//    registers) and release it on a second mbarrier. The producer runs ahead
//    across steps and work items, so the epilogue of one item overlaps the
//    loads of the next. The producer's warpgroup gives its registers to the
//    consumers (setmaxnreg 40 / 232): 128 accumulators a thread do not fit
//    the 168 that three warpgroups start with.
//  * A chunk is read only up to its last live slot, in whole slabs, and a
//    dead slot's row is zero-filled, not gathered: dead slots all name row
//    0, and a quarter of a million copies of one line that bypass L1 queue
//    on its L2 slice.
//  * Shared-memory rows are padded, not swizzled: the tensor maps ask for
//    boxes 8 elements wider than they need (136 features, 72 bf16 tile
//    columns), which gives row pitches of 272 and 144 bytes, free of bank
//    conflicts for ldmatrix.
//  * For int8 tiles a thread reads 16 consecutive bytes of a tile row and
//    feeds them to four MMAs in a permuted k order; the B rows are fetched
//    in the same order (ldmatrix takes one address per row), chosen so that
//    the eight rows of every 8x8 matrix fall in different banks.
//  * The epilogue scales and stores from registers, 16 bytes a lane, with no
//    shared staging: a lane pair exchanges halves to hold 4 consecutive
//    features of one row (f32), a quad's halves exchange again to hold 8
//    (bf16), so that no instruction leaves a 32-byte sector half written.
//
// Rounding points are those of tile_gemm.cuh: H to bf16, the column scale to
// bf16 and the scaled row to bf16 again, tile values to bf16, value-mode
// chunk rows bf16(bf16(H) * bf16(slot_scale)); exact products, f32 sums.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace sgr {

enum TileMode { TILE_BF16 = 0, TILE_I8 = 2 };  // the numbering of tile_gemm.cuh

constexpr int RM = 256;             // most rows a CTA owns: the whole tile height
constexpr int BN = 128;             // feature columns per CTA
constexpr int KS = 64;              // reduction depth of one stage
constexpr int CONSUMER_WARPS = 8;   // 4 along rows x 2 along features
// two consumer warpgroups and the producer's warpgroup, of which one warp
// works: setmaxnreg moves registers between whole warpgroups
constexpr int NTHREADS = 32 * (CONSUMER_WARPS + 4);
constexpr int STAGES = 4;
constexpr int B_BOX = BN + 8;       // features per B box: 8 spare ones pad the pitch
constexpr int B_PITCH = B_BOX * 2;  // 272 bytes
constexpr int B_BYTES = KS * B_PITCH;
constexpr int A_BOX_BF16 = KS + 8;  // bf16 tile columns per A box, 8 spare
constexpr unsigned FULL = 0xffffffffu;

// One slab of reduction depth SD (64, or 32 for the K11 ring's deeper
// stages): the A rows as the copy engine lands them, then the B rows.
template <int MODE, int SD = KS>
struct ATile {
  static constexpr int PITCH = MODE == TILE_I8 ? SD : (SD + 8) * 2;  // int8: SD bytes; bf16: 8 spare columns
  static constexpr int BYTES = RM * PITCH;
  static constexpr int STAGE = BYTES + SD * B_PITCH;  // one stage: the A slab, then the B slab
  // the ring, its 2 * STAGES barriers, and room to align the ring to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// expect_tx without the arrive: a slab that does not close its stage
__device__ __forceinline__ void mbar_expect_tx_only(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Wait until the barrier's phase differs from ``parity``. A lost arrival
// must not hang the card: after about two seconds the kernel traps.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 4000000000LL) __trap();
}

// ------------------------------------------------------------- copy engine

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared, asynchronous: the gather of chunk rows.
// Without ``valid`` nothing is read and 16 zero bytes are written, which a
// bulk copy cannot do and a dead slot needs.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// The barrier's phase stays open until this thread's cp.async copies so far
// have landed (the pending count goes up now and down then).
__device__ __forceinline__ void cp_async_arrive_on(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// ------------------------------------------------------------ tensor cores

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c[16x8] += a[16x16] @ b[16x8], bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two int8 bytes (bytes 0 and 1 of w, or 2 and 3 with HIGH) as a bf16
// pair, the lower byte in the low half; exact for every int8 value, and
// without the slow integer-to-float unit. A byte v = m - 128 s (m its low
// seven bits, s its sign bit); the bf16 numbers in [128, 256) are spaced by
// one, so the bit patterns 0x4300 | m and 0x4300 | (s << 7) are 128 + m
// and 128 + 128 s, and their difference is v.
template <bool HIGH>
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w) {
  const uint32_t x = __byte_perm(w, 0, HIGH ? 0x4342 : 0x4140);  // (b1 << 16) | b0
  const uint32_t a = (x & 0x007f007fu) | 0x43004300u;
  const uint32_t b = (x & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("sub.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// ------------------------------------------------- flash-GAT score helpers

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four bits (bit k: byte k of w is not zero).
__device__ __forceinline__ uint32_t nz4(uint32_t w) {
  const uint32_t b = __vcmpne4(w, 0u) & 0x01010101u;
  return (b | (b >> 7) | (b >> 14) | (b >> 21)) & 0xfu;
}

// Two bits (bit k: bf16 half k of w is a value > 0: sign clear, not +0).
__device__ __forceinline__ uint32_t pos2(uint32_t w) {
  return (uint32_t)((w & 0xffffu) - 1u < 0x7fffu) | ((uint32_t)((w >> 16) - 1u < 0x7fffu) << 1);
}

// The edge flags of 16 consecutive columns of a mask row in shared memory
// (bit c: column c of the 16), from int8 bytes or bf16 values, each read
// as a 16-bit pattern (> 0).
template <int MODE>
__device__ __forceinline__ uint32_t mask16(const uint8_t* row16) {
  if constexpr (MODE == TILE_I8) {
    const uint4 u = *reinterpret_cast<const uint4*>(row16);
    return nz4(u.x) | (nz4(u.y) << 4) | (nz4(u.z) << 8) | (nz4(u.w) << 12);
  } else {
    const uint4* q = reinterpret_cast<const uint4*>(row16);
    const uint4 u0 = q[0], u1 = q[1];
    return pos2(u0.x) | (pos2(u0.y) << 2) | (pos2(u0.z) << 4) | (pos2(u0.w) << 6) | (pos2(u1.x) << 8) |
           (pos2(u1.y) << 10) | (pos2(u1.z) << 12) | (pos2(u1.w) << 14);
  }
}

// The reduction index, inside a slab of depth SD, that position ``pp``
// (0..15) of the ``i``-th m16n8k16 product stands for.
//
// bf16 tiles: the natural order. int8 tiles at SD = 64: thread t of a quad
// reads the 16 bytes k = 16t .. 16t+15 of its tile rows; product i takes its
// word q = i ^ (t >> 1) and puts that word's half (t & 1) at positions 2t,
// 2t+1 and the other half at 2t+8, 2t+9. At SD = 32 thread t reads the 8
// bytes k = 8t .. 8t+7, and product i, half h takes their byte pair
// (t + 2i + h) & 3. Either way the eight rows of each 8x8 B matrix have
// k % 8 all different, which keeps ldmatrix off bank conflicts at a row
// pitch of 272 bytes.
template <int MODE, int SD = KS>
__device__ __forceinline__ int slab_k(int i, int pp) {
  if constexpr (MODE == TILE_I8) {
    const int p = pp & 7, hi = pp >> 3, tq = p >> 1, e = p & 1;
    if constexpr (SD == 32) return 8 * tq + 2 * ((tq + 2 * i + hi) & 3) + e;
    return 16 * tq + 4 * (i ^ (tq >> 1)) + 2 * ((tq & 1) ^ hi) + e;
  } else {
    return 16 * i + pp;
  }
}

// Per-thread constants of the consumer warps.
struct Lane {
  int wm, wn;       // warp's 64-row and 64-feature block
  int g, t;         // row in an 8-row group, thread in a quad
  uint32_t b_off[4];  // ldmatrix.trans: byte offset of this lane's B row for product i
  int k_lo[4], k_hi[4];  // slab_k of this thread's own positions 2t and 2t+8 (SD / 16 products)
};

// The lane of a consumer warp that owns rows wm * 64 and features wn * 64.
template <int MODE, int SD = KS>
__device__ __forceinline__ Lane make_lane(int wm, int wn) {
  Lane L;
  const int lane = threadIdx.x & 31;
  L.wm = wm;
  L.wn = wn;
  L.g = lane >> 2;
  L.t = lane & 3;
  // matrices of one ldmatrix.x4.trans: (k positions 0-7 | 8-15) x (features +0 | +8)
  const int pp = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int noff = (lane >> 4) * 8;
#pragma unroll
  for (int i = 0; i < SD / 16; ++i) {
    L.b_off[i] = slab_k<MODE, SD>(i, pp) * B_PITCH + (L.wn * 64 + noff) * 2;
    L.k_lo[i] = slab_k<MODE, SD>(i, 2 * L.t);
    L.k_hi[i] = slab_k<MODE, SD>(i, 2 * L.t + 8);
  }
  return L;
}
// The eight consumer warps as 4 along rows x 2 along features.
template <int MODE, int SD = KS>
__device__ __forceinline__ Lane make_lane() {
  const int warp = threadIdx.x >> 5;
  return make_lane<MODE, SD>(warp & 3, warp >> 2);
}

// acc += A_i @ B_i for product i of a slab, A fragments given.
__device__ __forceinline__ void mma_row(float (&acc)[4][8][4], const uint32_t (&a)[4][4],
                                        uint32_t b_base, uint32_t b_off) {
#pragma unroll
  for (int njp = 0; njp < 4; ++njp) {
    uint32_t b[4];
    ldsm_x4_trans(b_base + b_off + njp * 32, b);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      mma_bf16(acc[mi][2 * njp], a[mi], b[0], b[1]);
      mma_bf16(acc[mi][2 * njp + 1], a[mi], b[2], b[3]);
    }
  }
}

// One slab of a tile step, SD deep.
template <int MODE, int SD = KS>
__device__ __forceinline__ void tile_slab(float (&acc)[4][8][4], const Lane& L, uint32_t a_base,
                                          const uint8_t* a_ptr, uint32_t b_base) {
  if constexpr (MODE == TILE_I8 && SD == 32) {
    // rows g and g+8 of the four m16 blocks: 8 bytes each; product i, half h
    // takes byte pair (t + 2i + h) & 3 (slab_k)
    uint2 w[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w[mi][h] = *reinterpret_cast<const uint2*>(a_ptr + (L.wm * 64 + mi * 16 + h * 8 + L.g) * SD + 8 * L.t);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j0 = (L.t + 2 * i) & 3, j1 = (L.t + 2 * i + 1) & 3;
      const uint32_t s0 = (uint32_t)(2 * j0) | ((uint32_t)(2 * j0 + 1) << 4);
      const uint32_t s1 = (uint32_t)(2 * j1) | ((uint32_t)(2 * j1 + 1) << 4);
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        a[mi][0] = i8x2_to_bf16x2<false>(__byte_perm(w[mi][0].x, w[mi][0].y, s0));
        a[mi][1] = i8x2_to_bf16x2<false>(__byte_perm(w[mi][1].x, w[mi][1].y, s0));
        a[mi][2] = i8x2_to_bf16x2<false>(__byte_perm(w[mi][0].x, w[mi][0].y, s1));
        a[mi][3] = i8x2_to_bf16x2<false>(__byte_perm(w[mi][1].x, w[mi][1].y, s1));
      }
      mma_row(acc, a, b_base, L.b_off[i]);
    }
  } else if constexpr (MODE == TILE_I8) {
    // rows g and g+8 of the four m16 blocks: 16 bytes each
    uint32_t w[4][2][4];
    const bool swap_words = (L.t >> 1) != 0;
    const uint32_t sel = (L.t & 1) ? 0x1032 : 0x3210;  // odd threads swap a word's halves
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = L.wm * 64 + mi * 16 + h * 8 + L.g;
        const uint4 u = *reinterpret_cast<const uint4*>(a_ptr + row * KS + 16 * L.t);
        w[mi][h][0] = __byte_perm(swap_words ? u.y : u.x, 0, sel);
        w[mi][h][1] = __byte_perm(swap_words ? u.x : u.y, 0, sel);
        w[mi][h][2] = __byte_perm(swap_words ? u.w : u.z, 0, sel);
        w[mi][h][3] = __byte_perm(swap_words ? u.z : u.w, 0, sel);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        a[mi][0] = i8x2_to_bf16x2<false>(w[mi][0][i]);
        a[mi][1] = i8x2_to_bf16x2<false>(w[mi][1][i]);
        a[mi][2] = i8x2_to_bf16x2<true>(w[mi][0][i]);
        a[mi][3] = i8x2_to_bf16x2<true>(w[mi][1][i]);
      }
      mma_row(acc, a, b_base, L.b_off[i]);
    }
  } else {
    const int lane = threadIdx.x & 31;
    // matrices of one ldmatrix.x4: (rows 0-7 | 8-15) x (k 0-7 | 8-15)
    constexpr int PITCH = ATile<MODE, SD>::PITCH;
    const uint32_t a_lane = a_base + (L.wm * 64 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH +
                            (lane >> 4) * 16;
#pragma unroll
    for (int i = 0; i < SD / 16; ++i) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldsm_x4(a_lane + mi * 16 * PITCH + i * 32, a[mi]);
      mma_row(acc, a, b_base, L.b_off[i]);
    }
  }
}

// One slab of a chunk step, SD deep: A = onehot(lrow), built in registers
// from the slab's lrow in shared memory (dead slots hold lrow == tb).
template <int SD = KS>
__device__ __forceinline__ void chunk_slab(float (&acc)[4][8][4], const Lane& L, const int* lrow,
                                           uint32_t b_base) {
  constexpr uint32_t ONE = 0x3f80;  // bf16 1.0
#pragma unroll
  for (int i = 0; i < SD / 16; ++i) {
    const int2 lo = *reinterpret_cast<const int2*>(lrow + L.k_lo[i]);
    const int2 hi = *reinterpret_cast<const int2*>(lrow + L.k_hi[i]);
    uint32_t a[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r0 = L.wm * 64 + mi * 16 + L.g, r1 = r0 + 8;
      a[mi][0] = (lo.x == r0 ? ONE : 0u) | (lo.y == r0 ? ONE << 16 : 0u);
      a[mi][1] = (lo.x == r1 ? ONE : 0u) | (lo.y == r1 ? ONE << 16 : 0u);
      a[mi][2] = (hi.x == r0 ? ONE : 0u) | (hi.y == r0 ? ONE << 16 : 0u);
      a[mi][3] = (hi.x == r1 ? ONE : 0u) | (hi.y == r1 ? ONE << 16 : 0u);
    }
    mma_row(acc, a, b_base, L.b_off[i]);
  }
}

// Value mode: the gathered rows of a chunk slab become
// bf16(row * bf16(slot_scale)) in place (consumer threads only).
template <int SD = KS>
__device__ __forceinline__ void scale_chunk_rows(uint8_t* b_ptr, const float* scale) {
  constexpr int TPR = 256 / SD;  // 256 consumer threads over SD rows
  const int row = threadIdx.x / TPR;
  const int c0 = (threadIdx.x % TPR) * (BN / TPR);
  const float s = bf16r(scale[row]);
  uint4* p = reinterpret_cast<uint4*>(b_ptr + row * B_PITCH + c0 * 2);
#pragma unroll
  for (int q = 0; q < BN / TPR / 8; ++q) {
    uint4 u = p[q];
    __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(__bfloat162float(v[e]) * s);
    p[q] = u;
  }
  // the copy engine overwrites this stage later
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// Epilogue from registers. part < 0: the segment is its row block's whole
// run, write out[row] = rs * acc in TO (rs[mi]: the row scale of the row
// this lane stores of m16 block mi, or 1). part >= 0: write the f32 partial
// sum for the finalize pass. A lane pair exchanges halves so that each lane
// stores four consecutive features of one row (eight for bf16 rows).
template <typename TO>
__device__ __forceinline__ void store_acc(float (&acc)[4][8][4], const Lane& L, int rb, int tb,
                                          int p0, int P, int n_rows, const float (&rs4)[4],
                                          TO* out, float* partial, int part) {
  const bool odd = (L.t & 1) != 0;
  if constexpr (sizeof(TO) == 2) {
    if (part < 0) {
      // bf16 rows: four features a lane would be 8-byte stores that leave
      // every 32-byte sector half written by each instruction. A second
      // exchange, across the quad's halves, gives a lane eight consecutive
      // features (one 16-byte store; a lane pair fills a sector).
      const bool upper = (L.t & 2) != 0;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const long grow = (long)rb * tb + L.wm * 64 + mi * 16 + L.g + (odd ? 8 : 0);
        const float rs = rs4[mi];
#pragma unroll
        for (int njp = 0; njp < 4; ++njp) {
          uint2 q[2];  // this lane's four features of blocks 2 njp and 2 njp + 1, packed
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float(&c)[4] = acc[mi][2 * njp + h];
            const float s0 = odd ? c[0] : c[2], s1 = odd ? c[1] : c[3];
            const float r0 = __shfl_xor_sync(FULL, s0, 1), r1 = __shfl_xor_sync(FULL, s1, 1);
            const float v0 = odd ? r0 : c[0], v1 = odd ? r1 : c[1];
            const float v2 = odd ? c[2] : r0, v3 = odd ? c[3] : r1;
            __nv_bfloat162 lo = __floats2bfloat162_rn(v0 * rs, v1 * rs);
            __nv_bfloat162 hi = __floats2bfloat162_rn(v2 * rs, v3 * rs);
            q[h].x = *reinterpret_cast<uint32_t*>(&lo);
            q[h].y = *reinterpret_cast<uint32_t*>(&hi);
          }
          // lanes 0, 1 of a quad keep block 2 njp, lanes 2, 3 block 2 njp + 1
          const uint2 send = upper ? q[0] : q[1];
          uint2 recv;
          recv.x = __shfl_xor_sync(FULL, send.x, 2);
          recv.y = __shfl_xor_sync(FULL, send.y, 2);
          const uint2 first = upper ? recv : q[0], second = upper ? q[1] : recv;
          const int col = p0 + L.wn * 64 + (2 * njp + (upper ? 1 : 0)) * 8;
          if (col < P && grow < n_rows)
            *reinterpret_cast<uint4*>(out + grow * P + col) =
                make_uint4(first.x, first.y, second.x, second.y);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int lr = L.wm * 64 + mi * 16 + L.g + (odd ? 8 : 0);
    const long grow = (long)rb * tb + lr;
    const float rs = rs4[mi];
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      float(&c)[4] = acc[mi][nj];
      // even lanes keep row g and send row g+8; odd lanes the other way round
      const float s0 = odd ? c[0] : c[2], s1 = odd ? c[1] : c[3];
      const float r0 = __shfl_xor_sync(FULL, s0, 1), r1 = __shfl_xor_sync(FULL, s1, 1);
      const float v0 = odd ? r0 : c[0], v1 = odd ? r1 : c[1];
      const float v2 = odd ? c[2] : r0, v3 = odd ? c[3] : r1;
      const int col = p0 + L.wn * 64 + nj * 8 + 4 * (L.t >> 1);
      if (col >= P) continue;
      if (part >= 0) {
        store4(partial + ((long)part * tb + lr) * P + col, v0, v1, v2, v3);
      } else if (grow < n_rows) {
        store4(out + grow * P + col, v0 * rs, v1 * rs, v2 * rs, v3 * rs);
      }
    }
  }
}

struct RingArgs {
  int tb, n_work, n_fs;
  const int *seg_rb, *seg_lo, *seg_hi, *seg_part;
  const int4* step;        // (tile or -1, cb, chunk or -1, chunk slots to read) per live step
  const int* lrow;         // [R, K]
  const int* slot_col;     // [R*K]
  const float* slot_scale; // [R*K]; null: chunk rows are read as they are
  int K;
  const float* rowscale;
  const __nv_bfloat16* Hs;  // [hs_rows, P]
  int P;
  void* out;
  float* partial;
  int n_rows;
};

// The ring of agg_ring_kernel: STAGES stages (at most the default four, as
// many as fit) of NSLAB slabs, each slab SD deep (ATile<MODE, SD>).
template <int MODE, int NSLAB, int SD>
struct RingLayout {
  static constexpr int SLAB = ATile<MODE, SD>::STAGE;  // the A slab, then the B slab
  static constexpr int STAGE = NSLAB * SLAB;
  static constexpr int FIT = (232448 - 2048) / STAGE;
  static constexpr int STAGES = FIT < sgr::STAGES ? FIT : sgr::STAGES;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(STAGES >= 2, "at least two stages must fit");
};

// FUSED: chunk steps and the row scale exist (K2); else tiles only (K1).
// NSLAB slabs a stage, each SD deep (K11: K2 with k slabs a stage). A stage
// takes a work item's slabs in walk order (each live step's tile slabs, then
// its chunk slabs) and closes at its NSLAB-th slab or at the item's last
// one: one expect_tx a slab for its bytes, one arrive on the full barrier
// and one on the empty barrier a stage. At NSLAB = 1, SD = 64 that is a
// handshake a slab (K1, K2).
template <int MODE, bool FUSED, typename TO, int NSLAB = 1, int SD = KS>
__global__ void __launch_bounds__(NTHREADS, 1)
    agg_ring_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, const RingArgs p) {
  using Ring = RingLayout<MODE, NSLAB, SD>;
  constexpr int NST = Ring::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the copy engine wants its targets aligned to 128 bytes; 1024 keeps every stage so
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + NST * Ring::STAGE);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + NST);
  constexpr int A_BYTES = ATile<MODE, SD>::BYTES;
  const int tb = p.tb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int stage = 0, j = 0;  // j: slabs already in the open stage (0 at NSLAB = 1)
  uint32_t phase = 0;
  // after a slab: the stage closes at its NSLAB-th slab or the item's last
  auto next_slab = [&](bool item_end) {
    if (NSLAB == 1 || item_end || j == NSLAB - 1) {
      j = 0;
      if (++stage == NST) {
        stage = 0;
        phase ^= 1;
      }
    } else {
      ++j;
    }
  };
  auto closes = [&](bool item_end) { return NSLAB == 1 || item_end || j == NSLAB - 1; };
  auto slab_ptr = [&]() { return smem + stage * Ring::STAGE + (NSLAB == 1 ? 0 : j) * Ring::SLAB; };

  if (warp >= CONSUMER_WARPS) {
    // ------------------------------------------------------------ producer
    // three warpgroups start at 168 registers a thread: the producer's
    // drops to 40 so that the two consumer groups can raise to 232 for
    // their accumulators (3 * 168 = 40 + 2 * 232)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != CONSUMER_WARPS) return;
    const uint32_t a_tx = (uint32_t)tb * ATile<MODE, SD>::PITCH;
    // Every index the loop needs is loaded one step ahead (the next step's
    // record, the next work item's bounds, the next slab's gather columns):
    // a load the producer waits for is a bubble in the copies it feeds.
    const int w0 = blockIdx.x;
    int lo = 0, hi = 0;
    if (w0 < p.n_work) {
      lo = p.seg_lo[w0 / p.n_fs];
      hi = p.seg_hi[w0 / p.n_fs];
    }
    const int4 none = make_int4(-1, 0, -1, 0);
    int4 nxt = lo < hi ? p.step[lo] : none;
    for (int w = w0; w < p.n_work; w += gridDim.x) {
      const int p0 = (w % p.n_fs) * BN;
      const uint32_t row_bytes = (uint32_t)min(BN, p.P - p0) * 2;
      const int wn = w + gridDim.x;
      int lo_n = 0, hi_n = 0;
      if (wn < p.n_work) {
        lo_n = p.seg_lo[wn / p.n_fs];
        hi_n = p.seg_hi[wn / p.n_fs];
      }
      for (int g = lo; g < hi; ++g) {
        const int4 st = nxt;
        nxt = g + 1 < hi ? p.step[g + 1] : (lo_n < hi_n ? p.step[lo_n] : none);
        const bool last = g + 1 == hi;
        const bool chunk = FUSED && st.z >= 0 && st.w > 0;
        // the gather columns of the chunk's first slab; -1 for a dead slot
        // (lrow == tb), whose row is zero-filled: a chunk is two thirds dead
        // slots on the power-law slice, all naming row 0, and copies that
        // bypass L1 would queue on that one line's L2 slice
        const int* cols = p.slot_col + (long)st.z * p.K;
        const int* rows = p.lrow + (long)st.z * p.K;
        int c0 = -1, c1 = -1;
        if (FUSED && st.z >= 0) {
          c0 = rows[lane] < tb ? cols[lane] : -1;
          if (SD > 32) c1 = rows[32 + lane] < tb ? cols[32 + lane] : -1;
        }
        if (st.x >= 0) {
          for (int k0 = 0; k0 < tb; k0 += SD) {
            const bool end = last && !chunk && k0 + SD >= tb;
            if (NSLAB == 1 || j == 0) mbar_wait(empty0 + 8 * stage, phase ^ 1);
            if (lane == 0) {
              const uint32_t a_dst = smem_u32(slab_ptr());
              const uint32_t bar = full0 + 8 * stage;
              if (closes(end))
                mbar_expect_tx(bar, a_tx + SD * B_PITCH);
              else
                mbar_expect_tx_only(bar, a_tx + SD * B_PITCH);
              tma_load_2d(a_dst, &map_a, bar, k0, st.x * tb);
              tma_load_2d(a_dst + A_BYTES, &map_b, bar, p0, st.y * tb + k0);
            }
            next_slab(end);
          }
        }
        if (chunk) {
          for (int k0 = 0; k0 < st.w; k0 += SD) {  // slabs past the last live slot are skipped
            int n0 = -1, n1 = -1;
            if (k0 + SD < st.w) {
              n0 = rows[k0 + SD + lane] < tb ? cols[k0 + SD + lane] : -1;
              if (SD > 32) n1 = rows[k0 + SD + 32 + lane] < tb ? cols[k0 + SD + 32 + lane] : -1;
            }
            const bool end = last && k0 + SD >= st.w;
            if (NSLAB == 1 || j == 0) mbar_wait(empty0 + 8 * stage, phase ^ 1);
            const uint32_t a_dst = smem_u32(slab_ptr());
            const uint32_t bar = full0 + 8 * stage;
            // half a warp copies one gathered row, 16 bytes a lane
            const int piece = (lane & 15) * 16;
#pragma unroll 8
            for (int q = 0; q < SD / 2; ++q) {
              const int r = 2 * q + (lane >> 4);
              const int col = __shfl_sync(FULL, q < 16 ? c0 : c1, r & 31);
              if (piece < (int)row_bytes)
                cp_async16(a_dst + A_BYTES + r * B_PITCH + piece,
                           reinterpret_cast<const uint8_t*>(p.Hs + (long)max(col, 0) * p.P + p0) + piece,
                           col >= 0);
            }
            cp_async_arrive_on(bar);
            __syncwarp();  // every lane's pending arrival is counted before the phase can end
            if (lane == 0) {
              if (closes(end))
                mbar_expect_tx(bar, SD * 4);
              else
                mbar_expect_tx_only(bar, SD * 4);
              bulk_load(a_dst, rows + k0, SD * 4, bar);
            }
            next_slab(end);
            c0 = n0;
            c1 = n1;
          }
        }
      }
      lo = lo_n;
      hi = hi_n;
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const Lane L = make_lane<MODE, SD>();
    const bool active = L.wm * 64 < tb;  // tb % 64 == 0: a warp's rows are all in or all out
    float acc[4][8][4];
    // as in the producer, every index is loaded one step ahead
    const int w0 = blockIdx.x;
    int lo = 0, hi = 0, rb = 0, part = -1;
    if (w0 < p.n_work) {
      const int seg = w0 / p.n_fs;
      lo = p.seg_lo[seg];
      hi = p.seg_hi[seg];
      rb = p.seg_rb[seg];
      part = p.seg_part[seg];
    }
    const int4 none = make_int4(-1, 0, -1, 0);
    int4 nxt = lo < hi ? p.step[lo] : none;
    // after a slab: release the stage where the producer closed it
    auto release = [&](bool end) {
      if (closes(end)) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      }
      next_slab(end);
    };
    for (int w = w0; w < p.n_work; w += gridDim.x) {
      const int p0 = (w % p.n_fs) * BN;
      // the row scales of this item's rows, wanted by the epilogue
      float rs[4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const long grow = (long)rb * tb + L.wm * 64 + mi * 16 + L.g + ((L.t & 1) ? 8 : 0);
        rs[mi] = (FUSED && p.rowscale != nullptr && active && part < 0 && grow < p.n_rows)
                     ? p.rowscale[grow] : 1.f;
      }
      const int wn = w + gridDim.x;
      int lo_n = 0, hi_n = 0, rb_n = 0, part_n = -1;
      if (wn < p.n_work) {
        const int seg = wn / p.n_fs;
        lo_n = p.seg_lo[seg];
        hi_n = p.seg_hi[seg];
        rb_n = p.seg_rb[seg];
        part_n = p.seg_part[seg];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
      for (int g = lo; g < hi; ++g) {
        const int4 st = nxt;
        nxt = g + 1 < hi ? p.step[g + 1] : (lo_n < hi_n ? p.step[lo_n] : none);
        const bool last = g + 1 == hi;
        const bool chunk = FUSED && st.z >= 0 && st.w > 0;
        if (st.x >= 0) {
          for (int k0 = 0; k0 < tb; k0 += SD) {
            uint8_t* a_ptr = slab_ptr();
            if (NSLAB == 1 || j == 0) mbar_wait(full0 + 8 * stage, phase);
            if (active) tile_slab<MODE, SD>(acc, L, smem_u32(a_ptr), a_ptr, smem_u32(a_ptr + A_BYTES));
            release(last && !chunk && k0 + SD >= tb);
          }
        }
        if (chunk) {
          for (int k0 = 0; k0 < st.w; k0 += SD) {
            uint8_t* a_ptr = slab_ptr();
            if (NSLAB == 1 || j == 0) mbar_wait(full0 + 8 * stage, phase);
            if (p.slot_scale != nullptr)
              scale_chunk_rows<SD>(a_ptr + A_BYTES, p.slot_scale + (long)st.z * p.K + k0);
            if (active)
              chunk_slab<SD>(acc, L, reinterpret_cast<const int*>(a_ptr), smem_u32(a_ptr + A_BYTES));
            release(last && k0 + SD >= st.w);
          }
        }
      }
      if (active)
        store_acc<TO>(acc, L, rb, tb, p0, p.P, p.n_rows, rs, static_cast<TO*>(p.out), p.partial, part);
      lo = lo_n;
      hi = hi_n;
      rb = rb_n;
      part = part_n;
    }
  }
}

// Sums the partials of each split run in a fixed order, four features a
// thread, and writes out[row] = rowscale[row] * sum (or sum) in TO.
template <typename TO>
__global__ void finalize_ring(const float* partial, const int* fin_rb, const int* fin_p0,
                              const int* fin_np, int n_fin, int tb, int P, int n_rows,
                              const float* rowscale, TO* out) {
  const int P4 = P >> 2;
  const long total = (long)n_fin * tb * P4;
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const int f = (int)(idx / ((long)tb * P4));
    const long rem = idx - (long)f * tb * P4;
    const int lr = (int)(rem / P4);
    const int c = (int)(rem - (long)lr * P4) * 4;
    const long grow = (long)fin_rb[f] * tb + lr;
    if (grow >= n_rows) continue;
    const int np = fin_np[f];
    const float* src = partial + ((long)fin_p0[f] * tb + lr) * P + c;
    const long stride = (long)tb * P;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int q = 0;
    for (; q + 4 <= np; q += 4) {  // four loads in flight, summed in order
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = *reinterpret_cast<const float4*>(src + (q + j) * stride);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc.x += v[j].x; acc.y += v[j].y; acc.z += v[j].z; acc.w += v[j].w;
      }
    }
    for (; q < np; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(src + q * stride);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    const float rs = rowscale != nullptr ? rowscale[grow] : 1.f;
    store4(out + grow * P + c, acc.x * rs, acc.y * rs, acc.z * rs, acc.w * rs);
  }
}

// The pre-pass: Hs[r] = bf16(bf16(H[r]) * bf16(colscale[r])) (bf16(H[r])
// without a column scale) for r < n_valid, zero rows up to ``rows``. One
// thread per 8 features (P % 8 == 0), 16-byte loads and stores.
template <typename TH>
__global__ void stage_h_kernel(const TH* H, int n_valid, const float* colscale,
                               __nv_bfloat16* Hs, long rows, int P) {
  const int P8 = P >> 3;
  const long idx = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (idx >= rows * P8) return;
  const long r = idx / P8;
  const int c = (int)(idx - r * P8) * 8;
  alignas(16) __nv_bfloat16 o[8];
  if (r < n_valid) {
    float v[8];
    if constexpr (sizeof(TH) == 4) {
      const float4* s4 = reinterpret_cast<const float4*>(H + r * P + c);
      const float4 a = s4[0], b = s4[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(H + r * P + c);
      const __nv_bfloat16* hb = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(hb[e]);
    }
    if (colscale != nullptr) {
      const float cs = bf16r(colscale[r]);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16_rn(bf16r(v[e]) * cs);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16_rn(v[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16_rn(0.f);
  }
  *reinterpret_cast<uint4*>(Hs + r * P + c) = *reinterpret_cast<const uint4*>(o);
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process has loaded (the
// kernels' library links the CUDA runtime only).
static EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib == nullptr) lib = dlopen("libcuda.so", RTLD_NOW | RTLD_GLOBAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A 2-D row-major matrix [rows, cols] of ``type`` cut into boxes of
// [box_rows, box_cols]; out-of-range elements read as zero. No swizzle: the
// box is wider than what is used, which pads the shared-memory pitch.
static int encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                     uint64_t rows, uint64_t cols, uint32_t box_rows, uint32_t box_cols) {
  EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return 20000;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (uint64_t)elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

// Launches the ring kernel and, for split runs, the finalize pass. Returns
// 0, a cudaError_t, or 10000 + a CUresult of the tensor-map encoder.
template <int MODE, bool FUSED, typename TO, int NSLAB = 1, int SD = KS>
static int launch_ring(const void* tiles, long n_tiles, int n_seg, int n_fin, const int* fin_rb,
                       const int* fin_p0, const int* fin_np, int hs_rows, int n_sm,
                       RingArgs args, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const int tb = args.tb;
  int err = MODE == TILE_I8
                ? encode_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, tiles,
                            (uint64_t)n_tiles * tb, tb, tb, SD)
                : encode_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, tiles,
                            (uint64_t)n_tiles * tb, tb, tb, SD + 8);
  if (err) return err;
  err = encode_2d(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, args.Hs, hs_rows, args.P, SD,
                  B_BOX);
  if (err) return err;
  args.n_fs = (args.P + BN - 1) / BN;
  args.n_work = n_seg * args.n_fs;
  auto kernel = agg_ring_kernel<MODE, FUSED, TO, NSLAB, SD>;
  constexpr int SMEM = RingLayout<MODE, NSLAB, SD>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = args.n_work < n_sm ? args.n_work : n_sm;
  kernel<<<grid, NTHREADS, SMEM, stream>>>(map_a, map_b, args);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_fin == 0) return (int)e;
  const long total = (long)n_fin * tb * (args.P >> 2);
  const int blocks = (int)((total + 255) / 256 < 65536 ? (total + 255) / 256 : 65536);
  finalize_ring<TO><<<blocks, 256, 0, stream>>>(args.partial, fin_rb, fin_p0, fin_np, n_fin, tb,
                                                args.P, args.n_rows,
                                                FUSED ? args.rowscale : nullptr,
                                                static_cast<TO*>(args.out));
  return (int)cudaGetLastError();
}

}  // namespace sgr
