// Full-integer aggregation on Hopper, ring design: out = Aq @ Hq exact in
// int32 over shifted-int8 tiles and value-carrying remainder chunks.
//
// Replaces sgracex1_tpu/ops/fused_agg.py:bsr_spmm_int8_fused (Pallas kernel
// _fused_int8_kernel), as fused_agg_int8.cu does, for tiles of height
// 64..256, P % 16 == 0 and K % 64 == 0 on a plan that carries the int8 ring
// schedule (ops/fused_agg.int8_ring_shape_ok, FusedAggPlan.edge_ring); the
// other forms stay on fused_agg_int8.cu. With no chunks it also replaces
// sgracex1_tpu/ops/bsr.py:bsr_spmm_int8 (Pallas kernel _bsr_int8_kernel),
// as bsr_spmm_int8.cu does, on the tile steps of BSRMatrix.edge_ring
// (ops/bsr.int8_ring_shape_ok_k7: any tile height a multiple of 64). A work
// item owns th <= 256 rows: the whole tile, or for taller tiles one row
// piece of it (tb = 512: two halves), whose tile steps reduce over the whole
// tile width tw; the TMA box then reads th rows of a tw-byte-pitch tile.
//
// Bound on the H100: bytes (the tiles that carry an edge, 64 KB each at
// tb = 256, Hq, the gathered chunk rows and the int32 output), far above
// the int8 tensor-core time. The design is K2's ring (tile_ring.cuh: one
// persistent CTA a SM owning the whole tile height, a producer warp feeding
// a TMA / mbarrier ring, eight mma.sync consumer warps, split runs summed in
// a fixed order) with what int8 changes:
//  * Only the tiles that carry an edge are walked. A tile holds Aq - 128
//    (Aq the unsigned 0..255 grid), so an all -128 cover tile is Aq = 0 and
//    adds nothing; the TPU kernel multiplies it and its shift correction
//    cancels it.
//  * No shift correction and no column-sum pre-pass: flipping bit 7 of a
//    shifted byte gives Aq itself (x ^ 0x80), and mma.sync m16n8k32 u8 x s8
//    with int32 sums gives Aq @ Hq exactly, which equals the TPU kernel's
//    As @ Hq + 128 colsum(Hq) modulo 2^32.
//  * Int8 MMAs take B K-major (B[n][k]), and there is no byte transpose in
//    ldmatrix. So Hq is staged transposed once (HqT [P, n], stage_hqt_kernel)
//    and a tile step's B slab is one TMA box of 128 features x 64 node bytes.
//  * A chunk slab gathers its 64 Hq rows (cp.async, 16 bytes a lane) row
//    major; the consumer warps transpose them in shared memory (4 x 4 byte
//    blocks, __byte_perm) into the same [feature][slot] layout, and build A
//    in registers as a value-carrying one-hot: byte (row r, slot s) is the
//    slot's value where its local row is r, four slots at a time with
//    __vcmpeq4. The products go into the same int32 accumulators as the
//    tile products: the chunk form needs no bf16 one-hot and no second
//    accumulator.
//  * Per 64-deep slab a thread reads 16 consecutive bytes of each of its A
//    and B rows, which feed both k32 products (bytes 8i .. 8i + 7 of its 16
//    stand for logical k 4t .. 4t + 3 and 16 + 4t .. + 3 of product i, the
//    same for A and B); at a row pitch of 64 bytes those reads are free of
//    bank conflicts without padding.
// The epilogue writes int32 rows 16 bytes a lane; split runs leave int32
// partials that a second kernel sums in a fixed order.
#include "tile_ring.cuh"

namespace sgi {

using namespace sgr;

constexpr int SLAB = KS;                 // 64 reduction bytes a slab
constexpr int A_AREA = RM * SLAB;        // 16 KB: tile rows x 64 bytes
constexpr int B_AREA = BN * SLAB;        // 8 KB: 128 features x 64 bytes (a chunk: 64 rows x 128 bytes)
constexpr int STAGE = A_AREA + B_AREA;
constexpr int NST = 8;
constexpr int SMEM = NST * STAGE + 2 * NST * 8 + 1024;
constexpr int LV_OFF = B_AREA;           // a chunk slab's row and value bytes, after its transposed rows
static_assert(SMEM <= 232448, "the ring must fit a CTA's shared memory");

struct Args {
  int th, tw, n_work, n_fs;  // rows a work item owns (a whole tile or a row piece), tile width
  const int *seg_rb, *seg_lo, *seg_hi, *seg_part;
  const int4* step;      // (row piece or -1, cb, chunk or -1, chunk slots to read) per live step
  const int* lrow;       // [R, K]; th marks a dead slot
  const int* slot_col;   // [R*K]
  const uint8_t* lv8;    // [R*K/64, 128]: each slab's 64 row bytes, then its 64 value bytes
  int K;
  const int8_t* Hq;      // [>= n_cols, P]: chunk rows are gathered from here
  int P;
  int* out;
  int* partial;
  int n_rows;
};

// c[16x8] += a[16x32] @ b[32x8]: A unsigned bytes, B signed bytes, int32 sums
__device__ __forceinline__ void mma_u8s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc += A @ B over one 64-deep slab. a[mi][h]: the 16 bytes 16t .. 16t + 15
// of row wm*64 + mi*16 + h*8 + g; B rows (features) at b_rows, pitch 64.
__device__ __forceinline__ void slab_mma(int (&acc)[4][8][4], const uint4 (&a)[4][2],
                                         const uint8_t* b_rows, const Lane& L) {
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const uint4 b = *reinterpret_cast<const uint4*>(b_rows + (L.wn * 64 + nj * 8 + L.g) * SLAB + 16 * L.t);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      mma_u8s8(acc[mi][nj], a[mi][0].x, a[mi][1].x, a[mi][0].y, a[mi][1].y, b.x, b.y);
      mma_u8s8(acc[mi][nj], a[mi][0].z, a[mi][1].z, a[mi][0].w, a[mi][1].w, b.z, b.w);
    }
  }
}

// The gathered rows of a chunk slab ([64 slots][128 bytes]) transposed into
// [128 features][64 slots], by the 256 consumer threads. A thread moves 4 x 4
// byte blocks: lane = feature word (reads hit 32 banks), slot word
// (lane + q) & 15 with the two half-warps storing their words in swapped
// order (stores hit 32 banks).
__device__ __forceinline__ void transpose_rows(const uint8_t* rows, uint8_t* T) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(rows);
  uint32_t* dst = reinterpret_cast<uint32_t*>(T);
  const int lane = threadIdx.x & 31, hi = lane >> 4;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int q = (threadIdx.x >> 5) * 2 + it;
    const int ng = lane, kg = (lane + q) & 15;
    uint32_t x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = src[(4 * kg + r) * (BN / 4) + ng];
    const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140), t1 = __byte_perm(x[0], x[1], 0x7362);
    const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140), t3 = __byte_perm(x[2], x[3], 0x7362);
    const uint32_t y[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int c = s ^ hi;
      dst[(4 * ng + c) * (SLAB / 4) + kg] = hi ? y[s ^ 1] : y[s];
    }
  }
}

template <bool SPLIT>
__device__ __forceinline__ void store_i32(int (&acc)[4][8][4], const Lane& L, int rb, int th, int p0,
                                          int P, int n_rows, int* dst_base, int part) {
  const bool odd = (L.t & 1) != 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int lr = L.wm * 64 + mi * 16 + L.g + (odd ? 8 : 0);
    const long grow = (long)rb * th + lr;
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      int(&c)[4] = acc[mi][nj];
      // even lanes keep row g and send row g+8; odd lanes the other way round
      const int s0 = odd ? c[0] : c[2], s1 = odd ? c[1] : c[3];
      const int r0 = __shfl_xor_sync(FULL, s0, 1), r1 = __shfl_xor_sync(FULL, s1, 1);
      const int4 v = odd ? make_int4(r0, r1, c[2], c[3]) : make_int4(c[0], c[1], r0, r1);
      const int col = p0 + L.wn * 64 + nj * 8 + 4 * (L.t >> 1);
      if (col >= P) continue;
      if (SPLIT)
        *reinterpret_cast<int4*>(dst_base + ((long)part * th + lr) * P + col) = v;
      else if (grow < n_rows)
        *reinterpret_cast<int4*>(dst_base + grow * P + col) = v;
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
    agg_ring_i8_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b, const Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + NST * STAGE);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + NST);
  const int th = p.th, tw = p.tw;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++stage == NST) {
      stage = 0;
      phase ^= 1;
    }
  };
  const int4 none = make_int4(-1, 0, -1, 0);

  if (warp >= CONSUMER_WARPS) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != CONSUMER_WARPS) return;
    const uint32_t tile_tx = (uint32_t)th * SLAB + B_AREA;
    // every index is loaded one step ahead, as in K2's ring
    const int w0 = blockIdx.x;
    int lo = 0, hi = 0;
    if (w0 < p.n_work) {
      lo = p.seg_lo[w0 / p.n_fs];
      hi = p.seg_hi[w0 / p.n_fs];
    }
    int4 nxt = lo < hi ? p.step[lo] : none;
    for (int w = w0; w < p.n_work; w += gridDim.x) {
      const int p0 = (w % p.n_fs) * BN;
      const int row_bytes = min(BN, p.P - p0);
      const int wn = w + gridDim.x;
      int lo_n = 0, hi_n = 0;
      if (wn < p.n_work) {
        lo_n = p.seg_lo[wn / p.n_fs];
        hi_n = p.seg_hi[wn / p.n_fs];
      }
      for (int g = lo; g < hi; ++g) {
        const int4 st = nxt;
        nxt = g + 1 < hi ? p.step[g + 1] : (lo_n < hi_n ? p.step[lo_n] : none);
        if (st.x >= 0) {
          for (int k0 = 0; k0 < tw; k0 += SLAB) {
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            if (lane == 0) {
              const uint32_t a_dst = smem_u32(smem + stage * STAGE);
              const uint32_t bar = full0 + 8 * stage;
              mbar_expect_tx(bar, tile_tx);
              tma_load_2d(a_dst, &map_a, bar, k0, st.x * th);
              tma_load_2d(a_dst + A_AREA, &map_b, bar, st.y * tw + k0, p0);
            }
            advance();
          }
        }
        if (st.z >= 0 && st.w > 0) {
          // the gather columns of a slab's 64 slots, a dead slot (lrow == th)
          // -1: its row is zero-filled, never read (its value is 0 anyway)
          const int* cols = p.slot_col + (long)st.z * p.K;
          const int* rows = p.lrow + (long)st.z * p.K;
          int c0 = rows[lane] < th ? cols[lane] : -1;
          int c1 = rows[32 + lane] < th ? cols[32 + lane] : -1;
          for (int k0 = 0; k0 < st.w; k0 += SLAB) {
            int n0 = -1, n1 = -1;
            if (k0 + SLAB < st.w) {
              n0 = rows[k0 + SLAB + lane] < th ? cols[k0 + SLAB + lane] : -1;
              n1 = rows[k0 + SLAB + 32 + lane] < th ? cols[k0 + SLAB + 32 + lane] : -1;
            }
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            const uint32_t a_dst = smem_u32(smem + stage * STAGE);
            const uint32_t bar = full0 + 8 * stage;
            // an eighth of a warp copies one gathered row, 16 bytes a lane
            const int piece = (lane & 7) * 16;
#pragma unroll 4
            for (int q = 0; q < SLAB / 4; ++q) {
              const int r = 4 * q + (lane >> 3);
              const int col = __shfl_sync(FULL, q < 8 ? c0 : c1, r & 31);
              cp_async16(a_dst + A_AREA + r * BN + piece,
                         p.Hq + (long)max(col, 0) * p.P + p0 + piece, col >= 0 && piece < row_bytes);
            }
            cp_async_arrive_on(bar);
            __syncwarp();  // every lane's pending arrival is counted before the phase can end
            if (lane == 0) {
              mbar_expect_tx(bar, 2 * SLAB);
              bulk_load(a_dst + LV_OFF, p.lv8 + 2 * ((long)st.z * p.K + k0), 2 * SLAB, bar);
            }
            advance();
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
    const Lane L = make_lane<TILE_I8>();
    const bool active = L.wm * 64 < th;  // th % 64 == 0: a warp's rows are all in or all out
    int acc[4][8][4];
    const int w0 = blockIdx.x;
    int lo = 0, hi = 0, rb = 0, part = -1;
    if (w0 < p.n_work) {
      const int seg = w0 / p.n_fs;
      lo = p.seg_lo[seg];
      hi = p.seg_hi[seg];
      rb = p.seg_rb[seg];
      part = p.seg_part[seg];
    }
    int4 nxt = lo < hi ? p.step[lo] : none;
    auto release = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      advance();
    };
    for (int w = w0; w < p.n_work; w += gridDim.x) {
      const int p0 = (w % p.n_fs) * BN;
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
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;
      for (int g = lo; g < hi; ++g) {
        const int4 st = nxt;
        nxt = g + 1 < hi ? p.step[g + 1] : (lo_n < hi_n ? p.step[lo_n] : none);
        if (st.x >= 0) {
          for (int k0 = 0; k0 < tw; k0 += SLAB) {
            const uint8_t* a_ptr = smem + stage * STAGE;
            mbar_wait(full0 + 8 * stage, phase);
            if (active) {
              uint4 a[4][2];
#pragma unroll
              for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  uint4 u = *reinterpret_cast<const uint4*>(
                      a_ptr + (L.wm * 64 + mi * 16 + h * 8 + L.g) * SLAB + 16 * L.t);
                  // the shifted byte Aq - 128 with bit 7 flipped is Aq
                  u.x ^= 0x80808080u; u.y ^= 0x80808080u; u.z ^= 0x80808080u; u.w ^= 0x80808080u;
                  a[mi][h] = u;
                }
              slab_mma(acc, a, a_ptr + A_AREA, L);
            }
            release();
          }
        }
        if (st.z >= 0 && st.w > 0) {
          for (int k0 = 0; k0 < st.w; k0 += SLAB) {
            uint8_t* a_ptr = smem + stage * STAGE;
            mbar_wait(full0 + 8 * stage, phase);
            transpose_rows(a_ptr + A_AREA, a_ptr);
            // the copy engine overwrites this stage later
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            asm volatile("bar.sync 1, 256;\n" ::: "memory");
            if (active) {
              const uint4 lw = *reinterpret_cast<const uint4*>(a_ptr + LV_OFF + 16 * L.t);
              const uint4 vw = *reinterpret_cast<const uint4*>(a_ptr + LV_OFF + SLAB + 16 * L.t);
              uint4 a[4][2];
#pragma unroll
              for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  // the slot's value where its local row is this row: a
                  // value-carrying one-hot, four slots a word
                  const uint32_t r = (uint32_t)(L.wm * 64 + mi * 16 + h * 8 + L.g) * 0x01010101u;
                  a[mi][h] = make_uint4(vw.x & __vcmpeq4(lw.x, r), vw.y & __vcmpeq4(lw.y, r),
                                        vw.z & __vcmpeq4(lw.z, r), vw.w & __vcmpeq4(lw.w, r));
                }
              slab_mma(acc, a, a_ptr, L);
            }
            release();
          }
        }
      }
      if (active) {
        if (part >= 0)
          store_i32<true>(acc, L, rb, th, p0, p.P, p.n_rows, p.partial, part);
        else
          store_i32<false>(acc, L, rb, th, p0, p.P, p.n_rows, p.out, part);
      }
      lo = lo_n;
      hi = hi_n;
      rb = rb_n;
      part = part_n;
    }
  }
}

// Sums the int32 partials of each split run in a fixed order, four features
// a thread.
__global__ void finalize_i32(const int* partial, const int* fin_rb, const int* fin_p0,
                             const int* fin_np, int n_fin, int th, int P, int n_rows, int* out) {
  const int P4 = P >> 2;
  const long total = (long)n_fin * th * P4;
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const int f = (int)(idx / ((long)th * P4));
    const long rem = idx - (long)f * th * P4;
    const int lr = (int)(rem / P4);
    const int c = (int)(rem - (long)lr * P4) * 4;
    const long grow = (long)fin_rb[f] * th + lr;
    if (grow >= n_rows) continue;
    const int* src = partial + ((long)fin_p0[f] * th + lr) * P + c;
    const long stride = (long)th * P;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);  // int32 sums wrap as the reference's do
    for (int q = 0; q < fin_np[f]; ++q) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + q * stride);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    *reinterpret_cast<uint4*>(out + grow * P + c) = acc;
  }
}

// The pre-pass: HqT[p][r] = Hq[r][p] for r < n_valid, 0 up to ``rows``.
// A block moves a 64-node x 64-feature block through shared memory, 16
// bytes a thread each way.
__global__ void __launch_bounds__(256)
    stage_hqt_kernel(const int8_t* Hq, int n_valid, int P, int8_t* HqT, long rows) {
  __shared__ uint8_t s[64][68];  // pitch 68: the column reads below spread over the banks
  const long n0 = (long)blockIdx.x * 64;
  const int p0 = blockIdx.y * 64;
  const int r = threadIdx.x >> 2, c = (threadIdx.x & 3) * 16;
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (n0 + r < n_valid && p0 + c < P) u = *reinterpret_cast<const uint4*>(Hq + (n0 + r) * P + p0 + c);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) *reinterpret_cast<uint32_t*>(&s[r][c + 4 * q]) = w[q];
  __syncthreads();
  // thread: feature row p0 + r, nodes n0 + c .. + 16
  if (p0 + r >= P) return;
  uint32_t o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    o[q] = (uint32_t)s[c + 4 * q][r] | ((uint32_t)s[c + 4 * q + 1][r] << 8) |
           ((uint32_t)s[c + 4 * q + 2][r] << 16) | ((uint32_t)s[c + 4 * q + 3][r] << 24);
  *reinterpret_cast<uint4*>(HqT + (long)(p0 + r) * rows + n0 + c) = make_uint4(o[0], o[1], o[2], o[3]);
}

}  // namespace sgi

// Hq int8 [n_valid.., P] -> HqT int8 [P, rows] (rows % 64 == 0, P % 16 == 0).
extern "C" int sg_stage_hqt(const void* Hq, int n_valid, int P, void* HqT, int rows,
                            void* stream_ptr) {
  if (P % 16 || rows % 64) return (int)cudaErrorInvalidValue;
  if (rows == 0 || P == 0) return 0;
  dim3 grid(rows / 64, (P + 63) / 64);
  sgi::stage_hqt_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const int8_t*>(Hq), n_valid, P, static_cast<int8_t*>(HqT), rows);
  return (int)cudaGetLastError();
}

// Returns 0, the cudaError_t of the launches, or 10000 + the CUresult of the
// tensor-map encoder. ``tiles`` is int8 [n_pieces * th, tw]: tiles of height
// tb and width tw = tb cut into row pieces of th rows each (th = tb where
// tb <= 256), piece i of tile t at index t * (tb / th) + i. The schedule's
// row blocks count pieces, rows of piece block q are q * th .. + th. ``HqT``
// is int8 [P, n_pad] (sg_stage_hqt), ``Hq`` the int8 [>= n_cols, P] it came
// from; ``out`` int32 [n_rows, P], ``partial`` int32 [n_part, th, P]. K8
// passes th = tw = tb; K7 passes no chunk arrays (K = 0: no chunk step).
extern "C" int sg_fused_agg_int8_ring(const void* tiles, int th, int tw, long n_pieces, int n_seg,
                                      const int* seg_rb, const int* seg_lo, const int* seg_hi,
                                      const int* seg_part, int n_fin, const int* fin_rb,
                                      const int* fin_p0, const int* fin_np, const void* step,
                                      const int* lrow, const int* slot_col, const void* lv8, int K,
                                      const void* HqT, int n_pad, const void* Hq, int P, int* out,
                                      int* partial, int n_rows, int n_sm, void* stream_ptr) {
  using namespace sgr;
  using namespace sgi;
  if (th % 64 || th > RM || tw % 64 || tw < th || P % 16 || K % SLAB || n_pad % 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  CUtensorMap map_a, map_b;
  int err = encode_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, tiles, (uint64_t)n_pieces * th, tw,
                      th, SLAB);
  if (err) return err;
  err = encode_2d(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, HqT, P, n_pad, BN, SLAB);
  if (err) return err;
  Args a{};
  a.th = th;
  a.tw = tw;
  a.n_fs = (P + BN - 1) / BN;
  a.n_work = n_seg * a.n_fs;
  a.seg_rb = seg_rb; a.seg_lo = seg_lo; a.seg_hi = seg_hi; a.seg_part = seg_part;
  a.step = static_cast<const int4*>(step);
  a.lrow = lrow; a.slot_col = slot_col; a.lv8 = static_cast<const uint8_t*>(lv8); a.K = K;
  a.Hq = static_cast<const int8_t*>(Hq);
  a.P = P; a.out = out; a.partial = partial; a.n_rows = n_rows;
  cudaError_t e = cudaFuncSetAttribute(agg_ring_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = a.n_work < n_sm ? a.n_work : n_sm;
  if (grid > 0) agg_ring_i8_kernel<<<grid, NTHREADS, SMEM, stream>>>(map_a, map_b, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_fin == 0) return (int)e;
  const long total = (long)n_fin * th * (P >> 2);
  const int blocks = (int)((total + 255) / 256 < 65536 ? (total + 255) / 256 : 65536);
  finalize_i32<<<blocks, 256, 0, stream>>>(partial, fin_rb, fin_p0, fin_np, n_fin, th, P, n_rows, out);
  return (int)cudaGetLastError();
}
