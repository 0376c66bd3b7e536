// The flash ring kernel of K3 / K6 / K12 and its launch, as templates: the
// kernel (VAR 0) is instantiated in flash_gat_ring.cu, which holds its
// design notes, and the JAX package's ablations of its consumer work in
// flash_gat_ring_fast.cu (VAR 1, fast_exp) and flash_gat_ring_noscore.cu
// (VAR 2, K6's noscore chunks), each source compiled on its own.
#pragma once

#include "subblock.cuh"
#include "tile_ring.cuh"

namespace sgfr {

using namespace sgr;

constexpr int FH = 64;                    // features a head: the rule takes F = 64
constexpr int CW = 8;                     // consumer warps
constexpr int NT = 32 * (CW + 4);         // and the producer's warpgroup
constexpr int RING = 4;                   // stages
constexpr float M_INIT = -1e5f;
constexpr float L2E = 1.4426950408889634f;

template <int H>
struct Cfg {
  static constexpr int NH = H < 2 ? H : 2;    // heads a warp owns
  static constexpr int WH = H / NH;           // warps along heads
  static constexpr int WR = CW / WH;          // warps along rows, 32 rows each
  static constexpr int R = 32 * WR;           // rows a CTA owns: 256 at H = 1, 2; 128 at H = 4
  static constexpr int HF = H * FH;
  static constexpr int NB = (HF + 127) / 128;             // Wh boxes of a slab
  static constexpr int BW = (HF < 128 ? HF : 128) + 8;    // box width: 8 spare pad the pitch
  static constexpr int WP = BW * 2;                       // 144 or 272 bytes
  static constexpr int S2_BYTES = KS * H * 4;
};

template <int MODE>
struct Msk {
  static constexpr int BOX = MODE == TILE_I8 ? KS : KS + 8;       // tile columns a box
  static constexpr int PITCH = MODE == TILE_I8 ? KS : (KS + 8) * 2;  // 64 or 144 bytes
};

// One stage: the slab's mask rows (or a chunk slab's lrow), s2, then Wh.
template <int MODE, int H>
struct Lay {
  static constexpr int S2 = Cfg<H>::R * Msk<MODE>::PITCH;
  static constexpr int W = S2 + Cfg<H>::S2_BYTES;
  static constexpr int STAGE = W + Cfg<H>::NB * KS * Cfg<H>::WP;
  static constexpr int SMEM = RING * STAGE + 2 * RING * 8 + 1024;
  static_assert(S2 % 128 == 0 && W % 128 == 0 && STAGE % 128 == 0, "TMA targets align to 128 bytes");
};

struct FArgs {
  int tb, n_rg, n_work, mrows, K;
  const int *seg_rb, *seg_lo, *seg_hi, *seg_part;
  // (tile or -1, cb, chunk or -1, chunk slots to read) per live step; K12's
  // tile steps hold no chunk and, last, the mask of the slabs to load
  const int4* step;
  const int* lrow;           // [R, K]
  const int* slot_col;       // [R*K]
  const float* s1;           // [n_s1, H]
  int n_s1;
  const float* s2p;          // [n_ct * tb, H], zero-padded
  const __nv_bfloat16* Wh;   // [n_wh, H * 64]
  float alpha;
  float* out;                // [n_rows, H, 64]
  int n_rows;
  float* m_out;              // [n_rt * tb, H] or null
  float* l_out;
  float* pm;                 // split runs: [n_part, tb, H]
  float* pl;
  float* pacc;               // [n_part, tb, H, 64]
  sgsub::Pop pop;            // K12: the sub-block bitmap
};

// s2 of one slot, H floats; zero-filled for a slot outside the CTA's rows
template <int H>
__device__ __forceinline__ void cp_async_s2(uint32_t dst, const float* src, bool valid) {
  if constexpr (H * 4 == 16) {
    cp_async16(dst, src, valid);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(H * 4),
                 "r"(valid ? H * 4 : 0)
                 : "memory");
  }
}

// One slab's products for head h of the consumer warp: p on the thread's 16
// positions (bit k of bits[mi][r2] is position k's edge flag), into l and,
// as bf16 A fragments of mma.sync.m16n8k16, into acc. HOW forms p: 0 exact
// (ex2 of max(s2 L2E + ap, alpha s2 L2E + an)), 1 fast_ex2 of the same
// exponent, 2 the value 1 with l untouched (K6's noscore chunks).
template <int HOW, int H, int NH>
__device__ __forceinline__ void slab_products(float (&acc)[2][NH][8][4], float (&l)[2][2][NH], int hh, int h,
                                              const uint32_t (&bits)[2][2], uint32_t live4, const float* s2s,
                                              int t, int sw, int tl, const float (&ap)[2][2],
                                              const float (&an)[2][2], float alpha, uint32_t wb,
                                              const uint32_t (&b_off)[4]) {
  auto cpos = [&](int i, int h2) { return 16 * t + 4 * (i ^ sw) + 2 * (tl ^ h2); };
  auto s2_at = [&](int k) { return s2s[(cpos(k >> 2, (k >> 1) & 1) + (k & 1)) * H + h]; };
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!((live4 >> i) & 1u)) continue;  // K12: the product adds nothing
    float sp_[4], sn_[4];  // s2 L2E and alpha s2 L2E of the product's positions
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sp_[j] = s2_at(4 * i + j) * L2E;
      sn_[j] = alpha * sp_[j];
    }
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * i + 2 * h2 + e;
            // __fadd_rn: never contracted into an FMA, so K12's and K3's
            // instantiations round the exponent alike
            const float y = fmaxf(__fadd_rn(sp_[k & 3], ap[mi][r2]), __fadd_rn(sn_[k & 3], an[mi][r2]));
            p[e] = ((bits[mi][r2] >> k) & 1u) ? (HOW == 2 ? 1.f : HOW == 1 ? fast_ex2(y) : ex2(y)) : 0.f;
          }
          if (HOW != 2) l[mi][r2][hh] += p[0] + p[1];
          af[mi][r2 + 2 * h2] = pack_bf16(p[0], p[1]);
        }
#pragma unroll
    for (int njp = 0; njp < 4; ++njp) {
      uint32_t b[4];
      ldsm_x4_trans(wb + b_off[i] + njp * 32, b);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][hh][2 * njp], af[mi], b[0], b[1]);
        mma_bf16(acc[mi][hh][2 * njp + 1], af[mi], b[2], b[3]);
      }
    }
  }
}

// VAR: 0 the kernel (exact exps), 1 fast_ex2 for p, 2 noscore chunk slabs
template <int MODE, int H, bool SUB, int VAR>
__global__ void __launch_bounds__(NT, 1)
    flash_ring_kernel(const __grid_constant__ CUtensorMap map_m,
                      const __grid_constant__ CUtensorMap map_w, const FArgs a) {
  using C = Cfg<H>;
  using Y = Lay<MODE, H>;
  constexpr int NH = C::NH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + RING * Y::STAGE);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + RING);
  const int tb = a.tb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++stage == RING) {
      stage = 0;
      phase ^= 1;
    }
  };

  if (warp >= CW) {
    // ------------------------------------------------------------ producer
    // three warpgroups start at 168 registers; the producer's gives 128 of
    // them to the consumers (3 * 168 = 40 + 2 * 232)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != CW) return;
    const uint32_t tile_tx = (uint32_t)(a.mrows * Msk<MODE>::PITCH + C::S2_BYTES + C::NB * KS * C::WP);
    constexpr int PIECES = C::HF / 8;  // 16-byte pieces of a Wh row
    constexpr int RPI = 32 / PIECES;   // rows a warp instruction gathers
    const int f0 = (lane % PIECES) * 8;
    const uint32_t w_lane = Y::W + (f0 >> 7) * KS * C::WP + (f0 & 127) * 2;
    for (int w = blockIdx.x; w < a.n_work; w += gridDim.x) {
      const int seg = w / a.n_rg, row0 = (w - seg * a.n_rg) * C::R;
      const int lo = a.seg_lo[seg], hi = a.seg_hi[seg];
      for (int g = lo; g < hi; ++g) {
        const int4 st = a.step[g];
        if (st.x >= 0) {
          const int sl = SUB ? st.w : ~0;  // K12: the 64-column slabs to load
          for (int k0 = 0; k0 < tb; k0 += KS) {
            if (!((sl >> (k0 / KS)) & 1)) continue;
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            if (lane == 0) {
              const uint32_t dst = smem_u32(smem + stage * Y::STAGE), bar = full0 + 8 * stage;
              const int c0 = st.y * tb + k0;
              mbar_expect_tx(bar, tile_tx);
              tma_load_2d(dst, &map_m, bar, k0, st.x * tb + row0);
              bulk_load(dst + Y::S2, a.s2p + (long)c0 * H, C::S2_BYTES, bar);
#pragma unroll
              for (int b = 0; b < C::NB; ++b) tma_load_2d(dst + Y::W + b * KS * C::WP, &map_w, bar, b * 128, c0);
            }
            advance();
          }
        }
        if (st.z >= 0) {
          const int* rows = a.lrow + (long)st.z * a.K;
          const int* cols = a.slot_col + (long)st.z * a.K;
          for (int k0 = 0; k0 < st.w; k0 += KS) {
            // the slab's slots that land in this CTA's rows; dead slots
            // (lrow == tb) and the other row groups' slots are zero-filled
            const int r0 = rows[k0 + lane], r1 = rows[k0 + 32 + lane];
            const int c0 = (r0 >= row0 && r0 < row0 + C::R && r0 < tb) ? cols[k0 + lane] : -1;
            const int c1 = (r1 >= row0 && r1 < row0 + C::R && r1 < tb) ? cols[k0 + 32 + lane] : -1;
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            const uint32_t dst = smem_u32(smem + stage * Y::STAGE), bar = full0 + 8 * stage;
            cp_async_s2<H>(dst + Y::S2 + lane * H * 4, a.s2p + (long)max(c0, 0) * H, c0 >= 0);
            cp_async_s2<H>(dst + Y::S2 + (lane + 32) * H * 4, a.s2p + (long)max(c1, 0) * H, c1 >= 0);
#pragma unroll 8
            for (int j = 0; j < KS; j += RPI) {
              const int r = j + lane / PIECES;
              const int col = __shfl_sync(FULL, j < 32 ? c0 : c1, r & 31);
              cp_async16(dst + w_lane + r * C::WP, a.Wh + (long)max(col, 0) * C::HF + f0, col >= 0);
            }
            cp_async_arrive_on(bar);
            __syncwarp();  // every lane's pending arrival is counted before the phase can end
            if (lane == 0) {
              mbar_expect_tx(bar, KS * 4);
              bulk_load(dst, rows + k0, KS * 4, bar);
            }
            advance();
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = lane >> 2, t = lane & 3, sw = t >> 1, tl = t & 1;
    const int wh = warp % C::WH, wr = warp / C::WH;
    // The thread's slab columns: position pair (i, h2) of product i is the
    // column pair cpos(i, h2), +1 (slab_k of tile_ring.cuh); a thread's 16
    // columns are 16t .. 16t + 15.
    auto cpos = [&](int i, int h2) { return 16 * t + 4 * (i ^ sw) + 2 * (tl ^ h2); };
    uint32_t b_off[4];
    {
      const int pp = ((lane >> 3) & 1) * 8 + (lane & 7), noff = (lane >> 4) * 8;
#pragma unroll
      for (int i = 0; i < 4; ++i) b_off[i] = slab_k<TILE_I8>(i, pp) * C::WP + noff * 2;
    }
    float acc[2][NH][8][4];
    float s1v[2][2][NH], m[2][2][NH], l[2][2][NH];
    // K12: byte j of cs0p / spanp is the first sub-block column of this
    // thread's 16-column window 64j + 16t .. + 15 and the sub-block columns
    // it meets less one (tb <= 256: four slabs)
    uint32_t cs0p = 0, spanp = 0;
    if constexpr (SUB) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = 64 * j + 16 * t;
        cs0p |= (uint32_t)(c0 / a.pop.sb) << (8 * j);
        spanp |= (uint32_t)((c0 + 15) / a.pop.sb - c0 / a.pop.sb) << (8 * j);
      }
    }

    for (int w = blockIdx.x; w < a.n_work; w += gridDim.x) {
      const int seg = w / a.n_rg, row0 = (w - seg * a.n_rg) * C::R;
      const int lo = a.seg_lo[seg], hi = a.seg_hi[seg], rb = a.seg_rb[seg], part = a.seg_part[seg];
      const int rloc = wr * 32;          // the warp's first row in the CTA's rows
      const bool active = row0 + rloc < tb;  // tb % 64 == 0: all 32 rows in, or all out
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
          for (int hh = 0; hh < NH; ++hh) {
            const long grow = (long)rb * tb + row0 + rloc + mi * 16 + g + 8 * r2;
            s1v[mi][r2][hh] = (active && grow < a.n_s1) ? a.s1[grow * H + wh * NH + hh] : 0.f;
            m[mi][r2][hh] = M_INIT;
            l[mi][r2][hh] = 0.f;
#pragma unroll
            for (int nj = 0; nj < 8; ++nj) acc[mi][hh][nj][2 * r2] = acc[mi][hh][nj][2 * r2 + 1] = 0.f;
          }
      // K12: the first bit of each of the thread's rows' sub-block rows, and
      // per tile step the tile's words and (ns <= 32) the rows' bits
      int rbit[2][2];
      uint32_t rowbits[2][2];
      const int* prow = nullptr;
      if constexpr (SUB) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) rbit[mi][r2] = ((row0 + rloc + mi * 16 + g + 8 * r2) / a.pop.sb) * a.pop.ns;
      }

      auto slab = [&](bool chunk, int k0) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint8_t* sp = smem + stage * Y::STAGE;
        if (active) {
          // K12: the keep flags of the thread's 16 columns in each of its rows
          uint32_t kp[2][2];
          if constexpr (SUB) {
            if (!chunk) {
              const int j8 = 8 * (k0 / KS), cs0 = (cs0p >> j8) & 255, span = (spanp >> j8) & 255;
              const int c0 = k0 + 16 * t;
              if (a.pop.sb % 32 == 0) {  // the warp's 32 rows lie in one sub-block row
                const uint32_t k = sgsub::expand<16>(rowbits[0][0] >> cs0, c0, a.pop.sb, span);
                kp[0][0] = kp[0][1] = kp[1][0] = kp[1][1] = k;
              } else {
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                  for (int r2 = 0; r2 < 2; ++r2) {
                    const uint32_t sub = a.pop.ns <= 32 ? rowbits[mi][r2] >> cs0
                                                        : sgsub::bits_at(prow, a.pop.nw, rbit[mi][r2] + cs0);
                    kp[mi][r2] = sgsub::expand<16>(sub, c0, a.pop.sb, span);
                  }
              }
            }
          }
          // the edge bits of the thread's rows at its 16 positions: bit
          // 4i + 2h2 + e is column cpos(i, h2) + e
          uint32_t bits[2][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2) {
              const int lr = rloc + mi * 16 + g + 8 * r2;  // row in the CTA's rows
              uint32_t b = 0;
              if (chunk) {
                const int* lrow = reinterpret_cast<const int*>(sp);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                  for (int h2 = 0; h2 < 2; ++h2) {
                    const int2 v = *reinterpret_cast<const int2*>(lrow + cpos(i, h2));
                    b |= (uint32_t)(v.x == row0 + lr) << (4 * i + 2 * h2);
                    b |= (uint32_t)(v.y == row0 + lr) << (4 * i + 2 * h2 + 1);
                  }
              } else {
                // the edge flags of the thread's 16 columns in column order
                // (bit c: column 16t + c), then in position order
                uint32_t c16 =
                    mask16<MODE>(sp + lr * Msk<MODE>::PITCH + (MODE == TILE_I8 ? 16 : 32) * t);
                if constexpr (SUB) c16 &= kp[mi][r2];  // only the columns of populated sub-blocks
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  uint32_t n = (c16 >> (4 * (i ^ sw))) & 0xfu;  // columns 4q .. 4q + 3
                  if (tl) n = ((n >> 2) | (n << 2)) & 0xfu;     // halves in position order
                  b |= n << (4 * i);
                }
              }
              bits[mi][r2] = b;
            }
          const uint32_t all4 = bits[0][0] | bits[0][1] | bits[1][0] | bits[1][1];
          // K12: bit i set when product i holds a bit in the warp's 32 rows
          uint32_t live4 = 0xfu;
          if constexpr (SUB) {
#pragma unroll
            for (int i = 0; i < 4; ++i) live4 &= ~((uint32_t)(((all4 >> (4 * i)) & 0xfu) == 0u) << i);
            live4 = __reduce_or_sync(FULL, live4);
          }
          if (__any_sync(FULL, all4 != 0u)) {
            const bool ones = VAR == 2 && chunk;  // noscore: p = 1 on each slot's row
            const float* s2s = reinterpret_cast<const float*>(sp + Y::S2);
#pragma unroll
            for (int hh = 0; hh < NH; ++hh) {
              const int h = wh * NH + hh;
              // s2 of position k (0..15) of this thread: column cpos(k / 4, k / 2 % 2) + k % 2
              auto s2_at = [&](int k) { return s2s[(cpos(k >> 2, (k >> 1) & 1) + (k & 1)) * H + h]; };
              // the running max, once a slab: the largest s2 over each row's edges
              if (!ones) {
                float big[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
                for (int k = 0; k < 16; ++k) {
                  const float v = s2_at(k);
#pragma unroll
                  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                    for (int r2 = 0; r2 < 2; ++r2)
                      if ((bits[mi][r2] >> k) & 1u) big[mi][r2] = fmaxf(big[mi][r2], v);
                }
                float corr[2][2];
                bool grew = false;
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                  for (int r2 = 0; r2 < 2; ++r2) {
                    float x = big[mi][r2];
                    x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
                    x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
                    float& mr = m[mi][r2][hh];
                    corr[mi][r2] = 1.f;
                    if (x > -INFINITY) {
                      x = s1v[mi][r2][hh] + x;
                      x = fmaxf(x, a.alpha * x);
                      if (x > mr) {
                        corr[mi][r2] = expf(mr - x);
                        l[mi][r2][hh] *= corr[mi][r2];
                        mr = x;
                        grew = true;
                      }
                    }
                  }
                if (__any_sync(FULL, grew)) {
#pragma unroll
                  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                    for (int nj = 0; nj < 8; ++nj) {
                      acc[mi][hh][nj][0] *= corr[mi][0];
                      acc[mi][hh][nj][1] *= corr[mi][0];
                      acc[mi][hh][nj][2] *= corr[mi][1];
                      acc[mi][hh][nj][3] *= corr[mi][1];
                    }
                }
              }
              // p in the A fragments, product by product, and bf16(p) @ bf16(Wh).
              // LeakyReLU(s1 + s2) - m = max(s1 + s2 - m, alpha (s1 + s2) - m),
              // so the exponent is max(s2 L2E + ap, alpha s2 L2E + an) with the
              // row terms ap = (s1 - m) L2E, an = (alpha s1 - m) L2E
              float ap[2][2], an[2][2];
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int r2 = 0; r2 < 2; ++r2) {
                  ap[mi][r2] = (s1v[mi][r2][hh] - m[mi][r2][hh]) * L2E;
                  an[mi][r2] = (a.alpha * s1v[mi][r2][hh] - m[mi][r2][hh]) * L2E;
                }
              const uint32_t wb = smem_u32(sp + Y::W) + ((h * FH) >> 7) * KS * C::WP + ((h * FH) & 127) * 2;
#pragma unroll
              asm volatile("" ::: "memory");  // s2 is read again below, not kept in registers
              if (ones)
                slab_products<2, H, NH>(acc, l, hh, h, bits, live4, s2s, t, sw, tl, ap, an, a.alpha, wb, b_off);
              else
                slab_products<VAR == 1, H, NH>(acc, l, hh, h, bits, live4, s2s, t, sw, tl, ap, an, a.alpha, wb,
                                               b_off);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        advance();
      };

      for (int gi = lo; gi < hi; ++gi) {
        const int4 st = a.step[gi];
        if (st.x >= 0) {
          int sl = ~0;
          if constexpr (SUB) {
            sl = st.w;
            prow = a.pop.bits + (long)st.x * a.pop.nw;
            if (a.pop.sb % 32 == 0 && active) {
              rowbits[0][0] = sgsub::bits_at(prow, a.pop.nw, rbit[0][0]);
            } else if (a.pop.ns <= 32 && active) {
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int r2 = 0; r2 < 2; ++r2) rowbits[mi][r2] = sgsub::bits_at(prow, a.pop.nw, rbit[mi][r2]);
            }
          }
          for (int k0 = 0; k0 < tb; k0 += KS)
            if ((sl >> (k0 / KS)) & 1) slab(false, k0);
        }
        if (st.z >= 0)
          for (int k0 = 0; k0 < st.w; k0 += KS) slab(true, k0);
      }

      // epilogue from registers: the run's result, or this segment's partial
      if (active) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
            for (int hh = 0; hh < NH; ++hh) {
              float lq = l[mi][r2][hh];
              lq += __shfl_xor_sync(FULL, lq, 1);
              lq += __shfl_xor_sync(FULL, lq, 2);
              const int lr = row0 + rloc + mi * 16 + g + 8 * r2;  // row in the tile
              const int h = wh * NH + hh;
              const float mr = m[mi][r2][hh];
              if (part >= 0) {
                const long o = ((long)part * tb + lr) * H + h;
                if (t == 0) {
                  a.pm[o] = mr;
                  a.pl[o] = lq;
                }
                float* dst = a.pacc + o * FH + 2 * t;
#pragma unroll
                for (int nj = 0; nj < 8; ++nj)
                  *reinterpret_cast<float2*>(dst + nj * 8) =
                      make_float2(acc[mi][hh][nj][2 * r2], acc[mi][hh][nj][2 * r2 + 1]);
              } else {
                const long grow = (long)rb * tb + lr;
                if (t == 0 && a.m_out != nullptr) {
                  a.m_out[grow * H + h] = mr;
                  a.l_out[grow * H + h] = lq;
                }
                if (grow < a.n_rows) {
                  const float inv = 1.f / fmaxf(lq, 1e-30f);
                  float* dst = a.out + (grow * H + h) * FH + 2 * t;
#pragma unroll
                  for (int nj = 0; nj < 8; ++nj)
                    *reinterpret_cast<float2*>(dst + nj * 8) =
                        make_float2(acc[mi][hh][nj][2 * r2] * inv, acc[mi][hh][nj][2 * r2 + 1] * inv);
                }
              }
            }
      }
    }
  }
}

template <int MODE, int H, bool SUB, int VAR>
static int launch(const void* tiles, long n_tiles, int n_seg, int n_wh, int n_sm, FArgs args,
                  cudaStream_t stream) {
  using C = Cfg<H>;
  const int tb = args.tb;
  args.n_rg = (tb + C::R - 1) / C::R;
  args.n_work = n_seg * args.n_rg;
  args.mrows = tb < C::R ? tb : C::R;
  CUtensorMap map_m, map_w;
  int err = MODE == TILE_I8
                ? encode_2d(&map_m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, tiles, (uint64_t)n_tiles * tb, tb,
                            args.mrows, Msk<MODE>::BOX)
                : encode_2d(&map_m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, tiles, (uint64_t)n_tiles * tb,
                            tb, args.mrows, Msk<MODE>::BOX);
  if (err) return err;
  err = encode_2d(&map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, args.Wh, n_wh, C::HF, KS, C::BW);
  if (err) return err;
  auto kernel = flash_ring_kernel<MODE, H, SUB, VAR>;
  constexpr int SMEM = Lay<MODE, H>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  if (args.n_work == 0) return 0;
  const int grid = args.n_work < n_sm ? args.n_work : n_sm;
  kernel<<<grid, NT, SMEM, stream>>>(map_m, map_w, args);
  return (int)cudaGetLastError();
}

// A variant of the kernel at the tile mode and head count of a launch:
// flash_gat_ring_fast.cu defines VAR 1's, flash_gat_ring_noscore.cu VAR 2's.
int launch_fast(int mode, int H, const void* tiles, long n_tiles, int n_seg, int n_wh, int n_sm,
                const FArgs& args, cudaStream_t stream);
int launch_noscore(int mode, int H, const void* tiles, long n_tiles, int n_seg, int n_wh, int n_sm,
                   const FArgs& args, cudaStream_t stream);

}  // namespace sgfr
