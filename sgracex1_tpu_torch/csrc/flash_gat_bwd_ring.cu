// Flash-GAT backward on Hopper, the ring kernels of K4 and K5: the two tile
// passes of the softmax-Jacobian identity over live tiles only. Per head and
// tile entry (r, c) with an edge:
//
//   p  = exp(LeakyReLU(s1[r] + s2[c]) - m[r]) / max(l[r], 1e-30)
//   lr = 1 if s1[r] + s2[c] > 0 else alpha
//   q  = bf16(gO[r]) . bf16(Wh[c])                        (f32 sums)
//
// K4, the row pass (replaces sgracex1_tpu/ops/flash_gat.py:_bwd_row_pass,
// Pallas kernel _flash_bwd_row_kernel): t = sum_c p q, u1 = sum_c p q lr,
// u2 = sum_c p lr. K5, the column pass (replaces :_bwd_col_pass,
// _flash_bwd_col_kernel): dWh[c] = sum_r bf16(p) bf16(gO[r]) and
// ds2[c] = sum_r p (q - t[r]) lr. Masked entries are never computed (they
// add exactly 0); rows and columns without a live tile come out 0.
// Taken where ops/flash_gat.flash_bwd_ring_shape_ok holds (int8 or bf16
// tiles of height 64..256, F = 64, H in {1, 2, 4}); flash_gat_bwd.cu keeps
// the other shapes.
//
// One kernel shape serves both passes, as FlashAttention-2's backward runs
// its key-block-outer pass as the query-block pass on the transpose:
//  * A work item is (segment of a live schedule, group of R "own" rows): K4
//    walks B.ring and owns rows of A; K5 walks the ring of the transposed
//    live tile set (ops/bsr.live_transpose: A^T over the live tiles only,
//    built once per tile set), whose rows are A's columns. One persistent
//    CTA per SM; it owns every head (R = 128 at H = 4, 256 at H = 1, 2), so
//    the mask is read once for all heads.
//  * The resident operand of the own rows stays for the whole item: K4's gO
//    rows as mma.sync A fragments in registers, K5's Wh rows in the warp's
//    own shared memory (its registers hold the dWh accumulators).
//  * A producer warpgroup keeps a ring of 64-deep slabs in flight: the mask
//    slab of the own rows (TMA), the streamed operand's 64 rows of all heads
//    (TMA; Wh for K4, gO for K5; 272-byte pitch at H = 4) and f32 stats of
//    the slab's rows (one bulk copy: s2 for K4; s1, m, 1/max(l, 1e-30), t
//    for K5), completing on an mbarrier.
//  * Eight consumer warps compute q with mma.sync.m16n8k16 (B through
//    ldmatrix) 16 slab positions at a time and form p, lr and the sums in
//    registers from the C fragment. The slab's order is permuted so that the
//    16 positions a thread holds across the eight n8 blocks are the 16
//    consecutive mask bytes 16t .. 16t + 15 of its row: position (n8 block
//    j, column 2t + e) is slab index 16t + 2((j + t) & 7) + e. ldmatrix
//    takes one address per row, so the streamed rows follow, and the eight
//    rows of each 8x8 matrix fall in eight different banks.
//  * K5 repacks bf16(p) from the C layout of two n8 blocks into the A layout
//    of the next m16n8k16 in registers and adds p^T @ gO to its dWh
//    accumulators, gO through ldmatrix.trans in the same permuted order.
// What bounds it on the H100: per live tile and head K4 does one tensor
// product and K5 two, around one exp and some ten f32 operations an entry;
// the ring moves the live mask once and the streamed operand once per own
// row group. Split runs leave f32 partials that sum_parts adds in a fixed
// order. No atomics.
#include "tile_ring.cuh"

namespace sgfb {

using namespace sgr;

constexpr int FH = 64;             // features a head: the rule takes F = 64
constexpr int CW = 8;              // consumer warps
constexpr int NT = 32 * (CW + 4);  // and the producer's warpgroup
constexpr int SMEM_MAX = 232448;
constexpr float L2E = 1.4426950408889634f;

template <int H>
struct Cfg {
  static constexpr int NH = H < 2 ? H : 2;  // heads a warp owns
  static constexpr int WH = H / NH;         // warps along heads
  static constexpr int WR = CW / WH;        // warps along own rows, 32 rows each
  static constexpr int R = 32 * WR;         // own rows of a CTA: 256 at H = 1, 2; 128 at H = 4
  static constexpr int HF = H * FH;
  static constexpr int NB = (HF + 127) / 128;           // boxes of a streamed row
  static constexpr int BW = (HF < 128 ? HF : 128) + 8;  // box width: 8 spare pad the pitch
  static constexpr int WP = BW * 2;                     // 144 or 272 bytes
  static constexpr int RP = NH * FH * 2 + 16;           // K5: pitch of a warp's resident Wh rows
};

template <int MODE, int H, bool COL>
struct Lay {
  using C = Cfg<H>;
  static constexpr int MBOX = MODE == TILE_I8 ? KS : KS + 8;        // tile columns a box
  static constexpr int MPITCH = MODE == TILE_I8 ? KS : (KS + 8) * 2;  // 64 or 144 bytes
  static constexpr int NS = COL ? 4 : 1;          // f32 stats a slab row and head
  static constexpr int ST = C::R * MPITCH;        // the stats after the mask slab
  static constexpr int OP = ST + KS * NS * H * 4;  // then the streamed rows
  static constexpr int STAGE = OP + C::NB * KS * C::WP;
  static constexpr int RES = COL ? CW * 32 * C::RP : 0;
  static constexpr int FIT = (SMEM_MAX - RES - 1024 - 64) / STAGE;
  static constexpr int RING = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = RING * STAGE + RES + 2 * RING * 8 + 1024;
  static_assert(RING >= 2, "two stages at least");
  static_assert(ST % 128 == 0 && OP % 128 == 0 && STAGE % 128 == 0, "TMA targets align to 128 bytes");
};

struct BArgs {
  int tb, n_rg, n_work, mrows;
  const int *seg_rb, *seg_lo, *seg_hi, *seg_part;
  const int4* step;                // (tile, cb, -1, 0) per live step
  const float* slab_stat;          // K4: s2 [n_ct*tb, H]; K5: [n_rt*tb, 4, H] (s1, m, 1/max(l), t)
  const __nv_bfloat16* res;        // own rows' operand, bf16 [*, H*64]: K4 gO, K5 Wh
  const float *s_own, *m_own, *l_own;  // K4: s1, m, l [n_rt*tb, H]; K5: s2 [n_ct*tb, H]
  float alpha;
  float* out;    // K4: t | u1 | u2 [n_rt*tb, 3H]; K5: dWh [n_ct*tb, H*64]
  float* out2;   // K5: ds2 [n_ct*tb, H]
  float* part;   // split runs: K4 [n_part, tb, 3H]; K5 [n_part, tb, H*64]
  float* part2;  // K5 [n_part, tb, H]
};

// Slab index of position n (0..7) of n8 block j.
__device__ __forceinline__ int pidx(int j, int n) { return 16 * (n >> 1) + 2 * ((j + (n >> 1)) & 7) + (n & 1); }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int MODE, int H, bool COL>
__global__ void __launch_bounds__(NT, 1)
    bwd_ring_kernel(const __grid_constant__ CUtensorMap map_m,
                    const __grid_constant__ CUtensorMap map_o, const BArgs a) {
  using C = Cfg<H>;
  using Y = Lay<MODE, H, COL>;
  constexpr int NH = C::NH, RING = Y::RING;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* res_smem = smem + RING * Y::STAGE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(res_smem + Y::RES);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != CW) return;
    constexpr uint32_t SB = KS * Y::NS * H * 4;
    const uint32_t tx = (uint32_t)(a.mrows * Y::MPITCH) + SB + C::NB * KS * C::WP;
    for (int w = blockIdx.x; w < a.n_work; w += gridDim.x) {
      const int seg = w / a.n_rg, row0 = (w - seg * a.n_rg) * C::R;
      const int lo = a.seg_lo[seg], hi = a.seg_hi[seg];
      for (int gi = lo; gi < hi; ++gi) {
        const int4 st = a.step[gi];
        if (st.x < 0) continue;
        for (int k0 = 0; k0 < tb; k0 += KS) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          if (lane == 0) {
            const uint32_t dst = smem_u32(smem + stage * Y::STAGE), bar = full0 + 8 * stage;
            const int r0 = st.y * tb + k0;  // the streamed rows of the slab
            mbar_expect_tx(bar, tx);
            tma_load_2d(dst, &map_m, bar, k0, st.x * tb + row0);
            bulk_load(dst + Y::ST, a.slab_stat + (long)r0 * Y::NS * H, SB, bar);
#pragma unroll
            for (int b = 0; b < C::NB; ++b) tma_load_2d(dst + Y::OP + b * KS * C::WP, &map_o, bar, b * 128, r0);
          }
          advance();
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = lane >> 2, t = lane & 3;
  const int wh = warp % C::WH, wr = warp / C::WH;
  const int rloc = wr * 32;  // the warp's first own row in the CTA's rows
  // ldmatrix row offsets, in bytes of a streamed row, per pair kk of n8
  // blocks: qo for q's B (rows = slab positions, 8 features each), dO for
  // the dWh product's B through .trans (rows = slab positions)
  uint32_t qo[4], dO[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int mat = lane >> 3;
    qo[kk] = pidx(2 * kk + (mat >> 1), lane & 7) * C::WP + (mat & 1) * 16;
    const int pp = (mat & 1) * 8 + (lane & 7);
    dO[kk] = pidx(2 * kk + (pp >> 3), pp & 7) * C::WP + (lane >> 4) * 16;
  }
  // the byte offset of head h in a streamed row
  auto hoff = [](int h) { return ((h * FH) >> 7) * KS * C::WP + ((h * FH) & 127) * 2; };
  // slab index of this thread's position (n8 block j, column 2t + e)
  auto mypos = [&](int j, int e) { return 16 * t + 2 * ((j + t) & 7) + e; };

  for (int w = blockIdx.x; w < a.n_work; w += gridDim.x) {
    const int seg = w / a.n_rg, row0 = (w - seg * a.n_rg) * C::R;
    const int lo = a.seg_lo[seg], hi = a.seg_hi[seg], rb = a.seg_rb[seg], part = a.seg_part[seg];
    const bool active = row0 + rloc < tb;  // tb % 64 == 0: all 32 rows in, or all out
    const long own0 = (long)rb * tb + row0 + rloc;  // the warp's first own row in the padded grid

    // per own row (m16 block mi, half r2) and head: the row's stats
    float sr[2][2][NH], mL[2][2][NH], li[2][2][NH];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {
          const long o = (own0 + mi * 16 + g + 8 * r2) * H + wh * NH + hh;
          sr[mi][r2][hh] = active ? a.s_own[o] : 0.f;
          if constexpr (!COL) {
            mL[mi][r2][hh] = active ? a.m_own[o] * L2E : 0.f;
            li[mi][r2][hh] = active ? 1.f / fmaxf(a.l_own[o], 1e-30f) : 0.f;
          }
        }

    // the own rows' operand: K4 gO as A fragments [mi][head][k step]; K5
    // the warp's Wh rows in its shared memory
    uint32_t ga[COL ? 1 : 2][NH][4][4];
    float su[COL ? 1 : 3][2][2][NH];   // K4: t, u1, u2
    float ds[2][2][NH];                // K5: ds2
    float acc[COL ? 2 : 1][NH][8][4];  // K5: dWh
    uint8_t* wres = res_smem + warp * 32 * C::RP;
    if constexpr (!COL) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const __nv_bfloat16* p0 = a.res + (own0 + mi * 16 + g) * C::HF + (wh * NH + hh) * FH + ks * 16 + 2 * t;
            const __nv_bfloat16* p1 = p0 + 8 * C::HF;
            ga[mi][hh][ks][0] = active ? ld32(p0) : 0u;
            ga[mi][hh][ks][1] = active ? ld32(p1) : 0u;
            ga[mi][hh][ks][2] = active ? ld32(p0 + 8) : 0u;
            ga[mi][hh][ks][3] = active ? ld32(p1 + 8) : 0u;
          }
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
            for (int hh = 0; hh < NH; ++hh) su[k][mi][r2][hh] = 0.f;
    } else {
      if (active) {
        constexpr int PIECES = NH * FH / 8;  // 16-byte pieces of a warp's row
        for (int i = lane; i < 32 * PIECES; i += 32) {
          const int r = i / PIECES, pc = i - r * PIECES;
          *reinterpret_cast<uint4*>(wres + r * C::RP + pc * 16) =
              *reinterpret_cast<const uint4*>(a.res + (own0 + r) * C::HF + wh * NH * FH + pc * 8);
        }
      }
      __syncwarp();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
          for (int nf = 0; nf < 8; ++nf)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][hh][nf][e] = 0.f;
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) ds[mi][r2][hh] = 0.f;
        }
    }
    // K5: ldmatrix (non-trans) lane address of the warp's Wh rows as A
    const uint32_t a_lane = smem_u32(wres) + ((lane & 7) + ((lane >> 3) & 1) * 8) * C::RP + (lane >> 4) * 16;

    for (int gi = lo; gi < hi; ++gi) {
      if (a.step[gi].x < 0) continue;
      for (int k0 = 0; k0 < tb; k0 += KS) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint8_t* sp = smem + stage * Y::STAGE;
        if (active) {
          // the edge bits of the thread's own rows at its 16 positions:
          // bit 2j + e is position (j, 2t + e), the mask byte 16t + 2((j + t) & 7) + e
          uint32_t bits[2][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2) {
              const int lr = rloc + mi * 16 + g + 8 * r2;
              const uint32_t c16 = mask16<MODE>(sp + lr * Y::MPITCH + (MODE == TILE_I8 ? 16 : 32) * t);
              bits[mi][r2] = ((c16 >> (2 * t)) | (c16 << (16 - 2 * t))) & 0xffffu;
            }
          if (__any_sync(FULL, (bits[0][0] | bits[0][1] | bits[1][0] | bits[1][1]) != 0)) {
            const float* stat = reinterpret_cast<const float*>(sp + Y::ST);
            const uint32_t ob = smem_u32(sp + Y::OP);
#pragma unroll
            for (int hh = 0; hh < NH; ++hh) {
              const int h = wh * NH + hh;
              const uint32_t oh = ob + hoff(h);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                // q of n8 blocks 2kk, 2kk + 1: [mi][j][C fragment]
                float q[2][2][4];
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                  for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) q[mi][j][e] = 0.f;
#pragma unroll
                for (int ks = 0; ks < 4; ++ks) {
                  uint32_t b[4];
                  ldsm_x4(oh + qo[kk] + ks * 32, b);
#pragma unroll
                  for (int mi = 0; mi < 2; ++mi) {
                    uint32_t af[4];
                    if constexpr (COL) {
                      ldsm_x4(a_lane + mi * 16 * C::RP + hh * FH * 2 + ks * 32, af);
                    } else {
#pragma unroll
                      for (int x = 0; x < 4; ++x) af[x] = ga[mi][hh][ks][x];
                    }
                    mma_bf16(q[mi][0], af, b[0], b[1]);
                    mma_bf16(q[mi][1], af, b[2], b[3]);
                  }
                }
                // p and the sums from the C fragments (q becomes p for K5)
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    const int k = 2 * (2 * kk + j) + e, r = mypos(2 * kk + j, e);
                    if constexpr (!COL) {
                      const float s2v = stat[r * H + h];
#pragma unroll
                      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                        for (int r2 = 0; r2 < 2; ++r2) {
                          const float x = sr[mi][r2][hh] + s2v;
                          const float lrv = x > 0.f ? 1.f : a.alpha;
                          const float y = fmaf(fmaxf(x, a.alpha * x), L2E, -mL[mi][r2][hh]);
                          const float p = ((bits[mi][r2] >> k) & 1u) ? ex2(y) * li[mi][r2][hh] : 0.f;
                          const float pq = p * q[mi][j][2 * r2 + e];
                          su[0][mi][r2][hh] += pq;
                          su[1][mi][r2][hh] += pq * lrv;
                          su[2][mi][r2][hh] += p * lrv;
                        }
                    } else {
                      const float* rs = stat + r * 4 * H + h;  // s1, m, 1/max(l), t of slab row r
                      const float s1v = rs[0], mLv = rs[H] * L2E, liv = rs[2 * H], tv = rs[3 * H];
#pragma unroll
                      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                        for (int r2 = 0; r2 < 2; ++r2) {
                          const float x = s1v + sr[mi][r2][hh];
                          const float lrv = x > 0.f ? 1.f : a.alpha;
                          const float y = fmaf(fmaxf(x, a.alpha * x), L2E, -mLv);
                          const float p = ((bits[mi][r2] >> k) & 1u) ? ex2(y) * liv : 0.f;
                          float& qv = q[mi][j][2 * r2 + e];
                          ds[mi][r2][hh] += p * (qv - tv) * lrv;
                          qv = p;
                        }
                    }
                  }
                if constexpr (COL) {
                  // bf16(p^T) of the 16 positions, C layout -> A layout, and
                  // dWh += p^T @ gO over the head's 64 features
                  uint32_t pa[2][4];
#pragma unroll
                  for (int mi = 0; mi < 2; ++mi) {
                    pa[mi][0] = pack_bf16(q[mi][0][0], q[mi][0][1]);
                    pa[mi][1] = pack_bf16(q[mi][0][2], q[mi][0][3]);
                    pa[mi][2] = pack_bf16(q[mi][1][0], q[mi][1][1]);
                    pa[mi][3] = pack_bf16(q[mi][1][2], q[mi][1][3]);
                  }
#pragma unroll
                  for (int nfp = 0; nfp < 4; ++nfp) {
                    uint32_t b[4];
                    ldsm_x4_trans(oh + dO[kk] + nfp * 32, b);
#pragma unroll
                    for (int mi = 0; mi < 2; ++mi) {
                      mma_bf16(acc[mi][hh][2 * nfp], pa[mi], b[0], b[1]);
                      mma_bf16(acc[mi][hh][2 * nfp + 1], pa[mi], b[2], b[3]);
                    }
                  }
                }
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        advance();
      }
    }

    // epilogue: the run's result, or this segment's partial
    if (!active) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int lr = row0 + rloc + mi * 16 + g + 8 * r2;  // own row in the tile
        const long row = part >= 0 ? (long)part * tb + lr : (long)rb * tb + lr;
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {
          const int h = wh * NH + hh;
          if constexpr (!COL) {
            float v[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              v[k] = su[k][mi][r2][hh];
              v[k] += __shfl_xor_sync(FULL, v[k], 1);
              v[k] += __shfl_xor_sync(FULL, v[k], 2);
            }
            if (t == 0) {
              float* dst = (part >= 0 ? a.part : a.out) + row * 3 * H;
              dst[h] = v[0];
              dst[H + h] = v[1];
              dst[2 * H + h] = v[2];
            }
          } else {
            float v = ds[mi][r2][hh];
            v += __shfl_xor_sync(FULL, v, 1);
            v += __shfl_xor_sync(FULL, v, 2);
            if (t == 0) (part >= 0 ? a.part2 : a.out2)[row * H + h] = v;
            float* dst = (part >= 0 ? a.part : a.out) + (row * H + h) * FH + 2 * t;
#pragma unroll
            for (int nf = 0; nf < 8; ++nf)
              *reinterpret_cast<float2*>(dst + nf * 8) =
                  make_float2(acc[mi][hh][nf][2 * r2], acc[mi][hh][nf][2 * r2 + 1]);
          }
        }
      }
  }
}

// out[fin_rb[f] * tb + r, c] = sum over the run's partials, in their order.
__global__ void sum_parts(const float* part, const int* fin_rb, const int* fin_p0, const int* fin_np,
                          int n_fin, int tb, int P, float* out) {
  const long total = (long)n_fin * tb * P;
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const int f = (int)(idx / ((long)tb * P));
    const long rem = idx - (long)f * tb * P;
    const int lr = (int)(rem / P), c = (int)(rem - (long)lr * P);
    const float* src = part + ((long)fin_p0[f] * tb + lr) * P + c;
    float s = 0.f;
    for (int q = 0; q < fin_np[f]; ++q) s += src[(long)q * tb * P];
    out[((long)fin_rb[f] * tb + lr) * P + c] = s;
  }
}

static int sum_runs(const float* part, const int* fin_rb, const int* fin_p0, const int* fin_np, int n_fin,
                    int tb, int P, float* out, cudaStream_t stream) {
  const long total = (long)n_fin * tb * P;
  const int blocks = (int)((total + 255) / 256 < 65536 ? (total + 255) / 256 : 65536);
  sum_parts<<<blocks, 256, 0, stream>>>(part, fin_rb, fin_p0, fin_np, n_fin, tb, P, out);
  return (int)cudaGetLastError();
}

template <int MODE, int H, bool COL>
static int launch(const void* tiles, long n_tiles, int n_seg, const void* op, long n_op, int n_sm, BArgs a,
                  cudaStream_t stream) {
  using C = Cfg<H>;
  using Y = Lay<MODE, H, COL>;
  const int tb = a.tb;
  a.n_rg = (tb + C::R - 1) / C::R;
  a.n_work = n_seg * a.n_rg;
  a.mrows = tb < C::R ? tb : C::R;
  CUtensorMap map_m, map_o;
  int err = MODE == TILE_I8
                ? encode_2d(&map_m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, tiles, (uint64_t)n_tiles * tb, tb, a.mrows,
                            Y::MBOX)
                : encode_2d(&map_m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, tiles, (uint64_t)n_tiles * tb, tb,
                            a.mrows, Y::MBOX);
  if (err) return err;
  err = encode_2d(&map_o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, op, (uint64_t)n_op, C::HF, KS, C::BW);
  if (err) return err;
  auto kernel = bwd_ring_kernel<MODE, H, COL>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Y::SMEM);
  if (e != cudaSuccess) return (int)e;
  if (a.n_work == 0) return 0;
  const int grid = a.n_work < n_sm ? a.n_work : n_sm;
  kernel<<<grid, NT, Y::SMEM, stream>>>(map_m, map_o, a);
  return (int)cudaGetLastError();
}

template <int MODE, bool COL>
static int launch_heads(int H, const void* tiles, long n_tiles, int n_seg, const void* op, long n_op, int n_sm,
                        const BArgs& a, cudaStream_t stream) {
  switch (H) {
    case 1: return launch<MODE, 1, COL>(tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream);
    case 2: return launch<MODE, 2, COL>(tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream);
    case 4: return launch<MODE, 4, COL>(tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sgfb

// K4 (col = 0) on B's live schedule, or K5 (col = 1) on the live schedule
// of the transposed live tile set: int8 (mode 2) or bf16 (mode 0) tiles,
// tb % 64 == 0 and tb <= 256, F = 64, H in {1, 2, 4}. ``op`` is the streamed
// bf16 operand [n_op, H * 64] (K4 Wh, K5 gO), ``res`` the own rows' one (K4
// gO, K5 Wh), both padded to the tile grid; ``slab_stat`` K4's s2
// [n_ct*tb, H] or K5's [n_rt*tb, 4, H]; s_own/m_own/l_own K4's s1, m, l
// (K5: s2, null, null). K4 writes out [n_rt*tb, 3H] (t | u1 | u2); K5 out
// (dWh) [n_ct*tb, H*64] and out2 (ds2) [n_ct*tb, H]. Returns 0, a
// cudaError_t, or 10000 + a CUresult of the tensor-map encoder.
extern "C" int sg_flash_gat_bwd_ring(int col, const void* tiles, int tile_mode, int tb, long n_tiles, int n_seg,
                                     const int* seg_rb, const int* seg_lo, const int* seg_hi,
                                     const int* seg_part, int n_fin, const int* fin_rb, const int* fin_p0,
                                     const int* fin_np, const int* step, const float* slab_stat, const void* op,
                                     long n_op, const void* res, const float* s_own, const float* m_own,
                                     const float* l_own, int H, float alpha, float* out, float* out2,
                                     float* part, float* part2, int n_sm, void* stream_ptr) {
  using namespace sgfb;
  if (tb % 64 || tb > 256 || tb < 64 || (!col && (m_own == nullptr || l_own == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  BArgs a{tb, 0, 0, 0,
          seg_rb, seg_lo, seg_hi, seg_part,
          reinterpret_cast<const int4*>(step), slab_stat, static_cast<const __nv_bfloat16*>(res),
          s_own, m_own, l_own, alpha, out, out2, part, part2};
  int err;
  if (tile_mode == TILE_I8)
    err = col ? launch_heads<TILE_I8, true>(H, tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream)
              : launch_heads<TILE_I8, false>(H, tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream);
  else if (tile_mode == TILE_BF16)
    err = col ? launch_heads<TILE_BF16, true>(H, tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream)
              : launch_heads<TILE_BF16, false>(H, tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0 || n_fin == 0) return err;
  if (!col) return sum_runs(part, fin_rb, fin_p0, fin_np, n_fin, tb, 3 * H, out, stream);
  err = sum_runs(part, fin_rb, fin_p0, fin_np, n_fin, tb, H * 64, out, stream);
  if (err != 0) return err;
  return sum_runs(part2, fin_rb, fin_p0, fin_np, n_fin, tb, H, out2, stream);
}
