// Flash-GAT forward on Hopper, the ring kernel of K3 and K6: masked
// online-softmax attention aggregation over the live steps of a block-sparse
// schedule. Per row r and head h:
//
//   out[r] = sum_c softmax_c(LeakyReLU(s1[r] + s2[c]) | edge(r, c)) * Wh[c]
//
// Replaces sgracex1_tpu/ops/flash_gat.py:flash_gat_forward (Pallas kernel
// _flash_gat_kernel), :flash_gat_hybrid_forward (_flash_hybrid_kernel) and
// at H = 1 :flash_gat_forward_subskip (_flash_gat_kernel_subskip, K12)
// where ops/flash_gat.flash_ring_shape_ok holds: int8 or bf16 tiles of
// height 64..256, F = 64, H in {1, 2, 4}, chunks of whole 64-slot slabs.
// The single-stage kernel (flash_gat.cu) keeps every other shape.
//
// K12 is K3 with the sub-block bitmap (subblock.cuh, any sb that divides
// tb), compiled into its own instantiations (SUB; K3 and K6 build without
// it). The host folds the bitmap into the live steps: at H = 1 a work item
// holds every row of its tile, and a tile step loads only the 64-column
// slabs that a populated sub-block meets (their mask in the step's last
// field), which saves the slabs' copies as well as their work. Inside a
// slab each thread clears the mask bits of its 16 columns that lie in empty
// sub-blocks. The consumers' instructions bound this kernel, so the bitmap
// costs a thread a few instructions a slab: its 16-column windows' first
// sub-block column and span are worked out once a launch, its rows'
// sub-block rows once a work item, and (sb >= 8 at tb = 256) its rows' bits
// once a tile step by one funnel shift each (one for all four rows where
// sb % 32 == 0: a warp's 32 rows then lie in one sub-block row). A warp
// then skips the exps and MMAs of every m16n8k16 product of its 32 rows
// whose positions hold no bit (one OR-reduction a slab), and the whole slab
// where none does. What is skipped adds exact zeros, so
// on a bitmap of the tiles' own edges K12 equals K3 bit for bit.
//
// What bounds it on the H100. The tensor work is small (2 * tb^2 * H * F a
// live tile); the score work is not: every entry of a live tile and head
// costs a mask test, two adds, a max, an exp and a sum, and the running max
// a masked max. Builds that drop one part of the consumers' work at a time
// (PERF.md, Findings) show the ring alone taking well under half of the kernel's
// time on the 2^20-node GAT slice: the consumers' instruction rate (8 warps
// an SM) bounds it. The single-stage kernel
// (flash_gat.cu, 8 ms) spent its time elsewhere: one CTA per (segment, 64
// rows, head, 64 features), so the mask was read once a head, and every CTA
// walked the empty cover tiles and some ten block barriers a step. Here:
//  * Only the live steps run (LiveSchedule: plan.ring for K6, B.ring for K3;
//    the empty cover tiles are gone, chunks stop at their last live slot).
//  * One persistent CTA per SM walks work items (segment, row group). A CTA
//    owns R rows and every head: R = 128 at H = 4, 256 (the whole tile) at
//    H = 1, 2, so its accumulators, R x H*F f32, fill the consumer warps'
//    registers. The mask is read once per row group, not once per head; Wh
//    is read once per row group (twice a tile at H = 4).
//  * A producer warpgroup keeps a ring of RING slabs in flight, 64 columns
//    deep: the mask rows of the slab (TMA), s2 of its columns (one bulk
//    copy) and the Wh rows of all heads (TMA, boxes of 128 features); for a
//    chunk step the slab's lrow (bulk copy) and the s2 and Wh rows of the
//    slots that land in the CTA's rows (cp.async; the other slots are
//    zero-filled, never gathered), completing on an mbarrier.
//  * Eight consumer warps (rows x heads, 32 rows and 1 or 2 heads each)
//    build p in registers directly in mma.sync.m16n8k16's A-fragment layout
//    (a thread reads 16 consecutive mask bytes of a row; the k order of the
//    products is permuted to match, as in tile_ring.cuh, and B follows
//    through ldmatrix.trans). The accumulators stay in registers: the
//    rescale is a register multiply, and the epilogue stores from them.
//  * The running max moves once a slab: a quad shuffle gives each row's
//    largest s2 over its edges in the slab, m_new = max(m, LeakyReLU(s1 +
//    that)) (LeakyReLU(s1 + x) rounds monotonically in x, so m is the exact
//    maximum of the row's scores, bit for bit the TPU kernel's), and the
//    accumulators are rescaled only when m grew. A warp whose rows hold no
//    edge in a slab skips it.
// Rounding points as the TPU kernel's: f32 scores, p = exp(e - m) (here
// ex2.approx of max((s1 + s2 - m) L2E, (alpha (s1 + s2) - m) L2E), the same
// value up to f32 rounding of the exponent), bf16(p) @ bf16(Wh) with f32
// sums, f32 p in l. bf16(p) rounds
// against this kernel's running max, not the TPU kernel's per-tile one.
// Split runs leave (m, l, acc) partials that merge_ring combines in a fixed
// order. No atomics.
// The JAX package's ablations of the consumers' work are variants of this
// kernel (the template's VAR; the kernel itself is in flash_gat_ring.cuh):
// VAR 1 takes Schraudolph's exp (fast_ex2) for p, the TPU kernel's
// fast_exp option (K3); VAR 2 adds a chunk slab's onehot(lrow) @ Wh to the
// sums with no score, max or l, K6's chunk mode noscore. They are built in
// their own sources (flash_gat_ring_fast.cu, flash_gat_ring_noscore.cu),
// compiled beside this one, so VAR 0, the kernel the main path runs, is the
// code it was: a runtime flag tested in the consumers' loop measured 13-22%
// on K3/K6 at H=4 on the card. A noscore chunk lands at the running max of
// its work item, so in a run split over work items it is weighted
// otherwise than in the unsplit run. K6's chunk mode off is K3 over the
// plan's tiles: the wrapper launches this kernel on the tiles' schedule.
#include "flash_gat_ring.cuh"

namespace sgfr {

// One warp per (split run, row, head): M = max m_i, L = sum l_i e^{m_i - M},
// out = sum acc_i e^{m_i - M} / max(L, 1e-30), partials in their fixed order;
// a lane holds two of the 64 features.
__global__ void merge_ring(const float* pm, const float* pl, const float* pacc, const int* fin_rb,
                           const int* fin_p0, const int* fin_np, int n_fin, int tb, int H,
                           int n_rows, float* out, float* m_out, float* l_out) {
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
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, o));
  float L = 0.f;
  for (int i = lane; i < np; i += 32) L += pl[at(i)] * expf(pm[at(i)] - M);
  for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(FULL, L, o);
  const long grow = (long)fin_rb[f] * tb + lr;
  if (lane == 0 && m_out != nullptr) {
    m_out[grow * H + h] = M;
    l_out[grow * H + h] = L;
  }
  if (grow >= n_rows) return;
  const float inv = 1.f / fmaxf(L, 1e-30f);
  float2 sum = make_float2(0.f, 0.f);
  for (int i = 0; i < np; ++i) {
    const float s = expf(pm[at(i)] - M);
    const float2 v = *reinterpret_cast<const float2*>(pacc + at(i) * FH + 2 * lane);
    sum.x += v.x * s;
    sum.y += v.y * s;
  }
  *reinterpret_cast<float2*>(out + (grow * H + h) * FH + 2 * lane) = make_float2(sum.x * inv, sum.y * inv);
}

// K12's fold of the bitmap into the live steps (ops/flash_gat.
// subskip_schedule is its plain version): one warp a step; the lanes walk
// the set bits of the step's tile, each a sub-block whose column meets
// 64-column slabs j0 .. j1, and OR their slab masks. The step keeps its
// place with the mask in its last field, or with no tile where the mask is
// empty.
__global__ void subskip_fold(const int4* step, int n_step, sgsub::Pop pop, int4* out) {
  const long warp = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_step) return;
  const int4 st = step[warp];
  uint32_t m = 0;
  if (st.x >= 0) {
    const int* row = pop.bits + (long)st.x * pop.nw;
    const int n_bits = pop.ns * pop.ns;
    for (int w = lane; w < pop.nw; w += 32) {
      uint32_t x = (uint32_t)__ldg(row + w);
      while (x != 0u) {
        const int bit = 32 * w + __ffs(x) - 1;
        x &= x - 1u;
        if (bit >= n_bits) break;
        const int c0 = (bit % pop.ns) * pop.sb;  // the sub-block's first column
        const int j0 = c0 / KS, j1 = (c0 + pop.sb - 1) / KS;
        m |= ((2u << j1) - 1u) & ~((1u << j0) - 1u);
      }
    }
    m = __reduce_or_sync(FULL, m);
  }
  if (lane == 0) out[warp] = make_int4(m != 0u ? st.x : -1, st.y, st.z, (int)m);
}

template <int MODE>
static int launch_heads(int H, const void* tiles, long n_tiles, int n_seg, int n_wh, int n_sm,
                        const FArgs& args, cudaStream_t stream) {
  if (args.pop.bits != nullptr)  // K12: one head
    return H == 1 ? launch<MODE, 1, true, 0>(tiles, n_tiles, n_seg, n_wh, n_sm, args, stream)
                  : (int)cudaErrorInvalidValue;
  switch (H) {
    case 1: return launch<MODE, 1, false, 0>(tiles, n_tiles, n_seg, n_wh, n_sm, args, stream);
    case 2: return launch<MODE, 2, false, 0>(tiles, n_tiles, n_seg, n_wh, n_sm, args, stream);
    case 4: return launch<MODE, 4, false, 0>(tiles, n_tiles, n_seg, n_wh, n_sm, args, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sgfr

// K3 (a tile-only live schedule, K = 0), K6 (a fused plan's live
// schedule) and K12 (K3's live steps with their slab masks, the bitmap
// ``pop`` of sub-blocks of sb, H = 1) on the ring kernel: int8 (mode 2) or
// bf16 (mode 0) tiles, tb % 64 == 0 and tb <= 256, F = 64, H in {1, 2, 4},
// K % 64 == 0; ``var`` the kernel's variant (VAR: 1 fast_exp, 2 noscore
// chunks; no K12 variant). Wh is bf16 [n_wh, H * 64], s2p f32 [n_ct * tb,
// H]. Returns
// 0, a cudaError_t, or 10000 + a CUresult of the tensor-map encoder.
extern "C" int sg_flash_gat_ring(const void* tiles, int tile_mode, int tb, long n_tiles, int n_seg,
                                 const int* seg_rb, const int* seg_lo, const int* seg_hi,
                                 const int* seg_part, int n_fin, const int* fin_rb,
                                 const int* fin_p0, const int* fin_np, const int* step,
                                 const int* lrow, const int* slot_col, int K, const float* s1,
                                 int n_s1, const float* s2p, const void* Wh, int n_wh, int H,
                                 float alpha, float* out, int n_rows, float* m_out, float* l_out,
                                 float* pm, float* pl, float* pacc, const int* pop, int sb, int var,
                                 int n_sm, void* stream_ptr) {
  using namespace sgfr;
  if (tb % 64 || tb > 256 || tb < 64 || K % 64 || (K > 0 && (lrow == nullptr || slot_col == nullptr)))
    return (int)cudaErrorInvalidValue;
  // K12 runs one head, every row of a tile in one work item, no chunk
  if (pop != nullptr && (sb < 1 || tb % sb || H != 1 || K != 0 || var != 0)) return (int)cudaErrorInvalidValue;
  if (var < 0 || var > 2) return (int)cudaErrorInvalidValue;
  const int ns = pop != nullptr ? tb / sb : 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  FArgs args{tb, 0, 0, 0, K,
             seg_rb, seg_lo, seg_hi, seg_part,
             reinterpret_cast<const int4*>(step), lrow, slot_col,
             s1, n_s1, s2p, static_cast<const __nv_bfloat16*>(Wh), alpha,
             out, n_rows, m_out, l_out, pm, pl, pacc, {pop, sb, ns, (ns * ns + 31) / 32}};
  int err;
  if (var == 1) {
    err = launch_fast(tile_mode, H, tiles, n_tiles, n_seg, n_wh, n_sm, args, stream);
  } else if (var == 2) {
    err = launch_noscore(tile_mode, H, tiles, n_tiles, n_seg, n_wh, n_sm, args, stream);
  } else {
    switch (tile_mode) {
      case TILE_I8: err = launch_heads<TILE_I8>(H, tiles, n_tiles, n_seg, n_wh, n_sm, args, stream); break;
      case TILE_BF16: err = launch_heads<TILE_BF16>(H, tiles, n_tiles, n_seg, n_wh, n_sm, args, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (err != 0 || n_fin == 0) return err;
  const long threads = (long)n_fin * tb * H * 32;
  merge_ring<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      pm, pl, pacc, fin_rb, fin_p0, fin_np, n_fin, tb, H, n_rows, out, m_out, l_out);
  return (int)cudaGetLastError();
}

// K12's slab masks on the card: ``out`` [n_step] int4 from the live steps
// ``step`` of a tile-only schedule and the bitmap ``pop`` [T, ceil((tb/sb)^2
// / 32)] of sub-blocks of sb. Returns the cudaError_t of the launch.
extern "C" int sg_subskip_fold(const int* step, int n_step, const int* pop, int tb, int sb, int* out,
                               void* stream_ptr) {
  using namespace sgfr;
  if (sb < 1 || tb % sb || tb > 256) return (int)cudaErrorInvalidValue;
  if (n_step == 0) return 0;
  const int ns = tb / sb;
  const long threads = (long)n_step * 32;
  subskip_fold<<<(unsigned)((threads + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      reinterpret_cast<const int4*>(step), n_step, sgsub::Pop{pop, sb, ns, (ns * ns + 31) / 32},
      reinterpret_cast<int4*>(out));
  return (int)cudaGetLastError();
}
