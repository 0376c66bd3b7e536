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
// order. No atomics. The kernel is a template in flash_gat_bwd_ring.cuh;
// its FAST instantiations take Schraudolph's exp (fast_ex2 of
// tile_ring.cuh) for p, the TPU passes' fast_exp option, and are built in a
// source of their own (flash_gat_bwd_ring_fast.cu), compiled beside this
// one, so the kernels of the main path keep their code: a runtime flag
// tested for every entry measured up to 1.9x on K4 at H=4 on the card.
#include "flash_gat_bwd_ring.cuh"

namespace sgfb {

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

}  // namespace sgfb

// K4 (col = 0) on B's live schedule, or K5 (col = 1) on the live schedule
// of the transposed live tile set: int8 (mode 2) or bf16 (mode 0) tiles,
// tb % 64 == 0 and tb <= 256, F = 64, H in {1, 2, 4}. ``op`` is the streamed
// bf16 operand [n_op, H * 64] (K4 Wh, K5 gO), ``res`` the own rows' one (K4
// gO, K5 Wh), both padded to the tile grid; ``slab_stat`` K4's s2
// [n_ct*tb, H] or K5's [n_rt*tb, 4, H]; s_own/m_own/l_own K4's s1, m, l
// (K5: s2, null, null). K4 writes out [n_rt*tb, 3H] (t | u1 | u2); K5 out
// (dWh) [n_ct*tb, H*64] and out2 (ds2) [n_ct*tb, H]. fast_exp != 0 runs
// the fast_exp variant. Returns 0, a
// cudaError_t, or 10000 + a CUresult of the tensor-map encoder.
extern "C" int sg_flash_gat_bwd_ring(int col, const void* tiles, int tile_mode, int tb, long n_tiles, int n_seg,
                                     const int* seg_rb, const int* seg_lo, const int* seg_hi,
                                     const int* seg_part, int n_fin, const int* fin_rb, const int* fin_p0,
                                     const int* fin_np, const int* step, const float* slab_stat, const void* op,
                                     long n_op, const void* res, const float* s_own, const float* m_own,
                                     const float* l_own, int H, float alpha, int fast_exp, float* out, float* out2,
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
  if (fast_exp)
    err = launch_fast(col, tile_mode, H, tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream);
  else if (tile_mode == TILE_I8)
    err = col ? launch_heads<TILE_I8, true, false>(H, tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream)
              : launch_heads<TILE_I8, false, false>(H, tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream);
  else if (tile_mode == TILE_BF16)
    err = col ? launch_heads<TILE_BF16, true, false>(H, tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream)
              : launch_heads<TILE_BF16, false, false>(H, tiles, n_tiles, n_seg, op, n_op, n_sm, a, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0 || n_fin == 0) return err;
  if (!col) return sum_runs(part, fin_rb, fin_p0, fin_np, n_fin, tb, 3 * H, out, stream);
  err = sum_runs(part, fin_rb, fin_p0, fin_np, n_fin, tb, H * 64, out, stream);
  if (err != 0) return err;
  return sum_runs(part2, fin_rb, fin_p0, fin_np, n_fin, tb, H, out2, stream);
}
