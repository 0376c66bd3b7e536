// Full-integer fused aggregation on Hopper: shifted-int8 dense tiles plus
// value-carrying remainder chunks in one schedule, out = Aq @ Hq exact in
// int32.
//
// Replaces sgracex1_tpu/ops/fused_agg.py:bsr_spmm_int8_fused (Pallas kernel
// _fused_int8_kernel). The TPU version walks the whole schedule on one
// core, keeps an int32 and an f32 accumulator resident across a row
// block's run and runs each chunk as a value-carrying one-hot product.
// Here the host cuts every run into segments (ops/bsr.RunSegments); a CTA
// owns one (segment, 128-row group, 128-feature slice). Its tile steps
// run on the int8 tensor cores with the shift undone from precomputed
// column sums (tile_gemm_i8.cuh); its chunk steps need no one-hot product
// on this card: each live slot adds v * Hq[slot_col] into a 128 x 128
// int32 block in shared memory with integer atomics, whose sum does not
// depend on the order. A kind-0 step's chunk id is never read and a kind-1
// step's tile is not multiplied. Split runs leave int32 partials that a
// second kernel sums in a fixed order, so the result is the same run to
// run and equals the TPU kernel wherever that one is exact.
//
// Bound on the H100 by bytes: tiles read once per feature slice, Hq
// blocks once per tile and row group, one Hq row per remainder edge, the
// int32 output written once. The 64 KiB accumulator block limits a SM to
// two CTAs. A first, simple kernel: no TMA, no wgmma, one stage.
#include "tile_gemm_i8.cuh"

// Returns the cudaError_t of the launches (0 on success). ``out`` is
// [n_out, P] with n_out = n_rows.
extern "C" int sg_fused_agg_int8(const void* tiles, int tb, int n_seg, const int* seg_rb,
                                 const int* seg_lo, const int* seg_hi, const int* seg_part,
                                 int n_fin, const int* fin_rb, const int* fin_p0,
                                 const int* fin_np, const int* step_cb, const int* step_tile,
                                 const int* step_chunk, const int* step_kind, const int* lrow,
                                 const int* slot_col, const float* slot_val, int K,
                                 const void* Hq, int n_h, int n_ct, int P, int vec, int vec4,
                                 int* colsum, int* out, int* partial, int n_out,
                                 void* stream_ptr) {
  return sg8::launch_agg_int8<true>(
      static_cast<const int8_t*>(tiles), tb, n_seg, seg_rb, seg_lo, seg_hi, seg_part, n_fin,
      fin_rb, fin_p0, fin_np, step_cb, step_tile, step_chunk, step_kind, lrow, slot_col,
      slot_val, K, static_cast<const int8_t*>(Hq), n_h, n_ct, P, vec, vec4, colsum, out, partial,
      (long)n_out, static_cast<cudaStream_t>(stream_ptr));
}
