// The sub-block population bitmap of K12 (sgracex1_tpu/ops/flash_gat.py:
// flash_gat_forward_subskip): pop[t] is nw int32 words of tile t, and bit
// i * ns + j is set when the sb x sb sub-block (i, j) of the tile is
// populated (ns = tb / sb; any sb that divides tb). A sub-block whose bit is
// 0 is never seen, whatever its mask holds. Both K12 kernels (flash_gat.cu,
// flash_gat_ring.cu) read it through these helpers.
#pragma once

#include <stdint.h>

namespace sgsub {

struct Pop {
  const int* bits;  // [T, nw]
  int sb, ns, nw;
};

// The 32 bits of a tile's row of words ``row`` from bit b on.
__device__ __forceinline__ uint32_t bits_at(const int* row, int nw, int b) {
  const int w = b >> 5;
  const uint32_t lo = (uint32_t)__ldg(row + w);
  const uint32_t hi = w + 1 < nw ? (uint32_t)__ldg(row + w + 1) : 0u;
  return __funnelshift_r(lo, hi, b & 31);
}

// expand's general case, a column at a time: out of line, so the hot loops
// of the kernels hold none of its divisions.
static __device__ __noinline__ uint32_t expand_any(uint32_t bits, int c0, int sb, int w) {
  const int cs0 = c0 / sb;
  uint32_t k = 0;
  for (int c = 0; c < w; ++c) k |= ((bits >> ((c0 + c) / sb - cs0)) & 1u) << c;
  return k;
}

// Keep flags of the W columns c0 .. c0 + W - 1 (W <= 16) of one row: bit c
// is set when the sub-block of column c0 + c is populated, given ``bits``
// whose bit i is the sub-block column c0 / sb + i, and ``span``, the
// sub-block columns the window meets less one.
template <int W>
__device__ __forceinline__ uint32_t expand(uint32_t bits, int c0, int sb, int span) {
  constexpr uint32_t ALL = (1u << W) - 1u;
  if (span == 0) return (bits & 1u) ? ALL : 0u;  // one sub-block holds the window
  if (sb == 1) return bits & ALL;
  if ((sb & (sb - 1)) == 0 && c0 % sb == 0) {  // whole sub-blocks of 2, 4 or 8 columns
    const uint32_t one = (1u << sb) - 1u;
    uint32_t k = 0;
    for (int i = 0; i <= span; ++i)
      if ((bits >> i) & 1u) k |= one << (i * sb);
    return k;
  }
  return expand_any(bits, c0, sb, W);
}

// The keep flags of columns c0 .. c0 + W - 1 of row r of tile t.
template <int W>
__device__ __forceinline__ uint32_t keep(const Pop& p, long t, int r, int c0) {
  const int cs0 = c0 / p.sb;
  const uint32_t bits = bits_at(p.bits + t * p.nw, p.nw, (r / p.sb) * p.ns + cs0);
  return expand<W>(bits, c0, p.sb, (c0 + W - 1) / p.sb - cs0);
}

// Whether tile t has a populated sub-block in tile rows r0 .. r1 - 1: their
// sub-block rows are the consecutive bits [b0, b1) of the tile's words. The
// caller's threads split the words (this thread: word i of every n) and
// combine the answers.
__device__ __forceinline__ bool any_row(const Pop& p, long t, int r0, int r1, int i, int n) {
  const long b0 = (long)(r0 / p.sb) * p.ns, b1 = (long)((r1 - 1) / p.sb + 1) * p.ns;
  const int* row = p.bits + t * p.nw;
  bool any = false;
  for (long w = (b0 >> 5) + i; w <= ((b1 - 1) >> 5); w += n) {
    uint32_t x = (uint32_t)__ldg(row + w);
    if (w == (b0 >> 5)) x &= ~0u << (b0 & 31);
    if (w == ((b1 - 1) >> 5) && (b1 & 31)) x &= ~0u >> (32 - (b1 & 31));
    any |= x != 0u;
  }
  return any;
}

}  // namespace sgsub
