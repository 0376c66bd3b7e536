// Row-loop tile SpMM on Hopper, cluster design: K1's product, out = A @ H
// over the live tb x tb tiles, every output row block written once by one
// thread-block cluster, with no partial buffer and no second kernel.
//
// Replaces sgracex1_tpu/ops/bsr.py:bsr_spmm_rowloop (Pallas kernel
// _bsr_rowloop_kernel), as bsr_spmm_rowloop.cu does, for int8 and bf16
// tiles of height 64..256 and P % 8 == 0 (ops/bsr.ring_shape_ok); f32 and
// 1-bit packed tiles and the other shapes stay on bsr_spmm_rowloop.cu.
//
// The TPU kernel walks each output row block's tiles in one grid step and
// writes the block once. One CTA per row block cannot do that here: on the
// degree-ordered power-law slice one row block holds about half of the live
// tiles, and a single SM would carry them alone. So the host
// (ops/bsr.cluster_schedule) makes a list of cluster items over the live
// tiles only: a heavy row block (more live tiles than an SM's fair share)
// is one item whose tile range is cut into C contiguous pieces, one per CTA
// of the cluster, or, when even that leaves a CTA more than its share, two
// items of half the tile height each (H is then read twice); light row
// blocks (an empty one included: it is written with zeros) are packed C to
// an item, one per CTA. The host hands each cluster its own list of items,
// longest first (greedy by an estimated cost, so the hub's clusters get
// fewer light items). Each CTA runs K1's ring pipeline (tile_ring.cuh: H
// staged once in bf16, a producer warp feeding a TMA / mbarrier ring of
// four 64-deep slabs to eight mma.sync consumer warps, f32 sums in
// registers), persistent over its cluster's items; on a half-height item
// four consumer warps, one per SM sub-partition, own 64 x 64 blocks and
// the other four wait. A light CTA stores its block from registers. In a
// heavy item every CTA writes its f32 partial [rows x 128] into its own
// shared memory (the drained ring), the cluster meets at a barrier, and
// rank r sums its share of the rows over ranks 0 .. C-1 in rank order
// through distributed shared memory, then stores them once; a second
// cluster barrier ends the item before any CTA refills its ring. The result
// does not depend on scheduling, and there are no atomics.
//
// Bound on the H100: bytes, as K1 (tiles, one bf16 H block a tile, the f32
// output); the heavy row block's tile products are spread over C SMs.
#include "tile_ring.cuh"

namespace sgr {
namespace cluster {

enum ItemKind { LIGHT = 0, HEAVY = 1, UPPER = 2, LOWER = 3 };  // UPPER / LOWER: half the tile height

struct ClusterArgs {
  int tb, n_fs;
  const int* cl_start;    // [n_clusters + 1]: each cluster's items
  const int* item_rb;     // [n_items * C]: the row block of each rank, -1 for none
  const int* item_lo;     // [n_items * C]: each rank's range of live steps
  const int* item_hi;
  const int* item_kind;   // [n_items]: ItemKind; all but LIGHT: the ranks share one row block
  const int4* step;       // live steps (tile, cb, -1, 0), row blocks contiguous
  const __nv_bfloat16* Hs;
  int P;
  float* out;
  int n_rows;
};

constexpr int PART_PITCH = BN + 4;  // f32 a partial row: 528 bytes, off the bank of the row above

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t n_clusters() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster: writes before it are seen by
// reads after it anywhere in the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float4 ld_cluster(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

template <int MODE, int C>
__global__ void __launch_bounds__(NTHREADS, 1)
    rowloop_cluster_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_half,
                           const __grid_constant__ CUtensorMap map_b, const ClusterArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * ATile<MODE>::STAGE);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + STAGES);
  constexpr int A_BYTES = ATile<MODE>::BYTES;
  static_assert(RM * PART_PITCH * 4 <= STAGES * ATile<MODE>::STAGE, "the partial must fit the ring");
  const int tb = p.tb;
  const int rank = (int)cluster_rank();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  const int cid = (int)cluster_id();
  const int it0 = p.cl_start[cid], it1 = p.cl_start[cid + 1];

  if (warp >= CONSUMER_WARPS) {
    // ------------------------------------------------------------ producer
    // The whole warpgroup stays: every thread of the cluster must reach the
    // cluster barriers of a heavy item. One warp issues the copies; after a
    // heavy item's last slab it waits at the barriers, so no copy lands in
    // the ring while the partials live there.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    for (int it = it0; it < it1; ++it) {
      const int kind = p.item_kind[it];
      const bool half = kind >= UPPER;
      const int r0 = kind == LOWER ? tb / 2 : 0;
      const uint32_t a_tx = (uint32_t)(half ? tb / 2 : tb) * ATile<MODE>::PITCH;
      const int slot = it * C + rank;
      for (int fs = 0; fs < p.n_fs; ++fs) {
        if (warp == CONSUMER_WARPS) {
          const int lo = p.item_lo[slot], hi = p.item_hi[slot];
          for (int g = lo; g < hi; ++g) {
            const int4 st = p.step[g];
            for (int k0 = 0; k0 < tb; k0 += KS) {
              mbar_wait(empty0 + 8 * stage, phase ^ 1);
              if (lane == 0) {
                const uint32_t a_dst = smem_u32(smem + stage * ATile<MODE>::STAGE);
                const uint32_t bar = full0 + 8 * stage;
                mbar_expect_tx(bar, a_tx + B_BYTES);
                tma_load_2d(a_dst, half ? &map_half : &map_a, bar, k0, st.x * tb + r0);
                tma_load_2d(a_dst + A_BYTES, &map_b, bar, fs * BN, st.y * tb + k0);
              }
              advance();
            }
          }
          __syncwarp();
        }
        if (kind != LIGHT) {
          cluster_sync();  // the partials are written
          cluster_sync();  // and summed
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const float one[4] = {1.f, 1.f, 1.f, 1.f};
    float acc[4][8][4];
    float* part = reinterpret_cast<float*>(smem);
    for (int it = it0; it < it1; ++it) {
      const int kind = p.item_kind[it];
      const bool half = kind >= UPPER;
      const int rows = half ? tb / 2 : tb, r0 = kind == LOWER ? tb / 2 : 0;
      // half the height: warps 0-3 (one per SM sub-partition) own 2 x 2
      // blocks of 64 x 64; the whole height: 4 along rows x 2 along features
      const Lane L = half ? make_lane<MODE>(warp >> 1, warp & 1) : make_lane<MODE>(warp & 3, warp >> 2);
      const bool active = (!half || warp < 4) && L.wm * 64 < rows;
      const int slot = it * C + rank;
      const int rb = p.item_rb[slot], lo = p.item_lo[slot], hi = p.item_hi[slot];
      for (int fs = 0; fs < p.n_fs; ++fs) {
        const int p0 = fs * BN;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int nj = 0; nj < 8; ++nj)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
        for (int g = lo; g < hi; ++g) {
          for (int k0 = 0; k0 < tb; k0 += KS) {
            uint8_t* a_ptr = smem + stage * ATile<MODE>::STAGE;
            mbar_wait(full0 + 8 * stage, phase);
            if (active) tile_slab<MODE>(acc, L, smem_u32(a_ptr), a_ptr, smem_u32(a_ptr + A_BYTES));
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * stage);
            advance();
          }
        }
        if (kind == LIGHT) {
          if (active && rb >= 0)
            store_acc<float>(acc, L, rb, tb, p0, p.P, p.n_rows, one, p.out, nullptr, -1);
          continue;
        }
        // every consumer warp is done with the ring before it holds partials
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        if (active) {
          const bool odd = (L.t & 1) != 0;
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            const int lr = L.wm * 64 + mi * 16 + L.g + (odd ? 8 : 0);
#pragma unroll
            for (int nj = 0; nj < 8; ++nj) {
              float(&c)[4] = acc[mi][nj];
              // a lane pair exchanges halves: four consecutive features of one row
              const float s0 = odd ? c[0] : c[2], s1 = odd ? c[1] : c[3];
              const float x0 = __shfl_xor_sync(FULL, s0, 1), x1 = __shfl_xor_sync(FULL, s1, 1);
              const float4 v = odd ? make_float4(x0, x1, c[2], c[3]) : make_float4(c[0], c[1], x0, x1);
              *reinterpret_cast<float4*>(part + lr * PART_PITCH + L.wn * 64 + nj * 8 + 4 * (L.t >> 1)) = v;
            }
          }
        }
        __syncwarp();
        cluster_sync();
        // this rank's rows of the item, summed over the ranks in rank order
        const int per = (rows + C - 1) / C;
        const int q0 = rank * per, q1 = min(rows, q0 + per);
        const int n4 = (q1 - q0) * (BN / 4);
        for (int idx = threadIdx.x; idx < n4; idx += 32 * CONSUMER_WARPS) {
          const int lr = q0 + idx / (BN / 4);
          const int c4 = (idx % (BN / 4)) * 4;
          const long grow = (long)rb * tb + r0 + lr;
          if (p0 + c4 >= p.P || grow >= p.n_rows) continue;
          const uint32_t local = smem_u32(part + lr * PART_PITCH + c4);
          float4 v[C];
#pragma unroll
          for (int q = 0; q < C; ++q) v[q] = ld_cluster(local, (uint32_t)q);
          float4 sum = v[0];
#pragma unroll
          for (int q = 1; q < C; ++q) {
            sum.x += v[q].x; sum.y += v[q].y; sum.z += v[q].z; sum.w += v[q].w;
          }
          *reinterpret_cast<float4*>(p.out + grow * p.P + p0 + c4) = sum;
        }
        // the copy engine refills this memory after the second barrier
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        cluster_sync();
      }
    }
  }
}

template <int MODE, int C>
static cudaError_t prepare(int* smem) {
  auto kernel = rowloop_cluster_kernel<MODE, C>;
  *smem = ATile<MODE>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

template <int MODE, int C>
static cudaLaunchConfig_t config(int n_cl, int smem, cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_cl * C, 1, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of C CTAs of this kernel the card holds at once (0 when
// none fits), or -(cudaError_t).
template <int MODE, int C>
static int occupancy(cudaStream_t stream) {
  int smem = 0, n = 0;
  cudaError_t e = prepare<MODE, C>(&smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<MODE, C>(1, smem, attr, stream);
  e = cudaOccupancyMaxActiveClusters(&n, rowloop_cluster_kernel<MODE, C>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

template <int MODE, int C>
static int launch(const void* tiles, long n_tiles, int n_cl, ClusterArgs a, int hs_rows,
                  cudaStream_t stream) {
  CUtensorMap map_a, map_half, map_b;
  const int tb = a.tb;
  int err = 0;
  for (int h = 0; h < 2 && !err; ++h)  // boxes of the whole and of half the tile height
    err = MODE == TILE_I8
              ? encode_2d(h ? &map_half : &map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, tiles,
                          (uint64_t)n_tiles * tb, tb, h ? tb / 2 : tb, KS)
              : encode_2d(h ? &map_half : &map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, tiles,
                          (uint64_t)n_tiles * tb, tb, h ? tb / 2 : tb, A_BOX_BF16);
  if (err) return err;
  err = encode_2d(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.Hs, hs_rows, a.P, KS, B_BOX);
  if (err) return err;
  a.n_fs = (a.P + BN - 1) / BN;
  if (n_cl == 0) return 0;
  int smem = 0;
  cudaError_t e = prepare<MODE, C>(&smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<MODE, C>(n_cl, smem, attr, stream);
  e = cudaLaunchKernelEx(&cfg, rowloop_cluster_kernel<MODE, C>, map_a, map_half, map_b, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace cluster
}  // namespace sgr

// Returns 0, a cudaError_t, or 10000 + the CUresult of the tensor-map
// encoder. Hs is the staged bf16 H (sg_stage_h), [hs_rows, P]; n_cl
// clusters of ``cluster`` CTAs each walk their items cl_start[c] ..
// cl_start[c + 1].
extern "C" int sg_bsr_spmm_cluster(const void* tiles, int tile_mode, int tb, int n_tiles,
                                   int cluster, int n_cl, const int* cl_start, const int* item_rb,
                                   const int* item_lo, const int* item_hi, const int* item_kind,
                                   const void* step, const void* Hs, int hs_rows, int P, float* out,
                                   int n_rows, void* stream_ptr) {
  using namespace sgr;
  using namespace sgr::cluster;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ClusterArgs a{};
  a.tb = tb;
  a.cl_start = cl_start;
  a.item_rb = item_rb; a.item_lo = item_lo; a.item_hi = item_hi; a.item_kind = item_kind;
  a.step = static_cast<const int4*>(step);
  a.Hs = static_cast<const __nv_bfloat16*>(Hs);
  a.P = P; a.out = out; a.n_rows = n_rows;
  if (tb % 64 || tb > RM || P % 8) return (int)cudaErrorInvalidValue;
#define SG_LAUNCH(MODE, C) return launch<MODE, C>(tiles, n_tiles, n_cl, a, hs_rows, stream)
  if (tile_mode == TILE_I8 && cluster == 8) SG_LAUNCH(TILE_I8, 8);
  if (tile_mode == TILE_I8 && cluster == 16) SG_LAUNCH(TILE_I8, 16);
  if (tile_mode == TILE_BF16 && cluster == 8) SG_LAUNCH(TILE_BF16, 8);
  if (tile_mode == TILE_BF16 && cluster == 16) SG_LAUNCH(TILE_BF16, 16);
#undef SG_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The clusters of ``cluster`` CTAs the card holds at once for this tile
// mode (cudaOccupancyMaxActiveClusters at the kernel's shared memory), or
// -(cudaError_t).
extern "C" int sg_bsr_spmm_cluster_occupancy(int tile_mode, int cluster) {
  using namespace sgr;
  if (tile_mode == TILE_I8 && cluster == 8) return cluster::occupancy<TILE_I8, 8>(nullptr);
  if (tile_mode == TILE_I8 && cluster == 16) return cluster::occupancy<TILE_I8, 16>(nullptr);
  if (tile_mode == TILE_BF16 && cluster == 8) return cluster::occupancy<TILE_BF16, 8>(nullptr);
  if (tile_mode == TILE_BF16 && cluster == 16) return cluster::occupancy<TILE_BF16, 16>(nullptr);
  return -(int)cudaErrorInvalidValue;
}
