// Grouped (ragged) expert GEMM for Hopper (sm_90a) and both of its
// gradients, bf16 in, fp32 accumulators, bf16 out.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/grouped_gemm.py:
//
//   `_gmm_kernel` (pallas_call in `_gmm_fwd_kernel_call`), the forward
//       out[start_e:end_e] = lhs[start_e:end_e] @ rhs[e],   e = 0 .. E-1;
//   `_gmm_dlhs_kernel` (pallas_call in `_gmm_dlhs_kernel_call`)
//       dlhs[start_e:end_e] = dout[start_e:end_e] @ rhs[e]^T;
//   `_gmm_drhs_kernel` (pallas_call in `_gmm_drhs_kernel_call`), the "tgmm"
//       drhs[e] = lhs[start_e:end_e]^T @ dout[start_e:end_e],
//
// where start/end are the running offsets of group_sizes [E] (int32, on the
// device: token routing decides them).  Rows of out and dlhs past
// sum(group_sizes) are zeros; an empty group's drhs is zeros.  Every output
// element is written exactly once, by one block, without atomics, so the
// wrappers allocate with torch.empty and two runs give the same bits.
//
// Work units (the forward and dlhs), as the TPU kernel enumerates them
// (`make_group_metadata`): the list is static, W = ceil(M / BM) + E - 1
// units, so nothing is read back to the host.  A block derives its unit
// from group_sizes itself (`find_unit`, an O(E) scan, E = 8 for Mixtral):
// unit w is the (group, m-tile) pair of rank w among the m-tiles each
// non-empty group touches, in group order.  A boundary m-tile shared by
// two groups is visited once per group, and each visit writes only its
// group's rows, so every output row is written by exactly one unit: a row
// of group e by e's unit; the rows of the last touched tile past
// sum(group_sizes) by the last valid unit (as zeros); each m-tile wholly
// past the sum by one of the units left over (there are at least as many
// spare units as such tiles), as zeros.  Rows past M are loaded as zeros
// and never written, so any M works (the TPU path sends an M that is not a
// multiple of its tile to the dense reference; that is a TPU rule).
//
// One kernel, `gmm_wgmma_kernel<KIND>`, serves the forward, dlhs and drhs
// at every M: where the tensor cores bound it (training, M = 8192 routed
// rows: a 4096 x 14336 expert product is 0.96 TFLOP, 0.97 ms at 989
// TFLOP/s) and where the expert weights do (prefill, M = 1024: 7 experts'
// 0.82 GB, 0.25 ms at 3.35 TB/s; a decode step, M = 16: a Mixtral-8x7B
// gate projection reads up to 0.94 GB for 16 rows, each of E units
// streaming its group's weights once).  It is built for Hopper rather
// than carried over from the TPU's grid:
//
// * one block a 128 x 256 output tile, in the order of a static tile list
//   that every block derives from group_sizes on the device; the hardware
//   hands the next tile to the first SM that frees, which kept the tiles in
//   flight together and balanced better than persistent blocks walking
//   the list (timed: tools/gmm_variants.py, PERF.md);
// * a block is a producer warpgroup, whose first thread keeps a ring of 4
//   k-steps (64 deep: 128 x 64 of A and 256 x 64 of B, bf16, 128-byte
//   swizzled) in flight through TMA and full / empty mbarriers, and two
//   consumer warpgroups of 64 output rows each, which multiply by wgmma
//   m64n256k16 from shared memory into 128 fp32 accumulators a thread
//   (`setmaxnreg` gives them the producer's registers);
// * the epilogue rounds to bf16 once, stages each warpgroup's 64 x 256
//   rows in shared memory of its own, half the columns at a time (a
//   4-stage ring leaves room for no more), and sends them out by TMA
//   store.
//
// The forward and dlhs walk the unit list (128-row units): their tiles
// are (unit, n-tile) pairs, ordered in bands of units; within a band the
// n-tile changes slowest, so the blocks in flight cover the band's units
// by a few n-tiles, the units of one group at one n-tile run side by side,
// and they share the units' rows and each group's weight slice through
// the 50 MB L2.  A warpgroup's 64 rows go out by TMA store when every one
// of them (below M) is its unit's, as product or as zeros; rows a boundary
// tile shares with another unit (the next group's rows, multiplied with
// this group's weights because TMA zero-fills only past M) go out from
// registers, masked by row.  Boundary tiles multiply rows that are not
// their own: ~10% of the MACs at M = 8192; at M = 1024 (7 groups of ~146
// rows) the units multiply ~1.75x the routed rows.  64-row units halve
// that waste but load each weight tile from L2 for half as many rows, and
// timed slower at every M (PERF.md).  The forward's bands are 8 units,
// dlhs's 16 (timed: tools/gmm_variants.py, PERF.md).
//
// The forward is A = lhs [M, K], K-major (a [BM rows x 64 of K] box), by
// B = rhs[g] [K, N] with N contiguous: MN-major [64 of K x 64 of N] boxes
// of the rank-3 map of rhs, read with wgmma's transpose-B; nothing is
// transposed in memory.  dlhs is the plain "TN" product: A = dout [M,
// N_fwd] and B = rhs[g] [K_fwd, N_fwd] both hold the reduction dim
// contiguous (K-major, wgmma reads them without transposes).
//
// drhs reduces over the group's rows, so both operands are MN-major: A =
// lhs[rows_g]^T (a [64 rows x 64 of K] TMA box, K contiguous; wgmma's
// transpose-A) and B = dout[rows_g] ([64 rows x 64 of N] boxes; transpose-
// B).  Its tiles are (group, 128-row K-tile, kBN-column N-tile), each
// walking the group's rows [start, end) in 64-row chunks from `start`
// (a 2-D TMA box starts at any row, so only the last chunk is partial);
// the last chunk's rows past `end` belong to the next group (TMA
// zero-fills only past M), so each consumer warpgroup zeroes those rows of
// its own A block in shared memory (then fence.proxy.async) before the
// product, as the TPU kernel masks lhs.  Tiles are listed largest group
// first (the order is computed on the device), so under skewed routing the
// long group's tiles start first instead of setting the tail, and the
// blocks in flight share one group's operands (~37 MB at Mixtral widths)
// through L2; within a group the tile of the shorter of K and N changes
// fastest.  An empty group's tiles write zeros; with M = 0
// every group is empty and no map over lhs or dout is made.
//
// Shapes (the wrappers check them): lhs bf16 [M, K], rhs bf16 [E, K, N]
// (N contiguous, the Flax layout), dout bf16 [M, N], group_sizes int32 [E],
// all contiguous and 16-byte aligned; K % 8 == 0 and N % 8 == 0 (16-byte
// vectors and TMA row strides; the edges in K and N are masked).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

#include "hopper.cuh"

namespace {

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// What one work unit does: its group and m-tile, the rows it writes with
// the product [lo, hi), and the rows it writes as zeros [zlo, zhi).
struct Unit {
  int group, m_tile, lo, hi, zlo, zhi;
};

template <int BM>
__device__ __forceinline__ Unit find_unit(const int* __restrict__ group_sizes,
                                          int e_count, int m, int w) {
  Unit u{-1, 0, 0, 0, 0, 0};
  int start = 0, work = 0;
  for (int e = 0; e < e_count; ++e) {
    const int end = min(start + max(group_sizes[e], 0), m);
    if (end > start) {
      const int first = start / BM;
      const int tiles = (end - 1) / BM - first + 1;
      if (u.group < 0 && w < work + tiles) {
        u.group = e;
        u.m_tile = first + (w - work);
        u.lo = start;
        u.hi = end;
      }
      work += tiles;
    }
    start = end;
  }
  const int total = start;                       // rows that belong to a group
  if (u.group >= 0) {
    if (w == work - 1) {                         // the last valid unit
      u.zlo = total;
      u.zhi = min(m, (u.m_tile + 1) * BM);
    }
  } else {
    // spare unit w - work zeros the m-tile of that rank past the sum
    u.m_tile = (total + BM - 1) / BM + (w - work);
    u.zlo = u.m_tile * BM;
    u.zhi = min(m, u.zlo + BM);
  }
  return u;
}

// ----------------------------------------------------------------------------
// The forward, dlhs and drhs on wgmma, fed by TMA
// ----------------------------------------------------------------------------
constexpr int kDlhs = 0, kDrhs = 1, kFwd = 2;
constexpr int kGradBM = 128;           // output rows of a tile: two warpgroups of 64
constexpr int kGradBK = 64;            // depth of a k-step (one 128-byte swizzle row)

// The launch shapes by kind (timed on the card, tools/gmm_variants.py;
// one block an SM: at two, ptxas caps a thread of these 384-thread blocks
// at 80 registers, too few for a wgmma m64n128).  kBN: output columns a
// tile; kStages: ring stages; kPersistent (0: one block a tile); kBand
// (forward and dlhs): units a band of the tile order; kByWork (drhs):
// groups largest first, else in index order; kNFast (drhs, within a
// group): 0 the K-tile changes fastest, 1 the N-tile, 2 that of the
// shorter of K and N, so that the tiles in flight cover the short
// dimension whole and a few tiles of the long one, the least of lhs and
// dout.
template <int KIND>
struct GmmTiles;
template <>
struct GmmTiles<kDlhs> {
  static constexpr int kBN = 256, kStages = 4, kPersistent = 0, kBand = 16;
};
template <>
struct GmmTiles<kDrhs> {
  static constexpr int kBN = 256, kStages = 4, kPersistent = 0, kByWork = 1, kNFast = 2;
};
template <>
struct GmmTiles<kFwd> {
  static constexpr int kBN = 256, kStages = 4, kPersistent = 0, kBand = 8;
};

template <int KIND>
struct GmmSmem {
  using T = GmmTiles<KIND>;
  static constexpr int kA = kGradBM * kGradBK * 2;      // [128 x 64] (drhs: 2 blocks of 64 x 64)
  static constexpr int kB = T::kBN * kGradBK * 2;       // [kBN x 64] (drhs, forward: kBN / 64 of 64 x 64)
  static constexpr int kStage = kA + kB;
  static constexpr int kOut = T::kStages * kStage;      // staging: [2][kBN / 128][64][128 B]
  static constexpr int kBars = kOut + 2 * 64 * T::kBN;  // full[kStages], empty[kStages]
  static constexpr int kTables = kBars + 2 * T::kStages * 8;   // drhs: order, start, end [E]
  static constexpr int kBytes = kTables + 1024;         // + alignment (and 12 E bytes, drhs)
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;   // of 168 at launch
};

struct GmmArgs {
  const int* group_sizes;
  __nv_bfloat16* out;            // forward [M, N], dlhs [M, K] or drhs [E, K, N]
  int m, k, n, e_count;          // the forward's M, K, N and E
  int tiles;
};

// One output tile.  Forward and dlhs: the unit's group (-1: a spare unit)
// and m-tile rows from row0, the rows written with the product [lo, hi)
// and as zeros [zlo, zhi).  drhs: the group, its rows [row0, hi), the
// K-tile from k0.  All: the n-tile from col0 and the k-steps of 64.
struct GmmTile {
  int group, row0, col0, k0, steps, lo, hi, zlo, zhi;
};

__device__ __forceinline__ int overlap(int a0, int a1, int b0, int b1) {
  return max(0, min(a1, b1) - max(a0, b0));
}

// d[N/2] (+)= A[64 x 16] B[16 x N] from shared memory, N = 128 / 256
template <int N, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (N == 256) wgmma_ss_bf16_256t<kTransA, kTransB>(d, da, db, scale_d);
  else wgmma_ss_bf16_128t<kTransA, kTransB>(d, da, db, scale_d);
}

template <int KIND>
__device__ __forceinline__ GmmTile gmm_tile(const GmmArgs& p, const int* order,
                                            const int* starts, const int* ends, int t) {
  using T = GmmTiles<KIND>;
  GmmTile tl{};
  if constexpr (KIND != kDrhs) {
    // dlhs writes [M, K] and sums over N, the forward [M, N] over K
    const int cols = KIND == kDlhs ? p.k : p.n, depth = KIND == kDlhs ? p.n : p.k;
    const int nt = cdiv(cols, T::kBN);
    const int units = cdiv(p.m, kGradBM) + p.e_count - 1;
    const int band = t / (T::kBand * nt);
    const int in = t - band * T::kBand * nt;
    const int width = min(T::kBand, units - band * T::kBand);
    const Unit u = find_unit<kGradBM>(p.group_sizes, p.e_count, p.m,
                                      band * T::kBand + in % width);
    tl.group = u.group;
    tl.row0 = u.m_tile * kGradBM;
    tl.col0 = (in / width) * T::kBN;
    tl.steps = u.group >= 0 ? cdiv(depth, kGradBK) : 0;
    tl.lo = u.lo;
    tl.hi = u.hi;
    tl.zlo = u.zlo;
    tl.zhi = u.zhi;
  } else {
    const int kt = cdiv(p.k, kGradBM), nt = cdiv(p.n, T::kBN);
    const int e = order[t / (kt * nt)], r = t % (kt * nt);
    const bool n_fast = T::kNFast == 1 || (T::kNFast == 2 && p.n < p.k);
    tl.group = e;
    tl.k0 = (n_fast ? r / nt : r % kt) * kGradBM;
    tl.col0 = (n_fast ? r % nt : r / kt) * T::kBN;
    tl.row0 = starts[e];
    tl.hi = ends[e];
    tl.steps = cdiv(ends[e] - starts[e], kGradBK);
  }
  return tl;
}

// drhs: each group's rows [start, end), clamped to M as the plain version
// clamps them, and the groups in the order their tiles are handed out
__device__ void group_table(const GmmArgs& p, bool by_work, int* order, int* starts,
                            int* ends) {
  if (threadIdx.x == 0) {
    int start = 0;
    for (int e = 0; e < p.e_count; ++e) {
      starts[e] = start;
      start = min(start + max(p.group_sizes[e], 0), p.m);
      ends[e] = start;                            // the group's end
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < p.e_count; e += blockDim.x) {
    int rank = e;
    if (by_work) {             // the larger group first; of equal ones the lower index
      const int size = ends[e] - starts[e];
      rank = 0;
      for (int f = 0; f < p.e_count; ++f) {
        const int other = ends[f] - starts[f];
        rank += other > size || (other == size && f < e);
      }
    }
    order[rank] = e;
  }
}

template <int KIND>
__global__ void __launch_bounds__(384, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map,
                 const __grid_constant__ CUtensorMap out_map, const GmmArgs p) {
  using T = GmmTiles<KIND>;
  using L = GmmSmem<KIND>;
  constexpr bool kUnits = KIND != kDrhs;          // forward and dlhs: the unit list
  constexpr int BN = T::kBN, NS = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + NS;
  int* order = reinterpret_cast<int*>(sm + L::kTables);
  int* starts = order + p.e_count;
  int* ends = starts + p.e_count;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  if constexpr (KIND == kDrhs) group_table(p, T::kByWork, order, starts, ends);
  __syncthreads();
  const int first = T::kPersistent ? blockIdx.x : 0;
  const int stride = T::kPersistent ? gridDim.x : 1;
  const int last = T::kPersistent ? p.tiles : 1;
  const int base = T::kPersistent ? 0 : blockIdx.x;

  if (threadIdx.x < 128) {
    // the producer: one thread keeps the ring full, across tiles
    setmaxnreg_dec<L::kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int i = first; i < last; i += stride) {
        const GmmTile tl = gmm_tile<KIND>(p, order, starts, ends, base + i);
        for (int s = 0; s < tl.steps; ++s, ++it) {
          const int st = it % NS;
          if (it >= NS) mbar_wait(&empty[st], ((it / NS) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], L::kStage);
          unsigned char* a_s = sm + st * L::kStage;
          unsigned char* b_s = a_s + L::kA;
          if constexpr (KIND == kDlhs) {
            tma_load_2d(a_s, &a_map, &full[st], s * kGradBK, tl.row0);
            tma_load_3d(b_s, &b_map, &full[st], s * kGradBK, tl.col0, tl.group);
          } else if constexpr (KIND == kDrhs) {
            const int r0 = tl.row0 + s * kGradBK;
            for (int c = 0; c < 2; ++c)
              tma_load_2d(a_s + c * 8192, &a_map, &full[st], tl.k0 + 64 * c, r0);
            for (int c = 0; c < BN / 64; ++c)
              tma_load_2d(b_s + c * 8192, &b_map, &full[st], tl.col0 + 64 * c, r0);
          } else {
            tma_load_2d(a_s, &a_map, &full[st], s * kGradBK, tl.row0);
            for (int c = 0; c < BN / 64; ++c)
              tma_load_3d(b_s + c * 8192, &b_map, &full[st], tl.col0 + 64 * c, s * kGradBK,
                          tl.group);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<L::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;         // consumer warpgroup: rows 64 cw ..
    const int ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32, g = lane / 4, t4 = lane % 4;
    constexpr int OC = BN / 2;                    // columns a store pass: the staging's
    unsigned char* staging = sm + L::kOut + cw * 64 * OC * 2;
    float acc[BN / 2];
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) acc[x] = 0.f;
    int it = 0;
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % NS]);
    };
    for (int i = first; i < last; i += stride) {
      const GmmTile tl = gmm_tile<KIND>(p, order, starts, ends, base + i);
      for (int s = 0; s < tl.steps; ++s, ++it) {
        const int st = it % NS;
        mbar_wait(&full[st], (it / NS) & 1);
        const unsigned char* a_s = sm + st * L::kStage;
        const unsigned char* b_s = a_s + L::kA;
        if constexpr (KIND == kDrhs) {
          // the group's last chunk: its rows from `valid` on are the next
          // group's (or past M), zeroed in this warpgroup's block of lhs
          const int valid = tl.hi - (tl.row0 + s * kGradBK);
          if (valid < kGradBK) {
            int4* blk = reinterpret_cast<int4*>(sm + st * L::kStage + cw * 8192);
            for (int x = valid * 8 + ct; x < kGradBK * 8; x += 128) blk[x] = make_int4(0, 0, 0, 0);
            fence_proxy_async();
            named_barrier(1 + cw, 128);
          }
        }
#pragma unroll
        for (int x = 0; x < BN / 2; ++x) fence_reg(acc[x]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kGradBK / 16; ++kk) {
          const int scale_d = s > 0 || kk > 0;
          if constexpr (KIND == kDrhs) {
            // MN-major: 16 rows of the chunk, 64-column blocks 8192 apart
            const uint64_t da = wgmma_desc(a_s + cw * 8192 + kk * 2048, 8192, 1024);
            const uint64_t db = wgmma_desc(b_s + kk * 2048, 8192, 1024);
            wgmma_bf16<BN, 1, 1>(acc, da, db, scale_d);
          } else {
            // A K-major: 16 columns of the 128-byte rows, 8-row groups 1024 apart
            const uint64_t da = wgmma_desc(a_s + cw * 64 * 128 + kk * 32, 16, 1024);
            if constexpr (KIND == kDlhs) {
              // B K-major as A
              const uint64_t db = wgmma_desc(b_s + kk * 32, 16, 1024);
              wgmma_bf16<BN, 0, 0>(acc, da, db, scale_d);
            } else {
              // B MN-major: 16 rows of K, 64-column blocks 8192 apart
              const uint64_t db = wgmma_desc(b_s + kk * 2048, 8192, 1024);
              wgmma_bf16<BN, 0, 1>(acc, da, db, scale_d);
            }
          }
        }
        wgmma_commit();
        wgmma_wait<1>();                          // the step before has been read
#pragma unroll
        for (int x = 0; x < BN / 2; ++x) fence_reg(acc[x]);
        if (s > 0) release(it - 1);
      }
      const bool have = tl.steps > 0;
      if (have) {
        wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < BN / 2; ++x) fence_reg(acc[x]);
        release(it - 1);
      }

      // The epilogue.  This warpgroup's rows are r0 + 16 warp + g (+ 8);
      // acc[4 j + 2 h + x] is row + 8 h, column col0 + 8 j + 2 t4 + x.
      int r0, r1, lo = 0, hi = 0, zlo = 0, zhi = 0;
      if constexpr (kUnits) {
        r0 = tl.row0 + 64 * cw;
        r1 = min(r0 + 64, p.m);
        lo = tl.lo, hi = tl.hi;                   // the rows written with the product
        zlo = tl.zlo, zhi = tl.zhi;
      } else {
        r0 = tl.k0 + 64 * cw;
        r1 = min(r0 + 64, p.k);
      }
      if (r1 <= r0) continue;
      const bool whole = !kUnits
                         || overlap(r0, r1, lo, hi) + overlap(r0, r1, zlo, zhi) == r1 - r0;
      if (whole) {
        // round (zeros for the rows the unit writes as zeros), stage in the
        // 128-byte swizzle (TMA's layout) and store by TMA, OC columns a pass
#pragma unroll
        for (int pass = 0; pass < BN / OC; ++pass) {
          if (ct == 0) bulk_wait_read<0>();       // the last store has read the staging
          named_barrier(1 + cw, 128);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * warp + g + 8 * h;
            const bool prod = have && (!kUnits || (r0 + row >= lo && r0 + row < hi));
#pragma unroll
            for (int jj = 0; jj < OC / 8; ++jj) {
              const int j = pass * (OC / 8) + jj;
              const __nv_bfloat162 v = prod ? __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                                                    acc[4 * j + 2 * h + 1])
                                            : __floats2bfloat162_rn(0.f, 0.f);
              *reinterpret_cast<__nv_bfloat162*>(
                  staging + (jj / 8) * 8192 + swizzle128(row, (8 * jj) % 64 + 2 * t4, 64)) = v;
            }
          }
          fence_proxy_async();
          named_barrier(1 + cw, 128);
          if (ct == 0) {
            const int c0 = tl.col0 + pass * OC;
            for (int c = 0; c < OC / 64; ++c) {
              if constexpr (kUnits)
                tma_store_2d(&out_map, staging + c * 8192, c0 + 64 * c, r0);
              else
                tma_store_3d(&out_map, staging + c * 8192, c0 + 64 * c, r0, tl.group);
            }
            bulk_commit();
          }
        }
      } else {
        // a boundary tile's rows: each row this unit owns, from registers
        const int cols = KIND == kDlhs ? p.k : p.n;
        __nv_bfloat16* out = p.out;
        if constexpr (KIND == kDrhs) out += static_cast<size_t>(tl.group) * p.k * p.n;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 16 * warp + g + 8 * h;
          const bool prod = have && (!kUnits || (r >= lo && r < hi));
          if (r >= r1 || !(!kUnits || prod || (r >= zlo && r < zhi))) continue;
          __nv_bfloat16* orow = out + static_cast<size_t>(r) * cols;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int c = tl.col0 + 8 * j + 2 * t4;
            if (c >= cols) continue;
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                prod ? __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1])
                     : __floats2bfloat162_rn(0.f, 0.f);
          }
        }
      }
    }
    if (ct == 0) bulk_wait<0>();                  // every store done before exit
  }
}

// ------------------------------------------------------------------ host side

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// What the last launch was, for reports (`dstt_gmm_launch_info`): which
// kernel (kDlhs, kDrhs or kFwd) and its shape.
struct LaunchInfo {
  const void* fn;
  long long kernel, grid, threads, smem, tiles, bm, bn, stages, band, encode_ns;
};
LaunchInfo g_last{};

// The map of `depth` row-major bf16 [rows, cols] matrices, one after
// another (rank 3; rank 2 for one matrix): a box is 64 columns (128 bytes,
// swizzled for wgmma) of `box_rows` rows of one matrix; elements past an
// edge read as zeros and are not written.
bool encode(CUtensorMap* map, const void* base, int cols, int rows, int depth, int box_rows,
            int rank) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {64u, static_cast<cuuint32_t>(box_rows), 1u};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                      const_cast<void*>(base), dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// forward: a = lhs [M, K], b = rhs [E, K, N], out [M, N]; dlhs: a = dout
// [M, N], b = rhs [E, K, N], out [M, K]; drhs: a = lhs [M, K], b = dout
// [M, N], out [E, K, N].
template <int KIND>
int launch_wgmma(const void* a, const void* b, const void* group_sizes, void* out, int m,
                 int k, int n, int e_count, cudaStream_t stream) {
  using T = GmmTiles<KIND>;
  using L = GmmSmem<KIND>;
  const auto t0 = std::chrono::steady_clock::now();
  CUtensorMap a_map{}, b_map{}, out_map{};
  bool ok;
  long long tiles, band = 0;
  if constexpr (KIND != kDrhs) band = T::kBand;
  if constexpr (KIND == kDlhs) {
    tiles = static_cast<long long>(cdiv(m, kGradBM) + e_count - 1) * cdiv(k, T::kBN);
    ok = encode(&a_map, a, n, m, 1, kGradBM, 2) && encode(&b_map, b, n, k, e_count, T::kBN, 3)
         && encode(&out_map, out, k, m, 1, 64, 2);
  } else if constexpr (KIND == kDrhs) {
    tiles = static_cast<long long>(e_count) * cdiv(k, kGradBM) * cdiv(n, T::kBN);
    // with M = 0 every group is empty: nothing is loaded and no map is made
    ok = (m == 0 || (encode(&a_map, a, k, m, 1, 64, 2) && encode(&b_map, b, n, m, 1, 64, 2)))
         && encode(&out_map, out, n, k, e_count, 64, 3);
  } else {
    tiles = static_cast<long long>(cdiv(m, kGradBM) + e_count - 1) * cdiv(n, T::kBN);
    ok = encode(&a_map, a, k, m, 1, kGradBM, 2)
         && encode(&b_map, b, n, k, e_count, 64, 3)
         && encode(&out_map, out, n, m, 1, 64, 2);
  }
  if (!ok || tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const long long encode_ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                                  std::chrono::steady_clock::now() - t0)
                                  .count();
  const size_t smem = L::kBytes + (KIND == kDrhs ? 12 * static_cast<size_t>(e_count) : 0);
  auto kernel = gmm_wgmma_kernel<KIND>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = sm_count();
  const long long grid = T::kPersistent ? (tiles < slots ? tiles : slots) : tiles;
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const GmmArgs args{static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(out),
                     m, k, n, e_count, static_cast<int>(tiles)};
  kernel<<<static_cast<unsigned>(grid), 384, smem, stream>>>(a_map, b_map, out_map, args);
  g_last = LaunchInfo{reinterpret_cast<const void*>(kernel), KIND, grid, 384,
                      static_cast<long long>(smem), tiles, kGradBM, T::kBN, T::kStages,
                      band, encode_ns};
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int m, int k, int n, int e_count) {
  return m >= 0 && k > 0 && n > 0 && e_count > 0 && k % 8 == 0 && n % 8 == 0;
}

}  // namespace

// The forward: lhs [M, K], rhs [E, K, N] -> out [M, N].  Return: the CUDA
// error code (0 ok).
extern "C" int dstt_grouped_gemm_bf16(const void* lhs, const void* rhs,
                                      const void* group_sizes, void* out, int m, int k,
                                      int n, int e_count, void* stream) {
  if (m <= 0 || !shape_ok(m, k, n, e_count)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma<kFwd>(lhs, rhs, group_sizes, out, m, k, n, e_count,
                            static_cast<cudaStream_t>(stream));
}

// dlhs: dout [M, N], rhs [E, K, N] -> dlhs [M, K] (the forward's K and N).
extern "C" int dstt_grouped_gemm_dlhs_bf16(const void* dout, const void* rhs,
                                           const void* group_sizes, void* dlhs, int m,
                                           int k, int n, int e_count, void* stream) {
  if (m <= 0 || !shape_ok(m, k, n, e_count)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma<kDlhs>(dout, rhs, group_sizes, dlhs, m, k, n, e_count,
                             static_cast<cudaStream_t>(stream));
}

// drhs: lhs [M, K], dout [M, N] -> drhs [E, K, N].  M may be 0 (every
// group empty: zeros).
extern "C" int dstt_grouped_gemm_drhs_bf16(const void* lhs, const void* dout,
                                           const void* group_sizes, void* drhs, int m,
                                           int k, int n, int e_count, void* stream) {
  if (!shape_ok(m, k, n, e_count)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma<kDrhs>(lhs, dout, group_sizes, drhs, m, k, n, e_count,
                             static_cast<cudaStream_t>(stream));
}

// The last launch of this library, for reports: out[0..11] = the kernel
// (0 dlhs, 1 drhs, 2 the forward), blocks,
// threads a block, dynamic shared memory (bytes), output tiles, rows and
// columns of a tile, ring stages, units a band of the tile order (0: not a
// unit walk), registers a thread at launch, local memory a thread (bytes:
// spills), and the host ns spent encoding its tensor maps.
extern "C" int dstt_gmm_launch_info(long long* out) {
  cudaFuncAttributes attr{};
  if (g_last.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncGetAttributes(&attr, g_last.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vals[12] = {g_last.kernel, g_last.grid,   g_last.threads,
                              g_last.smem,   g_last.tiles,  g_last.bm,
                              g_last.bn,     g_last.stages, g_last.band,
                              attr.numRegs,  static_cast<long long>(attr.localSizeBytes),
                              g_last.encode_ns};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  return 0;
}
