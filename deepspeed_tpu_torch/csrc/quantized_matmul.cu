// Int8-weight matmul for Hopper (sm_90a), bf16 activations.
//
// Replaces the TPU kernel deepspeed_tpu/ops/quantized_matmul.py
// `_qmm_kernel` (its pallas_call is in `_qmm_call`).
//
//   y[M, N] = x[M, K] @ W,   W[k, n] = bf16(float(q[k, n]) * scale[k / (K / G)])
//
// Each weight is dequantized to bf16 before the product, exactly where the
// reference's `dequant_reference` rounds, and every sum is kept in fp32.
// The weight stays int8 in device memory: no bf16 copy of W ever exists.
//
// What bounds it on the H100, and what the design does about it:
//
// * Decode (M <= 8, one row per live sequence) is a skinny product bound by
//   the int8 weight bytes, K*N per call (16.8 MB for a 4096x4096
//   projection: ~5 us at 3.35 TB/s), and on this card by the dequant's
//   instructions as much as by the bytes.  `qmm_skinny_kernel` is one
//   launch a call.  The weight is cut into column tiles of 128, each cut
//   along K over a cluster of up to 8 blocks (the wrapper takes the most
//   for which every cluster is resident at once, from the counts
//   `dstt_quantized_matmul_skinny_resident` reports: on an H100 3 at 4096
//   x 4096, 96 blocks, since the card holds fewer than 32 clusters of 4),
//   and each block walks its units of 128 columns x 256 k rows.  A
//   producer warp keeps TMA loads of the next units (the
//   int8 tile and the matching [8 x 256] slice of x) in flight through a
//   ring of 32 KB stages.  Each of 8 consumer warps takes two 16-row k
//   steps of a unit: a thread reads four 16-byte rows of its quad's 16
//   columns a step (k rows t, t+4, t+8, t+12; conflict-free under the
//   128-byte swizzle) and dequantizes them straight into the A fragments
//   of 8 m16n8k16 tensor-core products (the weight columns are mma's M, the
//   <= 8 x rows, zero-padded, its n8), so the multiply costs no CUDA-core
//   instruction: a weight costs a byte permute, an add, a multiply and
//   half a bf16x2 pack.  Each row's scale is loaded a unit ahead by the
//   warp that uses it, so a group boundary inside a unit costs nothing.  A
//   block sums its warps' products in shared memory; a cluster's blocks
//   then sum their parts through distributed shared memory in rank order,
//   so the result has the same bits every run and no second pass, scratch
//   or counter exists.  The launch may start while the kernel before it on
//   the stream finishes (programmatic dependent launch): every thread waits
//   for that kernel before its first global access.
// * Above M = 8 (prefill at the 512-token bucket, a verify pass of 8 x 5
//   rows, a SplitFuse tick) the product is bound by operations at large M
//   (2 M K N: 17 us at 989 TFLOP/s for M = 512 and 4096 x 4096) and by the
//   weight bytes at medium M (K N: 5 us at 4096 x 4096).
//   `qmm_wgmma_kernel` runs it on Hopper's warpgroup tensor-core product,
//   transposed: y^T = W^T x^T, so the dequantized weight is wgmma's
//   register A operand and never goes back to shared memory.  A block
//   takes 128 weight columns (two consumer warpgroups of 64) against BX x
//   rows, wgmma's N: 64 at M <= 64 (a medium M pays for 64 rows, not 128),
//   128 up to M = 128, and above that 256 (each dequantized weight feeds
//   256 rows) where the wrapper finds that fewer waves of these longer
//   blocks finish first.  A producer warp keeps TMA loads of the next k-tiles in
//   flight through a 4-stage ring (x [BX x 64] bf16, q [64 x 128] int8,
//   both 128-byte swizzled; the ragged edges in M, N and K are zero-filled
//   by TMA) and writes each k row's scale beside them (loaded a k-tile
//   ahead), so a group boundary inside a k-tile costs nothing (Llama's 64
//   groups at K = 11008 are 172 rows each).  The consumers dequantize each
//   16-row k step's A fragments straight from the int8 stage (a 2-byte
//   load gives a thread's two columns at one k row) into one of four
//   register sets, so up to three products are in flight while the next
//   step is dequantized.  When the output tiles would not fill the SMs
//   (medium M) the k-tiles are split over blocks whose fp32 partials
//   `qmm_reduce_kernel` sums.
//   What bounds it is not settled.  At M = 512 and 4096 x 4096 (128-row
//   tiles) it reaches about 40% of the tensor cores' rate, while its
//   operands cross from L2 into the SMs at ~4.3 TB/s (x re-read by each
//   of 32 column blocks, q by each of 4 row blocks: 201 MB); a 16-row k
//   step is ~57 instructions a consumer warp, two warps to each
//   sub-partition, against 64 cycles of tensor work a warpgroup.  Tried
//   on the H100 and not kept: two fragment sets (ptxas then serialises
//   every product, C7513; no faster), the weight dequantized into shared
//   memory for an all-shared-memory product (no faster), clusters of 2
//   and 4 blocks multicasting x (no faster).  Later work: a persistent
//   grid, and the skinny path's dequant (fewer instructions a weight).
//
// Shapes the kernel takes (the wrapper checks them): x bf16 [M, K] and
// out bf16 [M, N] contiguous, q int8 [K, N] contiguous, scale fp32 [G],
// G | K, K % 32 == 0, N % 16 == 0.  The ragged edges in N (32000 and 11008
// are not multiples of the 128-column tiles), K and M are zero-filled by
// TMA and masked at the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

// ----------------------------------------------------------- skinny path
//
// Column tiles of kSkBN weight columns, each cut along K over a cluster of
// c blocks (1 <= c <= 8: the wrapper takes the most for which every
// cluster of the launch is resident at once); block rank r of a tile's
// cluster walks its units of kSkBK k rows [r chunks / c, (r + 1) chunks /
// c).  A unit is one TMA box of 128 columns (a 128-byte swizzled row each),
// its x slice kSkXBoxes [8 x 64] bf16 boxes.  The cluster's
// parts meet in distributed shared memory: each block sums its warps'
// products into its own [8 x kSkBN] part, and after a cluster barrier rank
// r sums runs r, r + c, ... of every block's part in rank order (the same
// bits every run) and stores them.

constexpr int kSkMaxM = 8;                      // x rows: mma.sync's n8, zero-padded
constexpr int kSkBN = 128;                      // weight columns a tile (one TMA box)
constexpr int kSkQBytes = 32768;                // int8 bytes a unit (a q stage)
constexpr int kSkBK = kSkQBytes / kSkBN;        // k rows a unit
constexpr int kSkSteps = kSkBK / 16;            // 16-row k steps of a unit
constexpr int kSkStepsPerWarp = 2;              // ... a consumer warp takes
constexpr int kSkWarps = kSkSteps / kSkStepsPerWarp;    // consumer warps
constexpr int kSkStages = 2;
constexpr int kSkMaxCluster = 8;                // the portable cluster size
constexpr int kSkConsumers = 32 * kSkWarps;
constexpr int kSkThreads = kSkConsumers + 32;   // and the producer warp
constexpr int kSkXBoxes = kSkBK / 64;
constexpr int kSkXBytes = kSkXBoxes * 1024;     // an x stage: [8 x 64] bf16 boxes
constexpr int kSkRowQuads = kSkBN / 4;         // 4-column runs of a row of a tile
constexpr int kSkQuads = kSkMaxM * kSkRowQuads; // ... of a tile's [8 x kSkBN] sums
constexpr int kSkPer = kSkQuads / kSkConsumers; // ... a consumer thread's
constexpr int kSkRedPitch = 33;                 // a lane's 32 sums, padded: no bank conflicts
static_assert(kSkBK % 64 == 0 && kSkQuads % kSkConsumers == 0, "whole x boxes and sums");

// shared memory, in bytes from a 1024-aligned base
struct SkinnySmem {
  static constexpr int kQ = 0;                                    // [stages] q tiles
  static constexpr int kX = kQ + kSkStages * kSkQBytes;           // [stages] x slices
  static constexpr int kRed = kX + kSkStages * kSkXBytes;         // [warps][32][pitch] fp32
  static constexpr int kPart = kRed + kSkWarps * 32 * kSkRedPitch * 4;  // [8][kSkBN] fp32
  static constexpr int kBars = kPart + kSkMaxM * kSkBN * 4;
  static constexpr int kBytes = kBars + 2 * kSkStages * 8 + 1024;  // + alignment slack
};

// bf16(float(q) * s) of int8 byte j of two biased words (as in
// biased_byte_to_float: the byte under the exponent of 2^23, `exp23` =
// 0x4B000000, a kernel parameter so that the byte permute takes it from
// the parameter bank and its selector as an immediate), as one mma
// fragment register (lo's in the low half): the fp32 product rounded once
// to bf16, where dequant_reference rounds.
__device__ __forceinline__ uint32_t deq_rows(unsigned lo, unsigned hi, unsigned exp23, int j,
                                             float s_lo, float s_hi) {
  const float a = (__uint_as_float(__byte_perm(lo, exp23, 0x7540u | j)) - 8388736.0f) * s_lo;
  const float b = (__uint_as_float(__byte_perm(hi, exp23, 0x7540u | j)) - 8388736.0f) * s_hi;
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                              *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Programmatic dependent launch: a launch may start while the kernel
// before it on the stream finishes.  Every thread waits for that kernel
// (and its memory) before its first global access, and lets the next
// launch start once its own main loop is done.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void release_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// every thread of the cluster: its shared-memory writes before, visible
// to every block of the cluster after
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the float4 at `p` (this block's shared memory) in block `rank`'s
__device__ __forceinline__ float4 ld_cluster_f4(const void* p, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float4 v;           // ordered after the cluster barrier by its acquire
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote));
  return v;
}

__global__ void __launch_bounds__(kSkThreads, 1)
qmm_skinny_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap q_map,
                  const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M, int K,
                  int N, int rows_per_group, unsigned exp23) {
  using L = SkinnySmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem + L::kQ;
  unsigned char* xs = smem + L::kX;
  float* red = reinterpret_cast<float*>(smem + L::kRed);
  float* part = reinterpret_cast<float*>(smem + L::kPart);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kSkStages;

  const unsigned c = cluster_size(), rank = cluster_rank();
  const int tile = blockIdx.x / c;
  const int chunks = (K + kSkBK - 1) / kSkBK;            // units of a tile
  const int c0 = static_cast<int>(rank * chunks / c);
  const int c1 = static_cast<int>((rank + 1) * chunks / c);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSkStages; ++s) {
      mbar_init(&full[s], 1);                 // the producer's arrival, and the bytes
      mbar_init(&empty[s], kSkWarps);         // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  wait_prior_grid();

  if (warp == kSkWarps) {
    // producer: stage i % kSkStages takes unit c0 + i once its readers
    // have released it
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&q_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&x_map))
                   : "memory");
      for (int kc = c0; kc < c1; ++kc) {
        const int i = kc - c0, s = i % kSkStages;
        if (i >= kSkStages) mbar_wait(&empty[s], ((i / kSkStages) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], kSkQBytes + kSkXBytes);
        tma_load_2d(qs + s * kSkQBytes, &q_map, &full[s], tile * kSkBN, kc * kSkBK);
#pragma unroll
        for (int b = 0; b < kSkXBoxes; ++b)
          tma_load_2d(xs + s * kSkXBytes + b * 1024, &x_map, &full[s], kc * kSkBK + 64 * b, 0);
      }
    }
    __syncwarp();
    if (c > 1) {                                   // the cluster's two barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // consumers: warp w takes kSkStepsPerWarp 16-row k steps of the unit,
  // from step w kSkStepsPerWarp;
  // lane (g, t) holds A rows g and g + 8 of 8 products as the box's weight
  // columns 16 c + 2 j and + 1 of its quad's chunk c, and k rows t, t + 4,
  // t + 8, t + 12 of a step as the fragment's k 2t, 2t + 1, 2t + 8, 2t + 9
  // (x is read in the same order, so the product is unchanged)
  constexpr int kH = kSkStepsPerWarp;
  const int g = lane >> 2, t = lane & 3;
  const int step0 = warp * kH;
  const int chunk = (g >> 1) | ((g & 1) << 2);     // 16-byte chunks 0-3 to even quads, 4-7 odd
  // this thread's four 16-byte q rows of each step in a stage, and its
  // four x values (x row g at k 16 step + t + 4 i of the swizzled [8 x 64]
  // boxes)
  int q_off[kH][4], x_off[kH][4];
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * (step0 + h) + t + 4 * r;
      q_off[h][r] = row * 128 + ((chunk ^ (row & 7)) << 4);
      x_off[h][r] = (row >> 6) * 1024 + g * 128 + ((((row & 63) >> 3) ^ g) << 4) + (row & 7) * 2;
    }
  // the scales of the warp's 16 kH k rows, lane l row l % (16 kH)'s, loaded
  // a unit ahead (a group boundary inside a unit costs nothing)
  auto row_scale = [&](int kc) {
    const int k = kc * kSkBK + 16 * step0 + (lane & (16 * kH - 1));
    return k < K ? __ldg(&scale[k / rows_per_group]) : 0.f;
  };
  float sc_next = c0 < c1 ? row_scale(c0) : 0.f;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kc = c0; kc < c1; ++kc) {
    const int i = kc - c0, s = i % kSkStages;
    const float sc = sc_next;
    if (kc + 1 < c1) sc_next = row_scale(kc + 1);
    mbar_wait(&full[s], (i / kSkStages) & 1);
    const unsigned char* qt = qs + s * kSkQBytes;
    const unsigned char* xt = xs + s * kSkXBytes;
    uint4 w[kH][4];
    float sk[kH][4];
    uint32_t b0[kH], b1[kH];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        w[h][r] = *reinterpret_cast<const uint4*>(qt + q_off[h][r]);
        sk[h][r] = __shfl_sync(0xffffffffu, sc, 16 * h + t + 4 * r);
      }
      b0[h] = *reinterpret_cast<const uint16_t*>(xt + x_off[h][0])
              | (*reinterpret_cast<const uint16_t*>(xt + x_off[h][1]) << 16);
      b1[h] = *reinterpret_cast<const uint16_t*>(xt + x_off[h][2])
              | (*reinterpret_cast<const uint16_t*>(xt + x_off[h][3]) << 16);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);         // the steps are in registers

#pragma unroll
    for (int h = 0; h < kH; ++h) {
      unsigned v[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        v[r][0] = w[h][r].x ^ 0x80808080u;
        v[r][1] = w[h][r].y ^ 0x80808080u;
        v[r][2] = w[h][r].z ^ 0x80808080u;
        v[r][3] = w[h][r].w ^ 0x80808080u;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // columns 2j and 2j + 1 of the chunk: bytes 2 (j & 1) and + 1 of word j / 2
        const int wd = j >> 1, by = 2 * (j & 1);
        const uint32_t a[4] = {deq_rows(v[0][wd], v[1][wd], exp23, by, sk[h][0], sk[h][1]),
                               deq_rows(v[0][wd], v[1][wd], exp23, by + 1, sk[h][0], sk[h][1]),
                               deq_rows(v[2][wd], v[3][wd], exp23, by, sk[h][2], sk[h][3]),
                               deq_rows(v[2][wd], v[3][wd], exp23, by + 1, sk[h][2], sk[h][3])};
        mma16816(acc[j], a, b0[h], b1[h]);
      }
    }
  }

  release_next_grid();
  // this block's part: the k steps' sums in order.  acc[j][e] of lane
  // (g, t) is column 16 chunk(g) + 2j + (e >> 1) of the tile at x row
  // 2t + (e & 1); run o of the part is x row o / kSkRowQuads, tile
  // columns 4 (o % kSkRowQuads) .. + 3
  float* mine = red + (warp * 32 + lane) * kSkRedPitch;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[4 * j + e] = acc[j][e];
  named_barrier(1, kSkConsumers);
  const int ct = threadIdx.x;
#pragma unroll
  for (int p = 0; p < kSkPer; ++p) {
    const int o = ct + p * kSkConsumers, m = o / kSkRowQuads, col0 = o % kSkRowQuads * 4;
    float v4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = col0 + q, ch = col >> 4;
      const int at = (4 * (((ch & 3) << 1) | (ch >> 2)) + (m >> 1)) * kSkRedPitch
                     + 4 * ((col & 15) >> 1) + 2 * (col & 1) + (m & 1);
      float acc_k = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSkWarps; ++ks) acc_k += red[ks * 32 * kSkRedPitch + at];
      v4[q] = acc_k;
    }
    const float4 sum = make_float4(v4[0], v4[1], v4[2], v4[3]);
    const int n = tile * kSkBN + col0;
    if (c == 1) {                                  // the whole tile in this block
      if (m < M && n < N) store_bf16x4(out + static_cast<size_t>(m) * N + n, sum);
    } else {
      *reinterpret_cast<float4*>(part + 4 * o) = sum;
    }
  }
  if (c == 1) return;
  cluster_sync();                                  // every block's part is in
  for (int o = rank + c * ct; o < kSkQuads; o += c * kSkConsumers) {
    const int m = o / kSkRowQuads, n = tile * kSkBN + o % kSkRowQuads * 4;
    if (m >= M || n >= N) continue;
    float4 p4[kSkMaxCluster];                      // every rank's loads in flight
#pragma unroll
    for (unsigned r = 0; r < kSkMaxCluster; ++r)
      if (r < c) p4[r] = ld_cluster_f4(part + 4 * o, r);
    float4 tot = p4[0];
#pragma unroll
    for (unsigned r = 1; r < kSkMaxCluster; ++r) {  // in rank order
      if (r < c) {
        tot.x += p4[r].x;
        tot.y += p4[r].y;
        tot.z += p4[r].z;
        tot.w += p4[r].w;
      }
    }
    store_bf16x4(out + static_cast<size_t>(m) * N + n, tot);
  }
  cluster_sync();                                  // no block leaves while its part is read
}

// the kernel's shared memory allowed on the current device (once a device)
cudaError_t allow_skinny_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev >= 0 && dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(qmm_skinny_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SkinnySmem::kBytes);
  if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return err;
}

// The clusters of c blocks (c = 2 .. 8) the current device holds at once:
// counts[c - 2], 0 where none fits.
cudaError_t skinny_resident(int* counts) {
  cudaError_t err = allow_skinny_smem();
  for (int c = 2; c <= kSkMaxCluster && err == cudaSuccess; ++c) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kSkThreads);
    cfg.dynamicSmemBytes = SkinnySmem::kBytes;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    counts[c - 2] = 0;
    err = cudaOccupancyMaxActiveClusters(&counts[c - 2], qmm_skinny_kernel, &cfg);
  }
  return err;
}

int launch_skinny(const __nv_bfloat16* x, const int8_t* q, const float* scale,
                  __nv_bfloat16* out, int M, int K, int N, int rows_per_group, int cluster,
                  cudaStream_t stream) {
  if (M < 1 || M > kSkMaxM || cluster < 1 || cluster > kSkMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_skinny_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap x_map, q_map;
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
    const cuuint32_t box[2] = {64, kSkMaxM};
    if (encode_tiled(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(x),
                     dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N)};
    const cuuint32_t box[2] = {128, kSkBK};
    if (encode_tiled(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(q), dims,
                     strides, box, CU_TENSOR_MAP_SWIZZLE_128B) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kSkBN - 1) / kSkBN * cluster);
  cfg.blockDim = dim3(kSkThreads);
  cfg.dynamicSmemBytes = SkinnySmem::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, qmm_skinny_kernel, x_map, q_map, scale, out, M, K, N,
                           rows_per_group, 0x4B000000u);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The tiled path's k-split partials: out = bf16(sum over splits), one
// thread an output.
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  __nv_bfloat16* __restrict__ out,
                                  int splits, int mn) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int p = 0; p < splits; ++p) sum += partial[static_cast<size_t>(p) * mn + i];
    out[i] = __float2bfloat16(sum);
  }
}

// ------------------------------------------------------------ tiled path
//
// One block computes a 128-column (weights) x BX-row (x) output tile as
// y^T = W^T x^T on wgmma: the dequantized weight is the register A operand
// (m64, one consumer warpgroup per 64 columns), x the shared-memory B
// operand (BX rows, K-major, 128-byte swizzled).  A producer warp keeps TMA
// loads of the next k-tiles (x [BX x 64] bf16, q [64 x 128] int8) in
// flight through a ring of kStages stages and writes each k row's scale
// beside them; full / empty mbarriers hand the stages over.

constexpr int kBN = 128;                      // weight columns a block
constexpr int kBK = 64;                       // k rows a stage
constexpr int kStages = 4;
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kTiledThreads = kConsumers + 32;  // and the producer warp
constexpr int kQBytes = kBK * kBN;            // one int8 q stage

template <int BX>
constexpr int tiled_smem() {
  return kStages * (BX * 128 + kQBytes + kBK * 4) + 2 * kStages * 8 + 1024;
}

// fp32 x of int8 byte j of `biased` (see biased_byte_to_float) times s,
// for two k rows, as one packed bf16 pair: the rounding point of
// dequant_reference
__device__ __forceinline__ uint32_t deq_pair(unsigned biased, int j0, int j1, float s0, float s1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(biased_byte_to_float(biased, j0) * s0,
                                                 biased_byte_to_float(biased, j1) * s1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int BX>
__global__ void __launch_bounds__(kTiledThreads, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap q_map,
                 const float* __restrict__ scale, float* __restrict__ partial,
                 __nv_bfloat16* __restrict__ out, int M, int K, int N,
                 int rows_per_group, int tiles_per_split) {
  constexpr int kXBytes = BX * 128;           // one x stage: BX rows of 64 bf16
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;
  unsigned char* qs = xs + kStages * kXBytes;
  float* ss = reinterpret_cast<float*>(qs + kStages * kQBytes);   // [stage][64] scales
  uint64_t* full = reinterpret_cast<uint64_t*>(ss + kStages * kBK);
  uint64_t* empty = full + kStages;

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BX;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int nk = min((K + kBK - 1) / kBK, kt0 + tiles_per_split) - kt0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);                // the producer warp's lanes
      mbar_init(&empty[s], kConsumers / 32);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: stage i % kStages takes k-tile kt0 + i once its readers
    // have released it.  The scales of the next k-tile are loaded one
    // iteration ahead, so that their latency never holds the loop up.
    auto row_scale = [&](int k) { return k < K ? __ldg(scale + k / rows_per_group) : 0.f; };
    float sc0 = row_scale(kt0 * kBK + lane), sc1 = row_scale(kt0 * kBK + lane + 32);
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
      const int k0 = (kt0 + i) * kBK;
      ss[s * kBK + lane] = sc0;
      ss[s * kBK + lane + 32] = sc1;
      sc0 = row_scale(k0 + kBK + lane);
      sc1 = row_scale(k0 + kBK + lane + 32);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], kXBytes + kQBytes);
        tma_load_2d(xs + s * kXBytes, &x_map, &full[s], k0, m0);
        tma_load_2d(qs + s * kQBytes, &q_map, &full[s], n0, k0);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warp wi of warpgroup wg holds A rows 16 wi + g and + 8 of
  // its m64 tile, taken as the weight columns nl and nl + 1, so one
  // 2-byte load reads both
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int nl = 64 * wg + 16 * wi + 2 * g;
  float acc[BX / 2];
#pragma unroll
  for (int i = 0; i < BX / 2; ++i) acc[i] = 0.f;
  uint32_t a[4][4];                         // one fragment set a k step

  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const unsigned char* qt = qs + s * kQBytes;
    const float* st = ss + s * kBK;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      // k rows kr, kr + 1, kr + 8, kr + 9 of the stage at columns nl, nl + 1
      const int kr = 16 * ks + 2 * t;
      auto ld2 = [&](int row) -> unsigned {
        return *reinterpret_cast<const uint16_t*>(
            qt + row * 128 + ((((nl >> 4) ^ (row & 7)) << 4) | (nl & 15)));
      };
      const unsigned w01 = (ld2(kr) | (ld2(kr + 1) << 16)) ^ 0x80808080u;
      const unsigned w89 = (ld2(kr + 8) | (ld2(kr + 9) << 16)) ^ 0x80808080u;
      const float2 s01 = *reinterpret_cast<const float2*>(st + kr);
      const float2 s89 = *reinterpret_cast<const float2*>(st + kr + 8);
      wgmma_wait<3>();                        // the product that last read a[ks] is done
      uint32_t (&av)[4] = a[ks];
      av[0] = deq_pair(w01, 0, 2, s01.x, s01.y);   // column nl, rows kr, kr + 1
      av[1] = deq_pair(w01, 1, 3, s01.x, s01.y);   // column nl + 1
      av[2] = deq_pair(w89, 0, 2, s89.x, s89.y);   // column nl, rows kr + 8, kr + 9
      av[3] = deq_pair(w89, 1, 3, s89.x, s89.y);
      wgmma_fence();
      wgmma_rs<BX, 0>(acc, av, wgmma_desc(xs + s * kXBytes + ks * 32, 16, 1024));
      wgmma_commit();
      if (ks == 3 && i > 0) {                 // the last k-tile's products are done
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(i - 1) % kStages]);
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BX / 2; ++i) fence_reg(acc[i]);

  // acc[4j + e]: column nl, x row 8j + 2t + e; acc[4j + 2 + e]: column nl + 1
  const int n = n0 + nl;
  if (n < N) {                      // N % 16 == 0: n + 1 < N too
#pragma unroll
    for (int j = 0; j < BX / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m < M) {
          if (partial != nullptr)
            *reinterpret_cast<float2*>(partial + (static_cast<size_t>(blockIdx.z) * M + m) * N
                                       + n) = make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
          else
            *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * N + n) =
                __floats2bfloat162_rn(acc[4 * j + e], acc[4 * j + 2 + e]);
        }
      }
    }
  }
}

template <int BX>
int launch_tiled(const __nv_bfloat16* x, const int8_t* q, const float* scale, float* partial,
                 __nv_bfloat16* out, int M, int K, int N, int rows_per_group, int k_splits,
                 cudaStream_t stream) {
  CUtensorMap x_map, q_map;
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
    const cuuint32_t box[2] = {kBK, BX};
    if (encode_tiled(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(x),
                     dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N)};
    const cuuint32_t box[2] = {kBN, kBK};
    if (encode_tiled(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(q), dims,
                     strides, box, CU_TENSOR_MAP_SWIZZLE_128B) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = tiled_smem<BX>();
  const cudaError_t err = cudaFuncSetAttribute(
      qmm_wgmma_kernel<BX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int k_tiles = (K + kBK - 1) / kBK;
  const int per_split = (k_tiles + k_splits - 1) / k_splits;
  const int splits = (k_tiles + per_split - 1) / per_split;
  const dim3 grid((N + kBN - 1) / kBN, (M + BX - 1) / BX, splits);
  qmm_wgmma_kernel<BX><<<grid, kTiledThreads, smem, stream>>>(
      x_map, q_map, scale, splits > 1 ? partial : nullptr, out, M, K, N, rows_per_group,
      per_split);
  if (splits > 1) {
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
    const int mn = M * N;
    qmm_reduce_kernel<<<std::min((mn + 255) / 256, 4096), 256, 0, stream>>>(partial, out, splits,
                                                                            mn);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Skinny path (1 <= M <= 8): one launch, column tiles of 128 cut along K
// over clusters of `cluster` (1 .. 8) blocks.  Returns the CUDA error code
// of the launch (0 on success).
extern "C" int dstt_quantized_matmul_skinny_bf16(const void* x, const void* q, const void* scale,
                                                 void* out, int M, int K, int N, int groups,
                                                 int cluster, void* stream) {
  return launch_skinny(static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
                       static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M, K,
                       N, K / groups, cluster, static_cast<cudaStream_t>(stream));
}

// The skinny kernel's clusters of c blocks the current device holds at
// once, counts[c - 2] for c = 2 .. 8.  Returns the CUDA error code of the
// occupancy queries (0 on success).
extern "C" int dstt_quantized_matmul_skinny_resident(int* counts) {
  return static_cast<int>(skinny_resident(counts));
}

// Tiled path (M > 8).  Returns the CUDA error code of the launches (0 on
// success).  `partial` is fp32 [k_splits, M, N] scratch, used only when
// k_splits > 1; `rows` (64, 128 or 256) is the x rows a block.
extern "C" int dstt_quantized_matmul_bf16(const void* x, const void* q,
                                          const void* scale, void* partial,
                                          void* out, int M, int K, int N,
                                          int groups, int k_splits, int rows,
                                          void* stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sb = static_cast<const float*>(scale);
  auto* pb = static_cast<float*>(partial);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int rows_per_group = K / groups;
  if (M <= kSkMaxM || (k_splits > 1 && pb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 64) return launch_tiled<64>(xb, qb, sb, pb, ob, M, K, N, rows_per_group, k_splits, s);
  if (rows == 128)
    return launch_tiled<128>(xb, qb, sb, pb, ob, M, K, N, rows_per_group, k_splits, s);
  if (rows == 256)
    return launch_tiled<256>(xb, qb, sb, pb, ob, M, K, N, rows_per_group, k_splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
