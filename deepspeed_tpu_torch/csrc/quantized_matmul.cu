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
// * Decode (M <= 8, one row per live sequence) is a skinny GEMV bound by
//   the int8 weight bytes, K*N per call (16.8 MB for a 4096x4096
//   projection: ~5 us at 3.35 TB/s).  `qmm_skinny_kernel` reads the weight
//   once, in 16-byte vectors: each thread owns 16 consecutive columns, so a
//   warp reads 512 contiguous bytes of one weight row; the loads of the
//   next 4 rows are in flight while the current 4 are dequantized and
//   multiplied, so the memory latency hides behind the arithmetic.  The 8 warps of a block walk
//   different rows of the same 512 columns and are reduced in shared
//   memory; x is staged in shared memory as fp32 and read as a broadcast.
//   The grid is split over K so that one wave of blocks covers the SMs,
//   and a second small pass (`qmm_reduce_kernel`) sums the per-split fp32
//   partials, which are small enough to stay in L2.
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
//   and 4 blocks multicasting x (no faster).  Later work: fewer
//   instructions a weight (an int8 -> bf16 path that keeps the fp32
//   rounding point), a persistent grid, and the skinny path on the same
//   loads.
//
// Shapes the kernel takes (the wrapper checks them): x bf16 [M, K] and
// out bf16 [M, N] contiguous, q int8 [K, N] contiguous, scale fp32 [G],
// G | K, K % 32 == 0, N % 16 == 0.  The ragged edge in N (32000 and 11008
// are not multiples of the 512- or 128-column tiles) and in M is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kSkinnyMaxM = 8;
constexpr int kSkinnyWarps = 8;
constexpr int kSkinnyThreads = 32 * kSkinnyWarps;
constexpr int kSkinnyCols = 16;                     // one 16-byte load
constexpr int kSkinnyBlockN = 32 * kSkinnyCols;     // 512 columns a block
constexpr int kRedStride = kSkinnyCols + 1;         // padded: no bank conflicts
constexpr int kUnroll = 4;                          // rows in flight a thread
constexpr int kChunkRows = 256;                     // x rows staged at once

__device__ __forceinline__ int word_of(const int4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// The skinny path's dequant runs once per weight byte, and int->float and
// float->bf16 conversion instructions issue at a fraction of the FMA rate,
// so it converts with full-rate integer and float ops instead
// (biased_byte_to_float, csrc/hopper.cuh, and round_to_bf16).

// v rounded to the nearest bf16 (ties to even) and widened back to fp32:
// what __bfloat162float(__float2bfloat16(v)) gives for every finite v.
__device__ __forceinline__ float round_to_bf16(float v) {
  unsigned u = __float_as_uint(v);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// The 16-byte weight vectors of rows [r0, r0 + kUnroll) of the current
// x chunk at this thread's columns (zeros past the chunk or past N).
__device__ __forceinline__ void load_rows(int4 (&dst)[kUnroll], const int8_t* __restrict__ q,
                                          int col, int N, int kc, int r0, int rows,
                                          bool active) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    dst[u] = make_int4(0, 0, 0, 0);
    if (active && r0 + u < rows)
      dst[u] = __ldg(reinterpret_cast<const int4*>(q + static_cast<size_t>(kc + r0 + u) * N + col));
  }
}

template <int MT>
__global__ void __launch_bounds__(kSkinnyThreads, 1)
qmm_skinny_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ q,
                  const float* __restrict__ scale,
                  float* __restrict__ partial,
                  __nv_bfloat16* __restrict__ out,
                  int M, int K, int N, int rows_per_group, int k_per_split) {
  __shared__ float red[kSkinnyWarps][32 * kRedStride];
  __shared__ float x_s[kChunkRows][MT];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kSkinnyBlockN + lane * kSkinnyCols;
  const bool active = col < N;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float acc[MT][kSkinnyCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kSkinnyCols; ++j) acc[m][j] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += kChunkRows) {
    const int rows = min(kChunkRows, k_end - kc);
    __syncthreads();                       // the previous chunk is consumed
    for (int i = threadIdx.x; i < rows * MT; i += kSkinnyThreads) {
      const int m = i / rows;
      const int r = i % rows;
      x_s[r][m] = m < M ? __bfloat162float(x[static_cast<size_t>(m) * K + kc + r]) : 0.f;
    }
    __syncthreads();
    // software pipeline: the next 4 rows' loads are in flight while the
    // current 4 are dequantized and multiplied
    constexpr int kStep = kSkinnyWarps * kUnroll;
    int4 packed[kUnroll];
    int4 ahead[kUnroll];
    load_rows(packed, q, col, N, kc, warp * kUnroll, rows, active);
    for (int r0 = warp * kUnroll; r0 < rows; r0 += kStep) {
      load_rows(ahead, q, col, N, kc, r0 + kStep, rows, active);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u < rows) {
          const float s = __ldg(scale + (kc + r0 + u) / rows_per_group);
          float w[kSkinnyCols];
#pragma unroll
          for (int j = 0; j < kSkinnyCols; ++j) {
            const unsigned biased = static_cast<unsigned>(word_of(packed[u], j / 4)) ^ 0x80808080u;
            w[j] = round_to_bf16(biased_byte_to_float(biased, j % 4) * s);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = x_s[r0 + u][m];
#pragma unroll
            for (int j = 0; j < kSkinnyCols; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) packed[u] = ahead[u];
    }
  }

  // Sum the 8 warps' partial rows in shared memory, one output row at a
  // time; the loop bound M is uniform across the block.
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSkinnyCols; ++j) red[warp][lane * kRedStride + j] = acc[m][j];
    __syncthreads();
    for (int c = threadIdx.x; c < kSkinnyBlockN; c += kSkinnyThreads) {
      const int n = blockIdx.x * kSkinnyBlockN + c;
      const int at = (c / kSkinnyCols) * kRedStride + c % kSkinnyCols;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kSkinnyWarps; ++w) sum += red[w][at];
      if (n < N) {
        if (partial == nullptr)
          out[static_cast<size_t>(m) * N + n] = __float2bfloat16(sum);
        else
          partial[(static_cast<size_t>(blockIdx.y) * M + m) * N + n] = sum;
      }
    }
  }
}

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

template <int MT>
void launch_skinny(const __nv_bfloat16* x, const int8_t* q, const float* scale,
                   float* partial, __nv_bfloat16* out, int M, int K, int N,
                   int rows_per_group, int k_splits, cudaStream_t stream) {
  const int k_per_split = (K + k_splits - 1) / k_splits;
  const dim3 grid((N + kSkinnyBlockN - 1) / kSkinnyBlockN, k_splits);
  qmm_skinny_kernel<MT><<<grid, kSkinnyThreads, 0, stream>>>(
      x, q, scale, k_splits > 1 ? partial : nullptr, out, M, K, N,
      rows_per_group, k_per_split);
}

}  // namespace

// Returns the CUDA error code of the launches (0 on success).  `partial`
// is fp32 [k_splits, M, N] scratch, used only when k_splits > 1; `rows`
// (64, 128 or 256) is the tiled path's x rows a block (M > 8).
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
  if (M <= kSkinnyMaxM) {
    if (k_splits > 1 && pb == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (M <= 1) launch_skinny<1>(xb, qb, sb, pb, ob, M, K, N, rows_per_group, k_splits, s);
    else if (M <= 2) launch_skinny<2>(xb, qb, sb, pb, ob, M, K, N, rows_per_group, k_splits, s);
    else if (M <= 4) launch_skinny<4>(xb, qb, sb, pb, ob, M, K, N, rows_per_group, k_splits, s);
    else launch_skinny<8>(xb, qb, sb, pb, ob, M, K, N, rows_per_group, k_splits, s);
    if (k_splits > 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      const int mn = M * N;
      const int blocks = std::min((mn + 255) / 256, 4096);
      qmm_reduce_kernel<<<blocks, 256, 0, s>>>(pb, ob, k_splits, mn);
    }
  } else {
    if (k_splits > 1 && pb == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 64) return launch_tiled<64>(xb, qb, sb, pb, ob, M, K, N, rows_per_group, k_splits, s);
    if (rows == 128)
      return launch_tiled<128>(xb, qb, sb, pb, ob, M, K, N, rows_per_group, k_splits, s);
    if (rows == 256)
      return launch_tiled<256>(xb, qb, sb, pb, ob, M, K, N, rows_per_group, k_splits, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
