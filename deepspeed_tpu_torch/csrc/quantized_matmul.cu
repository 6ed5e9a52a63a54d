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
// * Prefill (M up to the 512-token bucket) is bound by operations.
//   `qmm_tiled_kernel` computes 128x128 output tiles with bf16 tensor-core
//   products (WMMA 16x16x16, fp32 accumulate; 8 warps of 64x32): each
//   32-row slab of int8 weights is dequantized once into shared memory and
//   reused by all 128 rows of the tile.  A 4-stage `cp.async` pipeline
//   keeps the next three k-tiles' copies in flight while the current one
//   is multiplied, so loads overlap the tensor cores; registers are held
//   to 128 a thread so that two blocks share an SM.  No TMA, no wgmma:
//   those are later work.
//
// Shapes the kernel takes (the wrapper checks them): x bf16 [M, K] and
// out bf16 [M, N] contiguous, q int8 [K, N] contiguous, scale fp32 [G],
// G | K, K % 32 == 0, N % 16 == 0.  The ragged edge in N (32000 and 11008
// are not multiples of the 512- or 128-column tiles) and in M is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

#include "mma.cuh"

namespace {

constexpr int kSkinnyMaxM = 8;
constexpr int kSkinnyWarps = 8;
constexpr int kSkinnyThreads = 32 * kSkinnyWarps;
constexpr int kSkinnyCols = 16;                     // one 16-byte load
constexpr int kSkinnyBlockN = 32 * kSkinnyCols;     // 512 columns a block
constexpr int kRedStride = kSkinnyCols + 1;         // padded: no bank conflicts
constexpr int kUnroll = 4;                          // rows in flight a thread
constexpr int kChunkRows = 256;                     // x rows staged at once

constexpr int kTileM = 128;
constexpr int kTileN = 128;
constexpr int kTileK = 32;
constexpr int kTileThreads = 256;                   // 8 warps, 64x32 each
constexpr int kStages = 4;                          // k-tiles in flight
constexpr int kRowA = kTileK + 8;                   // padded smem rows
constexpr int kRowB = kTileN + 8;
constexpr int kTileSmemA = kStages * kTileM * kRowA * 2;
constexpr int kTileSmemQ = kStages * kTileK * kTileN;
constexpr int kTileSmem = kTileSmemA + kTileSmemQ + kTileK * kRowB * 2;
static_assert(8 * 256 * 4 <= kTileSmemA, "epilogue scratch fits the x slots");

// Byte b of a 32-bit word, sign-extended, as a float.
__device__ __forceinline__ float byte_to_float(int word, int b) {
  return static_cast<float>(static_cast<signed char>(word >> (8 * b)));
}

__device__ __forceinline__ int word_of(const int4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// The skinny path's dequant runs once per weight byte, and int->float and
// float->bf16 conversion instructions issue at a fraction of the FMA rate,
// so it converts with full-rate integer and float ops instead.
//
// float(b) for byte j of `biased`, a word whose int8 bytes were XORed with
// 0x80 (b + 128 as an unsigned byte): 2^23 + (b + 128) is built by placing
// that byte under the exponent of 2^23, then 2^23 + 128 is subtracted.
// Exact for every b.
__device__ __forceinline__ float biased_byte_to_float(unsigned biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | j)) - 8388736.0f;
}

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

// Issue the copies of k-tile `kt` into pipeline slot `slot`: the x slab
// [128 x 32] bf16 (two 16-byte vectors a thread) and the raw int8 weight
// slab [32 x 128] (one vector a thread).  Rows past M and columns past N
// are zero-filled.
__device__ __forceinline__ void issue_tile(__nv_bfloat16* a_slot, int8_t* q_slot,
                                           const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ q,
                                           int m0, int n0, int kt, int M, int K, int N) {
  const int k0 = kt * kTileK;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * kTileThreads;
    const int r = v / (kTileK / 8);
    const int seg = v % (kTileK / 8);
    const bool ok = m0 + r < M;
    cp_async16(a_slot + r * kRowA + seg * 8,
               ok ? x + static_cast<size_t>(m0 + r) * K + k0 + seg * 8 : x, ok);
  }
  const int r = threadIdx.x / (kTileN / 16);
  const int seg = threadIdx.x % (kTileN / 16);
  const bool ok = n0 + seg * 16 < N;
  cp_async16(q_slot + r * kTileN + seg * 16,
             ok ? q + static_cast<size_t>(k0 + r) * N + n0 + seg * 16 : q, ok);
}

__global__ void __launch_bounds__(kTileThreads, 2)
qmm_tiled_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ q,
                 const float* __restrict__ scale,
                 __nv_bfloat16* __restrict__ out,
                 int M, int K, int N, int rows_per_group) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);         // [stages][128][40]
  int8_t* q_s = reinterpret_cast<int8_t*>(smem + kTileSmemA);          // [stages][32][128]
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem + kTileSmemA + kTileSmemQ);
  // epilogue scratch, one 16x16 fp32 tile a warp, over the x slots
  float* c_s = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  const int k_tiles = K / kTileK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < k_tiles)
      issue_tile(a_s + st * kTileM * kRowA, q_s + st * kTileK * kTileN, x, q,
                 m0, n0, st, M, K, N);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int slot = kt % kStages;
    cp_async_wait<kStages - 2>();      // this thread's copies of tile kt
    __syncthreads();                   // everyone's; and tile kt-1 is consumed
    {
      // dequantize the weight slab once, for all 128 rows of the tile
      const int r = threadIdx.x / (kTileN / 16);
      const int seg = threadIdx.x % (kTileN / 16);
      const int4 raw = *reinterpret_cast<const int4*>(
          q_s + slot * kTileK * kTileN + r * kTileN + seg * 16);
      const float sc = __ldg(scale + (kt * kTileK + r) / rows_per_group);
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(b_s + r * kRowB + seg * 16);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int word = word_of(raw, p / 2);
        dst[p] = __floats2bfloat162_rn(byte_to_float(word, 2 * (p % 2)) * sc,
                                       byte_to_float(word, 2 * (p % 2) + 1) * sc);
      }
    }
    // refill the slot tile kt-1 used: every thread is past its reads
    const int next = kt + kStages - 1;
    if (next < k_tiles)
      issue_tile(a_s + (next % kStages) * kTileM * kRowA,
                 q_s + (next % kStages) * kTileK * kTileN, x, q, m0, n0, next,
                 M, K, N);
    cp_async_commit();
    __syncthreads();                   // the bf16 weight slab is complete
    const __nv_bfloat16* a_slot = a_s + slot * kTileM * kRowA;
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], a_slot + (wm + 16 * i) * kRowA + kk, kRowA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], b_s + kk * kRowB + wn + 16 * j, kRowB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the x slots are free for the scratch

  float* scratch = c_s + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, c[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane * 8 + e;
        const int row = m0 + wm + 16 * i + idx / 16;
        const int col = n0 + wn + 16 * j + idx % 16;
        if (row < M && col < N)
          out[static_cast<size_t>(row) * N + col] = __float2bfloat16(scratch[idx]);
      }
      __syncwarp();
    }
  }
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
// is fp32 [k_splits, M, N] scratch, used only when M <= 8 and k_splits > 1.
extern "C" int dstt_quantized_matmul_bf16(const void* x, const void* q,
                                          const void* scale, void* partial,
                                          void* out, int M, int K, int N,
                                          int groups, int k_splits,
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
    const cudaError_t err = cudaFuncSetAttribute(
        qmm_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
    qmm_tiled_kernel<<<grid, kTileThreads, kTileSmem, s>>>(xb, qb, sb, ob, M, K, N,
                                                           rows_per_group);
  }
  return static_cast<int>(cudaGetLastError());
}
