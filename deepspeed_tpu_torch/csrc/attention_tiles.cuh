// Tile helpers shared by the port's attention kernels (flash_attention.cu,
// evoformer_attn.cu, block_sparse_attention.cu): conversions between fp32
// and the operand type, and the two products of a flash-attention step on
// mma.m16n8k16 fragments (csrc/mma.cuh).  T is the operand type, bf16 or
// fp16 (to_f / from_f also take float).
//
// Fragment layout of an m16n8 accumulator tile: acc[j][0..1] = row g,
// columns 8j + 2t + {0, 1}; acc[j][2..3] = row g + 8 (g = lane / 4,
// t = lane % 4).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(v);
  } else if constexpr (std::is_same<T, __half>::value) {
    return __half2float(v);
  } else {
    return v;
  }
}

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(v);
  } else if constexpr (std::is_same<T, __half>::value) {
    return __float2half_rn(v);
  } else {
    return v;
  }
}

// acc[N/8][4] += A[16 x K] B[N x K]^T, both in shared memory, row-major with
// row stride LD (elements): A is the warp's 16 rows.
template <typename T, int K, int N, int LD>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const T* a,
                                        const T* b, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * LD + k0 + (lane / 16) * 8);
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (n0 + (lane / 16) * 8 + lane % 8) * LD + k0 + ((lane / 8) % 2) * 8);
      mma16816<T>(acc[n0 / 8], af, bf[0], bf[1]);
      mma16816<T>(acc[n0 / 8 + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[D/8][4] += P[16 x N] B[N x D]: P in registers as A fragments (one per 16
// columns), B in shared memory, row-major with row stride LD.
template <typename T, int N, int D, int LD>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4],
                                       const uint32_t (&pa)[N / 16][4],
                                       const T* b, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 16) {
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + d0 + (lane / 16) * 8);
      mma16816<T>(acc[d0 / 8], pa[k0 / 16], bf[0], bf[1]);
      mma16816<T>(acc[d0 / 8 + 1], pa[k0 / 16], bf[2], bf[3]);
    }
  }
}

// An m16n8 accumulator tile row block [16 x N] rounded to T as the A
// fragments of the next product.
template <typename T, int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&pa)[N / 16][4],
                                           const float (&s)[N / 8][4]) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c) {
    pa[c][0] = pack2<T>(s[2 * c][0], s[2 * c][1]);
    pa[c][1] = pack2<T>(s[2 * c][2], s[2 * c][3]);
    pa[c][2] = pack2<T>(s[2 * c + 1][0], s[2 * c + 1][1]);
    pa[c][3] = pack2<T>(s[2 * c + 1][2], s[2 * c + 1][3]);
  }
}
