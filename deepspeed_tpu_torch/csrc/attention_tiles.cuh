// Tile helpers shared by the port's attention kernels (flash_attention.cu,
// evoformer_attn.cu, block_sparse_attention.cu): conversions between fp32
// and the operand type, and a wgmma accumulator rounded to the register A
// operand of the next product.  T is the operand type, bf16 or fp16 (to_f /
// from_f also take float).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

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

// An accumulator tile [64 x N] of a warpgroup (the wgmma layout, d[4j + e])
// rounded to T as the register A operand of the next wgmma, one fragment
// per 16 columns.
template <typename T, int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
#pragma unroll
    for (int f = 0; f < 4; ++f) a[ks][f] = pack2<T>(d[8 * ks + 2 * f], d[8 * ks + 2 * f + 1]);
  }
}
