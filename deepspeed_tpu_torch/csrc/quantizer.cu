// Symmetric int8 groupwise quantization for Hopper (sm_90a), fp32, bf16 or
// fp16 in.
//
// Replaces the TPU kernel deepspeed_tpu/ops/quantizer.py `_quantize_kernel`
// (its pallas_call is in `_quantize_kernel_call`, called by
// `quantize_pallas`).  For x viewed as [G, n] (G groups of n consecutive
// values):
//
//   absmax[g] = max_i |x[g, i]|
//   scale[g]  = absmax[g] > 0 ? absmax[g] / 127 : 1
//   q[g, i]   = clamp(rint(x[g, i] / scale[g]), -127, 127)   (int8)
//
// in fp32, bit for bit what the plain version (ops/quantizer.py
// `quantize_plain`) and the JAX package's `quantize` give: the maximum is
// exact in any order, both divisions are IEEE divisions (no reciprocal:
// this file is built without fast math), and rintf rounds half to even as
// round() does there.
//
// What bounds it on the H100: bytes.  It reads x once and writes q and the
// scales: a 4096 x 11008 bf16 projection moves 90 + 45 MB, ~0.040 ms at
// 3.35 TB/s.  The TPU kernel gives each block of up to 32 groups to one grid
// step; the groups that weight quantization makes are blocks of rows
// (runtime/weight_quantizer.py), 64 of them for a whole matrix, so one block
// a group would put 64 blocks on 132 SMs.  Here a group is cut into chunks of
// 16384 values, one block of 256 threads a chunk, read with 16-byte loads:
//
// * pass 1 (`absmax_kernel`): each block reduces its chunk's |x| in
//   registers and a warp shuffle, and combines it into absmax[g] with an
//   atomicMax on the float's bits (for values >= 0 the bit patterns order as
//   the floats do); the wrapper's scratch is zeroed first;
// * pass 2 (`quant_kernel`): each block computes its group's scale from
//   absmax[g] and writes q for its chunk, 8 or 4 bytes a thread; the first
//   block of a group writes the scale.
//
// So one call is a memset and two launches, and x is read twice: above the
// L2's 50 MB the second read comes from device memory again, which puts the
// kernel at ~1.5x its bound for a large matrix.  Keeping a chunk in shared
// memory across a grid-wide barrier would read it once; that is later work.
//
// Groups whose size is a multiple of 16 bytes of x take the vector path;
// others a scalar one.  NaN is outside the contract (fmaxf drops it where the
// plain version's amax would propagate it).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 16384;          // values of a group per block

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(v);
  } else {
    return __half2float(v);
  }
}

__device__ __forceinline__ float block_max(float m) {
  __shared__ float part[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  return m;
}

__device__ __forceinline__ int8_t quant1(float x, float scale) {
  const float v = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
}

// Values of T in one 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec_n() { return 16 / static_cast<int>(sizeof(T)); }

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, float* __restrict__ absmax, long long n) {
  const long long g = blockIdx.x;
  const long long begin = blockIdx.y * kChunk;
  const long long end = min(begin + kChunk, n);
  const T* xg = x + g * n;
  float m = 0.f;
  if constexpr (VEC) {
    constexpr int kV = vec_n<T>();
    for (long long i = begin + threadIdx.x * kV; i < end; i += kThreads * kV) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(xg + i));
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kV; ++e) m = fmaxf(m, fabsf(to_f(v[e])));
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads)
      m = fmaxf(m, fabsf(to_f(xg[i])));
  }
  m = block_max(m);
  if (threadIdx.x == 0)
    atomicMax(reinterpret_cast<int*>(absmax + g), __float_as_int(m));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, const float* __restrict__ absmax,
             int8_t* __restrict__ q, float* __restrict__ scale, long long n) {
  const long long g = blockIdx.x;
  const long long begin = blockIdx.y * kChunk;
  const long long end = min(begin + kChunk, n);
  const float am = absmax[g];
  const float s = am > 0.f ? __fdiv_rn(am, 127.f) : 1.f;
  if (blockIdx.y == 0 && threadIdx.x == 0) scale[g] = s;
  const T* xg = x + g * n;
  int8_t* qg = q + g * n;
  if constexpr (VEC) {
    constexpr int kV = vec_n<T>();
    for (long long i = begin + threadIdx.x * kV; i < end; i += kThreads * kV) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(xg + i));
      const T* v = reinterpret_cast<const T*>(&raw);
      alignas(8) int8_t out[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e) out[e] = quant1(to_f(v[e]), s);
      if constexpr (kV == 8) {
        *reinterpret_cast<uint2*>(qg + i) = *reinterpret_cast<const uint2*>(out);
      } else {
        *reinterpret_cast<uint32_t*>(qg + i) = *reinterpret_cast<const uint32_t*>(out);
      }
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads)
      qg[i] = quant1(to_f(xg[i]), s);
  }
}

template <typename T>
int run(const void* x, void* q, void* scale, void* absmax, long long groups,
        long long n, cudaStream_t stream) {
  const long long chunks = (n + kChunk - 1) / kChunk;
  if (groups > 0x7fffffffLL || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t e = cudaMemsetAsync(absmax, 0, groups * sizeof(float), stream))
    return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(chunks));
  const T* xt = static_cast<const T*>(x);
  float* am = static_cast<float*>(absmax);
  // the vector path needs every group to start on 16 bytes of x (the base is
  // checked by the wrapper) and its q on a vector's worth of bytes
  if (n % vec_n<T>() == 0) {
    absmax_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, am, n);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    quant_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xt, am, static_cast<int8_t*>(q), static_cast<float*>(scale), n);
  } else {
    absmax_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, am, n);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    quant_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xt, am, static_cast<int8_t*>(q), static_cast<float*>(scale), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16.  x [groups, n] contiguous, 16-byte
// aligned; q int8 [groups, n]; scale and absmax (scratch) fp32 [groups].
// Return: the CUDA error code (0 ok).
extern "C" int dstt_quantize_int8(int dtype, const void* x, void* q, void* scale,
                                  void* absmax, long long groups, long long n,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, q, scale, absmax, groups, n, s);
  if (dtype == 1) return run<__nv_bfloat16>(x, q, scale, absmax, groups, n, s);
  if (dtype == 2) return run<__half>(x, q, scale, absmax, groups, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
