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
// exact in any order, the scale is an IEEE division, and q is the IEEE
// quotient rounded half to even (`Io::quant`: a product by the rounded
// reciprocal decides every value not within 1.2e-4 of a half-integer, the
// rest are divided; this file is built without fast math).
//
// What bounds it on the H100: bytes.  It reads x once and writes q and the
// scales: a 4096 x 11008 bf16 projection moves 90 + 45 MB, ~0.040 ms at
// 3.35 TB/s.  A group's quantization needs its maximum, so every value is
// needed twice, before and after the group's reduction; the design holds
// each value on chip between the two and keeps device memory busy while
// it computes, in one launch with no memset:
//
// * x is cut into pieces of `piece` 16-byte vectors: whole groups (route
//   "block", 16 KB at most: the 128-value groups, odd sizes) or a part of
//   one group (route "group", 32 KB at most: the row-block groups weight
//   quantization makes, 64 a matrix, 0.5-4 MB of bf16 each, `parts`
//   pieces a group);
// * a persistent grid of co-resident blocks walks the pieces (block b takes
//   b, b + grid, ...) through a ring of `nbuf` buffers of shared memory,
//   each piece brought in by one bulk copy of the TMA engine while the
//   block still works on the ones before it;
// * a vector's |x| maximum is taken on bf16 / fp16 pairs (exact: the
//   maximum is one of the values); q is read from the bits of
//   fma(x, 1 / s, 768) (`Io::quant`), about 8 instructions a value;
// * route "block": each vector's |x| maximum is reduced across the lanes
//   that share its group (a warp shuffle when the group's vectors fill
//   whole warps or divide one); a group within a warp (the 128-value
//   groups) is then scaled and quantized from registers, one read of the
//   piece; larger ones combine in a shared-memory slot a group (atomicMax
//   on the float's bits: for values >= 0 the bit patterns order as the
//   floats do) and are read again;
// * route "group": a piece's maximum goes into its group's word in global
//   memory, the piece arrives on the group's counter, and the last part to
//   arrive publishes the group's maximum under the launch's tag and zeroes
//   the maximum and the counter for the next launch (4 ints a group,
//   allocated once per device by the wrapper).  A piece is quantized one
//   iteration after it arrives, while the block reduces the next one and a
//   ninth warp, which touches no data, meets the group words (`nbuf` = 3:
//   a piece quantized, one reduced, one loading), so the waits overlap
//   work.  A group's parts are consecutive pieces, at most one grid of
//   them, and the whole grid is resident (a cooperative launch), so the
//   lowest unfinished group always completes;
// * q is written with streaming stores (8 bytes a bf16 / fp16 vector, 4 an
//   fp32 one), which leave L2 to the reads.
//
// The wrapper's `quantize_plan` (ops/quantizer.py) picks the route, the
// piece, the buffers and the grid; the launcher checks that the plan covers
// the groups, fits the card and that every group's parts are resident at
// once.  Groups whose size is a multiple of 16 bytes of x take 16-byte
// vectors; others one value a "vector", read twice from global memory
// (`nbuf` = 0, the second read from L2), as are groups of more pieces than
// a grid holds (lm_head's 16 MB groups at 16 a matrix), cut into one grid
// of larger pieces.  NaN is outside the contract (fmaxf drops it where the
// plain version's amax would propagate it).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;                // the threads that read and quantize x
constexpr int kWarps = kThreads / 32;
constexpr int kSync = kThreads;              // a ninth warp's first thread: the group words
constexpr int kBlock = kThreads + 32;
constexpr unsigned kFull = 0xffffffffu;
// q from y = x r (r = 1 / s rounded once): g = fma(x, r, 768) holds y to
// 2^-14 (g in [512, 1024): its low 14 mantissa bits are y's fraction), and
// |x r - x / s| <= 127 x 2^-24 is 0.12 of that unit, so a g whose fraction
// is not within one unit of 1/2 lies on the same side of the half-integer
// as x / s: rint(x / s) = floor(g - 768 + 1/2), read from g's bits; the
// others (about 1e-4 of the values) are divided
constexpr float kFrac = 768.f;
constexpr int kFracBits = 0x44400000;        // the bits of 768.f
constexpr int kHalf = 1 << 13;               // 1/2 in units of 2^-14

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

__device__ __forceinline__ int8_t quant1(float x, float scale) {
  const float v = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
}

__device__ __forceinline__ float scale_of(float absmax) {
  return absmax > 0.f ? __fdiv_rn(absmax, 127.f) : 1.f;
}

// 1 / s rounded once where the product path holds (s normal, 1 / s
// finite), else 0: that group's values are all divided
__device__ __forceinline__ float rcp_of(float s) {
  const float r = __frcp_rn(s);
  return s >= 1.17549435e-38f && r <= 3.0e38f ? r : 0.f;
}

// What a thread loads at once: a 16-byte vector of T (VEC) or one T.
template <typename T, bool VEC>
struct Io {
  using L = typename std::conditional<VEC, int4, T>::type;
  static constexpr int kV = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;

  // max |x| over the vector: bf16 / fp16 pairs at once (exact: the max is
  // one of the values)
  static __device__ __forceinline__ float amax(const L& v) {
    if constexpr (VEC && std::is_same<T, __nv_bfloat16>::value) {
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
      __nv_bfloat162 m = __habs2(e[0]);
#pragma unroll
      for (int i = 1; i < 4; ++i) m = __hmax2(m, __habs2(e[i]));
      return fmaxf(__low2float(m), __high2float(m));
    } else if constexpr (VEC && std::is_same<T, __half>::value) {
      const __half2* e = reinterpret_cast<const __half2*>(&v);
      __half2 m = __habs2(e[0]);
#pragma unroll
      for (int i = 1; i < 4; ++i) m = __hmax2(m, __habs2(e[i]));
      return fmaxf(__low2float(m), __high2float(m));
    } else if constexpr (VEC) {
      const float* e = reinterpret_cast<const float*>(&v);
      return fmaxf(fmaxf(fabsf(e[0]), fabsf(e[1])), fmaxf(fabsf(e[2]), fabsf(e[3])));
    } else {
      return fabsf(to_f(v));
    }
  }

  // q of the kV values of v at dst (kV bytes, kV-aligned), scale s and
  // r = rcp_of(s)
  static __device__ __forceinline__ void quant(const L& v, float s, float r, int8_t* dst) {
    const T* e = reinterpret_cast<const T*>(&v);
    uint32_t out[(kV + 3) / 4] = {};
    bool near = r == 0.f;
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int t = __float_as_int(fmaf(to_f(e[i]), r, kFrac)) + (kHalf - kFracBits);
      near |= static_cast<unsigned>(((t + 1) & (2 * kHalf - 1))) <= 2u;
      out[i / 4] |= (static_cast<uint32_t>(t >> 14) & 0xffu) << (8 * (i % 4));
    }
    if (near) {                        // rare: divide
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const uint32_t b = static_cast<uint8_t>(quant1(to_f(e[i]), s));
        out[i / 4] = (out[i / 4] & ~(0xffu << (8 * (i % 4)))) | (b << (8 * (i % 4)));
      }
    }
    if constexpr (kV == 8) {
      __stcs(reinterpret_cast<uint2*>(dst), make_uint2(out[0], out[1]));
    } else if constexpr (kV == 4) {
      __stcs(reinterpret_cast<unsigned int*>(dst), out[0]);
    } else {
      *dst = static_cast<int8_t>(out[0]);
    }
  }
};

// `bytes` (a multiple of 16) global -> shared by the TMA engine, complete
// on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A piece's arrival on its group's words w (thread 0 of its block): its
// maximum into w[0], one more on w[1] (the count before it returned);
// `arrived` then lets the last part to arrive publish (tag, the group's
// maximum) in w[2..3] and zero w[0..1] for the next launch.  (The launch's
// tag tells this launch's word from a stale one.)  The two halves let the
// thread work while the count comes back.
__device__ __forceinline__ int arrive(int* w, float m) {
  int old;
  asm volatile("red.relaxed.gpu.global.max.s32 [%0], %1;\n" ::"l"(w), "r"(__float_as_int(m))
               : "memory");
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(w + 1)
               : "memory");
  return old;
}

__device__ __forceinline__ void arrived(int* w, int old, int parts, int tag) {
  if (old == parts - 1) {
    int mx;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(mx) : "l"(w) : "memory");
    w[0] = 0;
    w[1] = 0;
    const unsigned long long word =
        static_cast<unsigned long long>(static_cast<unsigned>(mx)) << 32 | static_cast<unsigned>(tag);
    asm volatile("st.release.gpu.global.b64 [%0], %1;\n" ::"l"(w + 2), "l"(word) : "memory");
  }
}

// The group's maximum once every part has arrived (one thread of a block).
__device__ __forceinline__ float await_group(const int* w, int tag) {
  unsigned long long word;
  while (true) {
    asm volatile("ld.acquire.gpu.global.b64 %0, [%1];\n" : "=l"(word) : "l"(w + 2) : "memory");
    if (static_cast<int>(word & 0xffffffffu) == tag) break;
    __nanosleep(32);
  }
  return __int_as_float(static_cast<int>(word >> 32));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  return m;
}

// The launch plan (ops/quantizer.py `quantize_plan`), in vectors.
struct Plan {
  long long groups, gl;     // groups, vectors a group
  long long piece;          // vectors a piece (route "group": a part of a group)
  long long n_pieces;
  int gpp;                  // whole groups a piece (route "block"), else 0
  int parts;                // pieces a group (route "group"), else 1
  int nbuf;                 // staged pieces a block holds (0: read twice)
  int tag;                  // this launch's tag for the group words
};

constexpr int kMaxBuf = 6;                   // pieces a block holds at most

// Every block walks pieces blockIdx.x, + gridDim.x, ... through a ring of
// nbuf buffers in dynamic shared memory (one bulk copy a piece, one
// mbarrier a buffer), `ahead` pieces loading while one is reduced and
// quantized; route "group" with parts > 1 quantizes each piece one
// iteration after it is reduced and arrives (`defer`: nbuf >= 3, one more
// buffer held, or 0: read from global memory twice, the second time from
// L2), its ninth warp meeting the group words meanwhile.  After the ring (route "block"): the pieces' groups'
// maxima (as int bits), scales and reciprocals.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kBlock, 3)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
             int* __restrict__ words, const Plan p) {
  using IO = Io<T, VEC>;
  using L = typename IO::L;
  extern __shared__ int4 smem[];
  __shared__ float warp_s[kWarps];
  __shared__ float group_s;
  __shared__ uint64_t full[kMaxBuf];
  int* amax_s = reinterpret_cast<int*>(smem + p.nbuf * p.piece);
  float* scale_s = reinterpret_cast<float*>(amax_s + p.gpp);
  float* rcp_s = scale_s + p.gpp;
  const int tid = threadIdx.x, lane = tid & 31;
  const bool data = tid < kThreads;            // the ninth warp only meets the group words
  const L* xv = reinterpret_cast<const L*>(x);
  const bool staged = VEC && p.nbuf > 0;
  const bool defer = p.parts > 1;
  const int ahead = staged ? p.nbuf - 1 - (defer ? 1 : 0) : 0;

  // piece pc: its first vector, its vectors, its (first) group
  auto range = [&](long long pc, long long& v0, long long& nv, long long& g) {
    if (p.gpp > 0) {
      g = pc * p.gpp;
      v0 = g * p.gl;
      nv = min(static_cast<long long>(p.gpp), p.groups - g) * p.gl;
    } else {
      g = pc / p.parts;
      const long long s0 = (pc - g * p.parts) * p.piece;
      v0 = g * p.gl + s0;
      nv = max(0LL, min(p.piece, p.gl - s0));
    }
  };
  auto piece_of = [&](int k) { return blockIdx.x + static_cast<long long>(k) * gridDim.x; };
  auto issue = [&](int k) {                    // this block's k-th piece into its buffer
    const long long pc = piece_of(k);
    if (staged && pc < p.n_pieces && tid == 0) {
      long long v0, nv, g;
      range(pc, v0, nv, g);
      const int slot = k % p.nbuf;
      mbar_arrive_expect_tx(&full[slot], static_cast<uint32_t>(nv * 16));
      bulk_load(smem + slot * p.piece, xv + v0, static_cast<uint32_t>(nv * 16), &full[slot]);
    }
  };
  // the vectors of this block's k-th piece: staged, or in global memory
  auto src_of = [&](int k, long long v0) -> const L* {
    return staged ? reinterpret_cast<const L*>(smem + (k % p.nbuf) * p.piece) : xv + v0;
  };
  // quantize this block's k-th piece of route "group" by its group's maximum
  auto quantize_group = [&](int k, float m) {
    long long v0, nv, g;
    const long long pc = piece_of(k);
    range(pc, v0, nv, g);
    const L* src = src_of(k, v0);
    const float s = scale_of(m), r = rcp_of(s);
    if (tid == 0 && pc == g * p.parts) scale[g] = s;
#pragma unroll 4
    for (long long i = tid; i < nv; i += kThreads) IO::quant(src[i], s, r, q + (v0 + i) * IO::kV);
  };

  if (staged && tid == 0) {
    for (int b = 0; b < p.nbuf; ++b) mbar_init(&full[b], 1);
    mbar_fence_init();
  }
  __syncthreads();
  for (int k = 0; k < ahead; ++k) issue(k);
  int k = 0;
  for (long long pc = blockIdx.x; pc < p.n_pieces; pc += gridDim.x, ++k) {
    // the buffer of piece k + ahead was freed by the piece quantized last
    if (staged) {
      issue(k + ahead);
      mbar_wait(&full[k % p.nbuf], (k / p.nbuf) & 1);
    }
    long long v0, nv, g;
    range(pc, v0, nv, g);
    const L* src = src_of(k, v0);

    if (p.gpp > 0 && 32 % p.gl == 0) {        // route "block", groups of gl | 32 vectors
      if (data) {
      // a group's vectors are gl consecutive lanes of one warp: the
      // maximum is reduced in registers, its first lane computes scale and
      // reciprocal for the others, and each vector is quantized from the
      // registers it was read into
      const int gl = static_cast<int>(p.gl), sh = __ffs(gl) - 1;
      for (long long b = 0; b < nv; b += kThreads) {
        const long long i = b + tid;
        const L v = i < nv ? src[i] : L{};
        float m = i < nv ? IO::amax(v) : 0.f;
        for (int o = 1; o < gl; o <<= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
        float s = 0.f, r = 0.f;
        if ((lane & (gl - 1)) == 0) {
          s = scale_of(m);
          r = rcp_of(s);
          if (i < nv) scale[g + (i >> sh)] = s;
        }
        s = __shfl_sync(kFull, s, lane & ~(gl - 1));
        r = __shfl_sync(kFull, r, lane & ~(gl - 1));
        if (i < nv) IO::quant(v, s, r, q + (v0 + i) * IO::kV);
      }
      }
    } else if (p.gpp > 0) {                   // route "block": whole groups
      const int ng = static_cast<int>(nv / p.gl), gl = static_cast<int>(p.gl);
      const int sh = (gl & (gl - 1)) == 0 ? __ffs(gl) - 1 : -1;
      auto group_of = [&](long long i) {
        return sh >= 0 ? static_cast<int>(i >> sh) : static_cast<int>(i / gl);
      };
      if (data)
        for (int j = tid; j < ng; j += kThreads) amax_s[j] = 0;
      __syncthreads();
      // lanes that share a group: a whole warp (gl a multiple of 32), an
      // aligned run of gl lanes (gl divides 32), or one lane
      const int seg = gl % 32 == 0 ? 32 : 32 % gl == 0 ? gl : 1;
      for (long long b = 0; data && b < nv; b += kThreads) {
        const long long i = b + tid;
        float m = i < nv ? IO::amax(src[i]) : 0.f;
        for (int o = 1; o < seg; o <<= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
        if (i < nv && lane % seg == 0) atomicMax(&amax_s[group_of(i)], __float_as_int(m));
      }
      __syncthreads();
      for (int j = tid; data && j < ng; j += kThreads) {
        const float s = scale_of(__int_as_float(amax_s[j]));
        scale_s[j] = s;
        rcp_s[j] = rcp_of(s);
        scale[g + j] = s;
      }
      __syncthreads();
      int8_t* qv = q + v0 * IO::kV;
      for (long long i = tid; data && i < nv; i += kThreads) {
        const int j = group_of(i);
        IO::quant(src[i], scale_s[j], rcp_s[j], qv + i * IO::kV);
      }
    } else {                                  // route "group": a part of one group
      if (data) {
        float m = 0.f;
#pragma unroll 4
        for (long long i = tid; i < nv; i += kThreads) m = fmaxf(m, IO::amax(src[i]));
        m = warp_max(m);
        if (lane == 0) warp_s[tid >> 5] = m;
      } else if (defer && k > 0 && tid == kSync) {   // the deferred piece's group
        group_s = await_group(words + 4 * (piece_of(k - 1) / p.parts), p.tag);
      }
      __syncthreads();                        // warp_s (and group_s) in
      float mine = warp_s[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mine = fmaxf(mine, warp_s[w]);
      if (!defer) {
        if (data) quantize_group(k, mine);
      } else if (tid == kSync) {              // arrive while the data warps quantize
        int* w = words + 4 * g;
        arrived(w, arrive(w, mine), p.parts, p.tag);
      } else if (data && k > 0) {
        quantize_group(k - 1, group_s);
      }
    }
    __syncthreads();                          // this piece's buffer (or the deferred one's) free
  }
  if (defer && k > 0) {                       // the last piece, deferred
    if (tid == kSync) group_s = await_group(words + 4 * (piece_of(k - 1) / p.parts), p.tag);
    __syncthreads();
    if (data) quantize_group(k - 1, group_s);
  }
}

template <typename T, bool VEC>
cudaError_t occupancy(int smem, int* blocks_per_sm) {
  auto kernel = quant_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    if (cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
      return e;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kBlock, smem);
}

template <typename T, bool VEC>
int launch(const void* x, void* q, void* scale, int* words, const Plan& p, long long grid,
           cudaStream_t stream) {
  // the plan covers every group and fits the kernel
  const bool block = p.gpp > 0;
  if (p.piece < 1 || p.nbuf < 0 || p.nbuf > kMaxBuf || (!VEC && p.nbuf > 0) || grid < 1 ||
      grid > p.n_pieces || p.n_pieces > 0x7fffffffLL ||
      (block && (p.parts != 1 || p.gpp * p.gl > p.piece ||
                 p.n_pieces * p.gpp < p.groups || (p.n_pieces - 1) * p.gpp >= p.groups)) ||
      (!block && (p.parts < 1 || p.piece * p.parts < p.gl || p.n_pieces != p.groups * p.parts ||
                  (p.parts > 1 && (words == nullptr || p.parts > grid || p.nbuf == 1 ||
                                   p.nbuf == 2 ||
                                   (reinterpret_cast<uintptr_t>(words) & 15) != 0)))))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem_ll = p.nbuf * p.piece * 16 + (block ? 12LL * p.gpp : 0);
  if (smem_ll > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_ll);
  // the occupancy of the last (device, shared memory) asked, kept
  static int last_dev = -1, last_smem = -1, per_sm = 0, sms = 0;
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  if (dev != last_dev || smem != last_smem) {
    if (cudaError_t e = occupancy<T, VEC>(smem, &per_sm)) return static_cast<int>(e);
    if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      return static_cast<int>(e);
    last_dev = dev;
    last_smem = smem;
  }
  // a group's parts wait on each other: every block of the grid resident
  if (p.parts > 1 && grid > static_cast<long long>(per_sm) * sms)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = p.parts > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, quant_kernel<T, VEC>, static_cast<const T*>(x),
                                           static_cast<int8_t*>(q), static_cast<float*>(scale),
                                           words, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int run(const void* x, void* q, void* scale, int* words, long long groups, long long n, int vec,
        long long piece, long long n_pieces, int gpp, int parts, int nbuf, long long grid,
        int tag, cudaStream_t stream) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  if (groups < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the vector path needs every group to start on 16 bytes of x (the base
  // is checked by the wrapper)
  if (vec == kV && n % kV == 0)
    return launch<T, true>(x, q, scale, words,
                           Plan{groups, n / kV, piece, n_pieces, gpp, parts, nbuf, tag}, grid,
                           stream);
  if (vec == 1)
    return launch<T, false>(x, q, scale, words,
                            Plan{groups, n, piece, n_pieces, gpp, parts, nbuf, tag}, grid, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16.  x [groups, n] contiguous, 16-byte
// aligned; q int8 [groups, n]; scale fp32 [groups]; words int32 [4 groups]
// (or more), 16-byte aligned, whose first two of four a group are zero and
// are left zero, and whose last two never hold this launch's tag (> 0)
// before it (may be null when parts is 1).  The launch plan
// (ops/quantizer.py `quantize_plan`): vec, the values of a vector (16 /
// element bytes, or 1); piece, vectors a piece; n_pieces; gpp, whole
// groups a piece (route "block"), or 0 and parts, pieces a group (route
// "group"); nbuf, pieces a block stages (0: none; 3 with parts > 1: each
// piece quantized an iteration after it arrives); grid, the blocks.
// Return: the CUDA error code (0 ok).
extern "C" int dstt_quantize_int8(int dtype, const void* x, void* q, void* scale, int* words,
                                  long long groups, long long n, int vec, long long piece,
                                  long long n_pieces, int gpp, int parts, int nbuf,
                                  long long grid, int tag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tag <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return run<float>(x, q, scale, words, groups, n, vec, piece, n_pieces, gpp, parts, nbuf, grid,
                      tag, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, q, scale, words, groups, n, vec, piece, n_pieces, gpp, parts,
                              nbuf, grid, tag, s);
  if (dtype == 2)
    return run<__half>(x, q, scale, words, groups, n, vec, piece, n_pieces, gpp, parts, nbuf,
                       grid, tag, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks of the kernel for (dtype, vec) with `smem` bytes of dynamic
// shared memory that one SM of the current device holds at once (the
// runtime's occupancy query), in *blocks.
extern "C" int dstt_quantize_resident(int dtype, int vec, int smem, int* blocks) {
  *blocks = 0;
  if (smem < 0 || smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return vec > 1 ? occupancy<float, true>(smem, blocks)
                                 : occupancy<float, false>(smem, blocks);
  if (dtype == 1) return vec > 1 ? occupancy<__nv_bfloat16, true>(smem, blocks)
                                 : occupancy<__nv_bfloat16, false>(smem, blocks);
  if (dtype == 2) return vec > 1 ? occupancy<__half, true>(smem, blocks)
                                 : occupancy<__half, false>(smem, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}
