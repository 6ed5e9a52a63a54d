// Evoformer attention forward for Hopper (sm_90a): flash attention with
// broadcast additive biases, fp32 accumulators.  Two kernels:
//
// * evo_fwd_kernel, the tensor-core kernel: Q/K/V bf16 or fp16, D a multiple
//   of 8 up to 128, at most two biases of the input type;
// * evo_fwd_simt_kernel, the general kernel: Q/K/V fp32, bf16 or fp16, any D
//   up to 256, up to kMaxBiases biases, products in fp32 on the CUDA cores.
//
// Between them they take every input of the TPU kernel's domain that fits
// those limits (fp32 and any number of biases included), so
// ops/evoformer_attn.py never sends a CUDA tensor to the dense version.
//
// Replaces the TPU kernel deepspeed_tpu/ops/evoformer_attn.py `_evo_kernel`
// (its pallas_call is in `_evo_kernel_call`), the forward of
// `DS4Sci_EvoformerAttention`.  For one lead slice l (the flattened leading
// dims of Q [*, S, H, D]), head h and query row r:
//
//   s[c] = (q[l, r, h] . k[l, c, h]) * D^-1/2 + sum_i b_i[l, h, r, c]
//   o[l, r, h] = sum_c softmax(s)[c] v[l, c, h]
//
// in fp32 with the TPU kernel's online softmax; P is rounded to the input
// type before its product with V, as the TPU kernel rounds it
// (evoformer_attn.py:95; no rounding for fp32).  The backward is the dense
// recompute in torch math (ops/evoformer_attn.py), as it is XLA in the JAX
// package.
//
// Biases are broadcast views, never materialized, each of its own type
// (fp32, bf16 or fp16): a pointer, a small int64 table lead_off[l] (the
// element offset of lead slice l, 0 for every l of a dimension the bias
// broadcasts over; the counterpart of `_bias_lead_index`) and its strides
// over (h, r, c), 0 on a broadcast dimension.  OpenFold's two patterns are
// the MSA mask bias [B, N, 1, 1, S] (strides 0, 0, 1) and the pair bias
// [B, 1, H, S, S], shared by every row of the MSA (lead_off the same for all
// N).  Bias values are read straight from global memory at the thread's own
// score positions: the mask is one row a slice and the pair bias (0.5 MB at
// crop 256) is read by every lead slice, so both stay in L2.
//
// A row whose keys are all masked: with OpenFold's finite mask bias (-1e9
// in fp32 or bf16) every score of such a row is -1e9 rounded in fp32, the
// row's maximum is that value and its softmax is uniform: the mean of v,
// which is what the dense softmax gives.  fp16 cannot hold -1e9: an fp16
// mask bias of -1e9 is -inf, as is any -inf bias, and a row whose scores are
// all -inf comes out as zeros here (the TPU kernel's `safe_l` rule) where
// the dense softmax gives NaN.  Only keys past Sk (the ragged edge of the
// last k tile) are dropped on purpose (-inf).
//
// Design of the tensor-core kernel: one block of 4 warps per (lead slice,
// head, 64 query rows), 16 rows a warp, a loop over 64-key tiles staged in
// shared memory with 16-byte loads, products by mma.sync.m16n8k16
// (csrc/mma.cuh), the online softmax in registers (each row held by a quad
// of lanes).  D is padded with zeros in shared memory to the instantiated
// width DP (16, 32, 64 or 128: the mma depth is 16), so D = 8 and 16 run at
// DP = 16; the padding columns are never written out.
//
// Design of the general kernel: one block of 8 warps per (lead slice, head,
// 32 query rows), 4 rows a warp, a loop over 32-key tiles staged in shared
// memory as fp32 (one key a lane: the lane's scores are dot products over D
// from shared memory, its K row at an odd stride so the 32 lanes hit 32
// banks, each K value read once for the warp's 4 rows), the warp's max and
// sum by shuffles, and P V with each lane holding the output columns lane,
// lane + 32, ..., each V value read once for the 4 rows.  It is the simple
// kernel, kept for what the tensor-core one does not take.
//
// What bounds it on the H100: at OpenFold's shapes (S 256, D 32, 4-8 heads)
// the bytes, q, k, v, o and the biases read once: triangle attention at
// crop 256 moves ~68 MB (0.020 ms at 3.35 TB/s) for ~8.6 GFLOP (0.009 ms at
// 989 TFLOP/s).  With D = 32 each score costs 2 * 32 flops of mma against
// ~10 instructions of scale, bias, exp and sum, so the scalar softmax work
// (not the tensor cores, not the bytes) is what these blocks spend their
// time on; without a load pipeline the warps also wait on each tile.  The
// kernel is expected at a fraction of its bound.  In fp32 the same work is
// bound by the operations at 67 TFLOP/s outside the tensor cores (~0.13 ms
// at the triangle shape), and the general kernel's shared-memory reads (two
// a multiply-add) keep it well below that.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;             // rows of a q tile and of a k/v tile
constexpr float kNegInf = -1e30f;     // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBiases = 8;         // the general kernel's limit
constexpr int kMmaBiases = 2;         // the tensor-core kernel's limit
constexpr int kSimtWarps = 8;
constexpr int kSimtThreads = 32 * kSimtWarps;
constexpr int kSimtRowsPerWarp = 4;
constexpr int kSimtRows = kSimtWarps * kSimtRowsPerWarp;   // 32 query rows a block
constexpr int kSimtKeys = 32;                              // one key a lane
constexpr int kSimtMaxD = 256;

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

// acc[N/8][4] += A[16 x K] B[N x K]^T, both in shared memory, row stride LD.
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

// acc[D/8][4] += P[16 x N] B[N x D]: P in registers as A fragments, B in
// shared memory, row stride LD.
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

// kTile rows of one head (D values at `src + row * row_stride`) from row
// `row0` into shared memory (row stride DP + 8), 16 bytes a thread at a
// time; rows past `rows` and columns past D are 0.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride,
                                          int row0, int rows, int d) {
  constexpr int kVec = DP / 8;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < rows && c < d)
      val = *reinterpret_cast<const int4*>(src + static_cast<long long>(row0 + r) * row_stride + c);
    *reinterpret_cast<int4*>(dst + r * (DP + 8) + c) = val;
  }
}

// One additive bias as a broadcast view: element (l, h, r, c) is
// p[lead_off[l] + h * sh + r * sr + c * sc], of type `dtype` (0 bf16, 1
// fp16, 2 fp32).
struct Bias {
  const void* p;
  const long long* lead_off;
  long long sh, sr, sc;
  int dtype;
};

struct Biases {
  Bias b[kMaxBiases];
  int n;
};

__device__ __forceinline__ float bias_at(const Bias& b, long long i) {
  if (b.dtype == 2) return static_cast<const float*>(b.p)[i];
  if (b.dtype == 1) return __half2float(static_cast<const __half*>(b.p)[i]);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(b.p)[i]);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
evo_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int sq, int sk, int heads,
               int d, float scale, Biases bs) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kTile * LD;
  T* v_s = k_s + kTile * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long l = blockIdx.x;
  const int h = blockIdx.y, q0 = blockIdx.z * kTile;
  const long long row = static_cast<long long>(heads) * d;      // q/k/v/o row stride
  const T* qb = q + l * sq * row + static_cast<long long>(h) * d;
  const T* kb = k + l * sk * row + static_cast<long long>(h) * d;
  const T* vb = v + l * sk * row + static_cast<long long>(h) * d;
  // each bias's slice of this (lead slice, head): biases of the input type
  const T* bp[kMmaBiases];
  long long sr[kMmaBiases], sc[kMmaBiases];
#pragma unroll
  for (int i = 0; i < kMmaBiases; ++i) {
    bp[i] = i < bs.n ? static_cast<const T*>(bs.b[i].p) + bs.b[i].lead_off[l] + h * bs.b[i].sh
                     : nullptr;
    sr[i] = i < bs.n ? bs.b[i].sr : 0;
    sc[i] = i < bs.n ? bs.b[i].sc : 0;
  }

  load_tile<T, DP>(q_s, qb, row, q0, sq, d);

  const int r0 = q0 + warp * 16 + g;                // rows r0 and r0 + 8
  float m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_tiles = (sk + kTile - 1) / kTile;
  for (int nt = 0; nt < n_tiles; ++nt) {
    const int c0 = nt * kTile;
    __syncthreads();                                // the last tile's reads are done
    load_tile<T, DP>(k_s, kb, row, c0, sk, d);
    load_tile<T, DP>(v_s, vb, row, c0, sk, d);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt<T, DP, kTile, LD>(s, q_s + warp * 16 * LD, k_s, lane);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e >> 1) * 8;
        const int c = c0 + 8 * j + 2 * t + (e & 1);
        if (c < sk) {
          float x = s[j][e] * scale;
          // rows past Sq are computed but never written: no bias read there
          if (r < sq) {
#pragma unroll
            for (int i = 0; i < kMmaBiases; ++i)
              if (bp[i]) x += to_f(bp[i][r * sr[i] + c * sc[i]]);
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        } else {
          s[j][e] = -__int_as_float(0x7f800000);    // -inf: exp(-inf - m) = 0
        }
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(kFull, rs[i], 1);
      rs[i] += __shfl_xor_sync(kFull, rs[i], 2);
      lsum[i] = lsum[i] * corr[i] + rs[i];
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[j][0] *= corr[0]; acc[j][1] *= corr[0];
      acc[j][2] *= corr[1]; acc[j][3] *= corr[1];
    }
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      pa[c][0] = pack2<T>(s[2 * c][0], s[2 * c][1]);
      pa[c][1] = pack2<T>(s[2 * c][2], s[2 * c][3]);
      pa[c][2] = pack2<T>(s[2 * c + 1][0], s[2 * c + 1][1]);
      pa[c][3] = pack2<T>(s[2 * c + 1][2], s[2 * c + 1][3]);
    }
    mma_pb<T, kTile, DP, LD>(acc, pa, v_s, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= sq) continue;
    const float safe_l = lsum[i] == 0.f ? 1.f : lsum[i];
    T* orow = o + (l * sq + r) * row + static_cast<long long>(h) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j < d)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack2<T>(acc[j][2 * i] / safe_l, acc[j][2 * i + 1] / safe_l);
    }
  }
}

template <typename T, int DW>
__global__ void __launch_bounds__(kSimtThreads, 2)
evo_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int sq, int sk, int heads,
                    int d, float scale, Biases bs) {
  extern __shared__ __align__(16) float fsm[];
  const int ldk = d | 1;                            // odd: lane j's row in bank j
  float* q_s = fsm;                                 // [kSimtRows][d]
  float* k_s = q_s + kSimtRows * d;                 // [kSimtKeys][ldk]
  float* v_s = k_s + kSimtKeys * ldk;               // [kSimtKeys][d]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long l = blockIdx.x;
  const int h = blockIdx.y, q0 = blockIdx.z * kSimtRows;
  const long long row = static_cast<long long>(heads) * d;
  const T* qb = q + l * sq * row + static_cast<long long>(h) * d;
  const T* kb = k + l * sk * row + static_cast<long long>(h) * d;
  const T* vb = v + l * sk * row + static_cast<long long>(h) * d;
  // the biases, each with its offset of this (lead slice, head), in shared
  // memory: the bias loop below stays a loop, so 8 biases hold no registers
  __shared__ Bias sb[kMaxBiases];
  __shared__ long long boff[kMaxBiases];
#pragma unroll
  for (int i = 0; i < kMaxBiases; ++i) {
    if (threadIdx.x == i && i < bs.n) {
      sb[i] = bs.b[i];
      boff[i] = bs.b[i].lead_off[l] + h * bs.b[i].sh;
    }
  }

  for (int i = threadIdx.x; i < kSimtRows * d; i += kSimtThreads) {
    const int r = i / d, c = i % d;
    q_s[i] = q0 + r < sq ? to_f(qb[(q0 + r) * row + c]) : 0.f;
  }
  float m[kSimtRowsPerWarp], lsum[kSimtRowsPerWarp], acc[kSimtRowsPerWarp][DW];
#pragma unroll
  for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    lsum[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < DW; ++j) acc[rr][j] = 0.f;
  }

  const int lr0 = warp * kSimtRowsPerWarp;         // the warp's first row in q_s
  for (int c0 = 0; c0 < sk; c0 += kSimtKeys) {
    __syncthreads();                                // the last tile's reads are done
    for (int i = threadIdx.x; i < kSimtKeys * d; i += kSimtThreads) {
      const int j = i / d, c = i % d;
      const bool in = c0 + j < sk;
      k_s[j * ldk + c] = in ? to_f(kb[(c0 + j) * row + c]) : 0.f;
      v_s[j * d + c] = in ? to_f(vb[(c0 + j) * row + c]) : 0.f;
    }
    __syncthreads();
    const int c = c0 + lane;                        // this lane's key
    // the warp's rows' scores for this key: each K value read once for all
    // of them (the q values are broadcast reads)
    float x[kSimtRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) x[rr] = 0.f;
#pragma unroll 8
    for (int e = 0; e < d; ++e) {
      const float kv = k_s[lane * ldk + e];
#pragma unroll
      for (int rr = 0; rr < kSimtRowsPerWarp; ++rr)
        x[rr] = fmaf(q_s[(lr0 + rr) * d + e], kv, x[rr]);
    }
    float pr[kSimtRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
      const int r = q0 + lr0 + rr;
      if (c < sk) {
        x[rr] *= scale;
        if (r < sq) {                               // rows past Sq: never written
#pragma unroll 1
          for (int i = 0; i < bs.n; ++i)
            x[rr] += bias_at(sb[i], boff[i] + r * sb[i].sr + c * sb[i].sc);
        }
      } else {
        x[rr] = -__int_as_float(0x7f800000);        // -inf: keys past Sk
      }
      float mx = x[rr];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[rr], mx);
      const float corr = expf(m[rr] - m_new);
      const float p = expf(x[rr] - m_new);
      float rs = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(kFull, rs, off);
      lsum[rr] = lsum[rr] * corr + rs;
      m[rr] = m_new;
      pr[rr] = to_f(from_f<T>(p));                  // P in the input type
#pragma unroll
      for (int e = 0; e < DW; ++e) acc[rr][e] *= corr;
    }
    // P V: each V value read once for all of the warp's rows
#pragma unroll 8
    for (int j = 0; j < kSimtKeys; ++j) {
      float pj[kSimtRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) pj[rr] = __shfl_sync(kFull, pr[rr], j);
#pragma unroll
      for (int e = 0; e < DW; ++e) {
        const int col = lane + 32 * e;
        const float vv = col < d ? v_s[j * d + col] : 0.f;
#pragma unroll
        for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) acc[rr][e] = fmaf(pj[rr], vv, acc[rr][e]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
    const int r = q0 + warp * kSimtRowsPerWarp + rr;
    if (r >= sq) continue;
    const float safe_l = lsum[rr] == 0.f ? 1.f : lsum[rr];
    T* orow = o + (l * sq + r) * row + static_cast<long long>(h) * d;
#pragma unroll
    for (int e = 0; e < DW; ++e) {
      const int col = lane + 32 * e;
      if (col < d) orow[col] = from_f<T>(acc[rr][e] / safe_l);
    }
  }
}

// Opt a kernel in to `smem` bytes of dynamic shared memory and check the
// grid's limits; 0 when the launch may go ahead.
template <typename K>
int prepare(K kernel, dim3 grid, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T, int DP>
int fwd(const void* q, const void* k, const void* v, void* o, int lead, int sq, int sk,
        int heads, int d, const Biases& bs, cudaStream_t stream) {
  const size_t smem = 3 * kTile * (DP + 8) * sizeof(T);
  auto kernel = evo_fwd_kernel<T, DP>;
  const dim3 grid(lead, heads, (sq + kTile - 1) / kTile);
  const int rc = prepare(kernel, grid, smem);
  if (rc != 0) return rc;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, heads, d, 1.0f / sqrtf(static_cast<float>(d)), bs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DW>
int fwd_simt(const void* q, const void* k, const void* v, void* o, int lead, int sq,
             int sk, int heads, int d, const Biases& bs, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(kSimtRows) * d + kSimtKeys * (d | 1) +
                       static_cast<size_t>(kSimtKeys) * d) * sizeof(float);
  auto kernel = evo_fwd_simt_kernel<T, DW>;
  const dim3 grid(lead, heads, (sq + kSimtRows - 1) / kSimtRows);
  const int rc = prepare(kernel, grid, smem);
  if (rc != 0) return rc;
  kernel<<<grid, kSimtThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, heads, d, 1.0f / sqrtf(static_cast<float>(d)), bs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(bool simt, const void* q, const void* k, const void* v, void* o, int lead,
             int sq, int sk, int heads, int d, const Biases& bs, cudaStream_t stream) {
  if (simt) {
    if (d <= 32) return fwd_simt<T, 1>(q, k, v, o, lead, sq, sk, heads, d, bs, stream);
    if (d <= 64) return fwd_simt<T, 2>(q, k, v, o, lead, sq, sk, heads, d, bs, stream);
    if (d <= 128) return fwd_simt<T, 4>(q, k, v, o, lead, sq, sk, heads, d, bs, stream);
    return fwd_simt<T, 8>(q, k, v, o, lead, sq, sk, heads, d, bs, stream);
  }
  if constexpr (std::is_same<T, float>::value) {
    return static_cast<int>(cudaErrorInvalidValue);  // no fp32 tensor-core path
  } else {
    if (d <= 16) return fwd<T, 16>(q, k, v, o, lead, sq, sk, heads, d, bs, stream);
    if (d <= 32) return fwd<T, 32>(q, k, v, o, lead, sq, sk, heads, d, bs, stream);
    if (d <= 64) return fwd<T, 64>(q, k, v, o, lead, sq, sk, heads, d, bs, stream);
    return fwd<T, 128>(q, k, v, o, lead, sq, sk, heads, d, bs, stream);
  }
}

}  // namespace

// dtype (of q, k, v, o and of each bias): 0 = bf16, 1 = fp16, 2 = fp32.
// q [lead, sq, heads, d], k / v [lead, sk, heads, d] and o [lead, sq, heads,
// d] contiguous.  simt = 0: the tensor-core kernel (bf16 / fp16, d a
// multiple of 8 up to 128, 16-byte aligned, at most 2 biases of the input
// type); simt = 1: the
// general kernel (any dtype, d up to 256, at most 8 biases).  Bias i:
// bias_ptrs[i] with its int64 [lead] offset table lead_ptrs[i] on the
// device, its type bias_dtypes[i] and its (h, r, c) strides in elements at
// bias_strides[3 i .. 3 i + 2] (host arrays).  Return: the CUDA error code
// (0 ok).
extern "C" int dstt_evoformer_fwd(int dtype, int simt, const void* q, const void* k,
                                  const void* v, void* o, int lead, int sq, int sk, int heads,
                                  int d, int n_biases, const void* const* bias_ptrs,
                                  const void* const* lead_ptrs, const int* bias_dtypes,
                                  const long long* bias_strides, void* stream) {
  const int max_biases = simt ? kMaxBiases : kMmaBiases;
  if (d <= 0 || lead <= 0 || sq <= 0 || sk < 0 || heads <= 0 || n_biases < 0 ||
      n_biases > max_biases)
    return static_cast<int>(cudaErrorInvalidValue);
  if (simt ? d > kSimtMaxD : (d % 8 != 0 || d > 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Biases bs{};
  bs.n = n_biases;
  for (int i = 0; i < n_biases; ++i) {
    if (bias_dtypes[i] < 0 || bias_dtypes[i] > 2 || (!simt && bias_dtypes[i] != dtype))
      return static_cast<int>(cudaErrorInvalidValue);
    bs.b[i] = Bias{bias_ptrs[i], static_cast<const long long*>(lead_ptrs[i]),
                   bias_strides[3 * i], bias_strides[3 * i + 1], bias_strides[3 * i + 2],
                   bias_dtypes[i]};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(simt, q, k, v, o, lead, sq, sk, heads, d, bs, s);
  if (dtype == 1) return dispatch<__half>(simt, q, k, v, o, lead, sq, sk, heads, d, bs, s);
  if (dtype == 2) return dispatch<float>(simt, q, k, v, o, lead, sq, sk, heads, d, bs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
