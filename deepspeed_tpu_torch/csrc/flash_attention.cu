// Flash attention forward and backward for Hopper (sm_90a), bf16 or fp16 in,
// fp32 accumulators.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py that the
// training path runs, for all three of its layouts:
//
// * forward, `dstt_flash_fwd`, one CUDA block per 64 query rows of one
//   (batch, head): `_fwd_kernel_onepass` / `_fwd_kernel` (bshd, :119/:148),
//   `_fwd_kernel_folded_onepass` / `_fwd_kernel_folded` (folded, :568/:600),
//   `_fwd_kernel_paired_onepass` / `_fwd_kernel_paired` (paired,
//   :1091/:1133);
// * dQ, `dstt_flash_bwd_dq`, one block per 64 query rows of one (batch,
//   head): `_bwd_dq_kernel` (:260), `_bwd_dq_kernel_folded` (:720),
//   `_bwd_dq_kernel_paired` (:1272);
// * dK/dV, `dstt_flash_bwd_dkv`, one block per 64 keys of one (batch, KV
//   head): `_bwd_dkv_kernel` (:302), `_bwd_dkv_kernel_folded` (:766),
//   `_bwd_dkv_kernel_paired` (:1334).
//
// One kernel family serves the three layouts.  The folded layout exists on
// the TPU to avoid the BSHD <-> BHSD transposes around its kernels; these
// kernels read BSHD in place, so what "folded" means here is reading q, k and
// v where the projection left them: every operand is addressed by its own
// row stride (`Rows`), so column slices of one fused [B, S, (H + 2 Hkv) D]
// projection output are read without a copy.  The paired layout exists to
// fill the TPU's 128-lane MXU tile at d = 64; mma.m16n8k16 consumes d in
// 16-wide slices, so d = 64 already fills the operand and there is nothing to
// pair: the paired entry launches the same kernels and keeps only its own
// eligibility rule (ops/flash_attention.py).
//
// What they compute, with q pre-scaled by the softmax scale and rounded to
// the input type (done once outside, as the TPU path does):
//
//   keep(r, c) = c < Sk and, when causal, r + (Sk - Sq) >= c (end-aligned),
//                and with a window w > 0, c > r + (Sk - Sq) - w;
//   s = q k^T (fp32);  p = exp(s - m) on kept entries, 0 elsewhere;
//   o = (round(p) @ v) / l,  lse = m + log(l)   (l == 0 -> 1: a row that sees
//   no key comes out as zeros with lse = -1e30, never NaN);
//   backward: p = exp(s - lse), dp = do v^T, ds = p (dp - delta) with
//   delta = rowsum(do * o) (fp32; the dQ kernel computes it for its rows
//   and writes it for the dK/dV kernel, which runs after it on the same
//   stream), then dq = scale * round(ds) @ k, dv = round(p)^T @ do,
//   dk = round(ds)^T @ q.
//   round() is the input type: P and dS are rounded before their products,
//   as the TPU kernels round them (flash_attention.py:292, :332, :338).
//
// Layout: q / o / do / dq are [B, Sq, H, D] and k / v / dk / dv [B, Sk, Hkv,
// D], each with its own row stride (the distance between two consecutive
// positions, in elements; the batch stride is S times it, a head's D values
// are contiguous at offset h * D).  The contiguous case is stride = H * D.
// The kernels read and write BSHD in place, so the BSHD <-> BHSD transposes
// around the TPU kernels (flash_attention.py:498-504) do not exist here.
// The wrapper writes o, dq, dk and dv contiguous.  Every row must start on 16
// bytes (base pointer and stride), for the 16-byte loads.  lse and delta are
// fp32 [B, H, Sq], one value a row (the TPU stores them 8 wide only because
// its lowering wants it).
//
// Design (the simple one first; wgmma, TMA and warp specialisation are later
// work): 4 warps a block, 16 rows a warp; tiles of 64 rows staged in shared
// memory with 16-byte loads (rows padded by 16 bytes, so ldmatrix is free of
// bank conflicts); products by `mma.sync.m16n8k16` with operands fetched by
// `ldmatrix` (`.trans` for the operand whose reduction runs along rows in
// memory); the online softmax in registers, each row held by one quad of
// lanes.  The TPU's sequential grid axis becomes a loop inside the block.
// Tiles wholly outside the causal band or the window are never visited
// (the loop bounds are the TPU's `_run_predicate`), and any S works: the
// tail tile is loaded with zeros and masked.  GQA: the dK/dV block loops
// over every query head of its KV group and over the query tiles, summing in
// fp32 registers, so no two blocks write the same rows and no atomics are
// needed (the TPU's folded and paired backward writes each query head's dk /
// dv in the input type and sums the group outside, flash_attention.py:905-909:
// it rounds twice where this rounds once).
//
// What bounds them on the H100: at the training shapes (S 1024-2048,
// D 64-128) the products, ~4 * B * H * Sq * Sk * D flops forward (halved when
// causal) and 2.5 times that backward, at 989 TFLOP/s bf16 dense; the bytes
// (q, k, v, o once) are an order of magnitude below.  mma.sync reaches well
// under the wgmma peak, and without a load pipeline the warps wait on each
// tile's loads: these kernels are expected at a fraction of the bound.

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
constexpr float kNegInf = -1e30f;     // the TPU kernels' NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// ----------------------------------------------------------------------------
// Fragments
// ----------------------------------------------------------------------------
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

// acc[N/8][4] += A[16 x K] B[N x K]^T, both in shared memory, row-major with
// row stride LD (elements): A is the warp's 16 rows.  Accumulator layout of
// m16n8: acc[j][0..1] = row g, cols 8j + 2t + {0,1}; acc[j][2..3] = row g + 8
// (g = lane / 4, t = lane % 4).
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

// ROWS rows of a [*, row_stride] tensor from row row0 into shared memory
// (row stride D + 8), 16 bytes a thread at a time; rows past `rows` are 0.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t row_stride,
                                          int row0, int rows) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < rows)
      val = *reinterpret_cast<const int4*>(src + static_cast<size_t>(row0 + r) * row_stride + c);
    *reinterpret_cast<int4*>(dst + r * (D + 8) + c) = val;
  }
}

// Row strides in elements of each [B, S, *] operand: row s of batch b starts
// at b * S * stride + s * stride, and head h's D values at offset h * D in
// the row.  The contiguous BSHD case is stride = H * D (Hkv * D for k / v);
// a column slice of a wider buffer (GPT-2's q, k and v in one [B, S, 3 H D]
// c_attn output) is stride = the buffer's width.
struct Rows {
  long long q, k, v, o, dout, dq, dk, dv;
};

__device__ __forceinline__ size_t head_base(long long stride, int b, int s, int h, int d) {
  return static_cast<size_t>(b) * s * stride + static_cast<size_t>(h) * d;
}

__device__ __forceinline__ bool keep(int r, int c, int off, int causal, int window) {
  if (!causal) return true;
  return r + off >= c && (window <= 0 || c > r + off - window);
}

// Whether every (row, column) of rows [r0, r0 + nr) x columns [c0, c0 + nc)
// is visible and in range: such a tile skips the per-score mask (only the
// tiles that cross the diagonal, the window's edge or the end of S need
// it; the mask costs more instructions than the products).
__device__ __forceinline__ bool whole_tile(int r0, int nr, int rows, int c0, int nc,
                                           int cols, int off, int causal, int window) {
  if (r0 + nr > rows || c0 + nc > cols) return false;
  if (!causal) return true;
  return r0 + off >= c0 + nc - 1 && (window <= 0 || c0 > r0 + nr - 1 + off - window);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2<T>(a, b);
}

// sum over 8 elements of a * b, each 16-byte vector of T in fp32
template <typename T>
__device__ __forceinline__ float dot8(int4 a, int4 b) {
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 fa, fb;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pa + e));
      fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pb + e));
    } else {
      fa = __half22float2(*reinterpret_cast<const __half2*>(pa + e));
      fb = __half22float2(*reinterpret_cast<const __half2*>(pb + e));
    }
    acc = fmaf(fa.x, fb.x, acc);
    acc = fmaf(fa.y, fb.y, acc);
  }
  return acc;
}

// ----------------------------------------------------------------------------
// Forward
// ----------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, int heads, int kv_heads, int causal, int window,
                 Rows rs) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kTile * LD;
  T* v_s = k_s + kTile * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int off = sk - sq;
  const T* qb = q + head_base(rs.q, b, sq, h, D);
  const T* kb = k + head_base(rs.k, b, sk, kh, D);
  const T* vb = v + head_base(rs.v, b, sk, kh, D);

  load_tile<T, D, kTile>(q_s, qb, rs.q, q0, sq);

  // the k tiles that meet the visible band of rows [q0, q0 + 64)
  int n_begin = 0, n_end = (sk + kTile - 1) / kTile;
  if (causal) {
    const int hi = q0 + kTile - 1 + off;            // last column row q0+63 sees
    n_end = hi < 0 ? 0 : min(n_end, hi / kTile + 1);
    const int lo = q0 + off - window + 1;           // first column row q0 sees
    if (window > 0 && lo > 0) n_begin = lo / kTile;
  }

  const int r0 = q0 + warp * 16 + g;                // rows r0 and r0 + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int nt = n_begin; nt < n_end; ++nt) {
    const int c0 = nt * kTile;
    __syncthreads();                                // the last tile's reads are done
    load_tile<T, D, kTile>(k_s, kb, rs.k, c0, sk);
    load_tile<T, D, kTile>(v_s, vb, rs.v, c0, sk);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt<T, D, kTile, LD>(s, q_s + warp * 16 * LD, k_s, lane);

    float mx[2] = {kNegInf, kNegInf};
    // rows past Sq are computed but never written, so they do not count
    if (whole_tile(q0, kTile, q0 + kTile, c0, kTile, sk, off, causal, window)) {
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + (e >> 1) * 8;
          const int c = c0 + 8 * j + 2 * t + (e & 1);
          if (c < sk && keep(r, c, off, causal, window)) {
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          } else {
            s[j][e] = -__int_as_float(0x7f800000);  // -inf: exp(-inf - m) = 0
          }
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
      l[i] = l[i] * corr[i] + rs[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0]; acc[j][1] *= corr[0];
      acc[j][2] *= corr[1]; acc[j][3] *= corr[1];
    }
    uint32_t pa[kTile / 16][4];
    to_a_frags<T, kTile>(pa, s);
    mma_pb<T, kTile, D, LD>(acc, pa, v_s, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + head_base(rs.o, b, sq, h, D) + static_cast<size_t>(r) * rs.o;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2<T>(orow + 8 * j + 2 * t, acc[j][2 * i] / safe_l, acc[j][2 * i + 1] / safe_l);
    if (t == 0)
      lse[(static_cast<size_t>(b) * heads + h) * sq + r] = m[i] + logf(safe_l);
  }
}

// ----------------------------------------------------------------------------
// Backward: dQ
// ----------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
                    int heads, int kv_heads, int causal, int window, float scale,
                    Rows rs) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kTile * LD;
  T* k_s = do_s + kTile * LD;
  T* v_s = k_s + kTile * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int off = sk - sq;
  const T* kb = k + head_base(rs.k, b, sk, kh, D);
  const T* vb = v + head_base(rs.v, b, sk, kh, D);

  load_tile<T, D, kTile>(q_s, q + head_base(rs.q, b, sq, h, D), rs.q, q0, sq);
  load_tile<T, D, kTile>(do_s, dout + head_base(rs.dout, b, sq, h, D), rs.dout, q0, sq);

  int n_begin = 0, n_end = (sk + kTile - 1) / kTile;
  if (causal) {
    const int hi = q0 + kTile - 1 + off;
    n_end = hi < 0 ? 0 : min(n_end, hi / kTile + 1);
    const int lo = q0 + off - window + 1;
    if (window > 0 && lo > 0) n_begin = lo / kTile;
  }

  const int r0 = q0 + warp * 16 + g;
  const size_t row_base = (static_cast<size_t>(b) * heads + h) * sq;
  __syncthreads();                                  // do_s is loaded
  // delta = rowsum(do * o) of rows r0 and r0 + 8: each lane of the row's
  // quad takes every fourth 16-byte vector, then the quad sums
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    float part = 0.f;
    if (r < sq) {
      const T* orow = o + head_base(rs.o, b, sq, h, D) + static_cast<size_t>(r) * rs.o;
      const T* drow = do_s + (r - q0) * LD;
#pragma unroll
      for (int c = 8 * t; c < D; c += 32)
        part += dot8<T>(*reinterpret_cast<const int4*>(orow + c),
                        *reinterpret_cast<const int4*>(drow + c));
    }
    part += __shfl_xor_sync(kFull, part, 1);
    part += __shfl_xor_sync(kFull, part, 2);
    row_delta[i] = part;
    row_lse[i] = r < sq ? lse[row_base + r] : 0.f;
    if (t == 0 && r < sq) delta[row_base + r] = part;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int nt = n_begin; nt < n_end; ++nt) {
    const int c0 = nt * kTile;
    __syncthreads();
    load_tile<T, D, kTile>(k_s, kb, rs.k, c0, sk);
    load_tile<T, D, kTile>(v_s, vb, rs.v, c0, sk);
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    mma_abt<T, D, kTile, LD>(s, q_s + warp * 16 * LD, k_s, lane);
    mma_abt<T, D, kTile, LD>(dp, do_s + warp * 16 * LD, v_s, lane);
    auto to_ds = [&](const bool masked) {
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int r = r0 + 8 * i;
          const int c = c0 + 8 * j + 2 * t + (e & 1);
          const float p = (!masked || (c < sk && keep(r, c, off, causal, window)))
                              ? expf(s[j][e] - row_lse[i]) : 0.f;
          s[j][e] = p * (dp[j][e] - row_delta[i]);  // ds
        }
      }
    };
    // rows past Sq are computed but never written, so they do not count
    if (whole_tile(q0, kTile, q0 + kTile, c0, kTile, sk, off, causal, window))
      to_ds(false);
    else
      to_ds(true);
    uint32_t dsa[kTile / 16][4];
    to_a_frags<T, kTile>(dsa, s);
    mma_pb<T, kTile, D, LD>(acc, dsa, k_s, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= sq) continue;
    T* row = dq + head_base(rs.dq, b, sq, h, D) + static_cast<size_t>(r) * rs.dq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2<T>(row + 8 * j + 2 * t, acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

// ----------------------------------------------------------------------------
// Backward: dK, dV
// ----------------------------------------------------------------------------
// BQ query rows a step: 64 at D = 64; 32 at D = 128, so that the two
// [16 x BQ] score tiles and the two [16 x D] accumulators stay in registers.
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
                     int heads, int kv_heads, int causal, int window, Rows rs) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kTile * LD;
  T* q_s = v_s + kTile * LD;
  T* do_s = q_s + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + BQ * LD);
  float* delta_s = lse_s + BQ;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTile, kh = blockIdx.y, b = blockIdx.z;
  const int group = heads / kv_heads;
  const int off = sk - sq;
  load_tile<T, D, kTile>(k_s, k + head_base(rs.k, b, sk, kh, D), rs.k, k0, sk);
  load_tile<T, D, kTile>(v_s, v + head_base(rs.v, b, sk, kh, D), rs.v, k0, sk);

  // the q tiles whose rows see any of the keys [k0, k0 + 64)
  const int nq = (sq + BQ - 1) / BQ;
  int m_begin = 0, m_end = nq;
  if (causal) {
    const int lo = k0 - off;                        // first row that sees key k0
    if (lo > 0) m_begin = lo / BQ;
    if (window > 0) {
      const int hi = k0 + kTile - 1 - off + window - 1;   // last row seeing key k0+63
      m_end = hi < 0 ? 0 : min(nq, hi / BQ + 1);
    }
  }

  const int c_0 = k0 + warp * 16 + g;               // this thread's keys c_0, c_0 + 8
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }

  for (int hq = 0; hq < group; ++hq) {
    const int h = kh * group + hq;
    const T* qb = q + head_base(rs.q, b, sq, h, D);
    const T* dob = dout + head_base(rs.dout, b, sq, h, D);
    const size_t row_base = (static_cast<size_t>(b) * heads + h) * sq;
    for (int mt = m_begin; mt < m_end; ++mt) {
      const int r0 = mt * BQ;
      __syncthreads();
      load_tile<T, D, BQ>(q_s, qb, rs.q, r0, sq);
      load_tile<T, D, BQ>(do_s, dob, rs.dout, r0, sq);
      if (threadIdx.x < BQ) {
        const int r = r0 + threadIdx.x;
        lse_s[threadIdx.x] = r < sq ? lse[row_base + r] : 0.f;
        delta_s[threadIdx.x] = r < sq ? delta[row_base + r] : 0.f;
      }
      __syncthreads();

      // transposed scores: rows are this warp's 16 keys, columns BQ queries
      float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
        dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      }
      mma_abt<T, D, BQ, LD>(st, k_s + warp * 16 * LD, q_s, lane);
      mma_abt<T, D, BQ, LD>(dpt, v_s + warp * 16 * LD, do_s, lane);
      auto to_p_ds = [&](const bool masked) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c_0 + (e >> 1) * 8;
            const int rl = 8 * j + 2 * t + (e & 1);
            const int r = r0 + rl;
            const float p =
                (!masked || (r < sq && c < sk && keep(r, c, off, causal, window)))
                    ? expf(st[j][e] - lse_s[rl]) : 0.f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - delta_s[rl]);   // ds^T
          }
        }
      };
      // every q row counts here (dK/dV sum over them): rows past Sq must be
      // masked, so a tail q tile is never whole
      if (whole_tile(r0, BQ, sq, k0, kTile, sk, off, causal, window))
        to_p_ds(false);
      else
        to_p_ds(true);
      uint32_t pa[BQ / 16][4];
      to_a_frags<T, BQ>(pa, st);
      mma_pb<T, BQ, D, LD>(dv_acc, pa, do_s, lane);   // dV += P^T dO
      to_a_frags<T, BQ>(pa, dpt);
      mma_pb<T, BQ, D, LD>(dk_acc, pa, q_s, lane);    // dK += dS^T q
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = c_0 + 8 * i;
    if (c >= sk) continue;
    T* dk_row = dk + head_base(rs.dk, b, sk, kh, D) + static_cast<size_t>(c) * rs.dk;
    T* dv_row = dv + head_base(rs.dv, b, sk, kh, D) + static_cast<size_t>(c) * rs.dv;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2<T>(dk_row + 8 * j + 2 * t, dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      store2<T>(dv_row + 8 * j + 2 * t, dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

// ----------------------------------------------------------------------------
// Launchers
// ----------------------------------------------------------------------------
template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The 16-byte loads need every row to start on 16 bytes: each stride a
// multiple of 8 elements (the wrapper checks the base pointers too).
inline bool rows_aligned(const Rows& rs) {
  const long long all[] = {rs.q, rs.k, rs.v, rs.o, rs.dout, rs.dq, rs.dk, rs.dv};
  for (long long x : all)
    if (x % 8) return false;
  return true;
}

inline Rows to_rows(const long long* strides) {
  return Rows{strides[0], strides[1], strides[2], strides[3],
              strides[4], strides[5], strides[6], strides[7]};
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
        int sq, int sk, int heads, int kv_heads, int causal, int window, Rows rs,
        cudaStream_t stream) {
  if (!rows_aligned(rs)) return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = 3 * kTile * (D + 8) * sizeof(T);
  auto kernel = flash_fwd_kernel<T, D>;
  if (int rc = prepare(kernel, smem)) return rc;
  const dim3 grid((sq + kTile - 1) / kTile, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), sq, sk, heads, kv_heads, causal, window,
      rs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, int batch,
           int sq, int sk, int heads, int kv_heads, int causal, int window,
           float scale, Rows rs, cudaStream_t stream) {
  if (!rows_aligned(rs)) return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = 4 * kTile * (D + 8) * sizeof(T);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  if (int rc = prepare(kernel, smem)) return rc;
  const dim3 grid((sq + kTile - 1) / kTile, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<T*>(dq),
      sq, sk, heads, kv_heads, causal, window, scale, rs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int batch, int sq,
            int sk, int heads, int kv_heads, int causal, int window, Rows rs,
            cudaStream_t stream) {
  if (!rows_aligned(rs)) return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int BQ = D == 64 ? 64 : 32;
  const size_t smem = (2 * kTile + 2 * BQ) * (D + 8) * sizeof(T) + 2 * BQ * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, D, BQ>;
  if (int rc = prepare(kernel, smem)) return rc;
  const dim3 grid((sk + kTile - 1) / kTile, kv_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
      heads, kv_heads, causal, window, rs);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = bf16, 1 = fp16; head_dim 64 or 128.
#define DSTT_DISPATCH(FN, ...)                                              \
  do {                                                                      \
    if (dtype == 0 && head_dim == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__); \
    if (dtype == 0 && head_dim == 128) return FN<__nv_bfloat16, 128>(__VA_ARGS__); \
    if (dtype == 1 && head_dim == 64) return FN<__half, 64>(__VA_ARGS__);   \
    if (dtype == 1 && head_dim == 128) return FN<__half, 128>(__VA_ARGS__); \
    return static_cast<int>(cudaErrorInvalidValue);                         \
  } while (0)

}  // namespace

// `window` <= 0: no sliding window.  `row_strides`: a host array of 8 row
// strides in elements, in the order of `Rows` (q, k, v, o, dout, dq, dk, dv;
// a kernel ignores the tensors it does not take).  Return: the CUDA error
// code (0 ok).
extern "C" int dstt_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                              const void* v, void* o, void* lse, int batch, int sq,
                              int sk, int heads, int kv_heads, int causal, int window,
                              const long long* row_strides, void* stream) {
  DSTT_DISPATCH(fwd, q, k, v, o, lse, batch, sq, sk, heads, kv_heads, causal, window,
                to_rows(row_strides), static_cast<cudaStream_t>(stream));
}

// Writes dq and delta (fp32 [B, H, Sq]) for the dK/dV kernel.
extern "C" int dstt_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq, int batch,
                                 int sq, int sk, int heads, int kv_heads, int causal,
                                 int window, float scale, const long long* row_strides,
                                 void* stream) {
  DSTT_DISPATCH(bwd_dq, q, k, v, o, dout, lse, delta, dq, batch, sq, sk, heads,
                kv_heads, causal, window, scale, to_rows(row_strides),
                static_cast<cudaStream_t>(stream));
}

extern "C" int dstt_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                  const void* v, const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int batch,
                                  int sq, int sk, int heads, int kv_heads, int causal,
                                  int window, const long long* row_strides,
                                  void* stream) {
  DSTT_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, batch, sq, sk, heads,
                kv_heads, causal, window, to_rows(row_strides),
                static_cast<cudaStream_t>(stream));
}
