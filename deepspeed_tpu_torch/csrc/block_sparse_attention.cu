// Block-sparse attention forward and backward for Hopper (sm_90a): attention
// under a block layout [H, S/block, S/block] that visits only the live parts
// of the layout, fp32 accumulators.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/block_sparse_attention.py:
//
// * forward, `dstt_bsa_fwd`: `_fwd_kernel` (:82, pallas_call at :263);
// * dQ, `dstt_bsa_bwd_dq`: `_bwd_dq_kernel` (:131, pallas_call at :283);
// * dK/dV, `dstt_bsa_bwd_dkv`: `_bwd_dkv_kernel` (:166, pallas_call at :300).
//
// What they compute, for one (batch, head), with q pre-scaled by the softmax
// scale and rounded to the input type (done once outside, as the TPU path
// does), and keep(r, c) = layout[h, r / block, c / block]:
//
//   s = q k^T + kbias[b, c] (fp32; kbias an optional [B, S] key bias, the
//   key-padding mask of SparseSelfAttention: 0 keeps a key, -inf drops it,
//   a finite value is added as the "add" mode does);
//   p = exp(s - m) on kept entries, 0 elsewhere;
//   o = (round(p) @ v) / l,  lse = m + log(l)   (l == 0 -> 1: a row that sees
//   no key comes out as zeros with lse = -1e30, never NaN: `safe_l`, :122);
//   backward: p = exp(s - lse) on kept entries, dp = do v^T,
//   ds = p (dp - delta) with delta = rowsum(do * o) in fp32 (the dQ kernel
//   computes it for its rows and writes it for the dK/dV kernel, which runs
//   after it on the same stream), then dq = scale * round(ds) @ k,
//   dv = round(p)^T @ do, dk = round(ds)^T @ q.  round() is the input type
//   (the TPU kernel rounds P at :114 and dS at :156 / :196; fp32 rounds
//   nothing).
//
// Layout: q, k, v, o, do, dq, dk and dv are BHSD [B, H, S, D], contiguous;
// lse, delta fp32 [B, H, S]; kbias fp32 [B, S] or null.  S is a multiple
// of the layout's block, not of the kernel's tile: the tail tile is loaded
// with zeros and masked.
//
// The point is skipped work, so the TPU's predicated grid (every (q tile,
// k tile) step visited, `pl.when(tile_any...)` at :95) is not carried over.
// The host (ops/block_sparse_attention.py, `BlockSparseLayout`) builds
// compacted lists per head, in 64 x 64 tiles: for each query tile the live
// key tiles, for each key tile the live query tiles (CSR: `ptr[h * n + i]`
// .. `ptr[h * n + i + 1]` index `idx` and `mask`).  Each entry carries a
// 16-bit mask of the tile's 16 x 16 sub-blocks, bit (qs * 4 + ks) set when
// the layout keeps sub-block (qs, ks); the layout's block is a multiple of 16,
// so each sub-block lies in one layout cell, and sub-blocks past S are 0.
// The forward and dQ blocks walk only the live key tiles of their query
// tile; the dK/dV block walks only the live query tiles of its key tile.
// Inside a live tile, the mask is per warp and per 16 columns: a warp of the
// tensor-core kernels holds 16 rows (one sub-block row), so its four bits
// name which 16-column slices it keeps, and a dead slice skips its products
// and is masked whole (no per-element test, no cell expansion: the TPU
// kernel's `_cell_mask` matmuls at :57 have no counterpart).
//
// Two kernel families:
//
// * the tensor-core kernels (bf16 / fp16, D a multiple of 8 up to 128, padded
//   with zeros in shared memory to DP = 16, 32, 64 or 128): B1's simple
//   design (csrc/flash_attention.cu): 4 warps a block, 16 rows a warp,
//   64-row tiles staged in shared memory with 16-byte loads, products by
//   mma.sync.m16n8k16 (csrc/attention_tiles.cuh), the online softmax in
//   registers.  The dK/dV kernel takes 64 query rows a step at DP <= 64 and
//   32 at DP = 128 (registers);
// * the general kernels (fp32, any D up to 128; the TPU kernel takes fp32
//   too, and the JAX package's parity test runs it): the same tiles and
//   lists, products in fp32 on the CUDA cores, 8 warps a
//   block, 8 rows (or keys) a warp and one key (or query) a lane, as B12's
//   general kernel (csrc/evoformer_attn.cu).
//
// What bounds them on the H100: at BERT width (D = 64, S = 4096, batch 4,
// block 16) the products of the live layout cells, 4 S_live D flops forward
// and 14 S_live D backward (S_live = kept score entries), at 989 TFLOP/s
// bf16 (67 TFLOP/s fp32), from ~15% density up; below that the bytes (q,
// k, v, o, lse read or written once).  The kernels run whole live 16 x 16
// sub-blocks at mma.sync rates without a load pipeline, and a block walks
// its list in sequence, so the longest list (a global row's every key tile,
// a global column's every query tile) sets a layout's time: they run well
// above the bound (PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;             // rows of a q tile and of a k/v tile
constexpr float kNegInf = -1e30f;     // the TPU kernels' NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSimtWarps = 8;
constexpr int kSimtThreads = 32 * kSimtWarps;
constexpr int kSimtPer = kTile / kSimtWarps;   // rows (or keys) a warp: 8
constexpr int kMaxD = 128;

// The compacted tile lists of one orientation (see the header).
struct Lists {
  const int* ptr;
  const int* idx;
  const int* mask;
};

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// kTile-row tiles of one head (row stride d) from row `row0` into shared
// memory (row stride DP + 8), 16 bytes a thread at a time; rows past `rows`
// and columns past d are 0.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int d, int row0, int rows) {
  constexpr int kVec = DP / 8;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < rows && c < d)
      val = *reinterpret_cast<const int4*>(src + static_cast<size_t>(row0 + r) * d + c);
    *reinterpret_cast<int4*>(dst + r * (DP + 8) + c) = val;
  }
}

// acc[N/8][4] += A[16 x K] B[N x K]^T over the 16-column slices of B whose bit
// in `live` is set (the others are left as they are).
template <typename T, int K, int N, int LD>
__device__ __forceinline__ void mma_abt_live(float (&acc)[N / 8][4], const T* a, const T* b,
                                             int lane, int live) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * LD + k0 + (lane / 16) * 8);
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      if (!((live >> (n0 / 16)) & 1)) continue;
      uint32_t bf[4];
      ldsm_x4(bf, b + (n0 + (lane / 16) * 8 + lane % 8) * LD + k0 + ((lane / 8) % 2) * 8);
      mma16816<T>(acc[n0 / 8], af, bf[0], bf[1]);
      mma16816<T>(acc[n0 / 8 + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[D/8][4] += P[16 x N] B[N x D] over the 16-row slices of B whose bit in
// `live` is set (P is 0 on the others).
template <typename T, int N, int D, int LD>
__device__ __forceinline__ void mma_pb_live(float (&acc)[D / 8][4],
                                            const uint32_t (&pa)[N / 16][4], const T* b,
                                            int lane, int live) {
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 16) {
    if (!((live >> (k0 / 16)) & 1)) continue;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + d0 + (lane / 16) * 8);
      mma16816<T>(acc[d0 / 8], pa[k0 / 16], bf[0], bf[1]);
      mma16816<T>(acc[d0 / 8 + 1], pa[k0 / 16], bf[2], bf[3]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2<T>(a, b);
}

// sum over 8 elements of a * b, each 16-byte vector of T in fp32
template <typename T>
__device__ __forceinline__ float dot8(int4 a, int4 b) {
  const T* pa = reinterpret_cast<const T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc = fmaf(to_f(pa[e]), to_f(pb[e]), acc);
  return acc;
}

// bits (qs * 4 + w) of `mask` for qs = 0..3: the query sub-blocks that key
// sub-block w keeps
__device__ __forceinline__ int column_bits(int mask, int w) {
  return ((mask >> w) & 1) | (((mask >> (4 + w)) & 1) << 1) |
         (((mask >> (8 + w)) & 1) << 2) | (((mask >> (12 + w)) & 1) << 3);
}

// ----------------------------------------------------------------------------
// Tensor-core kernels
// ----------------------------------------------------------------------------
// BIAS: a key bias is given (kbias non-null).  A template flag, so that the
// kernels without one keep the registers they had (the dK/dV kernel runs
// near the register limit at DP = 64).
template <typename T, int DP, bool BIAS>
__global__ void __launch_bounds__(kThreads)
bsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse,
               const float* __restrict__ kbias, int seq, int heads, int d, Lists lists) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kTile * LD;
  T* v_s = k_s + kTile * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const size_t row_base = (static_cast<size_t>(b) * heads + h) * seq;
  const T* qb = q + row_base * d;
  const T* kb = k + row_base * d;
  const T* vb = v + row_base * d;

  load_tile<T, DP, kTile>(q_s, qb, d, q0, seq);

  const int r0 = q0 + warp * 16 + g;                // rows r0 and r0 + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int li = h * gridDim.x + qt;
  for (int it = lists.ptr[li], end = lists.ptr[li + 1]; it < end; ++it) {
    const int c0 = lists.idx[it] * kTile;
    const int live = (lists.mask[it] >> (4 * warp)) & 0xF;   // this warp's key slices
    __syncthreads();                                // the last tile's reads are done
    load_tile<T, DP, kTile>(k_s, kb, d, c0, seq);
    load_tile<T, DP, kTile>(v_s, vb, d, c0, seq);
    __syncthreads();
    if (!live) continue;

    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt_live<T, DP, kTile, LD>(s, q_s + warp * 16 * LD, k_s, lane, live);

    // this tile's key bias (a live slice lies inside S)
    const float* kb = BIAS ? kbias + static_cast<size_t>(b) * seq + c0 + 2 * t : nullptr;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const bool keep = (live >> (j >> 1)) & 1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (keep) {
          if (BIAS) s[j][e] += kb[8 * j + (e & 1)];
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        } else {
          s[j][e] = neg_inf();                      // exp(-inf - m) = 0
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
    for (int j = 0; j < DP / 8; ++j) {
      acc[j][0] *= corr[0]; acc[j][1] *= corr[0];
      acc[j][2] *= corr[1]; acc[j][3] *= corr[1];
    }
    uint32_t pa[kTile / 16][4];
    to_a_frags<T, kTile>(pa, s);
    mma_pb_live<T, kTile, DP, LD>(acc, pa, v_s, lane, live);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= seq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (row_base + r) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < d) store2<T>(orow + 8 * j + 2 * t, acc[j][2 * i] / safe_l, acc[j][2 * i + 1] / safe_l);
    if (t == 0) lse[row_base + r] = m[i] + logf(safe_l);
  }
}

template <typename T, int DP, bool BIAS>
__global__ void __launch_bounds__(kThreads)
bsa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ o, const T* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  T* __restrict__ dq, const float* __restrict__ kbias, int seq, int heads,
                  int d, float scale, Lists lists) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kTile * LD;
  T* k_s = do_s + kTile * LD;
  T* v_s = k_s + kTile * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const size_t row_base = (static_cast<size_t>(b) * heads + h) * seq;
  const T* kb = k + row_base * d;
  const T* vb = v + row_base * d;

  load_tile<T, DP, kTile>(q_s, q + row_base * d, d, q0, seq);
  load_tile<T, DP, kTile>(do_s, dout + row_base * d, d, q0, seq);

  const int r0 = q0 + warp * 16 + g;
  __syncthreads();                                  // do_s is loaded
  // delta = rowsum(do * o) of rows r0 and r0 + 8: each lane of the row's
  // quad takes every fourth 16-byte vector, then the quad sums
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    float part = 0.f;
    if (r < seq) {
      const T* orow = o + (row_base + r) * d;
      const T* drow = do_s + (r - q0) * LD;
      for (int c = 8 * t; c < d; c += 32)
        part += dot8<T>(*reinterpret_cast<const int4*>(orow + c),
                        *reinterpret_cast<const int4*>(drow + c));
    }
    part += __shfl_xor_sync(kFull, part, 1);
    part += __shfl_xor_sync(kFull, part, 2);
    row_delta[i] = part;
    row_lse[i] = r < seq ? lse[row_base + r] : 0.f;
    if (t == 0 && r < seq) delta[row_base + r] = part;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int li = h * gridDim.x + qt;
  for (int it = lists.ptr[li], end = lists.ptr[li + 1]; it < end; ++it) {
    const int c0 = lists.idx[it] * kTile;
    const int live = (lists.mask[it] >> (4 * warp)) & 0xF;
    __syncthreads();
    load_tile<T, DP, kTile>(k_s, kb, d, c0, seq);
    load_tile<T, DP, kTile>(v_s, vb, d, c0, seq);
    __syncthreads();
    if (!live) continue;

    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    mma_abt_live<T, DP, kTile, LD>(s, q_s + warp * 16 * LD, k_s, lane, live);
    mma_abt_live<T, DP, kTile, LD>(dp, do_s + warp * 16 * LD, v_s, lane, live);
    const float* kb = BIAS ? kbias + static_cast<size_t>(b) * seq + c0 + 2 * t : nullptr;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const bool keep = (live >> (j >> 1)) & 1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float x = s[j][e] + (BIAS && keep ? kb[8 * j + (e & 1)] : 0.f);
        const float p = keep ? expf(x - row_lse[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - row_delta[i]);    // ds
      }
    }
    uint32_t dsa[kTile / 16][4];
    to_a_frags<T, kTile>(dsa, s);
    mma_pb_live<T, kTile, DP, LD>(acc, dsa, k_s, lane, live);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= seq) continue;
    T* row = dq + (row_base + r) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < d) store2<T>(row + 8 * j + 2 * t, acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

// BQ query rows a step: 64 at DP <= 64; 32 at DP = 128, so that the two
// [16 x BQ] score tiles and the two [16 x DP] accumulators stay in registers.
template <typename T, int DP, int BQ, bool BIAS>
__global__ void __launch_bounds__(kThreads)
bsa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   const float* __restrict__ kbias, int seq, int heads, int d, Lists lists) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kTile * LD;
  T* q_s = v_s + kTile * LD;
  T* do_s = q_s + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + BQ * LD);
  float* delta_s = lse_s + BQ;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  const size_t row_base = (static_cast<size_t>(b) * heads + h) * seq;
  const T* qb = q + row_base * d;
  const T* dob = dout + row_base * d;
  load_tile<T, DP, kTile>(k_s, k + row_base * d, d, k0, seq);
  load_tile<T, DP, kTile>(v_s, v + row_base * d, d, k0, seq);

  const int c_0 = k0 + warp * 16 + g;               // this thread's keys c_0, c_0 + 8
  float key_b[2] = {0.f, 0.f};                      // their bias
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = c_0 + 8 * i;
    if (BIAS && c < seq) key_b[i] = kbias[static_cast<size_t>(b) * seq + c];
  }
  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }

  const int li = h * gridDim.x + kt;
  for (int it = lists.ptr[li], end = lists.ptr[li + 1]; it < end; ++it) {
    // the query sub-blocks this warp's 16 keys (key sub-block `warp`) keep
    const int col = column_bits(lists.mask[it], warp);
#pragma unroll 1
    for (int half = 0; half < kTile / BQ; ++half) {
      const int r0 = lists.idx[it] * kTile + half * BQ;
      const int live = (col >> (half * BQ / 16)) & ((1 << (BQ / 16)) - 1);
      __syncthreads();
      load_tile<T, DP, BQ>(q_s, qb, d, r0, seq);
      load_tile<T, DP, BQ>(do_s, dob, d, r0, seq);
      if (threadIdx.x < BQ) {
        const int r = r0 + threadIdx.x;
        lse_s[threadIdx.x] = r < seq ? lse[row_base + r] : 0.f;
        delta_s[threadIdx.x] = r < seq ? delta[row_base + r] : 0.f;
      }
      __syncthreads();
      if (!live) continue;

      // transposed scores: rows are this warp's 16 keys, columns BQ queries
      float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
        dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      }
      mma_abt_live<T, DP, BQ, LD>(st, k_s + warp * 16 * LD, q_s, lane, live);
      mma_abt_live<T, DP, BQ, LD>(dpt, v_s + warp * 16 * LD, do_s, lane, live);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const bool keep = (live >> (j >> 1)) & 1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = 8 * j + 2 * t + (e & 1);
          const float x = BIAS ? st[j][e] + key_b[e >> 1] : st[j][e];
          const float p = keep ? expf(x - lse_s[rl]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - delta_s[rl]);   // ds^T
        }
      }
      uint32_t pa[BQ / 16][4];
      to_a_frags<T, BQ>(pa, st);
      mma_pb_live<T, BQ, DP, LD>(dv_acc, pa, do_s, lane, live);   // dV += P^T dO
      to_a_frags<T, BQ>(pa, dpt);
      mma_pb_live<T, BQ, DP, LD>(dk_acc, pa, q_s, lane, live);    // dK += dS^T q
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = c_0 + 8 * i;
    if (c >= seq) continue;
    T* dk_row = dk + (row_base + c) * d;
    T* dv_row = dv + (row_base + c) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j >= d) continue;
      store2<T>(dk_row + 8 * j + 2 * t, dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      store2<T>(dv_row + 8 * j + 2 * t, dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

// ----------------------------------------------------------------------------
// General kernels (CUDA cores, fp32 products)
// ----------------------------------------------------------------------------
// kTile rows of one head into fp32 shared memory at row stride ld; rows past
// `rows` are 0.
template <typename T>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const T* src, int d, int row0,
                                              int rows) {
  for (int i = threadIdx.x; i < kTile * d; i += kSimtThreads) {
    const int r = i / d, c = i % d;
    dst[r * ld + c] = row0 + r < rows ? to_f(src[static_cast<size_t>(row0 + r) * d + c]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// DW = ceil(d / 32) output columns a lane: lane + 32 e.
template <typename T, int DW>
__global__ void __launch_bounds__(kSimtThreads)
bsa_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, float* __restrict__ lse,
                    const float* __restrict__ kbias, int seq, int heads, int d, Lists lists) {
  extern __shared__ __align__(16) float fsm[];
  const int ldk = d | 1;                            // odd: lane j's row in bank j
  float* q_s = fsm;                                 // [kTile][d]
  float* k_s = q_s + kTile * d;                     // [kTile][ldk]
  float* v_s = k_s + kTile * ldk;                   // [kTile][d]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const size_t row_base = (static_cast<size_t>(b) * heads + h) * seq;
  const T* kb = k + row_base * d;
  const T* vb = v + row_base * d;
  load_rows_f32<T>(q_s, d, q + row_base * d, d, q0, seq);

  const int lr0 = warp * kSimtPer;                  // the warp's first row in q_s
  const int shift = 4 * (lr0 / 16);                 // its query sub-block's bits
  float m[kSimtPer], lsum[kSimtPer], acc[kSimtPer][DW];
#pragma unroll
  for (int rr = 0; rr < kSimtPer; ++rr) {
    m[rr] = kNegInf;
    lsum[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < DW; ++j) acc[rr][j] = 0.f;
  }

  const int li = h * gridDim.x + qt;
  for (int it = lists.ptr[li], end = lists.ptr[li + 1]; it < end; ++it) {
    const int c0 = lists.idx[it] * kTile;
    const int live = (lists.mask[it] >> shift) & 0xF;
    __syncthreads();                                // the last tile's reads are done
    load_rows_f32<T>(k_s, ldk, kb, d, c0, seq);
    load_rows_f32<T>(v_s, d, vb, d, c0, seq);
    __syncthreads();
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      if (!((live >> (2 * half)) & 3)) continue;    // both 16-key slices dead
      const int kl = 32 * half + lane;              // this lane's key in the tile
      const bool keep = (live >> (kl / 16)) & 1;
      float x[kSimtPer];
#pragma unroll
      for (int rr = 0; rr < kSimtPer; ++rr) x[rr] = 0.f;
      for (int e = 0; e < d; ++e) {
        const float kv = k_s[kl * ldk + e];
#pragma unroll
        for (int rr = 0; rr < kSimtPer; ++rr) x[rr] = fmaf(q_s[(lr0 + rr) * d + e], kv, x[rr]);
      }
      const float kbv = keep && kbias ? kbias[static_cast<size_t>(b) * seq + c0 + kl] : 0.f;
      float pr[kSimtPer];
#pragma unroll
      for (int rr = 0; rr < kSimtPer; ++rr) {
        const float xv = keep ? x[rr] + kbv : neg_inf();
        float mx = xv;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float m_new = fmaxf(m[rr], mx);
        const float corr = expf(m[rr] - m_new);
        const float p = expf(xv - m_new);
        float rs = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(kFull, rs, off);
        lsum[rr] = lsum[rr] * corr + rs;
        m[rr] = m_new;
        pr[rr] = round_to<T>(p);                    // P in the input type
#pragma unroll
        for (int e = 0; e < DW; ++e) acc[rr][e] *= corr;
      }
      // P V: each V value read once for all of the warp's rows
      for (int j = 0; j < 32; ++j) {
        float pj[kSimtPer];
#pragma unroll
        for (int rr = 0; rr < kSimtPer; ++rr) pj[rr] = __shfl_sync(kFull, pr[rr], j);
        const float* vrow = v_s + (32 * half + j) * d;
#pragma unroll
        for (int e = 0; e < DW; ++e) {
          const int c = lane + 32 * e;
          const float vv = c < d ? vrow[c] : 0.f;
#pragma unroll
          for (int rr = 0; rr < kSimtPer; ++rr) acc[rr][e] = fmaf(pj[rr], vv, acc[rr][e]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kSimtPer; ++rr) {
    const int r = q0 + lr0 + rr;
    if (r >= seq) continue;
    const float safe_l = lsum[rr] == 0.f ? 1.f : lsum[rr];
    T* orow = o + (row_base + r) * d;
#pragma unroll
    for (int e = 0; e < DW; ++e) {
      const int c = lane + 32 * e;
      if (c < d) orow[c] = from_f<T>(acc[rr][e] / safe_l);
    }
    if (lane == 0) lse[row_base + r] = m[rr] + logf(safe_l);
  }
}

template <typename T, int DW>
__global__ void __launch_bounds__(kSimtThreads)
bsa_bwd_dq_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ o,
                       const T* __restrict__ dout, const float* __restrict__ lse,
                       float* __restrict__ delta, T* __restrict__ dq,
                       const float* __restrict__ kbias, int seq, int heads, int d, float scale,
                       Lists lists) {
  extern __shared__ __align__(16) float fsm[];
  const int ldk = d | 1;
  float* q_s = fsm;                                 // [kTile][d]
  float* do_s = q_s + kTile * d;                    // [kTile][d]
  float* k_s = do_s + kTile * d;                    // [kTile][ldk]
  float* v_s = k_s + kTile * ldk;                   // [kTile][ldk]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const size_t row_base = (static_cast<size_t>(b) * heads + h) * seq;
  const T* kb = k + row_base * d;
  const T* vb = v + row_base * d;
  load_rows_f32<T>(q_s, d, q + row_base * d, d, q0, seq);
  load_rows_f32<T>(do_s, d, dout + row_base * d, d, q0, seq);
  __syncthreads();

  const int lr0 = warp * kSimtPer;
  const int shift = 4 * (lr0 / 16);
  float row_lse[kSimtPer], row_delta[kSimtPer], acc[kSimtPer][DW];
#pragma unroll
  for (int rr = 0; rr < kSimtPer; ++rr) {
    const int r = q0 + lr0 + rr;
    float part = 0.f;
    if (r < seq)
      for (int c = lane; c < d; c += 32)
        part = fmaf(do_s[(lr0 + rr) * d + c], to_f(o[(row_base + r) * d + c]), part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
    row_delta[rr] = part;
    row_lse[rr] = r < seq ? lse[row_base + r] : 0.f;
    if (lane == 0 && r < seq) delta[row_base + r] = part;
#pragma unroll
    for (int e = 0; e < DW; ++e) acc[rr][e] = 0.f;
  }

  const int li = h * gridDim.x + qt;
  for (int it = lists.ptr[li], end = lists.ptr[li + 1]; it < end; ++it) {
    const int c0 = lists.idx[it] * kTile;
    const int live = (lists.mask[it] >> shift) & 0xF;
    __syncthreads();
    load_rows_f32<T>(k_s, ldk, kb, d, c0, seq);
    load_rows_f32<T>(v_s, ldk, vb, d, c0, seq);
    __syncthreads();
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      if (!((live >> (2 * half)) & 3)) continue;
      const int kl = 32 * half + lane;
      const bool keep = (live >> (kl / 16)) & 1;
      float x[kSimtPer], y[kSimtPer];
#pragma unroll
      for (int rr = 0; rr < kSimtPer; ++rr) x[rr] = y[rr] = 0.f;
      for (int e = 0; e < d; ++e) {
        const float kv = k_s[kl * ldk + e], vv = v_s[kl * ldk + e];
#pragma unroll
        for (int rr = 0; rr < kSimtPer; ++rr) {
          x[rr] = fmaf(q_s[(lr0 + rr) * d + e], kv, x[rr]);
          y[rr] = fmaf(do_s[(lr0 + rr) * d + e], vv, y[rr]);
        }
      }
      const float kbv = keep && kbias ? kbias[static_cast<size_t>(b) * seq + c0 + kl] : 0.f;
      float ds[kSimtPer];
#pragma unroll
      for (int rr = 0; rr < kSimtPer; ++rr) {
        const float p = keep ? expf(x[rr] + kbv - row_lse[rr]) : 0.f;
        ds[rr] = round_to<T>(p * (y[rr] - row_delta[rr]));
      }
      for (int j = 0; j < 32; ++j) {
        float dj[kSimtPer];
#pragma unroll
        for (int rr = 0; rr < kSimtPer; ++rr) dj[rr] = __shfl_sync(kFull, ds[rr], j);
        const float* krow = k_s + (32 * half + j) * ldk;
#pragma unroll
        for (int e = 0; e < DW; ++e) {
          const int c = lane + 32 * e;
          const float kv = c < d ? krow[c] : 0.f;
#pragma unroll
          for (int rr = 0; rr < kSimtPer; ++rr) acc[rr][e] = fmaf(dj[rr], kv, acc[rr][e]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kSimtPer; ++rr) {
    const int r = q0 + lr0 + rr;
    if (r >= seq) continue;
    T* row = dq + (row_base + r) * d;
#pragma unroll
    for (int e = 0; e < DW; ++e) {
      const int c = lane + 32 * e;
      if (c < d) row[c] = from_f<T>(acc[rr][e] * scale);
    }
  }
}

template <typename T, int DW>
__global__ void __launch_bounds__(kSimtThreads)
bsa_bwd_dkv_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv,
                        const float* __restrict__ kbias, int seq, int heads, int d,
                        Lists lists) {
  extern __shared__ __align__(16) float fsm[];
  const int ldq = d | 1;
  float* k_s = fsm;                                 // [kTile][d]
  float* v_s = k_s + kTile * d;                     // [kTile][d]
  float* q_s = v_s + kTile * d;                     // [kTile][ldq]
  float* do_s = q_s + kTile * ldq;                  // [kTile][ldq]
  float* lse_s = do_s + kTile * ldq;                // [kTile]
  float* delta_s = lse_s + kTile;                   // [kTile]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  const size_t row_base = (static_cast<size_t>(b) * heads + h) * seq;
  const T* qb = q + row_base * d;
  const T* dob = dout + row_base * d;
  load_rows_f32<T>(k_s, d, k + row_base * d, d, k0, seq);
  load_rows_f32<T>(v_s, d, v + row_base * d, d, k0, seq);

  const int kl0 = warp * kSimtPer;                  // the warp's first key in the tile
  const int ksb = kl0 / 16;                         // its key sub-block
  float dk_acc[kSimtPer][DW], dv_acc[kSimtPer][DW], key_b[kSimtPer];
#pragma unroll
  for (int kk = 0; kk < kSimtPer; ++kk) {
    const int c = k0 + kl0 + kk;
    key_b[kk] = kbias && c < seq ? kbias[static_cast<size_t>(b) * seq + c] : 0.f;
#pragma unroll
    for (int e = 0; e < DW; ++e) dk_acc[kk][e] = dv_acc[kk][e] = 0.f;
  }

  const int li = h * gridDim.x + kt;
  for (int it = lists.ptr[li], end = lists.ptr[li + 1]; it < end; ++it) {
    const int r0 = lists.idx[it] * kTile;
    const int col = column_bits(lists.mask[it], ksb);   // live query sub-blocks
    __syncthreads();
    load_rows_f32<T>(q_s, ldq, qb, d, r0, seq);
    load_rows_f32<T>(do_s, ldq, dob, d, r0, seq);
    for (int i = threadIdx.x; i < kTile; i += kSimtThreads) {
      const int r = r0 + i;
      lse_s[i] = r < seq ? lse[row_base + r] : 0.f;
      delta_s[i] = r < seq ? delta[row_base + r] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      if (!((col >> (2 * half)) & 3)) continue;     // both 16-query slices dead
      const int ql = 32 * half + lane;              // this lane's query in the tile
      const bool keep = (col >> (ql / 16)) & 1;
      float x[kSimtPer], y[kSimtPer];
#pragma unroll
      for (int kk = 0; kk < kSimtPer; ++kk) x[kk] = y[kk] = 0.f;
      for (int e = 0; e < d; ++e) {
        const float qv = q_s[ql * ldq + e], dov = do_s[ql * ldq + e];
#pragma unroll
        for (int kk = 0; kk < kSimtPer; ++kk) {
          x[kk] = fmaf(qv, k_s[(kl0 + kk) * d + e], x[kk]);
          y[kk] = fmaf(dov, v_s[(kl0 + kk) * d + e], y[kk]);
        }
      }
      float pr[kSimtPer], ds[kSimtPer];
#pragma unroll
      for (int kk = 0; kk < kSimtPer; ++kk) {
        const float p = keep ? expf(x[kk] + key_b[kk] - lse_s[ql]) : 0.f;
        pr[kk] = round_to<T>(p);
        ds[kk] = round_to<T>(p * (y[kk] - delta_s[ql]));
      }
      for (int j = 0; j < 32; ++j) {
        const float* qrow = q_s + (32 * half + j) * ldq;
        const float* dorow = do_s + (32 * half + j) * ldq;
        float pj[kSimtPer], dj[kSimtPer];
#pragma unroll
        for (int kk = 0; kk < kSimtPer; ++kk) {
          pj[kk] = __shfl_sync(kFull, pr[kk], j);
          dj[kk] = __shfl_sync(kFull, ds[kk], j);
        }
#pragma unroll
        for (int e = 0; e < DW; ++e) {
          const int c = lane + 32 * e;
          const float qv = c < d ? qrow[c] : 0.f;
          const float dov = c < d ? dorow[c] : 0.f;
#pragma unroll
          for (int kk = 0; kk < kSimtPer; ++kk) {
            dv_acc[kk][e] = fmaf(pj[kk], dov, dv_acc[kk][e]);
            dk_acc[kk][e] = fmaf(dj[kk], qv, dk_acc[kk][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < kSimtPer; ++kk) {
    const int c = k0 + kl0 + kk;
    if (c >= seq) continue;
    T* dk_row = dk + (row_base + c) * d;
    T* dv_row = dv + (row_base + c) * d;
#pragma unroll
    for (int e = 0; e < DW; ++e) {
      const int col = lane + 32 * e;
      if (col < d) {
        dk_row[col] = from_f<T>(dk_acc[kk][e]);
        dv_row[col] = from_f<T>(dv_acc[kk][e]);
      }
    }
  }
}

// ----------------------------------------------------------------------------
// Launchers
// ----------------------------------------------------------------------------
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

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *out0, *out1, *delta;
  const float* kbias;
  int batch, heads, seq, d;
  float scale;
  Lists lists;
};

inline dim3 grid_of(const Args& a) {
  return dim3((a.seq + kTile - 1) / kTile, a.heads, a.batch);
}

template <typename T, int DP>
int fwd(const Args& a, cudaStream_t stream) {
  const size_t smem = 3 * kTile * (DP + 8) * sizeof(T);
  auto kernel = a.kbias ? bsa_fwd_kernel<T, DP, true> : bsa_fwd_kernel<T, DP, false>;
  if (int rc = prepare(kernel, grid_of(a), smem)) return rc;
  kernel<<<grid_of(a), kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out0), static_cast<float*>(a.out1), a.kbias, a.seq, a.heads, a.d,
      a.lists);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int bwd_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = 4 * kTile * (DP + 8) * sizeof(T);
  auto kernel = a.kbias ? bsa_bwd_dq_kernel<T, DP, true> : bsa_bwd_dq_kernel<T, DP, false>;
  if (int rc = prepare(kernel, grid_of(a), smem)) return rc;
  kernel<<<grid_of(a), kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
      static_cast<T*>(a.out0), a.kbias, a.seq, a.heads, a.d, a.scale, a.lists);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int bwd_dkv(const Args& a, cudaStream_t stream) {
  constexpr int BQ = DP <= 64 ? 64 : 32;
  const size_t smem = (2 * kTile + 2 * BQ) * (DP + 8) * sizeof(T) + 2 * BQ * sizeof(float);
  auto kernel =
      a.kbias ? bsa_bwd_dkv_kernel<T, DP, BQ, true> : bsa_bwd_dkv_kernel<T, DP, BQ, false>;
  if (int rc = prepare(kernel, grid_of(a), smem)) return rc;
  kernel<<<grid_of(a), kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), static_cast<T*>(a.out1),
      a.kbias, a.seq, a.heads, a.d, a.lists);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DW>
int fwd_simt(const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTile) * (2 * a.d + (a.d | 1)) * sizeof(float);
  auto kernel = bsa_fwd_simt_kernel<T, DW>;
  if (int rc = prepare(kernel, grid_of(a), smem)) return rc;
  kernel<<<grid_of(a), kSimtThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out0), static_cast<float*>(a.out1), a.kbias, a.seq, a.heads, a.d,
      a.lists);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DW>
int bwd_dq_simt(const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTile) * (2 * a.d + 2 * (a.d | 1)) * sizeof(float);
  auto kernel = bsa_bwd_dq_simt_kernel<T, DW>;
  if (int rc = prepare(kernel, grid_of(a), smem)) return rc;
  kernel<<<grid_of(a), kSimtThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
      static_cast<T*>(a.out0), a.kbias, a.seq, a.heads, a.d, a.scale, a.lists);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DW>
int bwd_dkv_simt(const Args& a, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kTile) * (2 * a.d + 2 * (a.d | 1) + 2) * sizeof(float);
  auto kernel = bsa_bwd_dkv_simt_kernel<T, DW>;
  if (int rc = prepare(kernel, grid_of(a), smem)) return rc;
  kernel<<<grid_of(a), kSimtThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), static_cast<T*>(a.out1),
      a.kbias, a.seq, a.heads, a.d, a.lists);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 forward, 1 dQ, 2 dK/dV.  bf16 / fp16 (d % 8 == 0) take the
// tensor-core kernels, fp32 the general ones.
template <typename T>
int dispatch(int which, const Args& a, cudaStream_t s) {
  const int d = a.d;
  if constexpr (std::is_same<T, float>::value) {
#define DSTT_SIMT(DW)                                        \
  return which == 0 ? fwd_simt<T, DW>(a, s)                  \
         : which == 1 ? bwd_dq_simt<T, DW>(a, s)             \
                      : bwd_dkv_simt<T, DW>(a, s)
    if (d <= 32) DSTT_SIMT(1);
    if (d <= 64) DSTT_SIMT(2);
    if (d <= 96) DSTT_SIMT(3);
    DSTT_SIMT(4);
#undef DSTT_SIMT
  } else {
    if (d % 8) return static_cast<int>(cudaErrorInvalidValue);
#define DSTT_MMA(DP)                                         \
  return which == 0 ? fwd<T, DP>(a, s)                       \
         : which == 1 ? bwd_dq<T, DP>(a, s)                  \
                      : bwd_dkv<T, DP>(a, s)
    if (d <= 16) DSTT_MMA(16);
    if (d <= 32) DSTT_MMA(32);
    if (d <= 64) DSTT_MMA(64);
    DSTT_MMA(128);
#undef DSTT_MMA
  }
}

int run(int which, int dtype, const Args& a, void* stream) {
  if (a.d <= 0 || a.d > kMaxD || a.seq <= 0 || a.heads <= 0 || a.batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<__nv_bfloat16>(which, a, s);
  if (dtype == 1) return dispatch<__half>(which, a, s);
  if (dtype == 2) return dispatch<float>(which, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16 (the tensor-core kernels; d a multiple of 8),
// 2 = fp32 (the general kernels).  d <= 128.  Tensors BHSD [batch,
// heads, seq, d] contiguous, lse / delta fp32 [batch, heads, seq], kbias
// fp32 [batch, seq] (added to every row's scores, key by key) or null.  Lists:
// device int32 arrays (ptr of heads * ceil(seq / 64) + 1 entries, idx, mask)
// of the query-major orientation for the forward and dQ, of the key-major
// orientation for dK/dV.  Return: the CUDA error code (0 ok).
extern "C" int dstt_bsa_fwd(int dtype, const void* q, const void* k, const void* v,
                            void* o, void* lse, const float* kbias, int batch, int heads,
                            int seq, int d, const int* ptr, const int* idx, const int* mask,
                            void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, kbias, batch, heads, seq, d, 1.f,
         Lists{ptr, idx, mask}};
  return run(0, dtype, a, stream);
}

// Writes dq and delta (fp32 [batch, heads, seq]) for the dK/dV kernel.
extern "C" int dstt_bsa_bwd_dq(int dtype, const void* q, const void* k,
                               const void* v, const void* o, const void* dout,
                               const void* lse, void* delta, void* dq, const float* kbias,
                               int batch, int heads, int seq, int d, float scale,
                               const int* ptr, const int* idx, const int* mask, void* stream) {
  Args a{q, k, v, o, dout, lse, dq, nullptr, delta, kbias, batch, heads, seq, d, scale,
         Lists{ptr, idx, mask}};
  return run(1, dtype, a, stream);
}

extern "C" int dstt_bsa_bwd_dkv(int dtype, const void* q, const void* k,
                                const void* v, const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, const float* kbias,
                                int batch, int heads, int seq, int d, const int* ptr,
                                const int* idx, const int* mask, void* stream) {
  Args a{q, k, v, nullptr, dout, lse, dk, dv, const_cast<void*>(delta), kbias, batch, heads,
         seq, d, 1.f, Lists{ptr, idx, mask}};
  return run(2, dtype, a, stream);
}
