// Tiled paged prefill attention for Hopper (sm_90a), bf16 queries over a
// bf16 blocked KV pool, fp32 accumulators.
//
// Replaces the TPU kernel deepspeed_tpu/inference/v2/kernels/blocked_flash.py
// `_prefill_kernel` (its pallas_call is in `paged_prefill_attention`).
//
// The engine packs prefill chunks tile-aligned: every tile_q-row stripe of
// the token buffer belongs to one slot (the slot of its first row), and pad
// rows carry position -1.  For token row r at position p_r, query head h and
// its KV head kh = h / G (G = H / Hkv):
//
//   o[r, h] = softmax_c(q[r, h] . k[c] * scale) @ v[c]   over context
//             positions c in [max(0, p_r - window + 1), p_r],
//
// where context position c lives in pool row tables[s, c / bs] * bs + c % bs.
// A pad row sees no key and comes out as exact zeros (l == 0 -> 1, as the
// TPU kernel's `safe_l`): a NaN there would be written to the trash block
// and poison real rows.  P keeps about 16 bits where it weighs V: it is
// split into two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), each
// multiplied by V into the same fp32 accumulator.  The TPU kernel rounds P
// to bf16 (`p.astype(vb.dtype)`); that moved the whole output 2e-3 in norm
// from the plain version (fp32 P, as the JAX package's XLA path and the
// port's other paged kernels keep it), enough to flip a near-tie of
// Mixtral's top-2 router a few layers on.
//
// The TPU kernel runs a grid of (tiles, table blocks), carrying the
// online-softmax state in VMEM across the sequential block axis.  CUDA
// blocks run in parallel and in no order, so here one block takes 64 rows
// of one stripe for one query head, and walks the slot's context in
// 64-key tiles in a loop inside the block, from the window's low edge (of
// the rows' lowest position) up to their highest position: keys past it,
// and tiles wholly below the window, are never read.  Each 64-key tile is
// gathered through the block table row by row (any block size), K and V
// staged in shared memory with 16-byte loads, rows padded by 16 bytes so
// that ldmatrix is free of bank conflicts; the products run on mma.sync
// m16n8k16, 4 warps of 16 rows each, with the online softmax in registers
// (each row held by one quad of lanes) and the per-row mask key_pos <= p_r
// (and > p_r - window).  A tile that every row sees whole skips the mask.
//
// What bounds it on the H100: at the served prefill (2 x 256 tokens,
// 32 heads over 8 KV heads, D = 128) the bytes, ~10 MB (q and out once,
// each slot's K and V rows once: ~3 us at 3.35 TB/s), against ~1 GFLOP of
// causal products (~1 us at 989 TFLOP/s).  The generic paged kernel reads
// a slot's context once per token; here once per 64-row tile and query
// head, the G heads of a KV head and the two 64-row halves of a stripe
// re-reading it from L2.  Loads are not pipelined behind the products yet
// (cp.async double buffering, wgmma and TMA are later work).
//
// Shapes (the wrapper checks them): q / out bf16 [T, H, D]; pools bf16
// [rows, Hkv, D]; tables int32 [S, B]; token_slot / token_pos int32 [T];
// all contiguous; D is 64 or 128; tile_q a multiple of 64 dividing T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;             // rows of a q tile, keys of a k/v tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[N/8][4] += A[16 x K] B[N x K]^T, both in shared memory with row stride
// LD: A is the warp's 16 query rows, B the tile's keys.  Accumulator layout
// of m16n8: acc[j][0..1] = row g, cols 8j + 2t + {0,1}; acc[j][2..3] = row
// g + 8 (g = lane / 4, t = lane % 4).
template <int K, int N, int LD>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * LD + k0 + (lane / 16) * 8);
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (n0 + (lane / 16) * 8 + lane % 8) * LD + k0 + ((lane / 8) % 2) * 8);
      mma16816(acc[n0 / 8], af, bf[0], bf[1]);
      mma16816(acc[n0 / 8 + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[D/8][4] += (P_hi + P_lo)[16 x N] V[N x D]: P's two bf16 terms in
// registers as A fragments, V in shared memory, row-major with row stride
// LD, each V fragment loaded once for both terms.
template <int N, int D, int LD>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4], const uint32_t (&hi)[N / 16][4],
                                       const uint32_t (&lo)[N / 16][4],
                                       const __nv_bfloat16* v, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 16) {
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, v + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + d0 + (lane / 16) * 8);
      mma16816(acc[d0 / 8], hi[k0 / 16], bf[0], bf[1]);
      mma16816(acc[d0 / 8 + 1], hi[k0 / 16], bf[2], bf[3]);
      mma16816(acc[d0 / 8], lo[k0 / 16], bf[0], bf[1]);
      mma16816(acc[d0 / 8 + 1], lo[k0 / 16], bf[2], bf[3]);
    }
  }
}

// two fp32 values as the packed bf16 pair hi and the packed bf16 pair of
// what hi leaves over
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack2(a - __low2float(h), b - __high2float(h));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
                     const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ tables,
                     const int* __restrict__ token_slot, const int* __restrict__ token_pos,
                     __nv_bfloat16* __restrict__ out, int heads, int kv_heads, int table_width,
                     int block_size, int tile_q, int window, float scale) {
  constexpr int LD = D + 8;
  constexpr int kVec = D / 8;                  // 16-byte vectors in a row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + kTile * LD;
  __nv_bfloat16* v_s = k_s + kTile * LD;
  int* pos_s = reinterpret_cast<int*>(v_s + kTile * LD);   // the rows' positions
  int* row_s = pos_s + kTile;                              // the tile's pool rows

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = blockIdx.x * kTile, h = blockIdx.y;
  const int kh = h / (heads / kv_heads);
  const size_t q_stride = static_cast<size_t>(heads) * D;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * D;
  const int* table = tables + static_cast<size_t>(token_slot[(t0 / tile_q) * tile_q]) * table_width;

  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    *reinterpret_cast<int4*>(q_s + r * LD + c) = *reinterpret_cast<const int4*>(
        q + static_cast<size_t>(t0 + r) * q_stride + static_cast<size_t>(h) * D + c);
  }
  if (threadIdx.x < kTile) pos_s[threadIdx.x] = token_pos[t0 + threadIdx.x];
  __syncthreads();

  // the rows' highest position, lowest real position and lowest position
  // (pads included: -1 when the tile holds a pad)
  int max_pos = -1, min_real = 0x7fffffff, min_all = 0x7fffffff;
  for (int i = 0; i < kTile; ++i) {
    const int p = pos_s[i];
    max_pos = max(max_pos, p);
    min_all = min(min_all, p);
    if (p >= 0) min_real = min(min_real, p);
  }
  const int r0 = warp * 16 + g;                // this lane's rows r0, r0 + 8
  const int pr[2] = {pos_s[r0], pos_s[r0 + 8]};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int last = min(max_pos, table_width * block_size - 1);
  const int first = (window > 0 && max_pos >= 0) ? max(0, min_real - window + 1) : 0;
  for (int c0 = (first / kTile) * kTile; c0 <= last; c0 += kTile) {
    __syncthreads();                            // the last tile's reads are done
    if (threadIdx.x < kTile) {
      const int c = c0 + threadIdx.x;
      row_s[threadIdx.x] = c <= last ? table[c / block_size] * block_size + c % block_size : -1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
      const int r = i / kVec, c = (i % kVec) * 8;
      const int row = row_s[r];
      int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
      if (row >= 0) {
        const size_t off = static_cast<size_t>(row) * kv_stride + static_cast<size_t>(kh) * D + c;
        kv = *reinterpret_cast<const int4*>(k_pool + off);
        vv = *reinterpret_cast<const int4*>(v_pool + off);
      }
      *reinterpret_cast<int4*>(k_s + r * LD + c) = kv;
      *reinterpret_cast<int4*>(v_s + r * LD + c) = vv;
    }
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt<D, kTile, LD>(s, q_s + warp * 16 * LD, k_s, lane);

    float mx[2] = {kNegInf, kNegInf};
    const bool whole = c0 + kTile - 1 <= min_all && (window <= 0 || c0 > max_pos - window);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = pr[e >> 1];
        const int c = c0 + 8 * j + 2 * t + (e & 1);
        if (whole || (c <= p && (window <= 0 || c > p - window))) {
          s[j][e] *= scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        } else {
          s[j][e] = -__int_as_float(0x7f800000);   // -inf: exp(-inf - m) = 0
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
    uint32_t ph[kTile / 16][4], pl[kTile / 16][4];
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      split2(s[2 * c][0], s[2 * c][1], ph[c][0], pl[c][0]);
      split2(s[2 * c][2], s[2 * c][3], ph[c][1], pl[c][1]);
      split2(s[2 * c + 1][0], s[2 * c + 1][1], ph[c][2], pl[c][2]);
      split2(s[2 * c + 1][2], s[2 * c + 1][3], ph[c][3], pl[c][3]);
    }
    mma_pv<kTile, D, LD>(acc, ph, pl, v_s, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    __nv_bfloat16* orow = out + static_cast<size_t>(t0 + r) * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          pack2(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* token_slot, const void* token_pos, void* out, int tokens, int heads,
           int kv_heads, int table_width, int block_size, int tile_q, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = 3 * kTile * (D + 8) * sizeof(__nv_bfloat16) + 2 * kTile * sizeof(int);
  auto kernel = paged_prefill_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(tokens / kTile, heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(token_slot), static_cast<const int*>(token_pos),
      static_cast<__nv_bfloat16*>(out), heads, kv_heads, table_width, block_size, tile_q,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `window` <= 0: no sliding window.  Return: the CUDA error code (0 ok).
extern "C" int dstt_paged_prefill_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* token_slot, const void* token_pos, void* out, int tokens, int heads,
    int kv_heads, int head_dim, int table_width, int block_size, int tile_q, int window,
    float scale, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads || block_size <= 0 || tile_q <= 0
      || tile_q % kTile || tokens % tile_q)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return launch<128>(q, k_pool, v_pool, tables, token_slot, token_pos, out, tokens, heads,
                       kv_heads, table_width, block_size, tile_q, window, scale, s);
  if (head_dim == 64)
    return launch<64>(q, k_pool, v_pool, tables, token_slot, token_pos, out, tokens, heads,
                      kv_heads, table_width, block_size, tile_q, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
