// Paged attention over the blocked KV pool for Hopper (sm_90a), bf16.
//
// Replaces two TPU kernels of deepspeed_tpu/inference/v2/kernels/blocked_flash.py:
//
// * `_kernel` (pallas_call in `paged_attention`): the generic grid over
//   (tokens, table blocks) that every prefill / put() batch takes.  Here:
//   `dstt_paged_attention_bf16`, one CUDA block per (token, KV head).
// * `_decode_kernel` (pallas_call in `paged_decode_attention`), bf16 mode:
//   one query per slot walking only the slot's live blocks.  Here:
//   `dstt_paged_decode_attention_bf16`, one CUDA block per (slot, KV head).
//
// Both compute, for token t with position p = token_pos[t] in slot
// s = token_slot[t], and each query head h of KV head kh = h / (H / Hkv):
//
//   o[t, h] = softmax_c(q[t, h] . k[c] / sqrt(D)) @ v[c]   over context
//             positions c in [max(0, p - window + 1), p],
//
// where context position c lives in pool row
// tables[s, c / bs] * bs + c % bs.  The softmax is online, in fp32.  A row
// with no visible key (a pad row, p = -1) comes out as exact zeros: a NaN
// there would be written to the trash block and poison real rows.
//
// The TPU kernels walk the table one [bs, Hkv, D] block per grid step and
// carry the online-softmax state in VMEM scratch across the sequential grid
// axis.  CUDA blocks run in parallel and in no order, so here the walk is a
// loop inside the block: each warp takes 32 keys at a time (one key a lane),
// stages their K rows in shared memory with 16-byte coalesced loads, scores
// them against the G = H / Hkv query heads of its KV head (GQA: the KV rows
// are read once for the whole group), folds them into its own online-softmax
// state, and accumulates V rows read straight from the pool (each lane owns
// D / 32 output columns).  The warps' states are merged in shared memory at
// the end.  Keys past p (or before the window) are never read.
//
// What bounds it on the H100:
// * Decode reads Σ live context × Hkv × D × 2 B × 2 (K and V) — about
//   39 MB per 7B layer at 8 × 300 tokens, ~12 us at 3.35 TB/s.  The grid is
//   only S × Hkv = 256 blocks, so the decode launch uses 8 warps a block to
//   keep more loads in flight.  Splitting each context over several blocks
//   (flash-decoding: per-split partial softmax states merged by a second
//   pass) would put ~4x more blocks in flight and hide the latency of the
//   serial per-warp chunk walk; that is later work.
// * The generic kernel at prefill re-reads each sequence's context once per
//   token: T × C × Hkv × D × 4 bytes per layer, mostly absorbed by L2 (one
//   7B sequence's 384-token context is 6.3 MB).  A tiled design that shares
//   the context across a tile of tokens (the TPU's `_prefill_kernel`) is
//   later work.
//
// Shapes: q / out bf16 [T, H, D]; pools bf16 [rows, Hkv, D]; tables int32
// [S, B]; token_slot / token_pos int32 [T]; all contiguous.  D is 64 or
// 128, H / Hkv <= 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;        // keys a warp takes per step: one a lane
constexpr int kMaxGroup = 8;      // query heads per KV head
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int D, int W>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(W) * kChunk * (D + 8) * sizeof(__nv_bfloat16)  // K rows
         + static_cast<size_t>(kMaxGroup) * D * sizeof(float)               // q
         + 2 * static_cast<size_t>(W) * kMaxGroup * sizeof(float);          // m, l
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One (token, KV head): W warps walk the visible context in 32-key chunks.
template <int D, int W>
__global__ void __launch_bounds__(32 * W)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pool,
                       const __nv_bfloat16* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ token_slot,
                       const int* __restrict__ token_pos,
                       __nv_bfloat16* __restrict__ out,
                       int heads, int kv_heads, int table_width,
                       int block_size, int window, float scale) {
  constexpr int kRow = D + 8;       // padded K row: conflict-free 16 B reads
  constexpr int kVecs = D / 8;      // 16-byte vectors in one K row
  constexpr int kPer = D / 32;      // output columns a lane owns
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + static_cast<size_t>(W) * kChunk * kRow * 2);
  float* m_s = q_s + kMaxGroup * D;
  float* l_s = m_s + W * kMaxGroup;
  // after the walk the K staging area holds the warps' accumulators
  float* acc_s = reinterpret_cast<float*>(smem);
  static_assert(W * kMaxGroup * D * 4 <= W * kChunk * kRow * 2, "acc_s fits");

  const int t = blockIdx.x;
  const int kh = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = heads / kv_heads;
  const int pos = token_pos[t];
  const int* table = tables + static_cast<size_t>(token_slot[t]) * table_width;
  const size_t head_off = (static_cast<size_t>(t) * heads + static_cast<size_t>(kh) * group) * D;
  const size_t row_stride = static_cast<size_t>(kv_heads) * D;
  const size_t kv_off = static_cast<size_t>(kh) * D;

  for (int i = threadIdx.x; i < group * D; i += 32 * W)
    q_s[i] = __bfloat162float(q[head_off + i]);
  __syncthreads();

  const int first = window > 0 ? max(0, pos - window + 1) : 0;
  const int last = min(pos, table_width * block_size - 1);   // < first: empty

  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][kPer];
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[h][e] = 0.f;
  }

  __nv_bfloat16* ks = k_s + warp * kChunk * kRow;
  for (int c0 = (first / kChunk) * kChunk + warp * kChunk; c0 <= last;
       c0 += W * kChunk) {
    // this lane's key and its pool row (-1: not visible, never read)
    const int c = c0 + lane;
    const bool valid = c >= first && c <= last;
    long long row = -1;
    if (valid) row = static_cast<long long>(table[c / block_size]) * block_size + c % block_size;

    // stage the chunk's K rows: half a warp per 256-byte row at D = 128
#pragma unroll 4
    for (int i = lane; i < kChunk * kVecs; i += 32) {
      const int r = i / kVecs;
      const int seg = i % kVecs;
      const long long rr = __shfl_sync(kFull, row, r);
      int4 val = make_int4(0, 0, 0, 0);
      if (rr >= 0)
        val = __ldg(reinterpret_cast<const int4*>(k_pool + rr * row_stride + kv_off + seg * 8));
      *reinterpret_cast<int4*>(ks + r * kRow + seg * 8) = val;
    }
    __syncwarp();

    // scores of this lane's key against the group's query heads
    float p[kMaxGroup];
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) p[h] = 0.f;
    const __nv_bfloat16* krow = ks + lane * kRow;
#pragma unroll 4
    for (int d = 0; d < D; d += 8) {
      const int4 raw = *reinterpret_cast<const int4*>(krow + d);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float kf[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(k2[e]);
        kf[2 * e] = f.x;
        kf[2 * e + 1] = f.y;
      }
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) {
        if (h < group) {
#pragma unroll
          for (int e = 0; e < 8; ++e) p[h] = fmaf(q_s[h * D + d + e], kf[e], p[h]);
        }
      }
    }

    // online softmax: fold the chunk into this warp's running state
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) {
      if (h < group) {
        const float sc = valid ? p[h] * scale : kNegInf;
        const float m_new = fmaxf(m[h], warp_max(sc));
        const float prob = valid ? __expf(sc - m_new) : 0.f;
        const float corr = __expf(m[h] - m_new);
        l[h] = l[h] * corr + warp_sum(prob);
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[h][e] *= corr;
        m[h] = m_new;
        p[h] = prob;
      }
    }

    // acc[h][:] += Σ_key prob(key, h) · v[key, lane's columns]
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const long long rr = __shfl_sync(kFull, row, j);
      if (rr < 0) continue;                     // uniform across the warp
      const __nv_bfloat16* vrow = v_pool + rr * row_stride + kv_off + lane * kPer;
      float vf[kPer];
      if constexpr (kPer == 4) {
        const uint2 raw = __ldg(reinterpret_cast<const uint2*>(vrow));
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        vf[0] = a.x; vf[1] = a.y; vf[2] = b.x; vf[3] = b.y;
      } else {
        const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(vrow));
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
        vf[0] = a.x; vf[1] = a.y;
      }
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) {
        if (h < group) {
          const float pj = __shfl_sync(kFull, p[h], j);
#pragma unroll
          for (int e = 0; e < kPer; ++e) acc[h][e] = fmaf(pj, vf[e], acc[h][e]);
        }
      }
    }
    __syncwarp();       // the next chunk overwrites this warp's K rows
  }

  // merge the W warps' (m, l, acc) states
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) {
      m_s[warp * kMaxGroup + h] = m[h];
      l_s[warp * kMaxGroup + h] = l[h];
    }
  }
  __syncthreads();                              // all warps are done with k_s
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
    if (h < group) {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        acc_s[(warp * kMaxGroup + h) * D + lane * kPer + e] = acc[h][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * D; i += 32 * W) {
    const int h = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, m_s[w * kMaxGroup + h]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float f = __expf(m_s[w * kMaxGroup + h] - mx);
      num += f * acc_s[(w * kMaxGroup + h) * D + i % D];
      den += f * l_s[w * kMaxGroup + h];
    }
    out[head_off + i] = __float2bfloat16(den == 0.f ? 0.f : num / den);
  }
}

template <int D, int W>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* token_slot, const void* token_pos,
           void* out, int tokens, int heads, int kv_heads, int table_width,
           int block_size, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, W>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<D, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(tokens, kv_heads);
  paged_attention_kernel<D, W><<<grid, 32 * W, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(token_slot), static_cast<const int*>(token_pos),
      static_cast<__nv_bfloat16*>(out), heads, kv_heads, table_width, block_size,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int dispatch(int head_dim, const void* q, const void* k_pool, const void* v_pool,
             const void* tables, const void* token_slot, const void* token_pos,
             void* out, int tokens, int heads, int kv_heads, int table_width,
             int block_size, int window, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return launch<128, W>(q, k_pool, v_pool, tables, token_slot, token_pos, out,
                          tokens, heads, kv_heads, table_width, block_size,
                          window, scale, s);
  if (head_dim == 64)
    return launch<64, W>(q, k_pool, v_pool, tables, token_slot, token_pos, out,
                         tokens, heads, kv_heads, table_width, block_size,
                         window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// `window` <= 0 means no sliding window.  Return: the CUDA error code (0 ok).
extern "C" int dstt_paged_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* token_slot, const void* token_pos, void* out, int tokens,
    int heads, int kv_heads, int head_dim, int table_width, int block_size,
    int window, float scale, void* stream) {
  return dispatch<4>(head_dim, q, k_pool, v_pool, tables, token_slot, token_pos,
                     out, tokens, heads, kv_heads, table_width, block_size,
                     window, scale, stream);
}

extern "C" int dstt_paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* token_slot, const void* token_pos, void* out, int slots,
    int heads, int kv_heads, int head_dim, int table_width, int block_size,
    int window, float scale, void* stream) {
  return dispatch<8>(head_dim, q, k_pool, v_pool, tables, token_slot, token_pos,
                     out, slots, heads, kv_heads, table_width, block_size,
                     window, scale, stream);
}
