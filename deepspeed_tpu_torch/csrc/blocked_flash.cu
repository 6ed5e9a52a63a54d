// Paged attention over the blocked KV pool for Hopper (sm_90a), bf16 queries
// over bf16 or int8 pools.
//
// Replaces three TPU kernels of deepspeed_tpu/inference/v2/kernels/blocked_flash.py
// and one XLA path:
//
// * `_kernel` (pallas_call in `paged_attention`): the generic grid over
//   (tokens, table blocks) that every prefill / put() batch takes.  Here:
//   `dstt_paged_attention_bf16`, one CUDA block per (token, KV head).
// * `_decode_kernel` (pallas_call in `paged_decode_attention`), both modes:
//   one query per slot walking only the slot's live blocks.  Here:
//   `dstt_paged_decode_attention_{bf16,int8}`, one CUDA block per (slot, KV
//   head).
// * `_verify_kernel` (pallas_call in `paged_verify_attention`), both modes:
//   K query rows per slot (the fed token and K-1 drafts, at consecutive
//   positions) share one walk of the slot's blocks, each row with its own
//   causal frontier.  Here: `dstt_paged_verify_attention_{bf16,int8}`, one
//   CUDA block per (slot, KV head) scoring every staged key against all
//   K * G query rows of its KV head (G = H / Hkv).
// * `dstt_paged_attention_int8`: the generic kernel over an int8 pool.  The
//   JAX package has no TPU kernel for it: int8 prefill there is XLA (gather,
//   dequantize, einsum; model_implementations/ragged_llama.py:263-275).
//
// All compute, for query row r of unit u (a token, or a verify slot) at
// position p_r in slot s, and each query head h of KV head kh = h / G:
//
//   o[r, h] = softmax_c(q[r, h] . k[c] / sqrt(D)) @ v[c]   over context
//             positions c in [max(0, p_r - window + 1), p_r],
//
// where context position c lives in pool row tables[s, c / bs] * bs + c % bs
// and, in int8 mode, k[c] = k_q[c] * k_scale[row, kh] (v likewise).  For a
// verify unit p_r = token_pos[u * K] + r / G: row s*K + k sits at position
// pos0 + k (the JAX layout).  The softmax is online, in fp32.  A row with no
// visible key (a pad row, p = -1) comes out as exact zeros: a NaN there would
// be written to the trash block and poison real rows.
//
// The TPU kernels walk the table one [bs, Hkv, D] block per grid step (the
// decode and verify kernels with double-buffered DMAs) and carry the
// online-softmax state in VMEM across the sequential grid axis.  CUDA blocks
// run in parallel and in no order, so here the walk is a loop inside the
// block: each warp takes 32 keys at a time (one key a lane), stages their K
// rows in shared memory with 16-byte coalesced loads (8 bf16 or 16 int8
// values), scores them against the block's query rows (GQA: the KV rows are
// read once for the whole group; verify: once for all K rows), folds them
// into its own online-softmax state per row, and accumulates V rows read
// straight from the pool (each lane owns D / 32 output columns).  The warps'
// states are merged in shared memory at the end.  Keys past the deepest
// frontier (or before the window) are never read.
//
// int8: the scale factors out of a dot product, so a key's score is
// scale_k * (q . k_q), with k_q staged as int8 and converted in registers;
// a key's probability is multiplied by its v_scale before it weighs the
// int8 V row.  Each lane loads the two fp32 scales of its own key.
//
// What bounds it on the H100 (3.35 TB/s):
// * Decode reads Σ live context × Hkv × D × 2 (K and V) × (2 bytes bf16, or
//   1 byte + 4 / D of scale in int8): about 39 / 20 MB per 7B layer at
//   8 × 300 tokens, ~12 / ~6 us.  The grid is only S × Hkv = 256 blocks, so
//   decode and verify use 8 warps a block to keep more loads in flight.
//   Splitting each context over several blocks (flash-decoding) would put
//   more blocks in flight; that is later work.
// * Verify reads the same context once for all K rows (the generic kernel
//   would read it K times); its operations, 4 · K · H · ctx · D, do not bind.
// * The generic kernel at prefill re-reads each sequence's context once per
//   token, mostly absorbed by L2.  A tiled design that shares the context
//   across a tile of tokens (the TPU's `_prefill_kernel`) is later work.
//
// Shapes: q / out bf16 [T, H, D]; pools bf16 or int8 [rows, Hkv, D]; scales
// fp32 [rows, Hkv] (int8 only); tables int32 [S, B]; token_slot /
// token_pos int32 [T]; all contiguous.  D is 64 or 128; query rows per
// block (K * G) at most 8 (generic, decode) or 16 (verify).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;        // keys a warp takes per step: one a lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const __nv_bfloat16* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;           // int8 mode only
  const float* v_scale;
  const int* tables;
  const int* token_slot;
  const int* token_pos;
  __nv_bfloat16* out;
  int heads, kv_heads, table_width, block_size, window, k_tokens;
  float scale;
};

// bytes of one staged K row: 16 bytes of padding keep the lanes' 16-byte
// reads of their own rows free of bank conflicts
template <int D, bool kInt8>
__host__ __device__ constexpr int row_bytes() { return (kInt8 ? D : 2 * D) + 16; }

// the warps' staged K rows during the walk, their accumulators after it
template <int D, int W, int R, bool kInt8>
__host__ __device__ constexpr size_t stage_bytes() {
  constexpr size_t stage = static_cast<size_t>(W) * kChunk * row_bytes<D, kInt8>();
  constexpr size_t acc = static_cast<size_t>(W) * R * D * sizeof(float);
  return stage > acc ? stage : acc;
}

template <int D, int W, int R, bool kInt8>
__host__ __device__ constexpr size_t smem_bytes() {
  return stage_bytes<D, W, R, kInt8>()
         + static_cast<size_t>(R) * D * sizeof(float)           // q
         + 2 * static_cast<size_t>(W) * R * sizeof(float);      // m, l
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

// 16 staged bytes as floats: 8 bf16 or 16 int8 values
template <bool kInt8>
__device__ __forceinline__ void unpack16(const int4 raw, float* f) {
  if constexpr (kInt8) {
    const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      f[4 * w] = static_cast<float>(c[w].x);
      f[4 * w + 1] = static_cast<float>(c[w].y);
      f[4 * w + 2] = static_cast<float>(c[w].z);
      f[4 * w + 3] = static_cast<float>(c[w].w);
    }
  } else {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(b[e]);
      f[2 * e] = v.x;
      f[2 * e + 1] = v.y;
    }
  }
}

// this lane's D / 32 columns of one V row as floats
template <int D, bool kInt8>
__device__ __forceinline__ void load_v(const void* v_pool, long long off, float* f) {
  constexpr int kPer = D / 32;
  if constexpr (kInt8) {
    const int8_t* p = static_cast<const int8_t*>(v_pool) + off;
    if constexpr (kPer == 4) {
      const char4 c = __ldg(reinterpret_cast<const char4*>(p));
      f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
    } else {
      const char2 c = __ldg(reinterpret_cast<const char2*>(p));
      f[0] = c.x; f[1] = c.y;
    }
  } else {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(v_pool) + off;
    if constexpr (kPer == 4) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
    } else {
      const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
      f[0] = a.x; f[1] = a.y;
    }
  }
}

// One (unit, KV head): W warps walk the visible context in 32-key chunks for
// the unit's k_tokens * G query rows (at most R).
template <int D, int W, int R, bool kInt8>
__global__ void __launch_bounds__(32 * W)
paged_attention_kernel(const Params p) {
  constexpr int kRowB = row_bytes<D, kInt8>();
  constexpr int kElem = kInt8 ? 1 : 2;          // bytes per pool element
  constexpr int kVecEl = 16 / kElem;            // elements per 16-byte vector
  constexpr int kVecs = D / kVecEl;             // 16-byte vectors in a K row
  constexpr int kPer = D / 32;                  // output columns a lane owns
  constexpr size_t kStage = stage_bytes<D, W, R, kInt8>();
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_s = smem;
  float* q_s = reinterpret_cast<float*>(smem + kStage);
  float* m_s = q_s + R * D;
  float* l_s = m_s + W * R;
  float* acc_s = reinterpret_cast<float*>(smem);  // after the walk

  const int u = blockIdx.x;
  const int kh = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = p.heads / p.kv_heads;
  const int rows = p.k_tokens * group;
  const int t0 = u * p.k_tokens;                // the unit's first token
  const int pos0 = p.token_pos[t0];
  const int* table = p.tables + static_cast<size_t>(p.token_slot[t0]) * p.table_width;
  const size_t row_stride = static_cast<size_t>(p.kv_heads) * D;   // elements
  const size_t kv_off = static_cast<size_t>(kh) * D;
  // q / out offset of query row r: token t0 + r / G, head kh * G + r % G
  auto q_off = [&](int r) {
    return (static_cast<size_t>(t0 + r / group) * p.heads + static_cast<size_t>(kh) * group
            + r % group) * D;
  };

  for (int i = threadIdx.x; i < rows * D; i += 32 * W)
    q_s[i] = __bfloat162float(p.q[q_off(i / D) + i % D]);
  __syncthreads();

  const int first = p.window > 0 ? max(0, pos0 - p.window + 1) : 0;
  const int last = min(pos0 + p.k_tokens - 1, p.table_width * p.block_size - 1);

  float m[R], l[R], acc[R][kPer];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[r][e] = 0.f;
  }

  unsigned char* ks = k_s + static_cast<size_t>(warp) * kChunk * kRowB;
  const unsigned char* k_bytes = static_cast<const unsigned char*>(p.k_pool);
  for (int c0 = (first / kChunk) * kChunk + warp * kChunk; c0 <= last;
       c0 += W * kChunk) {
    // this lane's key and its pool row (-1: outside the walk, never read)
    const int c = c0 + lane;
    const bool valid = c >= first && c <= last;
    long long row = -1;
    if (valid) row = static_cast<long long>(table[c / p.block_size]) * p.block_size + c % p.block_size;
    float k_sc = 1.f, v_sc = 1.f;
    if constexpr (kInt8) {
      if (valid) {
        k_sc = __ldg(p.k_scale + row * p.kv_heads + kh);
        v_sc = __ldg(p.v_scale + row * p.kv_heads + kh);
      }
    }

    // stage the chunk's K rows, 16 bytes a lane per load
#pragma unroll 4
    for (int i = lane; i < kChunk * kVecs; i += 32) {
      const int r = i / kVecs;
      const int seg = i % kVecs;
      const long long rr = __shfl_sync(kFull, row, r);
      int4 val = make_int4(0, 0, 0, 0);
      if (rr >= 0)
        val = __ldg(reinterpret_cast<const int4*>(
            k_bytes + (rr * row_stride + kv_off) * kElem + seg * 16));
      *reinterpret_cast<int4*>(ks + r * kRowB + seg * 16) = val;
    }
    __syncwarp();

    // scores of this lane's key against the unit's query rows
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const unsigned char* krow = ks + lane * kRowB;
#pragma unroll 4
    for (int d = 0; d < D; d += kVecEl) {
      float kf[kVecEl];
      unpack16<kInt8>(*reinterpret_cast<const int4*>(krow + d * kElem), kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
#pragma unroll
          for (int e = 0; e < kVecEl; ++e) s[r] = fmaf(q_s[r * D + d + e], kf[e], s[r]);
        }
      }
    }

    // online softmax: fold the chunk into this warp's state, row by row;
    // s[r] becomes the probability that weighs V (times v_scale in int8)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        const int pr = pos0 + r / group;        // row r's causal frontier
        const bool vis = valid && c <= pr && (p.window <= 0 || c > pr - p.window);
        const float sc = vis ? s[r] * p.scale * k_sc : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sc));
        const float prob = vis ? __expf(sc - m_new) : 0.f;
        const float corr = __expf(m[r] - m_new);
        l[r] = l[r] * corr + warp_sum(prob);
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[r][e] *= corr;
        m[r] = m_new;
        s[r] = prob * v_sc;
      }
    }

    // acc[r][:] += Σ_key prob(key, r) · v[key, lane's columns]
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const long long rr = __shfl_sync(kFull, row, j);
      if (rr < 0) continue;                     // uniform across the warp
      float vf[kPer];
      load_v<D, kInt8>(p.v_pool, rr * row_stride + kv_off + lane * kPer, vf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          const float pj = __shfl_sync(kFull, s[r], j);
#pragma unroll
          for (int e = 0; e < kPer; ++e) acc[r][e] = fmaf(pj, vf[e], acc[r][e]);
        }
      }
    }
    __syncwarp();       // the next chunk overwrites this warp's K rows
  }

  // merge the W warps' (m, l, acc) states
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m_s[warp * R + r] = m[r];
      l_s[warp * R + r] = l[r];
    }
  }
  __syncthreads();                              // all warps are done with k_s
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows) {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        acc_s[(warp * R + r) * D + lane * kPer + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += 32 * W) {
    const int r = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, m_s[w * R + r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float f = __expf(m_s[w * R + r] - mx);
      num += f * acc_s[(w * R + r) * D + i % D];
      den += f * l_s[w * R + r];
    }
    p.out[q_off(r) + i % D] = __float2bfloat16(den == 0.f ? 0.f : num / den);
  }
}

template <int D, int W, int R, bool kInt8>
int launch(const Params& p, int units, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, W, R, kInt8>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<D, W, R, kInt8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(units, p.kv_heads);
  paged_attention_kernel<D, W, R, kInt8><<<grid, 32 * W, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int W, int R, bool kInt8>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* tables,
             const void* token_slot, const void* token_pos, void* out,
             int units, int heads, int kv_heads, int head_dim, int table_width,
             int block_size, int window, int k_tokens, float scale, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads || k_tokens < 1
      || k_tokens * (heads / kv_heads) > R)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
                 static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                 static_cast<const int*>(tables), static_cast<const int*>(token_slot),
                 static_cast<const int*>(token_pos), static_cast<__nv_bfloat16*>(out),
                 heads, kv_heads, table_width, block_size, window, k_tokens, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return launch<128, W, R, kInt8>(p, units, s);
  if (head_dim == 64) return launch<64, W, R, kInt8>(p, units, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Every entry point takes the same arguments.  `units`: tokens (generic,
// decode) or slots (verify: T = units * k_tokens rows, slot-major);
// `k_tokens` is 1 outside verify; `window` <= 0 means no sliding window;
// k_scale / v_scale are read in the int8 modes only.  Return: the CUDA error
// code (0 ok).
#define DSTT_ARGS                                                              \
  const void *q, const void *k_pool, const void *v_pool, const void *k_scale,  \
      const void *v_scale, const void *tables, const void *token_slot,         \
      const void *token_pos, void *out, int units, int heads, int kv_heads,    \
      int head_dim, int table_width, int block_size, int window, int k_tokens, \
      float scale, void *stream
#define DSTT_PASS                                                              \
  q, k_pool, v_pool, k_scale, v_scale, tables, token_slot, token_pos, out,     \
      units, heads, kv_heads, head_dim, table_width, block_size, window,       \
      k_tokens, scale, stream

extern "C" int dstt_paged_attention_bf16(DSTT_ARGS) {
  return dispatch<4, 8, false>(DSTT_PASS);
}
extern "C" int dstt_paged_attention_int8(DSTT_ARGS) {
  return dispatch<4, 8, true>(DSTT_PASS);
}
extern "C" int dstt_paged_decode_attention_bf16(DSTT_ARGS) {
  return dispatch<8, 8, false>(DSTT_PASS);
}
extern "C" int dstt_paged_decode_attention_int8(DSTT_ARGS) {
  return dispatch<8, 8, true>(DSTT_PASS);
}
extern "C" int dstt_paged_verify_attention_bf16(DSTT_ARGS) {
  return dispatch<8, 16, false>(DSTT_PASS);
}
extern "C" int dstt_paged_verify_attention_int8(DSTT_ARGS) {
  return dispatch<8, 16, true>(DSTT_PASS);
}
