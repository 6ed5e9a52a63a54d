// Paged attention over the blocked KV pool for Hopper (sm_90a), bf16 queries
// over bf16 or int8 pools.
//
// Replaces three TPU kernels of deepspeed_tpu/inference/v2/kernels/blocked_flash.py
// and one XLA path:
//
// * `_kernel` (pallas_call in `paged_attention`): the generic grid over
//   (tokens, table blocks) that every prefill / put() batch takes.  Here:
//   `dstt_paged_attention_bf16`, the tiled kernel below.
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
// The generic kernel (`paged_attention_tiled_kernel`).  The TPU kernel is
// one grid step per (token, table block); here one CUDA block (a
// warpgroup) takes a 64-row stripe of query rows for one KV head: 64 / G
// tokens x their G query heads (G = H / Hkv, at most 8), so each K / V
// row is read once for the whole group and once for the stripe's tokens
// instead of once per token.  The engine packs each sequence's tokens
// contiguously, so a stripe holds one slot or a few at run boundaries;
// the kernel assumes nothing of the order: it lists the distinct slots of
// its stripe and walks each one's context once, in 64-key tiles from the
// lowest window edge of that slot's rows up to their highest position,
// masking the rows of other slots.  Each row keeps its own causal
// frontier and window; a tile that a row sees whole skips its mask, and
// with a window a tile that no row sees is skipped.  A stripe of 64
// one-token slots reads what a per-token walk reads, never more.
//   Both products run on wgmma: S = Q K^T (m64 n64 k16, Q and K K-major
// in 128-byte-swizzled shared memory) and O += P V (m64 nD k16, P from
// registers, V MN-major, read in place as [keys, D] rows).  The online
// softmax stays in fp32 registers.  P keeps about 16 bits where it weighs
// V: it is split into hi = bf16(p) and lo = bf16(p - hi), both multiplied
// into the same fp32 accumulator (a single bf16 P moved Mixtral's output
// by 2e-3 in norm, enough to flip a router near-tie).  K / V tiles load
// asynchronously into a 2-stage ring while the previous tile multiplies:
// one TMA box per operand (per 64-column half in bf16) when the block
// size is a multiple of 64, so that a tile lies in one pool block;
// otherwise 16-byte cp.async gathers through the table, row by row; a
// tile's pool rows are looked up one tile ahead, and the q tile is copied
// with cp.async while the block lists its slots.  int8
// pools: the rows are converted to bf16 in shared memory (every int8 value
// is exact in bf16), k_scale multiplies its score column in fp32 after
// Q K^T and v_scale P's column before P V.  Keys past the table's end are
// zeros; a tile's other keys are pool rows (finite: the pool is zeroed at
// allocation and written with finite values).
//
// The decode and verify kernels (`paged_attention_kernel`): each block
// walks its unit's live context in 32-key chunks per warp: it stages the K
// rows in shared memory with 16-byte coalesced loads (8 bf16 or 16 int8
// values), scores them against the unit's query rows (GQA: the KV rows
// are read once for the whole group; verify: once for all K rows), folds
// them into each warp's online-softmax state per row, and accumulates V
// rows read straight from the pool (each lane owns D / 32 output
// columns); the warps' states merge in shared memory at the end.  int8:
// a key's score is scale_k * (q . k_q) and its probability is multiplied
// by its v_scale before it weighs the int8 V row.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16):
// * Prefill (2 x 256 tokens, 32 heads, D = 128): each slot's K and V rows
//   once, q and out once: ~10 MB in bf16 (~3 us), ~7 MB in int8, against
//   ~1.1 GFLOP of causal products (~1 us), so bytes bind; the generic
//   kernel reads a stripe's context once per KV head, and the 4 stripes
//   of a 256-token prompt re-read the earlier tiles from L2.  Later work:
//   stripes of 128 rows (two consumer warpgroups) and a warp-specialised
//   producer, so that the softmax of one tile overlaps the products of the
//   next.
// * Decode reads Σ live context × Hkv × D × 2 (K and V) × (2 bytes bf16, or
//   1 byte + 4 / D of scale in int8): about 39 / 20 MB per 7B layer at
//   8 × 300 tokens, ~12 / ~6 us.  The grid is only S × Hkv = 256 blocks, so
//   decode and verify use 8 warps a block to keep more loads in flight.
//   Splitting each context over several blocks (flash-decoding) would put
//   more blocks in flight; that is later work.
// * Verify reads the same context once for all K rows (the generic kernel
//   would read it once per 64-row stripe); its operations,
//   4 · K · H · ctx · D, do not bind.
//
// Shapes: q / out bf16 [T, H, D]; pools bf16 or int8 [rows, Hkv, D]; scales
// fp32 [rows, Hkv] (int8 only); tables int32 [S, B]; token_slot /
// token_pos int32 [T]; all contiguous.  D is 64 or 128; G at most 8;
// query rows per block (K * G) at most 8 (decode) or 16 (verify).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

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


// two fp32 values as the packed bf16 pair hi and the packed bf16 pair of
// what hi leaves over
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// ------------------------------------------------- the generic (tiled) kernel

namespace tiled {

constexpr int kRows = 64;        // query rows of a block: (64 / G) tokens x G heads
constexpr int kKeys = 64;        // keys of a tile
constexpr int kThreads = 128;    // one warpgroup
constexpr int kMeta = 8 * 64 * 4;  // token and walk metadata (int32 arrays of 64)
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

struct Params {
  const __nv_bfloat16* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;          // int8 mode only
  const float* v_scale;
  const int* tables;
  const int* token_slot;
  const int* token_pos;
  __nv_bfloat16* out;
  int tokens, heads, kv_heads, table_width, block_size, window;
  float scale_log2;              // log2(e) / sqrt(D)
  int tma;                       // block_size % 64 == 0: a tile is one TMA box a pool
};

// Shared memory, in bytes from a 1024-aligned base: the q tile (later the
// output), two stages of K and V (bf16 tiles, or the int8 rows as read),
// in int8 mode the K and V tiles converted to bf16 and the tile's scales,
// then the metadata and the stages' mbarriers.
template <int D, bool kInt8>
struct Layout {
  static constexpr int kTile = kKeys * D * 2;                 // a bf16 [64, D] tile
  static constexpr int kStage = kInt8 ? kKeys * D : kTile;    // one operand of a stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;                       // [2] stages
  static constexpr int kV = kK + 2 * kStage;
  static constexpr int kKc = kV + 2 * kStage;                 // int8: converted tiles
  static constexpr int kVc = kKc + (kInt8 ? kTile : 0);
  static constexpr int kScales = kVc + (kInt8 ? kTile : 0);   // k_scale[64], v_scale[64]
  static constexpr int kMetaOff = kScales + (kInt8 ? 2 * kKeys * 4 : 0);
  static constexpr int kBars = kMetaOff + kMeta;
  static constexpr int kBytes = kBars + 2 * 8 + 1024;         // + alignment slack
};

// a tile of the walk: the u-th distinct slot of the stripe, keys c0 .. c0 + 63
struct Tile {
  int u, c0;
};

template <int D, bool kInt8>
__global__ void __launch_bounds__(kThreads)
paged_attention_tiled_kernel(const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map, const Params p) {
  using L = Layout<D, kInt8>;
  constexpr int kElem = kInt8 ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = sm + L::kQ;
  float* ksc = reinterpret_cast<float*>(sm + L::kScales);
  float* vsc = ksc + kKeys;
  int* tok_pos = reinterpret_cast<int*>(sm + L::kMetaOff);    // [64] token positions (-1: none)
  int* tok_slot = tok_pos + 64;                               // [64] its slot (-1: none)
  int* w_slot = tok_slot + 64;                                // [64] the walks' slots
  int* w_lo = w_slot + 64;                                    // [64] a walk's first tile
  int* w_hi = w_lo + 64;                                      // [64] its last key
  unsigned* lead_mask = reinterpret_cast<unsigned*>(w_hi + 64);  // [2]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = p.heads / p.kv_heads;
  const int ts = kRows / group;                 // tokens of the stripe
  const int t0 = blockIdx.x * ts;
  const int kh = blockIdx.y;
  const int c_len = p.table_width * p.block_size;
  const int window = p.window;
  const float kInf = inf_f();
  const size_t kv_row = static_cast<size_t>(p.kv_heads) * D;   // pool row, elements

  // 1. the stripe's q rows r = i * G + gi (token t0 + i, head kh * G + gi)
  // into the 128-byte-swizzled q tile (copies in flight during step 2),
  // and its tokens
  for (int c = tid; c < kRows * D / 8; c += kThreads) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    const int i = r / group;
    const bool ok = i < ts && t0 + i < p.tokens;
    cp_async16(q_s + swizzle128(r, col, kRows),
               ok ? p.q + (static_cast<size_t>(t0 + i) * p.heads + kh * group + r % group) * D
                        + col
                  : p.q,
               ok);
  }
  cp_async_commit();
  if (tid < 64) {
    const int tok = t0 + tid;
    int pos = -1, slot = -1;
    if (tid < ts && tok < p.tokens) {
      pos = p.token_pos[tok];
      if (pos >= 0) slot = p.token_slot[tok];
      else pos = -1;
    }
    tok_pos[tid] = pos;
    tok_slot[tid] = slot;
  }
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_fence_init();
  }
  __syncthreads();

  // 2. the distinct slots, in order of first appearance: each is one walk
  // of its context from the lowest window edge of its tokens up to their
  // highest position (a stripe of one sequence's prompt has one walk)
  bool lead = false;
  if (tid < 64) {
    const int slot = tok_slot[tid];
    lead = slot >= 0;
    for (int j = 0; j < tid && lead; ++j) lead = tok_slot[j] != slot;
    const unsigned bal = __ballot_sync(0xffffffffu, lead);
    if (lane == 0) lead_mask[warp] = bal;
  }
  __syncthreads();
  const int n_walks = __popc(lead_mask[0]) + __popc(lead_mask[1]);
  if (lead) {
    const unsigned below = (1u << lane) - 1u;
    const int idx = warp == 0 ? __popc(lead_mask[0] & below)
                              : __popc(lead_mask[0]) + __popc(lead_mask[1] & below);
    const int slot = tok_slot[tid];
    int lo = 0x7fffffff, hi = -1;
    for (int j = 0; j < 64; ++j) {
      if (tok_slot[j] == slot) {
        const int pj = tok_pos[j];
        lo = min(lo, window > 0 ? max(0, pj - window + 1) : 0);
        hi = max(hi, pj);
      }
    }
    w_slot[idx] = slot;
    w_lo[idx] = (lo / kKeys) * kKeys;
    w_hi[idx] = min(hi, c_len - 1);
  }
  cp_async_wait<0>();                           // the q tile
  fence_proxy_async();
  __syncthreads();

  // the walk's next tile (every thread steps the same sequence); with a
  // window, tiles that no row of the walk sees are skipped
  auto advance = [&](Tile& tl) -> bool {
    while (tl.u < n_walks) {
      tl.c0 += kKeys;
      if (tl.c0 > w_hi[tl.u]) {
        if (++tl.u < n_walks) tl.c0 = w_lo[tl.u] - kKeys;
        continue;
      }
      if (window <= 0) return true;
      for (int j = 0; j < 64; ++j)
        if (tok_slot[j] == w_slot[tl.u] && tok_pos[j] >= tl.c0
            && tok_pos[j] - window < tl.c0 + kKeys - 1)
          return true;
    }
    return false;
  };

  // the pool row of key tid % 64 of tile `tl` (-1: past the table's end)
  auto key_row = [&](const Tile& tl) -> long long {
    const int c = tl.c0 + (tid & 63);
    if (c / p.block_size >= p.table_width) return -1;
    const int* table = p.tables + static_cast<size_t>(w_slot[tl.u]) * p.table_width;
    return static_cast<long long>(table[c / p.block_size]) * p.block_size + c % p.block_size;
  };

  // start the loads of tile `tl` into stage s (`row`: key_row(tl)): one
  // TMA box per operand (and 64-column half, bf16) when the tile lies in
  // one pool block, else 16-byte cp.async gathers, two threads a key
  auto issue = [&](int s, long long row) {
    unsigned char* kd = sm + L::kK + s * L::kStage;
    unsigned char* vd = sm + L::kV + s * L::kStage;
    if (p.tma) {
      if (tid == 0) {                           // row: the tile's first key's
        const int row0 = static_cast<int>(row);
        mbar_arrive_expect_tx(&bars[s], 2 * L::kStage);
        if constexpr (kInt8) {
          tma_load_3d(kd, &k_map, &bars[s], 0, kh, row0);
          tma_load_3d(vd, &v_map, &bars[s], 0, kh, row0);
        } else {
#pragma unroll
          for (int h = 0; h < D / 64; ++h) {
            tma_load_3d(kd + h * kKeys * 128, &k_map, &bars[s], 64 * h, kh, row0);
            tma_load_3d(vd + h * kKeys * 128, &v_map, &bars[s], 64 * h, kh, row0);
          }
        }
      }
    } else {
      constexpr int kChunks = D * kElem / 16;   // 16-byte chunks of a row
      const int key = tid & 63, part = tid >> 6;
      const size_t off = row >= 0 ? static_cast<size_t>(row) * kv_row + static_cast<size_t>(kh) * D
                                  : 0;
      const unsigned char* ks = static_cast<const unsigned char*>(p.k_pool) + off * kElem;
      const unsigned char* vs = static_cast<const unsigned char*>(p.v_pool) + off * kElem;
#pragma unroll
      for (int j = 0; j < kChunks / 2; ++j) {
        const int ch = part * (kChunks / 2) + j;
        const int dst =
            kInt8 ? key * D + ch * 16 : static_cast<int>(swizzle128(key, ch * 8, kKeys));
        cp_async16(kd + dst, ks + ch * 16, row >= 0);
        cp_async16(vd + dst, vs + ch * 16, row >= 0);
      }
    }
  };

  // int8: this thread's scale of a tile's key tid % 64 (`row`: its pool
  // row): k_scale for threads 0-63, v_scale for 64-127
  auto key_scale = [&](long long row) -> float {
    if (row < 0) return 0.f;
    return __ldg((tid < 64 ? p.k_scale : p.v_scale) + row * p.kv_heads + kh);
  };

  // 3. the walk: online softmax in fp32, this thread's rows r_a = 16 warp +
  // g and r_b = r_a + 8
  int r_pos[2], r_slot[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    const int i = r / group;
    r_pos[h] = i < ts ? tok_pos[i] : -1;
    r_slot[h] = i < ts ? tok_slot[i] : -1;
  }
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  // Each tile's pool rows are looked up one tile before its loads start,
  // so that neither the loads nor the scales wait on the table.
  Tile cur{0, n_walks > 0 ? w_lo[0] - kKeys : 0};
  bool have = advance(cur);
  Tile nxt = cur;
  bool more = have && advance(nxt);
  long long row_next = more ? key_row(nxt) : -1;
  if (have) {
    const long long row = key_row(cur);
    issue(0, row);
    if (!p.tma) cp_async_commit();
    if constexpr (kInt8) (tid < 64 ? ksc : vsc)[tid & 63] = key_scale(row);
  }
  for (int j = 0; have; ++j) {
    const int s = j & 1;
    Tile after = nxt;
    const bool more2 = more && advance(after);
    const long long row_after = more2 ? key_row(after) : -1;
    if (more) issue(s ^ 1, row_next);           // the stage tile j - 1 used
    if (!p.tma) cp_async_commit();
    float pf = 0.f;
    if constexpr (kInt8) {
      if (more) pf = key_scale(row_next);
    }
    if (p.tma) {
      mbar_wait(&bars[s], (j >> 1) & 1);
    } else {
      cp_async_wait<1>();                       // tile j's copies (j + 1's may fly)
      fence_proxy_async();
    }
    const unsigned char* k_t = sm + L::kK + s * L::kStage;
    const unsigned char* v_t = sm + L::kV + s * L::kStage;
    if constexpr (kInt8) {
      // int8 rows -> bf16 tiles: every int8 value is exact in bf16
      __syncthreads();
      unsigned char* kc = sm + L::kKc;
      unsigned char* vc = sm + L::kVc;
      for (int c = tid; c < kKeys * D / 16; c += kThreads) {
        const int key = c / (D / 16), seg = c % (D / 16);
#pragma unroll
        for (int op = 0; op < 2; ++op) {
          const int4 raw = *reinterpret_cast<const int4*>((op ? v_t : k_t) + key * D + seg * 16);
          const unsigned w[4] = {static_cast<unsigned>(raw.x) ^ 0x80808080u,
                                 static_cast<unsigned>(raw.y) ^ 0x80808080u,
                                 static_cast<unsigned>(raw.z) ^ 0x80808080u,
                                 static_cast<unsigned>(raw.w) ^ 0x80808080u};
          uint32_t b[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const __nv_bfloat162 v =
                __floats2bfloat162_rn(biased_byte_to_float(w[e / 2], 2 * (e % 2)),
                                      biased_byte_to_float(w[e / 2], 2 * (e % 2) + 1));
            b[e] = *reinterpret_cast<const uint32_t*>(&v);
          }
          unsigned char* dst = op ? vc : kc;
          *reinterpret_cast<int4*>(dst + swizzle128(key, seg * 16, kKeys)) =
              make_int4(b[0], b[1], b[2], b[3]);
          *reinterpret_cast<int4*>(dst + swizzle128(key, seg * 16 + 8, kKeys)) =
              make_int4(b[4], b[5], b[6], b[7]);
        }
      }
      fence_proxy_async();
      k_t = kc;
      v_t = vc;
    }
    __syncthreads();

    // S = Q K^T on wgmma (m64 n64 k16, both operands K-major in shared memory)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * kKeys * 128 + (kk % 4) * 32;
      wgmma_ss<64>(sc, wgmma_desc(q_s + off, 16, 1024), wgmma_desc(k_t + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(sc[i]);

    // mask (a row sees keys of its own slot up to its position, inside its
    // window), scale, online softmax; a tile that a row sees whole skips
    // the mask
    const int c0 = cur.c0;
    const int wslot = w_slot[cur.u];
    bool act[2], whole[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      act[h] = r_slot[h] == wslot;
      whole[h] = act[h] && c0 + kKeys - 1 <= min(r_pos[h], c_len - 1)
                 && (window <= 0 || c0 > r_pos[h] - window);
    }
    float mx[2] = {-kInf, -kInf};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = 8 * jj + 2 * t + (e & 1);
        const int c = c0 + key;
        float v = sc[4 * jj + e] * p.scale_log2;
        if constexpr (kInt8) v *= ksc[key];
        const bool vis = whole[h] || (act[h] && c <= r_pos[h] && c < c_len
                                      && (window <= 0 || c > r_pos[h] - window));
        sc[4 * jj + e] = vis ? v : -kInf;
        mx[h] = fmaxf(mx[h], sc[4 * jj + e]);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2f(sc[4 * jj + e] - m[e >> 1]);
        rs[e >> 1] += pr;
        if constexpr (kInt8) pr *= vsc[8 * jj + 2 * t + (e & 1)];
        sc[4 * jj + e] = pr;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * corr[h] + rs[h];
    }
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      o[4 * jj] *= corr[0];
      o[4 * jj + 1] *= corr[0];
      o[4 * jj + 2] *= corr[1];
      o[4 * jj + 3] *= corr[1];
    }

    // O += P V: P (times v_scale in int8) as two bf16 terms, hi = bf16(p)
    // and lo = bf16(p - hi), the register A operand; V the MN-major B
    // operand (rows of D contiguous), 16 keys a step
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        // fragment f: rows g (f even) or g + 8, keys 16 ks + 2t (f < 2) or + 8
        const int jj = 2 * ks + (f >> 1);
        const int e = 2 * (f & 1);
        split_bf16(sc[4 * jj + e], sc[4 * jj + e + 1], ph[ks][f], pl[ks][f]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t dv = wgmma_desc(v_t + ks * 16 * 128, kKeys * 128, 1024);
      wgmma_rs<D, 1>(o, ph[ks], dv);
      wgmma_rs<D, 1>(o, pl[ks], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_reg(o[i]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        fence_reg(ph[ks][f]);
        fence_reg(pl[ks][f]);
      }

    __syncthreads();                            // stage s and the scales are free
    if constexpr (kInt8) (tid < 64 ? ksc : vsc)[tid & 63] = pf;
    cur = nxt;
    have = more;
    nxt = after;
    more = more2;
    row_next = row_after;
  }
  if (!p.tma) cp_async_wait<0>();

  // 4. normalise (a row that saw no key is exact zeros), stage the bf16
  // rows in the q tile, write them out 16 bytes a thread
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(o[4 * jj + 2 * h] * inv,
                                                     o[4 * jj + 2 * h + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(q_s + swizzle128(r, 8 * jj + 2 * t, kRows)) = v;
    }
  }
  __syncthreads();
  for (int c = tid; c < kRows * D / 8; c += kThreads) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    const int i = r / group;
    if (i < ts && t0 + i < p.tokens)
      *reinterpret_cast<int4*>(p.out + (static_cast<size_t>(t0 + i) * p.heads + kh * group
                                        + r % group) * D + col) =
          *reinterpret_cast<const int4*>(q_s + swizzle128(r, col, kRows));
  }
}

template <int D, bool kInt8>
int launch_tiled(const Params& p, int pool_rows, cudaStream_t stream) {
  CUtensorMap k_map{}, v_map{};
  if (p.tma) {
    // pools [rows, Hkv, D]: a box is 64 rows of one KV head, 128 bytes wide
    // (a 64-column half of a bf16 row, swizzled for wgmma; a whole int8
    // row, converted in the kernel)
    const int elem = kInt8 ? 1 : 2;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(p.kv_heads),
                                static_cast<cuuint64_t>(pool_rows)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * elem,
                                   static_cast<cuuint64_t>(p.kv_heads) * D * elem};
    const cuuint32_t box[3] = {kInt8 ? static_cast<cuuint32_t>(D) : 64u, 1u,
                               static_cast<cuuint32_t>(kKeys)};
    const auto type = kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const auto swz = kInt8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
    if (encode_tiled(&k_map, type, 3, const_cast<void*>(p.k_pool), dims, strides, box, swz)
            != CUDA_SUCCESS
        || encode_tiled(&v_map, type, 3, const_cast<void*>(p.v_pool), dims, strides, box, swz)
               != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = Layout<D, kInt8>::kBytes;
  auto kernel = paged_attention_tiled_kernel<D, kInt8>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ts = kRows / (p.heads / p.kv_heads);
  const dim3 grid((p.tokens + ts - 1) / ts, p.kv_heads);
  kernel<<<grid, kThreads, smem, stream>>>(k_map, v_map, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInt8>
int dispatch_tiled(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                   const void* v_scale, const void* tables, const void* token_slot,
                   const void* token_pos, void* out, int tokens, int heads, int kv_heads,
                   int head_dim, int table_width, int block_size, int window, int pool_rows,
                   float scale, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads || heads / kv_heads > 8 || block_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
                 static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                 static_cast<const int*>(tables), static_cast<const int*>(token_slot),
                 static_cast<const int*>(token_pos), static_cast<__nv_bfloat16*>(out),
                 tokens, heads, kv_heads, table_width, block_size, window,
                 scale * 1.4426950408889634f, block_size % kKeys == 0 ? 1 : 0};
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return launch_tiled<128, kInt8>(p, pool_rows, s);
  if (head_dim == 64) return launch_tiled<64, kInt8>(p, pool_rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tiled

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

// The generic kernel: `tokens` rows of q, any token order; `pool_rows`
// rows in each pool.
#define DSTT_TILED_ARGS                                                        \
  const void *q, const void *k_pool, const void *v_pool, const void *k_scale,  \
      const void *v_scale, const void *tables, const void *token_slot,         \
      const void *token_pos, void *out, int tokens, int heads, int kv_heads,   \
      int head_dim, int table_width, int block_size, int window,               \
      int pool_rows, float scale, void *stream
#define DSTT_TILED_PASS                                                        \
  q, k_pool, v_pool, k_scale, v_scale, tables, token_slot, token_pos, out,     \
      tokens, heads, kv_heads, head_dim, table_width, block_size, window,      \
      pool_rows, scale, stream

extern "C" int dstt_paged_attention_bf16(DSTT_TILED_ARGS) {
  return tiled::dispatch_tiled<false>(DSTT_TILED_PASS);
}
extern "C" int dstt_paged_attention_int8(DSTT_TILED_ARGS) {
  return tiled::dispatch_tiled<true>(DSTT_TILED_PASS);
}
