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
//   `dstt_paged_decode_attention_{bf16,int8}`, the decode and verify
//   kernel below.
// * `_verify_kernel` (pallas_call in `paged_verify_attention`), both modes:
//   K query rows per slot (the fed token and K-1 drafts, at consecutive
//   positions) share one walk of the slot's blocks, each row with its own
//   causal frontier.  Here: `dstt_paged_verify_attention_{bf16,int8}`, the
//   same decode and verify kernel: all K * G query rows of a KV head (G = H /
//   Hkv) are scored against every staged key.
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
// The decode and verify kernel (`paged_decode_verify_kernel`): a unit (a
// decode token, or a verify slot's K rows) has R = K * G <= 16 query rows
// per KV head, padded to the 16 rows of an mma tile.  One block takes one
// (unit, KV head): the grid is units by Hkv.
//   What bounds it on the H100 is bytes: it reads Σ live context × Hkv × D
// × 2 (K and V) × (2 bytes bf16, or 1 byte + 4 / D of scale in int8), about
// 39 / 20 MB per 7B layer at 8 × 300 tokens (~12 / ~6 us); its operations,
// 4 · R · Hkv · ctx · D, sit three orders below the tensor cores' rate.  So
// the design is about keeping enough bytes in flight, and reading each K /
// V byte once per (unit, KV head):
// * A ring of NS = 3 stages, each a whole 64-key tile of K and V together,
//   loaded asynchronously while the tile before is multiplied: one TMA box
//   per operand (per 64-column half in bf16) when block_size % 64 == 0, so
//   that a tile lies in one pool block; otherwise 16-byte cp.async gathers
//   through the table, each warp its own 16 keys.  A block walks only its
//   unit's live tiles, from the window's edge to the deepest frontier,
//   which it finds on the device from token_pos (no host sync).
// * Tensor cores.  Each of the 4 warps takes 16 keys of every tile: S = Q
//   K^T and O += P V on mma.sync m16n8k16 (wgmma's 64 rows would waste
//   three quarters of each product, and the operations do not bind), with
//   the online softmax in fp32 per warp.  P keeps about 16 bits where it
//   weighs V, hi = bf16(p) and lo = bf16(p - hi), as in the generic
//   kernel.  int8 pools: each warp converts its keys' rows to bf16 in
//   shared memory (every int8 value is exact in bf16); k_scale multiplies
//   S's columns and v_scale P's, in fp32.
// * The 4 warps' states merge in shared memory, in warp order (so two runs
//   are bit-equal), and the block writes its rows' output.
//   Splitting a context over several blocks (flash-decoding, with a merge
//   of the splits' states) is left out: at every served shape units × Hkv
//   already fills the card (8 slots × 32 KV heads), and there a split only
//   adds the merge's tail.  It pays where few units meet long contexts.
//
// What bounds the generic kernel on the H100 (3.35 TB/s, 989 TFLOP/s bf16):
// prefill (2 x 256 tokens, 32 heads, D = 128) reads each slot's K and V
// rows once, q and out once: ~10 MB in bf16 (~3 us), ~7 MB in int8,
// against ~1.1 GFLOP of causal products (~1 us), so bytes bind; the generic
// kernel reads a stripe's context once per KV head, and the 4 stripes of a
// 256-token prompt re-read the earlier tiles from L2.  Later work: stripes
// of 128 rows (two consumer warpgroups) and a warp-specialised producer,
// so that the softmax of one tile overlaps the products of the next.
//
// Shapes: q / out bf16 [T, H, D]; pools bf16 or int8 [rows, Hkv, D]; scales
// fp32 [rows, Hkv] (int8 only); tables int32 [S, B]; token_slot /
// token_pos int32 [T]; all contiguous.  D is 64 or 128; G at most 8;
// query rows of a unit (K * G) at most 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

// two fp32 values as the packed bf16 pair hi and the packed bf16 pair of
// what hi leaves over
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// 4-byte asynchronous copy global -> shared (zero-filled when !pred)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(pred ? 4 : 0));
}

// 16 int8 values as 16 bf16 (two 16-byte vectors): every int8 is exact in
// bf16
__device__ __forceinline__ void int8x16_to_bf16(const int4 raw, int4& lo, int4& hi) {
  const unsigned w[4] = {static_cast<unsigned>(raw.x) ^ 0x80808080u,
                         static_cast<unsigned>(raw.y) ^ 0x80808080u,
                         static_cast<unsigned>(raw.z) ^ 0x80808080u,
                         static_cast<unsigned>(raw.w) ^ 0x80808080u};
  uint32_t b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(biased_byte_to_float(w[e / 2], 2 * (e % 2)),
                                                   biased_byte_to_float(w[e / 2], 2 * (e % 2) + 1));
    b[e] = *reinterpret_cast<const uint32_t*>(&v);
  }
  lo = make_int4(b[0], b[1], b[2], b[3]);
  hi = make_int4(b[4], b[5], b[6], b[7]);
}

// ------------------------------------------- the decode and verify kernel

namespace decode {

constexpr int kKeys = 64;                 // keys of a tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpKeys = kKeys / kWarps; // each warp's keys of a tile
constexpr int kRows = 16;                 // a unit's query rows, padded to mma's m16
constexpr int kStages = 3;                // tiles in the ring

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
  int heads, kv_heads, table_width, block_size, window, k_tokens;
  float scale_log2;              // log2(e) / sqrt(D)
  int tma;                       // block_size % 64 == 0: a tile is one TMA box a pool
};

// Shared memory, in bytes from a 1024-aligned base: the q tile, NS stages
// of K, then of V (bf16 [64, D] tiles, 128-byte swizzled, or the int8 rows
// as read), in int8 mode each warp's 16 K and V rows converted to bf16 and
// the stages' scales, the warps' softmax states and the stages'
// mbarriers.  After the walk the stages hold the warps' O.
template <int D, bool kInt8, int NS>
struct Layout {
  static constexpr int kStage = kInt8 ? kKeys * D : kKeys * D * 2;  // one operand
  static constexpr int kWarpTile = kWarpKeys * D * 2;               // bf16 [16, D]
  static constexpr int kQ = 0;                                      // bf16 [16, D]
  static constexpr int kK = kQ + kRows * D * 2;
  static constexpr int kV = kK + NS * kStage;
  static constexpr int kConv = kV + NS * kStage;                    // int8: [4][K, V]
  static constexpr int kScales = kConv + (kInt8 ? kWarps * 2 * kWarpTile : 0);
  static constexpr int kState = kScales + (kInt8 ? NS * 2 * kKeys * 4 : 0);  // m, l [4][16]
  static constexpr int kBars = kState + 2 * kWarps * kRows * 4;
  static constexpr int kBytes = kBars + NS * 8 + 1024;              // + alignment slack
  static_assert(kWarps * kRows * D * 4 <= 2 * NS * kStage, "the warps' O must fit the stages");
};

// One block: unit u's context for KV head kh (blockIdx.x = u, blockIdx.y =
// kh).
template <int D, bool kInt8, int NS>
__global__ void __launch_bounds__(kThreads)
paged_decode_verify_kernel(const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, const Params p) {
  using L = Layout<D, kInt8, NS>;
  constexpr int kElem = kInt8 ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = sm + L::kQ;
  float* m_s = reinterpret_cast<float*>(sm + L::kState);     // [4][16]
  float* l_s = m_s + kWarps * kRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int u = blockIdx.x;
  const int kh = blockIdx.y;
  const int group = p.heads / p.kv_heads;
  const int rows = p.k_tokens * group;
  const int t0 = u * p.k_tokens;                // the unit's first token
  const int pos0 = __ldg(p.token_pos + t0);
  const int c_len = p.table_width * p.block_size;
  const int window = p.window;

  // the unit's live tiles, from its window's edge to its deepest frontier
  // (none for a pad unit, which writes zeros)
  const int last = min(pos0 + p.k_tokens - 1, c_len - 1);
  const int first = window > 0 ? max(0, pos0 - window + 1) : 0;
  const int tile0 = first / kKeys;
  const int tiles = last >= first ? last / kKeys - tile0 + 1 : 0;

  const int* table = p.tables + static_cast<size_t>(__ldg(p.token_slot + t0)) * p.table_width;
  const size_t kv_row = static_cast<size_t>(p.kv_heads) * D;   // pool row, elements
  // q / out offset of query row r: token t0 + r / G, head kh * G + r % G
  auto q_off = [&](int r) {
    return (static_cast<size_t>(t0 + r / group) * p.heads + static_cast<size_t>(kh) * group
            + r % group) * D;
  };

  // 1. the unit's q rows into the swizzled [16, D] tile (zeros past them)
  for (int c = tid; c < kRows * D / 8; c += kThreads) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    const bool ok = r < rows;
    cp_async16(q_s + swizzle128(r, col, kRows), ok ? p.q + q_off(r) + col : p.q, ok);
  }
  cp_async_commit();
  if (p.tma && tid == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  // this thread's key of a tile (TMA: thread 0's, key 0, places the
  // boxes; int8 lanes read their key's scale; cp.async: two lanes a key)
  // and its pool row in tile j (-1: past the table's end), looked up a
  // tile ahead of the loads that use it
  const int my_key = kWarpKeys * warp + (p.tma ? (lane & 15) : (lane >> 1));
  auto key_row = [&](int j) -> long long {
    const int c = (tile0 + j) * kKeys + my_key;
    if (c >= c_len) return -1;
    return static_cast<long long>(__ldg(table + c / p.block_size)) * p.block_size
           + c % p.block_size;
  };

  // start the loads of the unit's live tile j into stage j % NS (`row`:
  // key_row(j)): one TMA box per operand (and 64-column half, bf16) issued
  // by thread 0, or each warp's 16 keys as 16-byte cp.async gathers, two
  // lanes a key; int8: each warp's keys' scales as 4-byte cp.async copies
  const unsigned char* k_bytes = static_cast<const unsigned char*>(p.k_pool);
  const unsigned char* v_bytes = static_cast<const unsigned char*>(p.v_pool);
  auto issue = [&](int j, long long row) {
    const int s = j % NS;
    unsigned char* kd = sm + L::kK + s * L::kStage;
    unsigned char* vd = sm + L::kV + s * L::kStage;
    float* sc_s = reinterpret_cast<float*>(sm + L::kScales) + s * 2 * kKeys;
    if (p.tma) {
      if (tid == 0) {
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
      if constexpr (kInt8)
        cp_async4(sc_s + (lane >> 4) * kKeys + my_key,
                  (lane < 16 ? p.k_scale : p.v_scale) + row * p.kv_heads + kh, true);
    } else {
      constexpr int kChunks = D * kElem / 16;   // 16-byte chunks of a row
      const int key = my_key, part = lane & 1;
      const bool ok = row >= 0;                 // keys past the table's end: zeros
      if (!ok) row = 0;
      const size_t off = (static_cast<size_t>(row) * kv_row + static_cast<size_t>(kh) * D) * kElem;
#pragma unroll
      for (int i = 0; i < kChunks / 2; ++i) {
        const int ch = part * (kChunks / 2) + i;
        const int dst =
            kInt8 ? key * D + ch * 16 : static_cast<int>(swizzle128(key, ch * 8, kKeys));
        cp_async16(kd + dst, k_bytes + off + ch * 16, ok);
        cp_async16(vd + dst, v_bytes + off + ch * 16, ok);
      }
      if constexpr (kInt8)
        cp_async4(sc_s + part * kKeys + key,
                  (part ? p.v_scale : p.k_scale) + row * p.kv_heads + kh, ok);
    }
  };

  // 2. the ring: tiles 0 .. NS-1 in flight (one cp.async group each, empty
  // past the live tiles), then the q tile's A fragments
  long long rows0[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) rows0[j] = j < tiles ? key_row(j) : -1;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (j < tiles) issue(j, rows0[j]);
    cp_async_commit();
  }
  cp_async_wait<NS>();                          // the q tile
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qa[kk], q_s + swizzle128(lane & 15, kk * 16 + (lane >> 4) * 8, kRows));

  // 3. the walk: this thread's rows g and g + 8 (their frontiers; -1 past
  // the unit's rows, which see nothing), online softmax in fp32
  int r_pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    r_pos[h] = r < rows ? pos0 + r / group : -1;
  }
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  const float kInf = __int_as_float(0x7f800000);

  for (int j = 0; j < tiles; ++j) {
    const int s = j % NS;
    const long long row_next = j + NS < tiles ? key_row(j + NS) : -1;
    cp_async_wait<NS - 1>();                    // tile j's copies (later tiles may fly)
    if (p.tma) mbar_wait(&bars[s], (j / NS) & 1);
    __syncwarp();
    const float* ksc = reinterpret_cast<const float*>(sm + L::kScales) + s * 2 * kKeys
                       + kWarpKeys * warp;
    const float* vsc = ksc + kKeys;

    // this warp's 16 keys as bf16 [16, D] tiles: in place (bf16), or
    // converted into the warp's own tiles (int8)
    const unsigned char* kt;
    const unsigned char* vt;
    int r0, nrows;
    if constexpr (kInt8) {
      unsigned char* kc = sm + L::kConv + warp * 2 * L::kWarpTile;
      unsigned char* vc = kc + L::kWarpTile;
      const unsigned char* ks = sm + L::kK + s * L::kStage + kWarpKeys * warp * D;
      const unsigned char* vs = sm + L::kV + s * L::kStage + kWarpKeys * warp * D;
#pragma unroll
      for (int c = lane; c < kWarpKeys * D / 16; c += 32) {
        const int key = c / (D / 16), seg = c % (D / 16);
        int4 lo, hi;
        int8x16_to_bf16(*reinterpret_cast<const int4*>(ks + key * D + seg * 16), lo, hi);
        *reinterpret_cast<int4*>(kc + swizzle128(key, seg * 16, kWarpKeys)) = lo;
        *reinterpret_cast<int4*>(kc + swizzle128(key, seg * 16 + 8, kWarpKeys)) = hi;
        int8x16_to_bf16(*reinterpret_cast<const int4*>(vs + key * D + seg * 16), lo, hi);
        *reinterpret_cast<int4*>(vc + swizzle128(key, seg * 16, kWarpKeys)) = lo;
        *reinterpret_cast<int4*>(vc + swizzle128(key, seg * 16 + 8, kWarpKeys)) = hi;
      }
      __syncwarp();
      kt = kc;
      vt = vc;
      r0 = 0;
      nrows = kWarpKeys;
    } else {
      kt = sm + L::kK + s * L::kStage;
      vt = sm + L::kV + s * L::kStage;
      r0 = kWarpKeys * warp;
      nrows = kKeys;
    }

    // S = Q K^T over the warp's 16 keys (two n8 tiles)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, kt + swizzle128(r0 + (lane >> 4) * 8 + (lane & 7),
                                 kk * 16 + ((lane >> 3) & 1) * 8, nrows));
      mma16816(sc[0], qa[kk], b[0], b[1]);
      mma16816(sc[1], qa[kk], b[2], b[3]);
    }

    // mask (a row sees keys up to its frontier, inside its window and the
    // table), scale, online softmax
    const int cw = (tile0 + j) * kKeys + kWarpKeys * warp;   // the warp's first key
    float mx[2] = {-kInf, -kInf};
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = 8 * jj + 2 * t + (e & 1);
        const int c = cw + key;
        float v = sc[jj][e] * p.scale_log2;
        if constexpr (kInt8) v *= ksc[key];
        const bool vis = c <= r_pos[h] && c < c_len && (window <= 0 || c > r_pos[h] - window);
        sc[jj][e] = vis ? v : -kInf;
        mx[h] = fmaxf(mx[h], sc[jj][e]);
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
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2f(sc[jj][e] - m[e >> 1]);
        rs[e >> 1] += pr;
        if constexpr (kInt8) pr *= vsc[8 * jj + 2 * t + (e & 1)];
        sc[jj][e] = pr;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * corr[h] + rs[h];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }

    // O += P V: P (times v_scale in int8) as hi + lo bf16 A fragments, V
    // the B operand read transposed from its [16, D] rows
    uint32_t ph[4], pl[4];
    split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t b[4];
      ldsm_x4_trans(b, vt + swizzle128(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                       d0 + (lane >> 4) * 8, nrows));
      mma16816(o[d0 / 8], ph, b[0], b[1]);
      mma16816(o[d0 / 8], pl, b[0], b[1]);
      mma16816(o[d0 / 8 + 1], ph, b[2], b[3]);
      mma16816(o[d0 / 8 + 1], pl, b[2], b[3]);
    }

    // stage s is free again: a TMA stage once every warp is done with it,
    // a gathered one (each warp its own keys) once this warp is
    if (p.tma) __syncthreads();
    else __syncwarp();
    if (j + NS < tiles) issue(j + NS, row_next);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // 4. the warps' states, merged in warp order (O over the stages), and
  // the output written
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(sm + L::kK);          // [4][rows][D]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    if (r < rows) {
      if (t == 0) {
        m_s[warp * kRows + r] = m[h];
        l_s[warp * kRows + r] = l[h];
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(o_s + (warp * rows + r) * D + 8 * i + 2 * t) =
            make_float2(o[i][2 * h], o[i][2 * h + 1]);
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mx = m_s[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * kRows + r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(m_s[w * kRows + r] - mx);
      num += f * o_s[(w * rows + r) * D + d];
      den += f * l_s[w * kRows + r];
    }
    p.out[q_off(r) + d] = __float2bfloat16(den == 0.f ? 0.f : num / den);
  }
}

template <int D, bool kInt8>
int launch(const Params& p, int units, int pool_rows, cudaStream_t stream) {
  CUtensorMap k_map{}, v_map{};
  if (p.tma) {
    // pools [rows, Hkv, D]: a box is 64 rows of one KV head, 128 bytes wide
    // (a 64-column half of a bf16 row, swizzled for ldmatrix; a whole int8
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
  constexpr int smem = Layout<D, kInt8, kStages>::kBytes;
  auto kernel = paged_decode_verify_kernel<D, kInt8, kStages>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(units, p.kv_heads);
  kernel<<<grid, kThreads, smem, stream>>>(k_map, v_map, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInt8>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
             const void* v_scale, const void* tables, const void* token_slot,
             const void* token_pos, void* out, int units, int heads, int kv_heads,
             int head_dim, int table_width, int block_size, int window, int k_tokens,
             int pool_rows, float scale, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads || heads / kv_heads > 8 || k_tokens < 1
      || k_tokens * (heads / kv_heads) > kRows || block_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (units == 0) return 0;
  const Params p{static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
                 static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                 static_cast<const int*>(tables), static_cast<const int*>(token_slot),
                 static_cast<const int*>(token_pos), static_cast<__nv_bfloat16*>(out),
                 heads, kv_heads, table_width, block_size, window, k_tokens,
                 scale * 1.4426950408889634f, block_size % kKeys == 0 ? 1 : 0};
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return launch<128, kInt8>(p, units, pool_rows, s);
  if (head_dim == 64) return launch<64, kInt8>(p, units, pool_rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace decode

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
  int stripe;                    // a row's slot is its stripe's first row's (1: its own)
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
      // a pad row (pos < 0) reads no slot, so a pad may carry any
      if (pos >= 0) slot = p.token_slot[tok - tok % p.stripe];
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
          int4 lo, hi;
          int8x16_to_bf16(
              *reinterpret_cast<const int4*>((op ? v_t : k_t) + key * D + seg * 16), lo, hi);
          unsigned char* dst = op ? vc : kc;
          *reinterpret_cast<int4*>(dst + swizzle128(key, seg * 16, kKeys)) = lo;
          *reinterpret_cast<int4*>(dst + swizzle128(key, seg * 16 + 8, kKeys)) = hi;
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
                   int head_dim, int table_width, int block_size, int window, int stripe,
                   int pool_rows, float scale, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads || heads / kv_heads > 8 || block_size <= 0
      || stripe < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
                 static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                 static_cast<const int*>(tables), static_cast<const int*>(token_slot),
                 static_cast<const int*>(token_pos), static_cast<__nv_bfloat16*>(out),
                 tokens, heads, kv_heads, table_width, block_size, window, stripe,
                 scale * 1.4426950408889634f, block_size % kKeys == 0 ? 1 : 0};
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return launch_tiled<128, kInt8>(p, pool_rows, s);
  if (head_dim == 64) return launch_tiled<64, kInt8>(p, pool_rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tiled

}  // namespace

// The decode and verify entry points take the same arguments.  `units`:
// tokens (decode) or slots (verify: T = units * k_tokens rows,
// slot-major); `k_tokens` is 1 in decode; `window` <= 0 means no sliding
// window; k_scale / v_scale are read in the int8 modes only; `pool_rows`:
// the rows of each pool.  Return: the CUDA error code (0 ok).
#define DSTT_ARGS                                                              \
  const void *q, const void *k_pool, const void *v_pool, const void *k_scale,  \
      const void *v_scale, const void *tables, const void *token_slot,         \
      const void *token_pos, void *out, int units, int heads, int kv_heads,    \
      int head_dim, int table_width, int block_size, int window, int k_tokens, \
      int pool_rows, float scale, void *stream
#define DSTT_PASS                                                              \
  q, k_pool, v_pool, k_scale, v_scale, tables, token_slot, token_pos, out,     \
      units, heads, kv_heads, head_dim, table_width, block_size, window,       \
      k_tokens, pool_rows, scale, stream

extern "C" int dstt_paged_decode_attention_bf16(DSTT_ARGS) {
  return decode::dispatch<false>(DSTT_PASS);
}
extern "C" int dstt_paged_decode_attention_int8(DSTT_ARGS) {
  return decode::dispatch<true>(DSTT_PASS);
}
extern "C" int dstt_paged_verify_attention_bf16(DSTT_ARGS) {
  return decode::dispatch<false>(DSTT_PASS);
}
extern "C" int dstt_paged_verify_attention_int8(DSTT_ARGS) {
  return decode::dispatch<true>(DSTT_PASS);
}

// The generic kernel: `tokens` rows of q, any token order; a row's slot
// is token_slot of the first row of its `stripe`-row stripe (1: its own;
// the tiled prefill's tile_q); `pool_rows` rows in each pool.
#define DSTT_TILED_ARGS                                                        \
  const void *q, const void *k_pool, const void *v_pool, const void *k_scale,  \
      const void *v_scale, const void *tables, const void *token_slot,         \
      const void *token_pos, void *out, int tokens, int heads, int kv_heads,   \
      int head_dim, int table_width, int block_size, int window, int stripe,   \
      int pool_rows, float scale, void *stream
#define DSTT_TILED_PASS                                                        \
  q, k_pool, v_pool, k_scale, v_scale, tables, token_slot, token_pos, out,     \
      tokens, heads, kv_heads, head_dim, table_width, block_size, window,      \
      stripe, pool_rows, scale, stream

extern "C" int dstt_paged_attention_bf16(DSTT_TILED_ARGS) {
  return tiled::dispatch_tiled<false>(DSTT_TILED_PASS);
}
extern "C" int dstt_paged_attention_int8(DSTT_TILED_ARGS) {
  return tiled::dispatch_tiled<true>(DSTT_TILED_PASS);
}
