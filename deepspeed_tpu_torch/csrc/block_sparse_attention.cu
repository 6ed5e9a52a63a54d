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
// The general kernels walk those lists; the tensor-core kernels walk
// tables built from the same masks (`bsa_tile_walk`, below).  A warp of 16
// rows keeps four bits, one a 16-column slice, and a dead slice is masked
// whole (no per-element test: the TPU kernel's `_cell_mask` matmuls at :57
// have no counterpart).
//
// Two kernel families:
//
// * the tensor-core kernels (bf16 / fp16, D a multiple of 8 up to 128,
//   padded with zeros to DP = 16, 32, 64 or 128), forward, dQ and dK/dV on
//   wgmma fed by TMA: the flash kernels (csrc/flash_attention.cu) on a walk
//   of 16-row slices instead of 64-row tiles.  A block holds up to four
//   stationary slices of one (batch, head) -- query slices for the forward
//   and dQ, key slices for dK/dV, gathered into one 64-row wgmma tile --
//   and streams the live slices of the other side through a TMA ring, four
//   to a stage, each gathered by a 16-row box, so that only live slices
//   cross the ring and a stage's 64 columns are mostly live: Fixed's global
//   columns (one live 16-key slice in each 64 x 64 tile) pack four to a
//   stage for the forward and dQ, and its global-column keys, grouped four
//   to a block, fill dK/dV's rows.  The host groups the slices
//   (`bsa_tile_walk`: "heavy" slices, a global row's or column's, among
//   themselves, the rest in their 64-row tile), splits a list that is long
//   against the launch's work into parts whose fp32 partials the last part
//   to finish merges in part order (no atomics on the outputs: two runs
//   give the same bits), and orders the blocks longest list first.  The
//   forward and dQ read one query-major walk, so one table a (device,
//   batch) serves both;
// * the fp32 forward (any D up to 128; the TPU kernel takes fp32 too, and
//   the JAX package's parity test runs it) on the same query-major walk:
//   `bsa_fwd_split_kernel`, mma.sync in split TF32 (3xTF32), each warp
//   skipping its dead 16-key slots (below);
// * the general fp32 dQ and dK/dV: the tile lists, products in fp32 on the
//   CUDA cores, 8 warps a block, 8 rows (or keys) a warp and one key (or
//   query) a lane.
//
// What bounds them on the H100: at BERT width (D = 64, S = 4096, batch 4,
// block 16) the products of the live layout cells, 4 S_live D flops forward
// and 14 S_live D backward (S_live = kept score entries), at 989 TFLOP/s
// bf16 (67 TFLOP/s fp32), from ~15% density up; below that the bytes (q,
// k, v, o, lse read or written once).  The tensor-core kernels multiply
// whole 64 x 64 slot pairs whose 16 x 16 sub-blocks are live in part, so
// their work is the stages' (PERF.md section 6 gives both); the forward
// also runs one exponential a slot pair's score and its online softmax in
// registers between the two products, which at D = 64 costs about as many
// issue slots as the products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>
#include <type_traits>

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {

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
// Forward and backward on wgmma (bf16 / fp16): the 16-row slice walk
// ----------------------------------------------------------------------------
// A block is one producer warpgroup and one consumer warpgroup, two blocks
// an SM.  Its item (a row of the block table, `bsa_tile_walk`) names up to
// four stationary 16-row slices of one (batch, head) -- query slices for
// the forward and dQ, key slices for dK/dV -- and a range of stages, each
// kSlots streamed slices of the other side with a mask (bit r * 4 + c:
// stationary slot r keeps streamed slot c).  Warp w of the consumer
// warpgroup holds the rows of stationary slot w (the wgmma accumulator rows
// 16w .. 16w + 15 of the warpgroup's 64), so a warp's four bits of the mask
// say which 16-column slices of its scores are live; a dead slice's P and dS
// are 0 before rounding.  The producer's first thread gathers every slice
// by a 16-row TMA box into consecutive slots of a tile (columns past D read
// zeros), through a ring of NS stages; its warp's lanes copy the stage's key
// bias (the forward and dQ) or lse and delta (dK/dV).
constexpr int kSlots = 4;                     // slices a warpgroup, and a stage
constexpr int kSlice = 16;
constexpr int kRows = kSlots * kSlice;        // a wgmma tile: 64 rows
constexpr int kStageInts = 8;                 // slot[4], mask, -
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 232;            // after setmaxnreg
constexpr int kBwdThreads = 256;              // producer + consumer warpgroup
constexpr int kItemInts = 8 + kSlots;         // a block-table row (`item_of`)
constexpr float kLog2e = 1.4426950408889634f;

// The walk of one launch (device arrays of `bsa_tile_walk`) and the scratch
// of its split lists: fp32 partials, one [64 x DP] tile (two for dK/dV) a
// (part, batch row), and one counter a (split group, batch row), zeroed by
// the host before the launch.
struct Walk {
  const int* blocks;
  const int* stages;
  float* ws;
  int* counters;
};

// A block-table row: head, stat[kSlots], begin, end, part, parts, partial
// slot, split group, -.
struct Item {
  int head, stat[kSlots], begin, end, part, parts, ws_base, group;
};

__device__ __forceinline__ Item item_of(const int* blocks, int row) {
  const int* r = blocks + static_cast<size_t>(row) * kItemInts;
  Item it;
  it.head = r[0];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) it.stat[s] = r[1 + s];
  it.begin = r[kSlots + 1];
  it.end = r[kSlots + 2];
  it.part = r[kSlots + 3];
  it.parts = r[kSlots + 4];
  it.ws_base = r[kSlots + 5];
  it.group = r[kSlots + 6];
  return it;
}

// the shared-memory geometry of a [64 x DP] tile: rows of SW bytes (D
// padded to DP = 16, 32, 64 or 128; 128-byte rows in DP / 64 column blocks
// at DP = 128), swizzled as TMA's CU_TENSOR_MAP_SWIZZLE_<SW>B writes it
template <int DP>
struct Geo {
  static constexpr int kSw = DP >= 64 ? 128 : DP * 2;
  static constexpr int kCols = kSw / 2;
  static constexpr int kCb = DP / kCols;
  static constexpr uint32_t kLayout = swizzle_layout(kSw);
  static constexpr int kTile = kRows * DP * 2;
};

template <int SW>
__device__ __forceinline__ uint32_t swz(int row, int col, int rows) {
  constexpr int kCols = SW / 2;
  const uint32_t o =
      static_cast<uint32_t>((col / kCols) * rows * SW + row * SW + (col % kCols) * 2);
  return o ^ (((o >> 7) & (SW / 16 - 1)) << 4);
}

// K-major descriptor of k-step kk (16 columns) of a [64 x DP] tile, from
// row row0 on
template <int DP>
__device__ __forceinline__ uint64_t kdesc(const unsigned char* tile, int row0, int kk) {
  using G = Geo<DP>;
  const int cb = kk * 16 / G::kCols, in = (kk * 32) % G::kSw;
  return wgmma_desc(tile + cb * kRows * G::kSw + row0 * G::kSw + in, 16, 8 * G::kSw, G::kLayout);
}

// MN-major descriptor of rows [r0, r0 + 16) of a [64 x DP] tile, the B
// operand whose N is DP
template <int DP>
__device__ __forceinline__ uint64_t mndesc(const unsigned char* tile, int r0) {
  using G = Geo<DP>;
  return wgmma_desc(tile + r0 * G::kSw, kRows * G::kSw, 8 * G::kSw, G::kLayout);
}

// The gathered tile of four slices: slice slices[r] into rows [16r, 16r +
// 16) of `dst` ([64 x DP]), every column block.
template <int DP>
__device__ __forceinline__ void load_slices(unsigned char* dst, const CUtensorMap* map,
                                            uint64_t* bar, const int (&slices)[kSlots], int bh) {
  using G = Geo<DP>;
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
#pragma unroll
    for (int cb = 0; cb < G::kCb; ++cb)
      tma_load_3d(dst + cb * kRows * G::kSw + r * kSlice * G::kSw, map, bar, cb * G::kCols,
                  kSlice * slices[r], bh);
}

// a[i] without indexing a register array at run time (which would put the
// array in local memory)
__device__ __forceinline__ int pick(const int (&a)[kSlots], int i) {
  int v = a[0];
#pragma unroll
  for (int k = 1; k < kSlots; ++k) v = i == k ? a[k] : v;
  return v;
}

// The stationary slices of an item, an empty slot (-1) replaced by slot 0's:
// its rows are masked and never stored, and slot 0 is always a slice.
__device__ __forceinline__ void slices_of(const int (&row)[kSlots], int (&out)[kSlots]) {
#pragma unroll
  for (int c = 0; c < kSlots; ++c) out[c] = row[c] >= 0 ? row[c] : row[0];
}

// The producer warp's view of its item's stages: lane l holds the four
// streamed slices of stage 32 j + l of the current chunk j, loaded once a
// chunk, so that a stage's slices cost the producer a shuffle and not a
// load's latency.  Every lane calls `get` for every stage, in order.
struct StageSlots {
  const int* stages;
  int begin, n, base = -32;
  int4 mine;
  __device__ __forceinline__ void get(int i, int lane, int (&out)[kSlots]) {
    if (i - base >= 32) {
      base = i;
      mine = i + lane < n ? __ldg(reinterpret_cast<const int4*>(
                                stages + static_cast<size_t>(begin + i + lane) * kStageInts))
                          : make_int4(0, 0, 0, 0);
    }
    const int src = i - base;
    out[0] = __shfl_sync(kFull, mine.x, src);
    out[1] = __shfl_sync(kFull, mine.y, src);
    out[2] = __shfl_sync(kFull, mine.z, src);
    out[3] = __shfl_sync(kFull, mine.w, src);
#pragma unroll
    for (int c = 1; c < kSlots; ++c) out[c] = out[c] >= 0 ? out[c] : out[0];
  }
};

// 4 bytes global -> shared, asynchronously (no register holds them)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// one arrival on `bar` once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// A split list's partials, in the consumer warpgroup (128 threads): slot p
// of the launch's scratch for this batch row holds part p's fp32 sums, each
// thread's N floats thread-major in float4s.
template <int N>
__device__ __forceinline__ void put_partial(float* slot, const float (&acc)[N], int ct) {
  float4* w = reinterpret_cast<float4*>(slot);
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    w[j * 128 + ct] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
}

// acc += w * a partial, w = w0 on this thread's first row (accumulator
// elements 4j, 4j + 1) and w1 on its second (4j + 2, 4j + 3); at w = 1 the
// plain sum, bit for bit (SHARED: a slot in this block's shared memory)
template <int N, bool SHARED = false>
__device__ __forceinline__ void add_partial(float (&acc)[N], const float* slot, int ct,
                                            float w0 = 1.f, float w1 = 1.f) {
  const float4* r = reinterpret_cast<const float4*>(slot);
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    float4 x;
    if constexpr (SHARED) x = r[j * 128 + ct];
    else x = __ldcg(r + j * 128 + ct);            // another SM wrote it: not from L1
    acc[4 * j] = fmaf(x.x, w0, acc[4 * j]);
    acc[4 * j + 1] = fmaf(x.y, w0, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(x.z, w1, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(x.w, w1, acc[4 * j + 3]);
  }
}

// After every thread of the consumer warpgroup (named barrier 1) put its
// partial: count this part in, on the counter of its group and batch row;
// true in the last part to arrive, which then sums every part's partial in
// part order (so the sum is the same whichever part finishes last).
__device__ __forceinline__ bool last_part(const Item& it, const Walk& walk, int b, int batch,
                                          int ct, int* flag) {
  __threadfence();
  named_barrier(1, 128);
  if (ct == 0)
    *flag = atomicAdd(walk.counters + static_cast<size_t>(it.group) * batch + b, 1) ==
            it.parts - 1;
  named_barrier(1, 128);
  if (*flag) __threadfence();
  return *flag;
}

// the partial slot of part `p` of this item and batch row, `floats` long
__device__ __forceinline__ float* partial_slot(const Item& it, const Walk& walk, int p, int b,
                                               int batch, int floats) {
  return walk.ws + (static_cast<size_t>(it.ws_base + p) * batch + b) * floats;
}

// The consumer warpgroup's [64 x DP] accumulator (this thread's rows 16
// warp + g and + 8, the wgmma layout), times `mul` and rounded, into the
// swizzled [64 x DP] staging tile `tile`.
template <typename T, int DP>
__device__ __forceinline__ void stage_rows(unsigned char* tile, const float (&acc)[DP / 2],
                                           float mul, int warp, int g, int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = 16 * warp + g + 8 * hr;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<uint32_t*>(tile + swz<Geo<DP>::kSw>(row, 8 * j + 2 * t, kRows)) =
          pack2<T>(acc[4 * j + 2 * hr] * mul, acc[4 * j + 2 * hr + 1] * mul);
  }
}

// The staged rows of each stationary slice that is not empty to the
// slice's rows of `dst` (one head, row stride d), 16 bytes a thread,
// columns past d dropped.
template <int DP>
__device__ __forceinline__ void store_slices(const unsigned char* tile, const Item& it, void* dst,
                                             int d, int ct) {
  for (int c = ct; c < kRows * DP / 8; c += 128) {
    const int rr = c / (DP / 8), col = (c % (DP / 8)) * 8;
    const int slice = pick(it.stat, rr / kSlice);
    if (slice >= 0 && col < d)
      *reinterpret_cast<int4*>(static_cast<unsigned char*>(dst)
                               + (static_cast<size_t>(kSlice * slice + rr % kSlice) * d + col) * 2) =
          *reinterpret_cast<const int4*>(tile + swz<Geo<DP>::kSw>(rr, col, kRows));
  }
}

// The producer warp's ring of the forward and dQ: for each of the item's
// stages, once its slot is free, the stage's streamed K and V slices by TMA
// into k_s / v_s (a [64 x DP] tile a slot) and, with a key bias, the
// stage's 64 key-bias values by the lanes' cp.async into bias_s (64 floats
// a slot); every lane runs it.
template <int DP, int NS, bool BIAS>
__device__ __forceinline__ void stream_kv(unsigned char* k_s, unsigned char* v_s, float* bias_s,
                                          const CUtensorMap* k_map, const CUtensorMap* v_map,
                                          uint64_t* full, uint64_t* empty,
                                          const float* kbias, const Walk& walk, const Item& it,
                                          int b, int bh, int seq, int lane) {
  constexpr int kTileBytes = Geo<DP>::kTile;
  const int n = it.end - it.begin;
  StageSlots table{walk.stages, it.begin, n};
  for (int i = 0; i < n; ++i) {
    const int s = i % NS;
    int slot[kSlots];
    table.get(i, lane, slot);
    if (i >= NS) mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
      load_slices<DP>(k_s + s * kTileBytes, k_map, &full[s], slot, bh);
      load_slices<DP>(v_s + s * kTileBytes, v_map, &full[s], slot, bh);
    }
    if (BIAS) {                                 // lane l: keys l and l + 32 of the stage
      float* bt = bias_s + s * kRows;
      const float* kb = kbias + static_cast<size_t>(b) * seq + lane % kSlice;
      cp_async4(bt + lane, kb + kSlice * (lane < kSlice ? slot[0] : slot[1]));
      cp_async4(bt + 32 + lane, kb + kSlice * (lane < kSlice ? slot[2] : slot[3]));
      cp_async_arrive(&full[s]);
    }
  }
}

template <int DP, int NS>
struct FwdSmem {
  static constexpr int kTile = Geo<DP>::kTile;
  static constexpr int kQ = 0;                        // the gathered Q rows
  static constexpr int kK = kTile;                    // [NS] K stages
  static constexpr int kV = kK + NS * kTile;          // [NS] V stages
  static constexpr int kBias = kV + NS * kTile;       // [NS][64] fp32 key bias
  static constexpr int kBars = kBias + NS * kRows * 4;    // stat, full[NS], empty[NS]
  static constexpr int kFlag = kBars + (1 + 2 * NS) * 8;  // int
  static constexpr int kBytes = kFlag + 16 + 1024;
};

// Floats of a forward partial slot: the unnormalised O [64 x DP], then each
// thread's m and l of its two rows (one float4 a consumer thread).
template <int DP>
constexpr int kFwdSlot = 128 * (DP / 2 + 4);

// Forward: stationary query slices, streamed key slices (dQ's walk without
// dO and dS).  S = Q K^T from shared memory; the key bias (copied by the
// producer's lanes) added, a dead slice -inf; the online softmax in fp32
// registers with exp2 of one FMA a score, the running max guarded at -inf,
// the output rescaled only when a row's max moved; P rounded to the input
// type as the register A operand of O += P V (V MN-major); step i's softmax
// runs while step i - 1's P V does (the loop of evo_wgmma_kernel,
// csrc/evoformer_attn.cu).
template <typename T, int DP, int NS, bool BIAS>
__global__ void __launch_bounds__(kBwdThreads, 2)
bsa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, T* __restrict__ o,
                     float* __restrict__ lse, const float* __restrict__ kbias, int seq,
                     int heads, int d, int batch, Walk walk) {
  using L = FwdSmem<DP, NS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* q_s = sm + L::kQ;
  uint64_t* stat_bar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = stat_bar + 1;
  uint64_t* empty = full + NS;
  int* flag = reinterpret_cast<int*>(sm + L::kFlag);

  const int b = blockIdx.x % batch;
  const Item it = item_of(walk.blocks, blockIdx.x / batch);
  const int bh = b * heads + it.head;
  const int n = it.end - it.begin;

  if (threadIdx.x == 0) {
    mbar_init(stat_bar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], BIAS ? 33 : 1);         // with a bias, + the lanes' copies
      mbar_init(&empty[s], 4);                    // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32 && n > 0) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        int stat[kSlots];
        slices_of(it.stat, stat);
        mbar_arrive_expect_tx(stat_bar, L::kTile);
        load_slices<DP>(q_s, &q_map, stat_bar, stat, bh);
      }
      stream_kv<DP, NS, BIAS>(sm + L::kK, sm + L::kV, reinterpret_cast<float*>(sm + L::kBias),
                              &k_map, &v_map, full, empty, kbias, walk, it, b, bh, seq, lane);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32, g = lane / 4, t = lane % 4;
    const int mine = pick(it.stat, warp), slice = mine >= 0 ? mine : it.stat[0];
    const size_t row_base = static_cast<size_t>(bh) * seq;
    const float kInf = __int_as_float(0x7f800000);

    // this thread's rows 16 warp + g and + 8: running max and its part of
    // the row sums
    float m[2] = {-kInf, -kInf}, l[2] = {0.f, 0.f};
    float acc[DP / 2], s[kRows / 2];
    uint32_t p[kRows / 16][4];
    zero(acc);
    zero(s);
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % NS]);
    };
    auto qk = [&](int i) {                        // S = Q K_i^T
      const unsigned char* k_t = sm + L::kK + (i % NS) * L::kTile;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_t<T, kRows>(s, kdesc<DP>(q_s, 0, kk), kdesc<DP>(k_t, 0, kk), kk);
    };
    auto pv = [&](int i) {                        // O += round(P) V_i
      const unsigned char* v_t = sm + L::kV + (i % NS) * L::kTile;
#pragma unroll
      for (int ks = 0; ks < kSlots; ++ks) wgmma_rs_t<T, DP>(acc, p[ks], mndesc<DP>(v_t, 16 * ks));
    };
    // step i's probabilities in s (fp32), 0 on this warp's dead slots: this
    // thread's columns are 8 (j / 4) + 2t + j % 2, in slot j / 8.  The max
    // runs on the scores, the exponent is one FMA into log2 units, and a
    // stage whose four slots are all live (a warp-uniform test) skips the
    // mask
    auto softmax = [&](int i, int live, float (&corr)[2]) {
      const float* bt = reinterpret_cast<const float*>(sm + L::kBias) + (i % NS) * kRows;
      if (BIAS) {
#pragma unroll
        for (int j = 0; j < kRows / 2; ++j) s[j] += bt[8 * (j >> 2) + 2 * t + (j & 1)];
      }
      if (live != 0xF) {
#pragma unroll
        for (int j = 0; j < kRows / 2; ++j) s[j] = (live >> (j >> 3)) & 1 ? s[j] : -kInf;
      }
      float mx[2] = {-kInf, -kInf};
#pragma unroll
      for (int j = 0; j < kRows / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
      float base[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 2));
        const float m_new = fmaxf(m[hr], mx[hr]);
        // a row that has seen only -inf subtracts 0: its p and corr are 0
        // (rounded products, not FMAs: an unmoved max gives corr = 1 exactly)
        base[hr] = m_new == -kInf ? 0.f : __fmul_rn(m_new, kLog2e);
        corr[hr] = exp2_ftz(__fmul_rn(m[hr], kLog2e) - base[hr]);
        m[hr] = m_new;
        l[hr] *= corr[hr];
      }
#pragma unroll
      for (int j = 0; j < kRows / 2; ++j) {
        const int hr = (j >> 1) & 1;
        s[j] = exp2_ftz(fmaf(s[j], kLog2e, -base[hr]));
        l[hr] += s[j];
      }
    };
    auto live_of = [&](int i) {
      return (__ldg(walk.stages + static_cast<size_t>(it.begin + i) * kStageInts + kSlots)
              >> (4 * warp)) & 0xF;
    };
    auto operands_ready = [&]() {                 // as flash_attention.cu's
      fence_all(s);
      fence_all(acc);
      fence_all(p);
      wgmma_fence();
    };

    if (n > 0) {
      float corr[2];
      mbar_wait(stat_bar, 0);
      mbar_wait(&full[0], 0);
      operands_ready();
      qk(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(s);
      softmax(0, live_of(0), corr);
      to_a<T, kRows>(p, s);
      // step i issues its S beside step i - 1's P V, then runs its softmax
      // while the P V product runs
      for (int i = 1; i < n; ++i) {
        const int live = live_of(i);
        mbar_wait(&full[i % NS], (i / NS) & 1);
        operands_ready();
        qk(i);
        wgmma_commit();
        pv(i - 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_all(s);
        softmax(i, live, corr);
        wgmma_wait<0>();
        fence_all(acc);
        fence_all(p);
        release(i - 1);
        // rescale only when a row's max moved (x 1 changes no bit)
        if (__any_sync(kFull, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
          for (int j = 0; j < DP / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
        }
        to_a<T, kRows>(p, s);
      }
      operands_ready();
      pv(n - 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(acc);
      fence_all(p);
      release(n - 1);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {              // the row's sum over its quad
      l[hr] += __shfl_xor_sync(kFull, l[hr], 1);
      l[hr] += __shfl_xor_sync(kFull, l[hr], 2);
    }

    if (it.parts > 1) {
      // each part's unnormalised O and its rows' m and l; the last part to
      // finish merges them in part order: m* = max m_p, O and l summed with
      // weights exp(m_p - m*)
      constexpr int kO = 128 * DP / 2;
      float* mine_slot = partial_slot(it, walk, it.part, b, batch, kFwdSlot<DP>);
      put_partial(mine_slot, acc, ct);
      reinterpret_cast<float4*>(mine_slot + kO)[ct] = make_float4(m[0], m[1], l[0], l[1]);
      if (!last_part(it, walk, b, batch, ct, flag)) return;
      float4 ml[2];
      m[0] = m[1] = -kInf;
      for (int q = 0; q < it.parts; ++q) {
        ml[0] = __ldcg(reinterpret_cast<const float4*>(
                           partial_slot(it, walk, q, b, batch, kFwdSlot<DP>) + kO) + ct);
        m[0] = fmaxf(m[0], ml[0].x);
        m[1] = fmaxf(m[1], ml[0].y);
      }
      const float base0 = m[0] == -kInf ? 0.f : __fmul_rn(m[0], kLog2e);
      const float base1 = m[1] == -kInf ? 0.f : __fmul_rn(m[1], kLog2e);
      zero(acc);
      l[0] = l[1] = 0.f;
      for (int q = 0; q < it.parts; ++q) {
        const float* part = partial_slot(it, walk, q, b, batch, kFwdSlot<DP>);
        ml[1] = __ldcg(reinterpret_cast<const float4*>(part + kO) + ct);
        const float w0 = exp2_ftz(__fmul_rn(ml[1].x, kLog2e) - base0);
        const float w1 = exp2_ftz(__fmul_rn(ml[1].y, kLog2e) - base1);
        add_partial(acc, part, ct, w0, w1);
        l[0] = fmaf(ml[1].z, w0, l[0]);
        l[1] = fmaf(ml[1].w, w1, l[1]);
      }
    }
    // normalise (a row that saw no key: zeros, lse -1e30), stage O (rounded
    // once) in the Q tile, which no product reads any more, write each
    // slice's rows and the rows' lse
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float safe_l = l[hr] == 0.f ? 1.f : l[hr];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j + 2 * hr] /= safe_l;
        acc[4 * j + 2 * hr + 1] /= safe_l;
      }
      if (t == 0 && mine >= 0)
        lse[row_base + kSlice * slice + g + 8 * hr] =
            m[hr] == -kInf ? kNegInf : m[hr] + logf(safe_l);
    }
    stage_rows<T, DP>(q_s, acc, 1.f, warp, g, t);
    named_barrier(1, 128);
    store_slices<DP>(q_s, it, o + row_base * d, d, ct);
  }
}

template <int DP, int NS>
struct DqSmem {
  static constexpr int kTile = Geo<DP>::kTile;
  static constexpr int kQ = 0;                        // the gathered Q rows
  static constexpr int kDo = kTile;                   // and dO rows
  static constexpr int kK = 2 * kTile;                // [NS] K stages
  static constexpr int kV = kK + NS * kTile;          // [NS] V stages
  static constexpr int kBias = kV + NS * kTile;       // [NS][64] fp32 key bias
  static constexpr int kBars = kBias + NS * kRows * 4;    // stat, full[NS], empty[NS]
  static constexpr int kFlag = kBars + (1 + 2 * NS) * 8;  // int
  static constexpr int kBytes = kFlag + 16 + 1024;
};

// dQ: stationary query slices, streamed key slices.  S = Q K^T and dP =
// dO V^T from shared memory, dS = P (dP - delta) masked and rounded in
// registers, dQ += dS K from registers, step i's S and dP beside step i - 1's
// dQ product (the loop of flash_bwd_dq_kernel, csrc/flash_attention.cu).
template <typename T, int DP, int NS, bool BIAS>
__global__ void __launch_bounds__(kBwdThreads, 2)
bsa_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq,
                    const float* __restrict__ kbias, int seq, int heads, int d, int batch,
                    float scale, Walk walk) {
  using L = DqSmem<DP, NS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* q_s = sm + L::kQ;
  unsigned char* do_s = sm + L::kDo;
  uint64_t* stat_bar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = stat_bar + 1;
  uint64_t* empty = full + NS;
  int* flag = reinterpret_cast<int*>(sm + L::kFlag);

  const int b = blockIdx.x % batch;
  const Item it = item_of(walk.blocks, blockIdx.x / batch);
  const int bh = b * heads + it.head;
  const int n = it.end - it.begin;

  if (threadIdx.x == 0) {
    mbar_init(stat_bar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], BIAS ? 33 : 1);         // with a bias, + the lanes' copies
      mbar_init(&empty[s], 4);                    // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32 && n > 0) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        int stat[kSlots];
        slices_of(it.stat, stat);
        mbar_arrive_expect_tx(stat_bar, 2 * L::kTile);
        load_slices<DP>(q_s, &q_map, stat_bar, stat, bh);
        load_slices<DP>(do_s, &do_map, stat_bar, stat, bh);
      }
      stream_kv<DP, NS, BIAS>(sm + L::kK, sm + L::kV, reinterpret_cast<float*>(sm + L::kBias),
                              &k_map, &v_map, full, empty, kbias, walk, it, b, bh, seq, lane);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32, g = lane / 4, t = lane % 4;
    const int mine = pick(it.stat, warp), slice = mine >= 0 ? mine : it.stat[0];
    const size_t row_base = static_cast<size_t>(bh) * seq;

    // delta = rowsum(do * o) of this thread's rows (of slot `warp`), written
    // for dK/dV by the list's first part: each lane of the row's quad takes
    // every fourth 16-byte vector
    float lse2[2], dlt[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const size_t r = row_base + kSlice * slice + g + 8 * hr;
      float part = 0.f;
      for (int c = 8 * t; c < d; c += 32)
        part += dot8<T>(*reinterpret_cast<const int4*>(o + r * d + c),
                        *reinterpret_cast<const int4*>(dout + r * d + c));
      part += __shfl_xor_sync(kFull, part, 1);
      part += __shfl_xor_sync(kFull, part, 2);
      dlt[hr] = part;
      lse2[hr] = lse[r] * kLog2e;
      if (t == 0 && it.part == 0 && mine >= 0) delta[r] = part;
    }

    float acc[DP / 2], s[kRows / 2], dp[kRows / 2];
    uint32_t ds[kRows / 16][4];
    zero(acc);
    zero(s);
    zero(dp);
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % NS]);
    };
    auto s_dp = [&](int i) {                      // S = Q K_i^T, dP = dO V_i^T
      const unsigned char* k_t = sm + L::kK + (i % NS) * L::kTile;
      const unsigned char* v_t = sm + L::kV + (i % NS) * L::kTile;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_t<T, kRows>(s, kdesc<DP>(q_s, 0, kk), kdesc<DP>(k_t, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_t<T, kRows>(dp, kdesc<DP>(do_s, 0, kk), kdesc<DP>(v_t, 0, kk), kk);
    };
    auto dq_step = [&](int i) {                   // dQ += round(dS) K_i
      const unsigned char* k_t = sm + L::kK + (i % NS) * L::kTile;
#pragma unroll
      for (int ks = 0; ks < kSlots; ++ks) wgmma_rs_t<T, DP>(acc, ds[ks], mndesc<DP>(k_t, 16 * ks));
    };
    // step i's dS = P (dP - delta) in s, 0 on this warp's dead slots: this
    // thread's columns are 8 (j / 4) + 2t + j % 2, in slot j / 8
    auto to_ds = [&](int i, int live) {
      const float* bt = reinterpret_cast<const float*>(sm + L::kBias) + (i % NS) * kRows;
#pragma unroll
      for (int j = 0; j < kRows / 2; ++j) {
        const int hr = (j >> 1) & 1;
        const float x = BIAS ? s[j] + bt[8 * (j >> 2) + 2 * t + (j & 1)] : s[j];
        const float pr = exp2_ftz(fmaf(x, kLog2e, -lse2[hr]));
        s[j] = (live >> (j >> 3)) & 1 ? pr * (dp[j] - dlt[hr]) : 0.f;
      }
    };
    auto live_of = [&](int i) {
      return (__ldg(walk.stages + static_cast<size_t>(it.begin + i) * kStageInts + kSlots)
              >> (4 * warp)) & 0xF;
    };
    auto operands_ready = [&]() {                 // as flash_attention.cu's
      fence_all(s);
      fence_all(dp);
      fence_all(acc);
      fence_all(ds);
      wgmma_fence();
    };

    if (n > 0) {
      int live = live_of(0);
      mbar_wait(stat_bar, 0);
      mbar_wait(&full[0], 0);
      operands_ready();
      s_dp(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(s);
      fence_all(dp);
      to_ds(0, live);
      to_a<T, kRows>(ds, s);
      for (int i = 1; i < n; ++i) {
        live = live_of(i);
        mbar_wait(&full[i % NS], (i / NS) & 1);
        operands_ready();
        s_dp(i);
        wgmma_commit();
        dq_step(i - 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_all(s);
        fence_all(dp);
        to_ds(i, live);
        wgmma_wait<0>();
        fence_all(acc);
        fence_all(ds);
        release(i - 1);
        to_a<T, kRows>(ds, s);
      }
      operands_ready();
      dq_step(n - 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(acc);
      fence_all(ds);
      release(n - 1);
    }

    if (it.parts > 1) {
      constexpr int kSlot = 128 * DP / 2;
      put_partial(partial_slot(it, walk, it.part, b, batch, kSlot), acc, ct);
      if (!last_part(it, walk, b, batch, ct, flag)) return;
      zero(acc);
      for (int p = 0; p < it.parts; ++p)
        add_partial(acc, partial_slot(it, walk, p, b, batch, kSlot), ct);
    }
    // stage dQ (scaled, rounded once) in the Q tile, which no product reads
    // any more, and write each slice's rows
    stage_rows<T, DP>(q_s, acc, scale, warp, g, t);
    named_barrier(1, 128);
    store_slices<DP>(q_s, it, dq + row_base * d, d, ct);
  }
}

template <int DP, int NS>
struct DkvSmem {
  static constexpr int kTile = Geo<DP>::kTile;
  static constexpr int kK = 0;                        // the gathered K rows
  static constexpr int kV = kTile;                    // and V rows
  static constexpr int kQ = 2 * kTile;                // [NS] Q stages
  static constexpr int kDo = kQ + NS * kTile;         // [NS] dO stages
  static constexpr int kStats = kDo + NS * kTile;     // [NS] lse[64], delta[64]
  static constexpr int kBars = kStats + NS * 2 * kRows * 4;  // stat, full[NS], empty[NS]
  static constexpr int kFlag = kBars + (1 + 2 * NS) * 8;     // int
  static constexpr int kBytes = kFlag + 16 + 1024;
};

// dK/dV: stationary key slices, streamed query slices, BQ query rows a step
// (64; 32 at DP = 128, so that both sums and both score tiles stay in
// registers).  S^T = K Q^T and dP^T = V dO^T from shared memory; P^T (the
// key bias of this thread's two keys held in registers) and dS^T masked and
// rounded in registers; dV += P^T dO and dK += dS^T Q from registers (the
// loop of flash_bwd_dkv_kernel).
template <typename T, int DP, int NS, int BQ, bool BIAS>
__global__ void __launch_bounds__(kBwdThreads, 2)
bsa_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     const float* __restrict__ kbias, int seq, int heads, int d, int batch,
                     Walk walk) {
  using L = DkvSmem<DP, NS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* k_s = sm + L::kK;
  unsigned char* v_s = sm + L::kV;
  uint64_t* stat_bar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = stat_bar + 1;
  uint64_t* empty = full + NS;
  int* flag = reinterpret_cast<int*>(sm + L::kFlag);

  const int b = blockIdx.x % batch;
  const Item it = item_of(walk.blocks, blockIdx.x / batch);
  const int bh = b * heads + it.head;
  const int n = it.end - it.begin;
  const size_t row_base = static_cast<size_t>(bh) * seq;

  if (threadIdx.x == 0) {
    mbar_init(stat_bar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 33);                    // TMA, + the producer lanes' copies
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32 && n > 0) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        int stat[kSlots];
        slices_of(it.stat, stat);
        mbar_arrive_expect_tx(stat_bar, 2 * L::kTile);
        load_slices<DP>(k_s, &k_map, stat_bar, stat, bh);
        load_slices<DP>(v_s, &v_map, stat_bar, stat, bh);
      }
      StageSlots table{walk.stages, it.begin, n};
      for (int i = 0; i < n; ++i) {
        const int s = i % NS;
        int slot[kSlots];
        table.get(i, lane, slot);
        if (i >= NS) mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
          load_slices<DP>(sm + L::kQ + s * L::kTile, &q_map, &full[s], slot, bh);
          load_slices<DP>(sm + L::kDo + s * L::kTile, &do_map, &full[s], slot, bh);
        }
        // lane l: lse and delta of the stage's rows l and l + 32
        float* st = reinterpret_cast<float*>(sm + L::kStats) + s * 2 * kRows;
        const size_t r0 = row_base + kSlice * (lane < kSlice ? slot[0] : slot[1]) + lane % kSlice;
        const size_t r1 = row_base + kSlice * (lane < kSlice ? slot[2] : slot[3]) + lane % kSlice;
        cp_async4(st + lane, lse + r0);
        cp_async4(st + 32 + lane, lse + r1);
        cp_async4(st + kRows + lane, delta + r0);
        cp_async4(st + kRows + 32 + lane, delta + r1);
        cp_async_arrive(&full[s]);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32, g = lane / 4, t = lane % 4;
    const int mine = pick(it.stat, warp), slice = mine >= 0 ? mine : it.stat[0];
    float kb[2] = {0.f, 0.f};                     // the key bias of keys g and g + 8
    if (BIAS) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        kb[hr] = kbias[static_cast<size_t>(b) * seq + kSlice * slice + g + 8 * hr];
    }

    float dk_acc[DP / 2], dv_acc[DP / 2], st[BQ / 2], dpt[BQ / 2];
    uint32_t fr[BQ / 16][4];
    zero(dk_acc);
    zero(dv_acc);
    zero(st);
    zero(dpt);
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % NS]);
    };
    auto operands_ready = [&]() {
      fence_all(st);
      fence_all(dpt);
      fence_all(dk_acc);
      fence_all(dv_acc);
      fence_all(fr);
      wgmma_fence();
    };

    if (n > 0) mbar_wait(stat_bar, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % NS;
      const unsigned char* q_t = sm + L::kQ + s * L::kTile;
      const unsigned char* do_t = sm + L::kDo + s * L::kTile;
      const float* lse_t = reinterpret_cast<const float*>(sm + L::kStats) + s * 2 * kRows;
      const float* delta_t = lse_t + kRows;
      const int live =
          (__ldg(walk.stages + static_cast<size_t>(it.begin + i) * kStageInts + kSlots)
           >> (4 * warp)) & 0xF;
      mbar_wait(&full[s], (i / NS) & 1);
#pragma unroll 1
      for (int h0 = 0; h0 < kRows; h0 += BQ) {
        operands_ready();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss_t<T, BQ>(st, kdesc<DP>(k_s, 0, kk), kdesc<DP>(q_t, h0, kk), kk);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss_t<T, BQ>(dpt, kdesc<DP>(v_s, 0, kk), kdesc<DP>(do_t, h0, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();                          // and the last step's dK product
        fence_all(st);
        fence_all(dpt);
        fence_all(dk_acc);
        fence_all(dv_acc);
        fence_all(fr);
        if (i > 0 && h0 == 0) release(i - 1);

        // P^T: this thread's keys (rows) against the step's queries h0 + x,
        // x = 8 (j / 4) + 2t + j % 2, in slot (h0 + x) / 16
#pragma unroll
        for (int j = 0; j < BQ / 2; ++j) {
          const int hr = (j >> 1) & 1, x = h0 + 8 * (j >> 2) + 2 * t + (j & 1);
          const float y = BIAS ? st[j] + kb[hr] : st[j];
          const float pr = exp2_ftz(fmaf(y, kLog2e, -lse_t[x] * kLog2e));
          st[j] = (live >> (x >> 4)) & 1 ? pr : 0.f;
        }
        to_a<T, BQ>(fr, st);
        operands_ready();
#pragma unroll
        for (int ks = 0; ks < BQ / 16; ++ks)      // dV += round(P^T) dO
          wgmma_rs_t<T, DP>(dv_acc, fr[ks], mndesc<DP>(do_t, h0 + 16 * ks));
        wgmma_commit();
        // dS^T = P^T (dP^T - delta) while the tensor cores run dV
#pragma unroll
        for (int j = 0; j < BQ / 2; ++j)
          dpt[j] = st[j] * (dpt[j] - delta_t[h0 + 8 * (j >> 2) + 2 * t + (j & 1)]);
        wgmma_wait<0>();
        fence_all(dv_acc);
        fence_all(fr);
        to_a<T, BQ>(fr, dpt);
        operands_ready();
#pragma unroll
        for (int ks = 0; ks < BQ / 16; ++ks)      // dK += round(dS^T) Q
          wgmma_rs_t<T, DP>(dk_acc, fr[ks], mndesc<DP>(q_t, h0 + 16 * ks));
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_all(dk_acc);
    fence_all(fr);
    if (n > 0) release(n - 1);

    if (it.parts > 1) {                           // dK's sums, then dV's, a slot
      constexpr int kHalf = 128 * DP / 2;
      float* part = partial_slot(it, walk, it.part, b, batch, 2 * kHalf);
      put_partial(part, dk_acc, ct);
      put_partial(part + kHalf, dv_acc, ct);
      if (!last_part(it, walk, b, batch, ct, flag)) return;
      zero(dk_acc);
      zero(dv_acc);
      for (int p = 0; p < it.parts; ++p) {
        const float* sums = partial_slot(it, walk, p, b, batch, 2 * kHalf);
        add_partial(dk_acc, sums, ct);
        add_partial(dv_acc, sums + kHalf, ct);
      }
    }
    // stage dK and dV (rounded once) in the K and V tiles, which no product
    // reads any more, and write each slice's rows
    stage_rows<T, DP>(k_s, dk_acc, 1.f, warp, g, t);
    stage_rows<T, DP>(v_s, dv_acc, 1.f, warp, g, t);
    named_barrier(1, 128);
    store_slices<DP>(k_s, it, dk + row_base * d, d, ct);
    store_slices<DP>(v_s, it, dv + row_base * d, d, ct);
  }
}

// ----------------------------------------------------------------------------
// Forward in fp32 on the slice walk: split TF32 on mma.sync
// ----------------------------------------------------------------------------
// What bounds it: at BSLongformer (B 4, H 12, S 4096, D 64) the stages'
// live slot pairs carry ~4 GFLOP of fp32 products (0.06 ms at 67 TFLOP/s on
// the CUDA cores) and the operands 0.06 ms of bytes.  The general kernel
// before it, one key a lane with dot products over D from shared memory and
// synchronous 64 x 64 tiles, ran at ~25x that.  So, on the bf16 forward's
// walk (query slices stationary, the live key slices streamed four to a
// stage):
// * the products run on the tensor cores, mma.sync.m16n8k8 in TF32 with
//   each fp32 operand split as hi = tf32(x) and lo = x - hi (which the
//   tensor cores truncate to TF32) and each product hi.hi + hi.lo + lo.hi
//   in fp32 accumulators (3xTF32; the split of evo_split_kernel,
//   csrc/evoformer_attn.cu, whose helpers are repeated here so that each
//   source's planted fault edits its own text); Q is split once a block;
// * a block is 8 warps: warp w holds the 16 rows of stationary slot w % 4
//   and the keys of stage slots 2 (w / 4) and 2 (w / 4) + 1, so a warp
//   skips a dead 16-key slot's products (the stage's mask bits are its
//   own, and a slot whose 16 keys the key bias drops, -inf: a padded
//   batch row's tail, is dead too: skipping it adds the same zeros) and
//   the whole stage when both are dead; the two warps of a row
//   slot keep their own running max, sums and O, merged in a fixed order at
//   the end (two 16-row tiles a warp against one slot, each K and V
//   fragment split once for both, ran 6-20% slower: 128 registers a thread
//   at two blocks an SM spill, PERF.md);
// * K and V slices come by cp.async (16, 8 or 4 bytes a copy, by D's
//   alignment; D padded with zeros to DP) through a ring of NS stages,
//   loaded NS - 1 stages ahead by the block's threads, with the stage's key
//   bias; row strides put every fragment's loads on distinct banks, and the
//   fragments' k order is permuted (column t holds element 2t, column t + 4
//   element 2t + 1, in A and B alike) so that S's accumulators are P V's A
//   fragments with no shuffle;
// * the online softmax runs in fp32 registers with exp2 of one FMA a score,
//   as the bf16 forward's; P is not rounded (fp32);
// * a split list's parts write O, m and l and the last part merges them in
//   part order (the bf16 forward's partial slots and counters).
// Every sum runs in a fixed order: two runs give the same bits.
constexpr int kSplitWarps = 8;
constexpr int kSplitThreads = 32 * kSplitWarps;

// x rounded to TF32 (10 explicit mantissa bits, to nearest, ties away)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as TF32 parts: hi = tf32(x) and the remainder x - hi, not rounded
// again (the tensor cores read its top 10 mantissa bits: one instruction
// less a value than rounding it, 6% faster on the card, PERF.md)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b over one m16n8k8 tile from TF32 parts: hi.lo + lo.hi (the
// split's cross terms), then hi.hi
__device__ __forceinline__ void mma_split(float* c, const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  {  // the split's cross terms
    mma_tf32(c, al, bh[0], bh[1]);
    mma_tf32(c, ah, bl[0], bl[1]);
  }
  mma_tf32(c, ah, bh[0], bh[1]);
}

// `BYTES` (4, 8 or 16) global -> shared, asynchronously
template <int BYTES>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The split kernel's shared memory (floats): Q [64 x kLdq], then NS stages
// of K [64 x kLdk], V [64 x kLdv] and the key bias [64]; row strides that put
// a warp's fragment loads on distinct banks.
template <int DP, int NS>
struct SplitSmem {
  static constexpr int kLdq = DP + 8, kLdk = DP + 8, kLdv = DP + 4;
  static constexpr int kQ = 0;                       // Q's TF32 parts: hi,
  static constexpr int kQLo = kRows * kLdq;          // and the remainders
  static constexpr int kRing = 2 * kRows * kLdq;
  static constexpr int kK = 0, kV = kRows * kLdk, kBias = kV + kRows * kLdv;
  static constexpr int kStage = kBias + kRows;
  static constexpr int kFlag = kRing + NS * kStage;
  static constexpr int kBytes = (kFlag + 4) * 4;
};

// The 64 rows of four 16-row slices of one head (`src`: its [S, d] rows)
// into `dst` at row stride ld, `vec` bytes a copy by the block's threads.
__device__ __forceinline__ void copy_slices_f32(float* dst, int ld, const float* src,
                                                const int (&sl)[kSlots], int d, int vec) {
  const int per = vec / 4, chunks = d / per;
  for (int i = threadIdx.x; i < kRows * chunks; i += kSplitThreads) {
    const int rr = i / chunks, c = (i - rr * chunks) * per;
    const float* from = src + static_cast<size_t>(kSlice * pick(sl, rr / kSlice) + rr % kSlice) * d + c;
    float* to = dst + rr * ld + c;
    if (vec == 16) cp_async_n<16>(to, from);
    else if (vec == 8) cp_async_n<8>(to, from);
    else cp_async_n<4>(to, from);
  }
}

template <int DP>
struct SplitTiles {
  static constexpr int kStages = DP <= 16 ? 3 : 2;
  static constexpr int kMinBlocks = DP <= 32 ? 3 : DP <= 64 ? 2 : 1;
};


template <int DP, int NS, bool BIAS>
__global__ void __launch_bounds__(kSplitThreads, SplitTiles<DP>::kMinBlocks)
bsa_fwd_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, const float* __restrict__ kbias, int seq,
                     int heads, int d, int batch, int vec, Walk walk) {
  using L = SplitSmem<DP, NS>;
  extern __shared__ __align__(16) float ssm[];
  float* q_s = ssm + L::kQ;
  float* qlo_s = ssm + L::kQLo;
  int* flag = reinterpret_cast<int*>(ssm + L::kFlag);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rs = warp % kSlots, half = warp / kSlots;    // row slot, key half
  const int b = blockIdx.x % batch;
  const Item it = item_of(walk.blocks, blockIdx.x / batch);
  const int bh = b * heads + it.head;
  const int n = it.end - it.begin;
  const size_t row_base = static_cast<size_t>(bh) * seq;
  const float* kb = k + row_base * d;
  const float* vb = v + row_base * d;
  auto stage_of = [&](int i) { return ssm + L::kRing + (i % NS) * L::kStage; };
  const float kInf = __int_as_float(0x7f800000);

  if (d < DP) {                                   // the padding the products read
    for (int i = threadIdx.x; i < kRows * (DP - d); i += kSplitThreads) {
      const int r = i / (DP - d), c = d + i % (DP - d);
      q_s[r * L::kLdq + c] = 0.f;
      for (int s = 0; s < NS; ++s) {
        stage_of(s)[L::kK + r * L::kLdk + c] = 0.f;
        stage_of(s)[L::kV + r * L::kLdv + c] = 0.f;
      }
    }
  }
  auto slots_of = [&](int i, int (&sl)[kSlots]) {
    const int4 st = __ldg(reinterpret_cast<const int4*>(
        walk.stages + static_cast<size_t>(it.begin + i) * kStageInts));
    sl[0] = st.x;
    sl[1] = st.y >= 0 ? st.y : st.x;
    sl[2] = st.z >= 0 ? st.z : st.x;
    sl[3] = st.w >= 0 ? st.w : st.x;
  };
  auto load = [&](int i) {                        // stage i's K, V and key bias
    if (i < n) {
      int sl[kSlots];
      slots_of(i, sl);
      float* st = stage_of(i);
      copy_slices_f32(st + L::kK, L::kLdk, kb, sl, d, vec);
      copy_slices_f32(st + L::kV, L::kLdv, vb, sl, d, vec);
      if (BIAS && threadIdx.x < kRows)
        cp_async_n<4>(st + L::kBias + threadIdx.x,
                      kbias + static_cast<size_t>(b) * seq + kSlice * pick(sl, threadIdx.x / kSlice)
                          + threadIdx.x % kSlice);
    }
    cp_commit();
  };
  {
    int stat[kSlots];
    slices_of(it.stat, stat);
    copy_slices_f32(q_s, L::kLdq, q + row_base * d, stat, d, vec);
  }
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) load(i);

  // this thread's rows 16 rs + g and + 8: running max, its part of the row
  // sums, and O (fragment order: element 4 nd + 2 hr + e is row g + 8 hr,
  // column 8 nd + 2t + e)
  float m[2] = {-kInf, -kInf}, l[2] = {0.f, 0.f};
  float acc[DP / 2];
  zero(acc);
  const float* q_row0 = q_s + (16 * rs + g) * L::kLdq + 2 * t;
  const float* qlo_row0 = qlo_s + (16 * rs + g) * L::kLdq + 2 * t;
  for (int i = 0; i < n; ++i) {
    cp_wait<NS - 2>();
    __syncthreads();                              // stage i landed; stage i - 1 read
    if (i == 0) {                                 // Q landed with stage 0: split it once
      for (int e = threadIdx.x; e < kRows * DP; e += kSplitThreads) {
        float* x = q_s + (e / DP) * L::kLdq + e % DP;
        uint32_t hi, lo;
        split_tf32(*x, hi, lo);
        *x = __uint_as_float(hi);
        qlo_s[(e / DP) * L::kLdq + e % DP] = __uint_as_float(lo);
      }
      __syncthreads();
    }
    load(i + NS - 1);
    int live = (__ldg(walk.stages + static_cast<size_t>(it.begin + i) * kStageInts + kSlots)
                >> (4 * rs + 2 * half)) & 3;
    const float* st = stage_of(i);
    if (BIAS) {                                   // a slot whose 16 keys the key bias drops
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (__all_sync(kFull, st[L::kBias + 32 * half + 16 * j + (lane & 15)] == -kInf))
          live &= ~(1 << j);
    }
    if (live == 0) continue;                      // (warp-uniform)
    const float* k_t = st + L::kK + 32 * half * L::kLdk;
    const float* v_t = st + L::kV + 32 * half * L::kLdv;

    // S = Q K^T over this warp's 32 keys: slot j's 8-key tile nb in
    // s[8 j + 4 nb ..]; k step kk takes dims 8 kk .. 8 kk + 7
    float s[16];
    zero(s);
#pragma unroll 2
    for (int kk = 0; kk < DP / 8; ++kk) {
      uint32_t ah[4], al[4];
      const float2 x0 = *reinterpret_cast<const float2*>(q_row0 + 8 * kk);
      const float2 x1 = *reinterpret_cast<const float2*>(q_row0 + 8 * L::kLdq + 8 * kk);
      const float2 y0 = *reinterpret_cast<const float2*>(qlo_row0 + 8 * kk);
      const float2 y1 = *reinterpret_cast<const float2*>(qlo_row0 + 8 * L::kLdq + 8 * kk);
      ah[0] = __float_as_uint(x0.x);
      ah[1] = __float_as_uint(x1.x);
      ah[2] = __float_as_uint(x0.y);
      ah[3] = __float_as_uint(x1.y);
      al[0] = __float_as_uint(y0.x);
      al[1] = __float_as_uint(y1.x);
      al[2] = __float_as_uint(y0.y);
      al[3] = __float_as_uint(y1.y);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!((live >> j) & 1)) continue;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const float2 y = *reinterpret_cast<const float2*>(
              k_t + (16 * j + 8 * nb + g) * L::kLdk + 8 * kk + 2 * t);
          uint32_t bh2[2], bl2[2];
          split_tf32(y.x, bh2[0], bl2[0]);
          split_tf32(y.y, bh2[1], bl2[1]);
          mma_split(s + 8 * j + 4 * nb, ah, al, bh2, bl2);
        }
      }
    }

    // the online softmax of this warp's keys: the key bias added, a dead
    // slot -inf, the max on the scores, exp2 of one FMA a score
    const float* bt = st + L::kBias + 32 * half;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int j = e / 8;
      const float bias = BIAS ? bt[8 * (e / 4) + 2 * t + (e & 1)] : 0.f;
      s[e] = (live >> j) & 1 ? s[e] + bias : -kInf;
    }
    float corr[2], base[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -kInf;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (((e >> 1) & 1) == hr) mx = fmaxf(mx, s[e]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      // a row that has seen only -inf subtracts 0: its p and corr are 0
      base[hr] = m_new == -kInf ? 0.f : __fmul_rn(m_new, kLog2e);
      corr[hr] = exp2_ftz(__fmul_rn(m[hr], kLog2e) - base[hr]);
      m[hr] = m_new;
      l[hr] *= corr[hr];
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int hr = (e >> 1) & 1;
      s[e] = exp2_ftz(fmaf(s[e], kLog2e, -base[hr]));
      l[hr] += s[e];
    }
    if (__any_sync(kFull, corr[0] != 1.f || corr[1] != 1.f)) {   // x 1 changes no bit
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
    }

    // O += P V: slot j's key block kb (keys 16 j + 8 kb ..; P's column t is
    // key 2t, its S accumulator element 0 / 2, column t + 4 key 2t + 1)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!((live >> j) & 1)) continue;
#pragma unroll
      for (int kb2 = 0; kb2 < 2; ++kb2) {
        const float* p = s + 8 * j + 4 * kb2;
        uint32_t ah[4], al[4];
        split_tf32(p[0], ah[0], al[0]);
        split_tf32(p[2], ah[1], al[1]);
        split_tf32(p[1], ah[2], al[2]);
        split_tf32(p[3], ah[3], al[3]);
        const float* v0 = v_t + (16 * j + 8 * kb2 + 2 * t) * L::kLdv + g;
#pragma unroll
        for (int nd = 0; nd < DP / 8; ++nd) {
          uint32_t bh2[2], bl2[2];
          split_tf32(v0[8 * nd], bh2[0], bl2[0]);
          split_tf32(v0[L::kLdv + 8 * nd], bh2[1], bl2[1]);
          mma_split(acc + 4 * nd, ah, al, bh2, bl2);
        }
      }
    }
  }
  cp_wait<0>();                                   // (only empty groups left)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {                // the row's sum over its quad
    l[hr] += __shfl_xor_sync(kFull, l[hr], 1);
    l[hr] += __shfl_xor_sync(kFull, l[hr], 2);
  }

  // the two key halves of a row slot: half 1 puts its m, l and O in the
  // ring (no stage is read any more), half 0 merges them, its own first
  const int ct = threadIdx.x % 128;
  float* mine_half = ssm + L::kRing;
  __syncthreads();
  if (half == 1) {
    put_partial(mine_half, acc, ct);
    reinterpret_cast<float4*>(mine_half + 64 * DP)[ct] = make_float4(m[0], m[1], l[0], l[1]);
  }
  __syncthreads();
  if (half == 1) return;
  {
    const float4 ml = reinterpret_cast<const float4*>(mine_half + 64 * DP)[ct];
    const float other_m[2] = {ml.x, ml.y}, other_l[2] = {ml.z, ml.w};
    float w_own[2], w_other[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float m_new = fmaxf(m[hr], other_m[hr]);
      const float base = m_new == -kInf ? 0.f : __fmul_rn(m_new, kLog2e);
      w_own[hr] = exp2_ftz(__fmul_rn(m[hr], kLog2e) - base);
      w_other[hr] = exp2_ftz(__fmul_rn(other_m[hr], kLog2e) - base);
      l[hr] = fmaf(other_l[hr], w_other[hr], l[hr] * w_own[hr]);
      m[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc[j] *= w_own[(j >> 1) & 1];
    add_partial<DP / 2, true>(acc, mine_half, ct, w_other[0], w_other[1]);
  }

  if (it.parts > 1) {
    // each part's unnormalised O and its rows' m and l; the last part to
    // finish merges them in part order: m* = max m_p, O and l summed with
    // weights exp(m_p - m*)
    constexpr int kO = 128 * DP / 2;
    float* mine_slot = partial_slot(it, walk, it.part, b, batch, kFwdSlot<DP>);
    put_partial(mine_slot, acc, ct);
    reinterpret_cast<float4*>(mine_slot + kO)[ct] = make_float4(m[0], m[1], l[0], l[1]);
    if (!last_part(it, walk, b, batch, ct, flag)) return;
    float4 ml;
    m[0] = m[1] = -kInf;
    for (int p = 0; p < it.parts; ++p) {
      ml = __ldcg(reinterpret_cast<const float4*>(
                      partial_slot(it, walk, p, b, batch, kFwdSlot<DP>) + kO) + ct);
      m[0] = fmaxf(m[0], ml.x);
      m[1] = fmaxf(m[1], ml.y);
    }
    const float base0 = m[0] == -kInf ? 0.f : __fmul_rn(m[0], kLog2e);
    const float base1 = m[1] == -kInf ? 0.f : __fmul_rn(m[1], kLog2e);
    zero(acc);
    l[0] = l[1] = 0.f;
    for (int p = 0; p < it.parts; ++p) {
      const float* part = partial_slot(it, walk, p, b, batch, kFwdSlot<DP>);
      ml = __ldcg(reinterpret_cast<const float4*>(part + kO) + ct);
      const float w0 = exp2_ftz(__fmul_rn(ml.x, kLog2e) - base0);
      const float w1 = exp2_ftz(__fmul_rn(ml.y, kLog2e) - base1);
      add_partial(acc, part, ct, w0, w1);
      l[0] = fmaf(ml.z, w0, l[0]);
      l[1] = fmaf(ml.w, w1, l[1]);
    }
  }
  // normalise (a row that saw no key: zeros, lse -1e30) and write this
  // thread's columns 8 nd + 2t, + 1 of its rows of its slot's slice
  const int mine = pick(it.stat, rs);
  if (mine < 0) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float safe_l = l[hr] == 0.f ? 1.f : l[hr];
    const size_t row = row_base + kSlice * mine + g + 8 * hr;
    float* orow = o + row * d;
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      const int c = 8 * nd + 2 * t;
      if (c < d) orow[c] = acc[4 * nd + 2 * hr] / safe_l;
      if (c + 1 < d) orow[c + 1] = acc[4 * nd + 2 * hr + 1] / safe_l;
    }
    if (t == 0) lse[row] = m[hr] == -kInf ? kNegInf : m[hr] + logf(safe_l);
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
  Walk walk;
  int n_blocks;
};

inline dim3 grid_of(const Args& a) {
  return dim3((a.seq + kTile - 1) / kTile, a.heads, a.batch);
}

// The wgmma launches' shape by padded head dim: ring stages of the forward,
// of dQ and of dK/dV, and dK/dV's query rows a step (measured on the card,
// PERF.md); every one runs two blocks an SM.
template <int DP>
struct SliceTiles {
  static constexpr int kFwdStages = DP == 128 ? 2 : 4;
  static constexpr int kDqStages = DP == 128 ? 2 : 3;
  static constexpr int kDkvStages = DP == 128 ? 2 : 3;
  static constexpr int kDkvRows = DP == 128 ? 32 : 64;
};

// What the last wgmma launch was, for `dstt_bsa_launch_info`.
struct LaunchInfo {
  const void* fn;
  long long grid, threads, smem, stages, step_rows, encode_ns;
};
LaunchInfo g_last{};

inline long long ns_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(std::chrono::steady_clock::now()
                                                              - t0)
      .count();
}

// The 3-D map (D, S, B * H) of a BHSD operand: a box is the Geo<DP>
// column block (SW bytes, swizzled for wgmma) of one 16-row slice; columns
// past D read zeros.
template <typename T, int DP>
bool encode_slices(CUtensorMap* map, const void* base, const Args& a) {
  using G = Geo<DP>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.d), static_cast<cuuint64_t>(a.seq),
                              static_cast<cuuint64_t>(a.batch) * a.heads};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(a.d) * 2,
                                 static_cast<cuuint64_t>(a.seq) * a.d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(G::kCols), kSlice, 1u};
  const auto type = std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto swizzle = G::kSw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                       : G::kSw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_tiled(map, type, 3, const_cast<void*>(base), dims, strides, box, swizzle) ==
         CUDA_SUCCESS;
}

// the maps of q, k, v (and dO when `n` is 4)
template <typename T, int DP>
bool encode_all(CUtensorMap (&maps)[4], const Args& a, int n) {
  const void* base[4] = {a.q, a.k, a.v, a.dout};
  for (int i = 0; i < n; ++i)
    if (!encode_slices<T, DP>(&maps[i], base[i], a)) return false;
  return true;
}

template <typename T, int DP>
int fwd(const Args& a, cudaStream_t stream) {
  constexpr int NS = SliceTiles<DP>::kFwdStages;
  const long long blocks = static_cast<long long>(a.n_blocks) * a.batch;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto t0 = std::chrono::steady_clock::now();
  CUtensorMap maps[4];
  if (!encode_all<T, DP>(maps, a, 3)) return static_cast<int>(cudaErrorInvalidValue);
  const long long encode_ns = ns_since(t0);
  constexpr int smem = FwdSmem<DP, NS>::kBytes;
  auto kernel = a.kbias ? bsa_fwd_wgmma_kernel<T, DP, NS, true>
                        : bsa_fwd_wgmma_kernel<T, DP, NS, false>;
  if (int rc = prepare(kernel, dim3(1), smem)) return rc;
  kernel<<<static_cast<unsigned>(blocks), kBwdThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<T*>(a.out0), static_cast<float*>(a.out1),
      a.kbias, a.seq, a.heads, a.d, a.batch, a.walk);
  g_last = LaunchInfo{reinterpret_cast<const void*>(kernel), blocks, kBwdThreads, smem, NS,
                      kRows, encode_ns};
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int bwd_dq(const Args& a, cudaStream_t stream) {
  constexpr int NS = SliceTiles<DP>::kDqStages;
  const long long blocks = static_cast<long long>(a.n_blocks) * a.batch;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto t0 = std::chrono::steady_clock::now();
  CUtensorMap maps[4];
  if (!encode_all<T, DP>(maps, a, 4)) return static_cast<int>(cudaErrorInvalidValue);
  const long long encode_ns = ns_since(t0);
  constexpr int smem = DqSmem<DP, NS>::kBytes;
  auto kernel = a.kbias ? bsa_dq_wgmma_kernel<T, DP, NS, true>
                        : bsa_dq_wgmma_kernel<T, DP, NS, false>;
  if (int rc = prepare(kernel, dim3(1), smem)) return rc;
  kernel<<<static_cast<unsigned>(blocks), kBwdThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.delta), static_cast<T*>(a.out0), a.kbias, a.seq, a.heads, a.d,
      a.batch, a.scale, a.walk);
  g_last = LaunchInfo{reinterpret_cast<const void*>(kernel), blocks, kBwdThreads, smem, NS,
                      kRows, encode_ns};
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int bwd_dkv(const Args& a, cudaStream_t stream) {
  constexpr int NS = SliceTiles<DP>::kDkvStages, BQ = SliceTiles<DP>::kDkvRows;
  const long long blocks = static_cast<long long>(a.n_blocks) * a.batch;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto t0 = std::chrono::steady_clock::now();
  CUtensorMap maps[4];
  if (!encode_all<T, DP>(maps, a, 4)) return static_cast<int>(cudaErrorInvalidValue);
  const long long encode_ns = ns_since(t0);
  constexpr int smem = DkvSmem<DP, NS>::kBytes;
  auto kernel = a.kbias ? bsa_dkv_wgmma_kernel<T, DP, NS, BQ, true>
                        : bsa_dkv_wgmma_kernel<T, DP, NS, BQ, false>;
  if (int rc = prepare(kernel, dim3(1), smem)) return rc;
  kernel<<<static_cast<unsigned>(blocks), kBwdThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), static_cast<T*>(a.out1),
      a.kbias, a.seq, a.heads, a.d, a.batch, a.walk);
  g_last = LaunchInfo{reinterpret_cast<const void*>(kernel), blocks, kBwdThreads, smem, NS,
                      BQ, encode_ns};
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int fwd_split(const Args& a, cudaStream_t stream) {
  constexpr int NS = SplitTiles<DP>::kStages;
  const long long blocks = static_cast<long long>(a.n_blocks) * a.batch;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies when every row starts on 16 bytes (the base does), else 8 or 4
  const int vec = a.d % 4 == 0 ? 16 : a.d % 2 == 0 ? 8 : 4;
  constexpr int smem = SplitSmem<DP, NS>::kBytes;
  auto kernel = a.kbias ? bsa_fwd_split_kernel<DP, NS, true> : bsa_fwd_split_kernel<DP, NS, false>;
  if (int rc = prepare(kernel, dim3(1), smem)) return rc;
  kernel<<<static_cast<unsigned>(blocks), kSplitThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out0), static_cast<float*>(a.out1),
      a.kbias, a.seq, a.heads, a.d, a.batch, vec, a.walk);
  g_last = LaunchInfo{reinterpret_cast<const void*>(kernel), blocks, kSplitThreads, smem, NS,
                      kRows, 0};
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
// tensor-core kernels; fp32 the split-TF32 forward on the same walk and the
// general dQ and dK/dV.
template <typename T>
int dispatch(int which, const Args& a, cudaStream_t s) {
  const int d = a.d;
  if constexpr (std::is_same<T, float>::value) {
    if (which == 0) {
      if (a.walk.blocks == nullptr || a.walk.stages == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      if (d <= 16) return fwd_split<16>(a, s);
      if (d <= 32) return fwd_split<32>(a, s);
      if (d <= 64) return fwd_split<64>(a, s);
      return fwd_split<128>(a, s);
    }
#define DSTT_SIMT(DW)                                        \
  return which == 1 ? bwd_dq_simt<T, DW>(a, s) : bwd_dkv_simt<T, DW>(a, s)
    if (d <= 32) DSTT_SIMT(1);
    if (d <= 64) DSTT_SIMT(2);
    if (d <= 96) DSTT_SIMT(3);
    DSTT_SIMT(4);
#undef DSTT_SIMT
  } else {
    if (d % 8) return static_cast<int>(cudaErrorInvalidValue);
    if (a.walk.blocks == nullptr || a.walk.stages == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
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
// 2 = fp32 (the split-TF32 forward, the general dQ and dK/dV).  d <= 128.  Tensors BHSD [batch,
// heads, seq, d] contiguous, lse / delta fp32 [batch, heads, seq], kbias
// fp32 [batch, seq] (added to every row's scores, key by key) or null.  Lists:
// device int32 arrays (ptr of heads * ceil(seq / 64) + 1 entries, idx, mask)
// of the query-major orientation for the forward and dQ, of the key-major
// orientation for dK/dV (the general kernels).  The bf16 / fp16 kernels
// and the fp32 forward walk `blocks` (n_blocks rows of 12 int32) and
// `stages` (rows of 8 int32) of `bsa_tile_walk`, the query-major walk (the
// forward and dQ) or the key-major one (dK/dV); `ws` holds the fp32
// partials of its split lists (a (part, batch row): one [64 x DP] tile for
// dQ, two for dK/dV, one and 512 floats of row maxima and sums for the
// forward) and `counters` one int32 a (split group, batch row), zeroed by
// the caller (both may be null when no list is split); the general kernels
// ignore all five.
// Return: the CUDA error code (0 ok).
extern "C" int dstt_bsa_fwd(int dtype, const void* q, const void* k, const void* v,
                            void* o, void* lse, const float* kbias, int batch, int heads,
                            int seq, int d, const int* ptr, const int* idx, const int* mask,
                            const int* blocks, const int* stages, int n_blocks, float* ws,
                            int* counters, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, kbias, batch, heads, seq, d, 1.f,
         Lists{ptr, idx, mask}, Walk{blocks, stages, ws, counters}, n_blocks};
  return run(0, dtype, a, stream);
}

// Writes dq and delta (fp32 [batch, heads, seq]) for the dK/dV kernel.
extern "C" int dstt_bsa_bwd_dq(int dtype, const void* q, const void* k,
                               const void* v, const void* o, const void* dout,
                               const void* lse, void* delta, void* dq, const float* kbias,
                               int batch, int heads, int seq, int d, float scale,
                               const int* ptr, const int* idx, const int* mask,
                               const int* blocks, const int* stages, int n_blocks, float* ws,
                               int* counters, void* stream) {
  Args a{q, k, v, o, dout, lse, dq, nullptr, delta, kbias, batch, heads, seq, d, scale,
         Lists{ptr, idx, mask}, Walk{blocks, stages, ws, counters}, n_blocks};
  return run(1, dtype, a, stream);
}

extern "C" int dstt_bsa_bwd_dkv(int dtype, const void* q, const void* k,
                                const void* v, const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, const float* kbias,
                                int batch, int heads, int seq, int d, const int* ptr,
                                const int* idx, const int* mask, const int* blocks,
                                const int* stages, int n_blocks, float* ws, int* counters,
                                void* stream) {
  Args a{q, k, v, nullptr, dout, lse, dk, dv, const_cast<void*>(delta), kbias, batch, heads,
         seq, d, 1.f, Lists{ptr, idx, mask}, Walk{blocks, stages, ws, counters}, n_blocks};
  return run(2, dtype, a, stream);
}

// The last bf16 / fp16 launch of this library, for reports:
// out[0..7] = blocks, threads a block, dynamic shared memory (bytes), ring
// stages, streamed rows a step, registers a thread at launch, local memory
// a thread (bytes: spills), and the host ns spent encoding its tensor maps.
extern "C" int dstt_bsa_launch_info(long long* out) {
  cudaFuncAttributes attr{};
  if (g_last.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncGetAttributes(&attr, g_last.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vals[8] = {g_last.grid,      g_last.threads,   g_last.smem,
                             g_last.stages,    g_last.step_rows, attr.numRegs,
                             static_cast<long long>(attr.localSizeBytes), g_last.encode_ns};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}
