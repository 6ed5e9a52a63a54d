// Evoformer attention forward for Hopper (sm_90a): flash attention with
// broadcast additive biases, fp32 accumulators.  Two kernels:
//
// * evo_wgmma_kernel, the tensor-core kernel: Q/K/V bf16 or fp16, D a
//   multiple of 8 up to 128, up to kMaxBiases biases, each fp32, bf16 or
//   fp16, of any broadcast pattern;
// * evo_fwd_simt_kernel, the general kernel: what the tensor-core kernel
//   does not take (fp32 Q/K/V, D not a multiple of 8, D from 136 to 256),
//   products in fp32 on the CUDA cores.
//
// Between them they take every input of the TPU kernel's domain that fits
// those limits, so ops/evoformer_attn.py never sends a CUDA tensor to the
// dense version.
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
// N).
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
// What bounds it on the H100: at OpenFold's shapes (S 256, D 32, 4-8 heads)
// the bytes, q, k, v, o and the biases read once: triangle attention at
// crop 256 moves ~68 MB (0.020 ms at 3.35 TB/s) for ~8.6 GFLOP (0.009 ms at
// 989 TFLOP/s); its 67 M exponentials take ~0.016 ms at 16 a clock an SM
// (at D = 8, 268 M of them, ~0.064 ms, above its 0.020 ms of bytes).  With
// D = 32 a score costs 2 * 32 flops of wgmma against ~8 instructions of
// scale, bias, max, exp2 and sum, so the consumers' scalar work a score and
// their waits on each step's products, not the tensor cores and not the
// bytes, are what the kernel spends its time on (PERF.md: measured by
// clock64 counters in tools/evo_variants.py's profiling variant).
//
// Design of the tensor-core kernel (evo_wgmma_kernel): persistent blocks,
// as many as fit on the card, each walking items (row block, head, lead
// slice) blockIdx.x, + gridDim.x, ...; a block is one producer warpgroup and
// C consumer warpgroups of 64 query rows each: 128 rows of one (lead slice,
// head), so at S <= 128 a head's K and V are read once and at S = 256
// twice, by two neighbouring blocks at once, the second from L2.
//
// * The producer's first thread loads each item's Q into one of two item
//   buffers (the next item's Q lands while this one is computed) and keeps
//   a ring of up to kMaxStages steps of BK keys in flight across items by
//   TMA (full / empty mbarriers): the K and V tiles, each in the swizzle of
//   its row width (D padded to DP = 16, 32, 64 or 128; the padding columns
//   are TMA's zero fill), and each bias that varies over both rows and keys
//   (a "tile": the pair bias) whose rows TMA can address (last stride 1, a
//   row pitch of 16 bytes' multiple), 128-byte swizzled in its own type.
// * The producer's 128 threads (the lanes), when a bias needs them, stage
//   the rest without waiting on a load: an item's row-bias sums (biases
//   that vary over rows only, or over nothing) beside its Q; each step's
//   key rows (the mask) and tiles of 4-byte aligned rows (S = 250: a
//   500-byte pitch) by 4-byte cp.async in their own types, each lane
//   keeping one column and walking the rows; what even that cannot copy
//   (a transposed or 2-byte aligned view) read and summed in fp32.  A tile
//   whose plane every lead slice shares and that cp.async copies is copied
//   once for all of a block's items that share its rows (the grid is then a
//   multiple of the (row block, head) pairs, so every item of a block has
//   the same rows): "resident".  A 1-D TMA box at an unaligned row raises an
//   illegal instruction, so none is used.
// * The bias descriptors live in shared memory, so 8 biases hold no
//   registers; the consumers loop over them once a step, not a score.
// * Each consumer warpgroup computes S = Q K^T by wgmma m64nBKk16 from
//   shared memory, then the scores in log2 units: one FMA for the scale and
//   the row biases, one FMA a bias value staged in its own type, one add
//   for the lanes' fp32 sums; the mask of keys past Sk only on the ragged
//   last step; exp2 with the running max guarded at -inf (a row with
//   nothing seen yet subtracts 0), P rounded to the input type as the A
//   operand of O += P V (wgmma from registers, V MN-major, N = DP); step
//   i's softmax runs while step i - 1's P V product does.  Every sum runs in
//   a fixed order (no atomics): two runs give the same bits.
// * The output is staged in the warpgroup's own rows of the item's Q tile
//   and written 16 bytes a thread; the item buffer then goes back to the
//   producer.
// * Launch shapes (EvoTiles) were chosen by timing on the card
//   (tools/evo_variants.py, PERF.md): two blocks of two consumer
//   warpgroups an SM at D <= 32, one at D = 64 and 128; 64 keys a step, 128
//   at D = 64; a ring of up to 4 stages.  At D <= 32 one block an SM, one
//   consumer warpgroup a block, 128-key steps, 2- and 8-stage rings, TMA
//   tiles resident, and the two warpgroups taking turns issuing their
//   products all measured slower.
//
// Design of the general kernel: one block of 8 warps per (lead slice, head,
// 32 query rows), 4 rows a warp, a loop over 32-key tiles staged in shared
// memory as fp32 (one key a lane: the lane's scores are dot products over D
// from shared memory, its K row at an odd stride so the 32 lanes hit 32
// banks, each K value read once for the warp's 4 rows), the warp's max and
// sum by shuffles, and P V with each lane holding the output columns lane,
// lane + 32, ..., each V value read once for the 4 rows.  It is the simple
// kernel, kept for what the tensor-core one does not take.  In fp32 the
// same work is bound by the operations at 67 TFLOP/s outside the tensor
// cores (~0.13 ms at the triangle shape), and its shared-memory reads (two
// a multiply-add) keep it well below that.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;     // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBiases = 8;
constexpr int kSimtWarps = 8;
constexpr int kSimtThreads = 32 * kSimtWarps;
constexpr int kSimtRowsPerWarp = 4;
constexpr int kSimtRows = kSimtWarps * kSimtRowsPerWarp;   // 32 query rows a block
constexpr int kSimtKeys = 32;                              // one key a lane
constexpr int kSimtMaxD = 256;

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

// ----------------------------------------------------------------------------
// The tensor-core kernel
// ----------------------------------------------------------------------------
constexpr int kRows = 64;             // query rows of one consumer warpgroup
constexpr int kMaxStages = 4;
constexpr int kMaxStaged = 4;         // bias tiles staged in their own type
constexpr int kProducerRegs = 40;

// What a bias varies over within one (lead slice, head), as
// ops/evoformer_attn.py `bias_plan` classifies it, and how it is staged: a
// scalar or a value a row (sc = 0), summed once an item by the producer's
// lanes; a value a key (sr = 0), copied a step by the lanes' 4-byte
// cp.async in its own type when its keys are 4-byte aligned (kKeyAsync),
// else read and summed in fp32 (kKeySum); a tile, which TMA stages when its
// rows are 16-byte aligned (kTileTma), the lanes copy by cp.async when they
// are 4-byte aligned (kTileAsync), and the lanes read and sum in fp32
// otherwise (kTileSum).
enum BiasKind {
  kScalar = 0,
  kRowBias = 1,
  kKeySum = 2,
  kTileTma = 3,
  kTileAsync = 4,
  kTileSum = 5,
  kKeyAsync = 6
};

struct TileBias {
  Bias b;
  int kind;
  int slot;          // kTileTma: its tensor map; -1 otherwise
  int off;           // kTileTma / kTileAsync / kKeyAsync: byte offset in a stage
                     // (resident: of its first step's tile in the resident region)
  int resident;      // kTileAsync, the same plane for every lead slice: copied
                     // once for all of a block's items (they share its rows)
};

struct EvoArgs {
  CUtensorMap bias_map[kMaxStaged];  // 2-D (keys, rows) maps of the TMA tiles
  TileBias tb[kMaxBiases];
  int n;                          // biases
  long long items;                // (row block, head, lead slice) triples
  int sq, sk, heads, d;
  float scale_log2;               // D^-1/2 * log2(e)
  int stages, stage_bytes;        // the ring
  int tma_bytes;                  // bias bytes TMA brings a step
  int sum_off, key_off;           // the lanes' fp32 tile and key row (-1: none)
  int rows;                       // whether an item stages the row biases' sum
  int lanes;                      // whether the producer's lanes stage anything
  int res_bytes;                  // the resident tiles, all steps (0: none)
  int ring_off;                   // the ring's offset past the item buffers
};

// The launch shape by padded head dim: consumer warpgroups (C), blocks an
// SM and keys a step; a call whose staged bias tiles need more shared
// memory than that leaves takes one block an SM (measured on the card,
// PERF.md).
template <int DP>
struct EvoTiles;
template <>
struct EvoTiles<16> {
  static constexpr int kC = 2, kPerSm = 2, kKeys = 64;
};
template <>
struct EvoTiles<32> {
  static constexpr int kC = 2, kPerSm = 2, kKeys = 64;
};
template <>
struct EvoTiles<64> {
  static constexpr int kC = 2, kPerSm = 1, kKeys = 128;
};
template <>
struct EvoTiles<128> {
  static constexpr int kC = 2, kPerSm = 1, kKeys = 64;
};

__host__ __device__ constexpr int floor8(int x) { return x / 8 * 8; }
__host__ __device__ constexpr int min_c(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int C, int PER_SM>
struct EvoBlock {
  static constexpr int kThreads = 128 * (1 + C);
  static constexpr int kBlockRows = C * kRows;
  // registers a thread at launch, and the consumers' after the producer
  // gives its own up (setmaxnreg)
  static constexpr int kLaunchRegs = min_c(248, floor8(65536 / (kThreads * PER_SM)));
  static constexpr int kConsumerRegs =
      min_c(240, floor8(kLaunchRegs + (kLaunchRegs - kProducerRegs) / C));
  // dynamic shared memory a block may take: one block an SM, or a share of
  // the SM's 228 KB (1 KB of it reserved a block)
  static constexpr int kSmemBudget = PER_SM == 1 ? 232448 - 1024 : (233472 / PER_SM) - 2048;
};

// Byte offset of 16-bit element (row, col) of a [rows x DP] tile stored as
// SW-byte rows (SW = 32, 64 or 128; DP / (SW / 2) column blocks of rows x SW
// bytes), swizzled as TMA's CU_TENSOR_MAP_SWIZZLE_<SW>B writes it.
template <int SW>
__device__ __forceinline__ uint32_t swz(int row, int col, int rows) {
  constexpr int kCols = SW / 2;
  const uint32_t o =
      static_cast<uint32_t>((col / kCols) * rows * SW + row * SW + (col % kCols) * 2);
  return o ^ (((o >> 7) & (SW / 16 - 1)) << 4);
}

// Byte offset of element (row, col) of a [rows x keys] bias tile of
// `elt`-byte values, 128-byte swizzled: 16-bit values in blocks of 64
// columns, fp32 in blocks of 32 (the layout TMA writes from 128-byte boxes).
__device__ __forceinline__ uint32_t swz_bias(int row, int col, int rows, int elt) {
  const int per = 128 / elt;                    // columns of one block
  const uint32_t o =
      static_cast<uint32_t>((col / per) * rows * 128 + row * 128 + (col % per) * elt);
  return o ^ ((row & 7) << 4);
}

// s[j] += mul * tile(row, col) over this thread's scores of one step: s[j]
// is row lr + 8 ((j >> 1) & 1), column 8 (j >> 2) + 2t + (j & 1) (the wgmma
// accumulator layout); a tile is [rows x BK] of U, as `swz_bias` lays it.
template <typename U, int BK>
__device__ __forceinline__ void add_tile(float (&s)[BK / 2], const unsigned char* tile, int lr,
                                         int t, int rows, float mul) {
#pragma unroll
  for (int j = 0; j < BK / 2; j += 2) {
    const int row = lr + 8 * ((j >> 1) & 1), col = 8 * (j >> 2) + 2 * t;
    const unsigned char* at = tile + swz_bias(row, col, rows, sizeof(U));
    float2 v;
    if constexpr (std::is_same<U, float>::value) {
      v = *reinterpret_cast<const float2*>(at);
    } else if constexpr (std::is_same<U, __half>::value) {
      v = __half22float2(*reinterpret_cast<const __half2*>(at));
    } else {
      v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
    }
    s[j] = fmaf(v.x, mul, s[j]);
    s[j + 1] = fmaf(v.y, mul, s[j + 1]);
  }
}

// s[j] += mul * keys(col) over this thread's scores of one step: a row of
// BK values of U (the same for every row).
template <typename U, int BK>
__device__ __forceinline__ void add_keys(float (&s)[BK / 2], const unsigned char* keys, int t,
                                         float mul) {
#pragma unroll
  for (int j = 0; j < BK / 2; j += 2) {
    const unsigned char* at = keys + (8 * (j >> 2) + 2 * t) * sizeof(U);
    float2 v;
    if constexpr (std::is_same<U, float>::value) {
      v = *reinterpret_cast<const float2*>(at);
    } else if constexpr (std::is_same<U, __half>::value) {
      v = __half22float2(*reinterpret_cast<const __half2*>(at));
    } else {
      v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
    }
    s[j] = fmaf(v.x, mul, s[j]);
    s[j + 1] = fmaf(v.y, mul, s[j + 1]);
  }
}

// 4 bytes global -> shared, of which the first `src_bytes` (0-4) are read
// and the rest are zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// one arrival on `bar` once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// `rows` rows (1: a key row, stored as it is; else a tile as `swz_bias`
// lays it) of BK values of bias `tb` from row q0 and key c0 of the plane at
// element offset `off`, by the producer's 128 lanes, 4 bytes a copy: each
// lane keeps one column and walks the rows with its source address; zeros
// past Sq and Sk.
template <int BK>
__device__ __forceinline__ void copy_async(unsigned char* dst, const TileBias& tb, long long off,
                                           int q0, int c0, int rows, int sq, int sk, int pt) {
  const int elt = tb.b.dtype == 2 ? 4 : 2, per = 4 / elt, pairs = BK / per;
  const int step = 128 / pairs, cc = (pt % pairs) * per, c = c0 + cc;
  const int cbytes = max(0, min(4, (sk - c) * elt));
  const unsigned char* base = static_cast<const unsigned char*>(tb.b.p);
  int rr = pt / pairs;
  const unsigned char* src = base + (off + (q0 + rr) * tb.b.sr + c) * elt;
  const long long hop = step * tb.b.sr * elt;
#pragma unroll 4
  for (; rr < rows; rr += step, src += hop) {
    const int bytes = q0 + rr < sq ? cbytes : 0;
    cp_async4(dst + (rows == 1 ? cc * elt : swz_bias(rr, cc, rows, elt)), bytes ? src : base,
              bytes);
  }
}

// The element offset of bias b's plane (lead slice l, head h).
__device__ __forceinline__ long long plane(const TileBias& tb, long long l, int h) {
  return tb.b.lead_off[l] + h * tb.b.sh;
}

template <typename T, int DP, int C, int PER_SM, int BK>
__global__ void __launch_bounds__(EvoBlock<C, PER_SM>::kThreads, PER_SM)
evo_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const __grid_constant__ EvoArgs a,
                 T* __restrict__ o) {
  using Blk = EvoBlock<C, PER_SM>;
  constexpr int kBlock = Blk::kBlockRows;
  constexpr int kKeys = BK;                       // keys a step
  constexpr int SW = DP >= 64 ? 128 : DP * 2;     // Q / K / V row width in shared memory
  constexpr int kCols = SW / 2;                   // elements of one swizzled row
  constexpr int kQBytes = kBlock * DP * 2;
  constexpr int kItem = kQBytes + 1024;           // an item's Q tile and row-bias sums
  constexpr int kKvTile = kKeys * DP * 2;
  constexpr uint32_t kLayout = swizzle_layout(SW);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* q_buf = sm;                      // two item buffers: items alternate
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + 2 * kItem);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kMaxStages;
  uint64_t* res_full = empty + kMaxStages;        // the resident tiles have landed
  unsigned char* res = sm + 2 * kItem + 1024;     // the resident tiles
  unsigned char* ring = sm + a.ring_off;
  __shared__ TileBias sb[kMaxBiases];

  const int nrb = cdiv(a.sq, kBlock);
  const int n = cdiv(a.sk, kKeys);                // steps an item
  const int ns = a.stages;
  // item -> (row block, head, lead slice): the row blocks of one head are
  // neighbours, taken by neighbouring blocks at once, so they share K and V
  // in L2
  auto decode = [&](long long item, int& q0, int& h, long long& l) {
    q0 = static_cast<int>(item % nrb) * kBlock;
    h = static_cast<int>((item / nrb) % a.heads);
    l = item / (static_cast<long long>(nrb) * a.heads);
  };

  if (threadIdx.x < a.n) sb[threadIdx.x] = a.tb[threadIdx.x];
  if (threadIdx.x == 32) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1 + (a.lanes ? 128 : 0));
      mbar_init(&q_empty[b], 4 * C);              // one arrival a consumer warp
    }
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], 1 + (a.lanes ? 256 : 0));
      mbar_init(&empty[s], 4 * C);
    }
    mbar_init(res_full, 128);                     // one cp.async arrival a lane
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // The producer.  Its first thread loads each item's Q (into the buffer
    // the item before last has released) and K, V and the TMA tiles through
    // the ring, running ahead across items; with biases TMA does not stage,
    // all 128 threads (the lanes) stage those too: an item's row-bias sums
    // beside its Q, each step's key rows and tiles by cp.async (no load the
    // lanes wait for), or read and summed in fp32 where cp.async cannot.
    setmaxnreg_dec<kProducerRegs>();
    const int pt = threadIdx.x;
    if (pt != 0 && !a.lanes) return;
    int g = 0;                                    // ring steps so far
    int k = 0;                                    // items so far
    for (long long item = blockIdx.x; item < a.items; item += gridDim.x, ++k) {
      int q0, h;
      long long l;
      decode(item, q0, h, l);
      long long off[kMaxBiases];                  // this item's planes, loaded once
#pragma unroll 1
      for (int b = 0; b < a.n; ++b) off[b] = plane(sb[b], l, h);
      const int qb = k & 1;
      unsigned char* item_buf = q_buf + qb * kItem;
      if (k >= 2) mbar_wait(&q_empty[qb], ((k >> 1) & 1) ^ 1);
      // the resident tiles (cp.async tiles whose plane every lead slice
      // shares), copied by the lanes with the block's first item: the grid
      // is a multiple of the (row block, head) pairs, so every item of the
      // block has the same rows and head
      if (a.res_bytes && k == 0) {
#pragma unroll 1
        for (int b = 0; b < a.n; ++b) {
          if (!sb[b].resident) continue;
          const int tile = kBlock * kKeys * (sb[b].b.dtype == 2 ? 4 : 2);
          for (int i = 0; i < n; ++i)
            copy_async<BK>(res + sb[b].off + i * tile, sb[b], off[b], q0, i * kKeys, kBlock, a.sq,
                           a.sk, pt);
        }
        cp_async_arrive(res_full);
      }
      if (pt == 0) {
        mbar_arrive_expect_tx(&q_full[qb], kQBytes);
        for (int c = 0; c < DP / kCols; ++c)
          tma_load_4d(item_buf + c * kBlock * SW, &q_map, &q_full[qb], kCols * c, h, q0,
                      static_cast<int>(l));
      }
      if (a.lanes) {
        if (a.rows) {
          // the biases that vary over rows only, one fp32 a row, log2 units
          float* rowb = reinterpret_cast<float*>(item_buf + kQBytes);
          for (int rr = pt; rr < kBlock; rr += 128) {
            const int r = q0 + rr;
            float x = 0.f;
#pragma unroll 1
            for (int b = 0; b < a.n && r < a.sq; ++b)
              if (sb[b].kind == kScalar || sb[b].kind == kRowBias)
                x += bias_at(sb[b].b, off[b] + r * sb[b].b.sr);
            rowb[rr] = x * kLog2e;
          }
        }
        mbar_arrive(&q_full[qb]);
      }
      for (int i = 0; i < n; ++i, ++g) {
        const int st = g % ns;
        unsigned char* stage = ring + st * a.stage_bytes;
        if (g >= ns) mbar_wait(&empty[st], ((g / ns) & 1) ^ 1);
        const int c0 = i * kKeys;
        if (pt == 0) {
          const bool stage_bias = true;           // this step's bias tiles
          mbar_arrive_expect_tx(&full[st], 2 * kKvTile + (stage_bias ? a.tma_bytes : 0));
          for (int c = 0; c < DP / kCols; ++c) {
            tma_load_4d(stage + c * kKeys * SW, &k_map, &full[st], kCols * c, h, c0,
                        static_cast<int>(l));
            tma_load_4d(stage + kKvTile + c * kKeys * SW, &v_map, &full[st], kCols * c, h, c0,
                        static_cast<int>(l));
          }
          for (int b = 0; stage_bias && b < a.n; ++b) {
            if (sb[b].kind != kTileTma) continue;
            const CUtensorMap* map = &a.bias_map[sb[b].slot];
            const int row = static_cast<int>(off[b] / sb[b].b.sr) + q0;
            const int elt = sb[b].b.dtype == 2 ? 4 : 2;
            for (int x = 0; x < kKeys * elt / 128; ++x)
              tma_load_2d(stage + sb[b].off + x * kBlock * 128, map, &full[st],
                          c0 + x * (128 / elt), row);
          }
        }
        if (a.lanes) {
#pragma unroll 1
          for (int b = 0; b < a.n; ++b) {
            const int kind = sb[b].kind;
            if ((kind == kTileAsync && !sb[b].resident) || kind == kKeyAsync)
              copy_async<BK>(stage + sb[b].off, sb[b], off[b], q0, c0,
                             kind == kKeyAsync ? 1 : kBlock, a.sq, a.sk, pt);
          }
          // the key rows and tiles cp.async cannot copy, each summed in
          // fp32, in log2 units; zeros past Sq and Sk
          if (a.key_off >= 0 && pt < kKeys) {
            float x = 0.f;
            if (c0 + pt < a.sk) {
#pragma unroll 1
              for (int b = 0; b < a.n; ++b)
                if (sb[b].kind == kKeySum)
                  x += bias_at(sb[b].b, off[b] + static_cast<long long>(c0 + pt) * sb[b].b.sc);
            }
            reinterpret_cast<float*>(stage + a.key_off)[pt] = x * kLog2e;
          }
          if (a.sum_off >= 0) {
            unsigned char* sum = stage + a.sum_off;
            constexpr int kBatch = 8;             // loads in flight a thread
#pragma unroll 1
            for (int e0 = pt; e0 < kBlock * kKeys; e0 += 128 * kBatch) {
              float x[kBatch];
#pragma unroll
              for (int u = 0; u < kBatch; ++u) x[u] = 0.f;
#pragma unroll 1
              for (int b = 0; b < a.n; ++b) {
                if (sb[b].kind != kTileSum) continue;
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                  const int e = e0 + 128 * u, r = q0 + e / kKeys, c = c0 + e % kKeys;
                  if (r < a.sq && c < a.sk)
                    x[u] += bias_at(sb[b].b, off[b] + r * sb[b].b.sr + c * sb[b].b.sc);
                }
              }
#pragma unroll
              for (int u = 0; u < kBatch; ++u) {
                const int e = e0 + 128 * u;
                *reinterpret_cast<float*>(sum + swz_bias(e / kKeys, e % kKeys, kBlock, 4)) =
                    x[u] * kLog2e;
              }
            }
          }
          mbar_arrive(&full[st]);
          cp_async_arrive(&full[st]);
        }
      }
    }
  } else {
    setmaxnreg_inc<Blk::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;         // consumer warpgroup
    const int ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32, g8 = lane / 4, t = lane % 4;
    const int lr = cw * kRows + 16 * warp + g8;   // this thread's rows lr, lr + 8 of the block
    const float kInf = __int_as_float(0x7f800000);

    float m[2], lsum[2], rowb[2];
    float acc[DP / 2], s[kKeys / 2];
    uint32_t p[kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kKeys / 2; ++j) s[j] = 0.f;
    int g = 0;                                    // ring steps so far

    auto stage_of = [&](int step) { return ring + (step % ns) * a.stage_bytes; };
    auto qk = [&](int step, const unsigned char* q_s) {   // S = Q K^T
      const unsigned char* k_t = stage_of(step);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int cb = kk * 16 / kCols, in = (kk * 32) % SW;
        wgmma_ss_t<T, kKeys>(
            s, wgmma_desc(q_s + cb * kBlock * SW + cw * kRows * SW + in, 16, 8 * SW, kLayout),
            wgmma_desc(k_t + cb * kKeys * SW + in, 16, 8 * SW, kLayout), kk);
      }
    };
    auto pv = [&](int step) {                     // O += round(P) V
      const unsigned char* v_t = stage_of(step) + kKvTile;
#pragma unroll
      for (int ks = 0; ks < kKeys / 16; ++ks)
        wgmma_rs_t<T, DP>(acc, p[ks], wgmma_desc(v_t + ks * 16 * SW, kKeys * SW, 8 * SW, kLayout));
    };
    // step i of an item (ring step `step`): scores -> probabilities in s
    // (fp32), the new max, corr
    auto softmax = [&](int i, int step, float (&corr)[2]) {
      const int c0 = i * kKeys;
      const unsigned char* stage = stage_of(step);
#pragma unroll
      for (int j = 0; j < kKeys / 2; ++j) s[j] = fmaf(s[j], a.scale_log2, rowb[(j >> 1) & 1]);
#pragma unroll 1
      for (int b = 0; b < a.n; ++b) {
        const int kind = sb[b].kind, dt = sb[b].b.dtype;
        const unsigned char* at =
            sb[b].resident ? res + sb[b].off + i * kBlock * kKeys * (dt == 2 ? 4 : 2)
                           : stage + sb[b].off;
        if (kind == kTileTma || kind == kTileAsync) {
          if (dt == 2) add_tile<float, BK>(s, at, lr, t, kBlock, kLog2e);
          else if (dt == 1) add_tile<__half, BK>(s, at, lr, t, kBlock, kLog2e);
          else add_tile<__nv_bfloat16, BK>(s, at, lr, t, kBlock, kLog2e);
        } else if (kind == kKeyAsync) {
          if (dt == 2) add_keys<float, BK>(s, at, t, kLog2e);
          else if (dt == 1) add_keys<__half, BK>(s, at, t, kLog2e);
          else add_keys<__nv_bfloat16, BK>(s, at, t, kLog2e);
        }
      }
      if (a.sum_off >= 0) add_tile<float, BK>(s, stage + a.sum_off, lr, t, kBlock, 1.f);
      if (a.key_off >= 0) add_keys<float, BK>(s, stage + a.key_off, t, 1.f);
      const int valid = a.sk - c0;                // keys of this step inside Sk
      if (valid < kKeys) {
#pragma unroll
        for (int j = 0; j < kKeys / 2; ++j)
          s[j] = 8 * (j >> 2) + 2 * t + (j & 1) < valid ? s[j] : -kInf;
      }
      float mx[2] = {-kInf, -kInf};
#pragma unroll
      for (int j = 0; j < kKeys / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
      float base[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 2));
        const float m_new = fmaxf(m[hr], mx[hr]);
        // a row that has seen only -inf subtracts 0: its p and corr are 0
        base[hr] = m_new == -kInf ? 0.f : m_new;
        corr[hr] = exp2_ftz(m[hr] - base[hr]);
        m[hr] = m_new;
        lsum[hr] *= corr[hr];
      }
#pragma unroll
      for (int j = 0; j < kKeys / 2; ++j) {
        const int hr = (j >> 1) & 1;
        s[j] = exp2_ftz(s[j] - base[hr]);
        lsum[hr] += s[j];
      }
    };
    auto to_p = [&]() {                           // P rounded to T, the A operand
#pragma unroll
      for (int ks = 0; ks < kKeys / 16; ++ks)
#pragma unroll
        for (int f = 0; f < 4; ++f) p[ks][f] = pack2<T>(s[8 * ks + 2 * f], s[8 * ks + 2 * f + 1]);
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // Every register a product reads or accumulates into is fenced right
    // before wgmma.fence, so that the compiler keeps its definitions above it
    // (else it fences again itself and serialises the products).
    auto operands_ready = [&]() {
      fence_all(s);
      fence_all(acc);
      fence_all(p);
      wgmma_fence();
    };

    int k = 0;                                    // items so far
    for (long long item = blockIdx.x; item < a.items; item += gridDim.x, ++k) {
      int q0, h;
      long long l;
      decode(item, q0, h, l);
      const int qb = k & 1;
      unsigned char* q_s = q_buf + qb * kItem;
      const int r_wg = q0 + cw * kRows;           // this warpgroup's first row
      m[0] = m[1] = -kInf;                        // running max, log2 units
      lsum[0] = lsum[1] = 0.f;                    // this thread's part of the row sums
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;

      mbar_wait(&q_full[qb], (k >> 1) & 1);
      if (a.res_bytes && k == 0) mbar_wait(res_full, 0);
      // the row biases' sums the producer staged beside Q, log2 units
      const float* row_sums = reinterpret_cast<const float*>(q_s + kQBytes);
      rowb[0] = a.rows ? row_sums[lr] : 0.f;
      rowb[1] = a.rows ? row_sums[lr + 8] : 0.f;
      if (n > 0) {
        float corr[2];
        mbar_wait(&full[g % ns], (g / ns) & 1);
        operands_ready();
        qk(g, q_s);
        wgmma_commit();
        wgmma_wait<0>();
        fence_all(s);
        softmax(0, g, corr);
        to_p();
        // step i issues its S beside step i - 1's P V, then runs its
        // softmax while the P V product runs
        for (int i = 1; i < n; ++i) {
          const int step = g + i;
          mbar_wait(&full[step % ns], (step / ns) & 1);
            operands_ready();
          qk(step, q_s);
          wgmma_commit();
          pv(step - 1);
          wgmma_commit();
          wgmma_wait<1>();
          fence_all(s);
          softmax(i, step, corr);
          wgmma_wait<0>();
          fence_all(acc);
          fence_all(p);
          release(&empty[(step - 1) % ns]);
#pragma unroll
          for (int j = 0; j < DP / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
          to_p();
        }
        operands_ready();
        pv(g + n - 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_all(acc);
        fence_all(p);
        release(&empty[(g + n - 1) % ns]);
        g += n;
      }

      // normalise, stage the rows (rounded) in this warpgroup's rows of the
      // item's Q tile, which no product reads any more, write them 16 bytes
      // a thread, and hand the Q tile back to the producer
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        lsum[hr] += __shfl_xor_sync(kFull, lsum[hr], 1);
        lsum[hr] += __shfl_xor_sync(kFull, lsum[hr], 2);
        const float inv = 1.f / (lsum[hr] == 0.f ? 1.f : lsum[hr]);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
          *reinterpret_cast<uint32_t*>(q_s + swz<SW>(lr + 8 * hr, 8 * j + 2 * t, kBlock)) =
              pack2<T>(acc[4 * j + 2 * hr] * inv, acc[4 * j + 2 * hr + 1] * inv);
      }
      named_barrier(1 + cw, 128);
      const int chunks = a.d / 8;                 // 16-byte chunks of an output row
      const long long row = static_cast<long long>(a.heads) * a.d;
      T* ob = o + l * a.sq * row + static_cast<long long>(h) * a.d;
      for (int c = ct; c < kRows * chunks; c += 128) {
        const int rr = c / chunks, col = (c % chunks) * 8;
        if (r_wg + rr < a.sq)
          *reinterpret_cast<int4*>(ob + (r_wg + rr) * row + col) =
              *reinterpret_cast<const int4*>(q_s + swz<SW>(cw * kRows + rr, col, kBlock));
      }
      release(&q_empty[qb]);
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


// ----------------------------------------------------------------------------
// Launchers
// ----------------------------------------------------------------------------

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

// What the last tensor-core launch was, for `dstt_evoformer_launch_info`.
struct LaunchInfo {
  const void* fn;
  long long grid, threads, smem, block_rows, stages, staged_tiles, summed_tiles, key_rows,
      resident, per_sm;
};
LaunchInfo g_last{};

// One bias as the wrapper passes it: the view, and its kind (BiasKind) and
// the largest element offset of one of its (lead slice, head) planes.
struct BiasIn {
  Bias b;
  int kind;
  int shared;        // one plane for every lead slice (lead_off all 0)
  long long max_plane;
};

// The 4-D map (D, heads, S, lead) of a contiguous [lead, S, heads, D]
// operand: a box is `cols` columns (SW bytes, swizzled for wgmma) of `rows`
// rows of one head; columns past D and rows past S read zeros.
template <typename T>
bool encode_rows(CUtensorMap* map, const void* base, int d, int heads, int s, int lead, int cols,
                 int rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t s1 = static_cast<cuuint64_t>(s > 0 ? s : 1);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads), s1,
                              static_cast<cuuint64_t>(lead)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * d * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2, row, s1 * row};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1u, static_cast<cuuint32_t>(rows), 1u};
  const auto type = std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode_tiled(map, type, 4, const_cast<void*>(base), dims, strides, box, swizzle) ==
         CUDA_SUCCESS;
}

// The 2-D map (keys, rows) of a bias tile whose rows are 16-byte aligned:
// every (lead slice, head) plane starts on a row (the wrapper checked), so
// row r of plane (l, h) is row (lead_off[l] + h sh) / sr + r; a box is 128
// bytes of keys (64 16-bit or 32 fp32 values) of `rows` rows.
bool encode_bias(CUtensorMap* map, const BiasIn& in, int sq, int sk, int rows) {
  const int elt = in.b.dtype == 2 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(sk),
                              static_cast<cuuint64_t>(in.max_plane / in.b.sr + sq)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(in.b.sr) * elt};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elt), static_cast<cuuint32_t>(rows)};
  const auto type = in.b.dtype == 2   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : in.b.dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode_tiled(map, type, 2, const_cast<void*>(in.b.p), dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B) == CUDA_SUCCESS;
}

// The shared memory of one launch shape: two item buffers (Q and the row
// sums), the barriers, the resident tiles (every step's, of the cp.async
// tiles whose plane every lead slice shares, when `resident`), then the ring: a
// stage holds K and V, the streamed tiles (TMA and cp.async) in their own
// types, the lanes' fp32 tile, and the key rows (the lanes' fp32 sum, then
// each cp.async row, 4 BK bytes each).  Streamed tiles past kMaxStaged, or
// past what lets two stages fit, are summed by the lanes instead (the last
// first).  Fills `a` and returns the dynamic shared bytes, or -1 when even
// one stage does not fit; `demoted` says whether a tile had to be summed.
template <int DP, int C, int PER_SM, int BK>
int plan_stages(EvoArgs& a, const BiasIn* in, int nb, int n_steps, bool resident,
                bool& demoted) {
  using Blk = EvoBlock<C, PER_SM>;
  constexpr int kBlock = Blk::kBlockRows;
  constexpr int kKeys = BK;
  int kinds[kMaxBiases];
  bool res[kMaxBiases];
  int res_bytes = 0;
  auto tile_bytes = [&](int i) { return kBlock * kKeys * (in[i].b.dtype == 2 ? 4 : 2); };
  for (int i = 0; i < nb; ++i) {
    kinds[i] = in[i].kind;
    res[i] = resident && kinds[i] == kTileAsync && in[i].shared;
    res_bytes += res[i] ? n_steps * tile_bytes(i) : 0;
  }
  const int fixed = 2 * (kBlock * DP * 2 + 1024) + 2048 + (res_bytes + 1023) / 1024 * 1024;
  const int kv = 2 * kKeys * DP * 2;
  const int sum_tile = kBlock * kKeys * 4;
  auto streamed = [&](int i) {
    return (kinds[i] == kTileTma || kinds[i] == kTileAsync) && !res[i];
  };
  auto key_bytes = [&]() {
    int bytes = 0;
    bool sum = false;
    for (int i = 0; i < nb; ++i) {
      bytes += kinds[i] == kKeyAsync ? kKeys * 4 : 0;
      sum |= kinds[i] == kKeySum;
    }
    return (bytes + (sum ? kKeys * 4 : 0) + 1023) / 1024 * 1024;
  };
  auto stage_bytes = [&]() {
    int bytes = kv, n_staged = 0;
    bool sum = false;
    for (int i = 0; i < nb; ++i) {
      if (streamed(i)) bytes += tile_bytes(i);
      n_staged += kinds[i] == kTileTma || kinds[i] == kTileAsync;
      sum |= kinds[i] == kTileSum;
    }
    return bytes + (sum ? sum_tile : 0) + key_bytes() +
           (n_staged > kMaxStaged ? (1 << 30) : 0);
  };
  demoted = false;
  for (int i = nb - 1; i >= 0 && fixed + 2 * stage_bytes() > Blk::kSmemBudget; --i) {
    if (streamed(i)) {
      kinds[i] = kTileSum;
      demoted = true;
    }
  }
  const int stage = stage_bytes();
  if (fixed + stage > Blk::kSmemBudget) return -1;
  a.stages = min_c(kMaxStages, (Blk::kSmemBudget - fixed) / stage);
  a.stage_bytes = stage;
  a.ring_off = fixed - 1024;                      // the last KB: alignment
  a.res_bytes = res_bytes;
  a.tma_bytes = 0;
  int off = kv, slot = 0, res_off = 0;
  bool sum = false, key_sum = false, lanes = false, rows = false;
  for (int i = 0; i < nb; ++i) {
    a.tb[i] = TileBias{in[i].b, kinds[i], -1, 0, res[i] ? 1 : 0};
    if (kinds[i] == kTileTma) a.tb[i].slot = slot++;
    if (res[i]) {
      a.tb[i].off = res_off;
      res_off += n_steps * tile_bytes(i);
    } else if (streamed(i)) {
      a.tb[i].off = off;
      off += tile_bytes(i);
      if (kinds[i] == kTileTma) a.tma_bytes += tile_bytes(i);
    }
    sum |= kinds[i] == kTileSum;
    key_sum |= kinds[i] == kKeySum;
    rows |= kinds[i] == kScalar || kinds[i] == kRowBias;
    lanes |= kinds[i] != kTileTma;
  }
  a.sum_off = sum ? off : -1;
  off += sum ? sum_tile : 0;
  a.key_off = key_sum ? off : -1;
  off += key_sum ? kKeys * 4 : 0;
  for (int i = 0; i < nb; ++i) {
    if (kinds[i] == kKeyAsync) {
      a.tb[i].off = off;
      off += kKeys * 4;
    }
  }
  a.rows = rows ? 1 : 0;
  a.lanes = lanes ? 1 : 0;
  return fixed + a.stages * stage;
}

inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

template <typename T, int DP, int C, int PER_SM, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int lead, int sq,
                 int sk, int heads, int d, EvoArgs& a, int smem, const BiasIn* in,
                 cudaStream_t stream) {
  using Blk = EvoBlock<C, PER_SM>;
  constexpr int kBlock = Blk::kBlockRows;
  constexpr int SW = DP >= 64 ? 128 : DP * 2;
  constexpr CUtensorMapSwizzle kSwizzle = SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                          : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_rows<T>(&q_map, q, d, heads, sq, lead, SW / 2, kBlock, kSwizzle) ||
      !encode_rows<T>(&k_map, k, d, heads, sk, lead, SW / 2, BK, kSwizzle) ||
      !encode_rows<T>(&v_map, v, d, heads, sk, lead, SW / 2, BK, kSwizzle))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < a.n; ++i)
    if (a.tb[i].kind == kTileTma && !encode_bias(&a.bias_map[a.tb[i].slot], in[i], sq, sk, kBlock))
      return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = static_cast<long long>(cdiv(sq, kBlock)) * heads;
  a.items = groups * lead;
  // persistent blocks, as many as fit on the card at once, each walking
  // items blockIdx.x, + gridDim.x, ...; with resident tiles a multiple of
  // the (row block, head) pairs (fwd_wgmma plans them only when the pairs
  // fit), so that a block's items share their rows
  const long long fit = static_cast<long long>(sm_count()) * PER_SM;
  long long blocks = a.res_bytes ? fit / groups * groups : fit;
  blocks = blocks < a.items ? blocks : a.items;
  auto kernel = evo_wgmma_kernel<T, DP, C, PER_SM, BK>;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (int rc = prepare(kernel, grid, smem)) return rc;
  kernel<<<grid, Blk::kThreads, smem, stream>>>(q_map, k_map, v_map, a, static_cast<T*>(o));
  int staged = 0, summed = 0, keys = 0, resident = 0;
  for (int i = 0; i < a.n; ++i) {
    staged += a.tb[i].kind == kTileTma || a.tb[i].kind == kTileAsync;
    summed += a.tb[i].kind == kTileSum;
    keys += a.tb[i].kind == kKeySum || a.tb[i].kind == kKeyAsync;
    resident += a.tb[i].resident;
  }
  g_last = LaunchInfo{reinterpret_cast<const void*>(kernel), blocks, Blk::kThreads, smem, kBlock,
                      a.stages, staged, summed, keys, resident, PER_SM};
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int fwd_wgmma(const void* q, const void* k, const void* v, void* o, int lead, int sq, int sk,
              int heads, int d, const BiasIn* in, int nb, cudaStream_t stream) {
  constexpr int C = EvoTiles<DP>::kC, PER_SM = EvoTiles<DP>::kPerSm;
  constexpr int BK = EvoTiles<DP>::kKeys;
  const long long groups = static_cast<long long>(cdiv(sq, C * kRows)) * heads;
  if (groups * lead == 0) return 0;
  const int n_steps = cdiv(sk, BK);
  EvoArgs a{};
  a.n = nb;
  a.sq = sq;
  a.sk = sk;
  a.heads = heads;
  a.d = d;
  a.scale_log2 = kLog2e / sqrtf(static_cast<float>(d));
  // the first shape that holds two stages without summing a tile: blocks
  // an SM as EvoTiles says, then one; resident tiles first, when the (row
  // block, head) pairs fit the card's blocks
  bool demoted = false;
  for (int resident = 1; resident >= 0; --resident) {
    if (groups <= static_cast<long long>(sm_count()) * PER_SM || !resident) {
      const int smem = plan_stages<DP, C, PER_SM, BK>(a, in, nb, n_steps, resident, demoted);
      if (smem >= 0 && !demoted && a.stages >= 2)
        return launch_wgmma<T, DP, C, PER_SM, BK>(q, k, v, o, lead, sq, sk, heads, d, a, smem, in,
                                              stream);
    }
    if constexpr (PER_SM > 1) {
      if (groups <= sm_count() || !resident) {
        const int smem = plan_stages<DP, C, 1, BK>(a, in, nb, n_steps, resident, demoted);
        if (smem >= 0 && !demoted && a.stages >= 2)
          return launch_wgmma<T, DP, C, 1, BK>(q, k, v, o, lead, sq, sk, heads, d, a, smem, in,
                                           stream);
      }
    }
  }
  // tiles that do not fit two stages: summed by the lanes, one block an SM
  const int smem = plan_stages<DP, C, 1, BK>(a, in, nb, n_steps, false, demoted);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma<T, DP, C, 1, BK>(q, k, v, o, lead, sq, sk, heads, d, a, smem, in, stream);
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
             int sq, int sk, int heads, int d, const BiasIn* in, int nb, cudaStream_t stream) {
  if (simt) {
    Biases bs{};
    bs.n = nb;
    for (int i = 0; i < nb; ++i) bs.b[i] = in[i].b;
    if (d <= 32) return fwd_simt<T, 1>(q, k, v, o, lead, sq, sk, heads, d, bs, stream);
    if (d <= 64) return fwd_simt<T, 2>(q, k, v, o, lead, sq, sk, heads, d, bs, stream);
    if (d <= 128) return fwd_simt<T, 4>(q, k, v, o, lead, sq, sk, heads, d, bs, stream);
    return fwd_simt<T, 8>(q, k, v, o, lead, sq, sk, heads, d, bs, stream);
  }
  if constexpr (std::is_same<T, float>::value) {
    return static_cast<int>(cudaErrorInvalidValue);  // no fp32 tensor-core path
  } else {
    if (d <= 16) return fwd_wgmma<T, 16>(q, k, v, o, lead, sq, sk, heads, d, in, nb, stream);
    if (d <= 32) return fwd_wgmma<T, 32>(q, k, v, o, lead, sq, sk, heads, d, in, nb, stream);
    if (d <= 64) return fwd_wgmma<T, 64>(q, k, v, o, lead, sq, sk, heads, d, in, nb, stream);
    return fwd_wgmma<T, 128>(q, k, v, o, lead, sq, sk, heads, d, in, nb, stream);
  }
}

}  // namespace

// dtype (of q, k, v, o and of each bias): 0 = bf16, 1 = fp16, 2 = fp32.
// q [lead, sq, heads, d], k / v [lead, sk, heads, d] and o [lead, sq, heads,
// d] contiguous.  simt = 0: the tensor-core kernel (bf16 / fp16, d a
// multiple of 8 up to 128, q / k / v 16-byte aligned); simt = 1: the general
// kernel (any dtype, d up to 256).  Up to 8 biases.  Bias i: bias_ptrs[i]
// with its int64 [lead] offset table lead_ptrs[i] on the device;
// bias_info[3 i .. 3 i + 2] its type, its kind (0 scalar, 1 a value a row, 2
// a value a key, read and summed in fp32; 3 a tile TMA can read: last
// stride 1, base and row pitch 16-byte aligned, every plane offset a
// multiple of the row pitch; 4 a tile of 4-byte aligned rows, last stride 1;
// 5 any other tile, read and summed in fp32; 6 a value a key, last stride 1,
// 4-byte aligned) and whether every lead slice shares its planes (1 / 0);
// bias_strides[4 i .. 4 i + 3] its (h, r, c) strides in
// elements and the largest plane offset (lead_off[l] + h sh), all host
// arrays.  Return: the CUDA error code (0 ok).
extern "C" int dstt_evoformer_fwd(int dtype, int simt, const void* q, const void* k,
                                  const void* v, void* o, int lead, int sq, int sk, int heads,
                                  int d, int n_biases, const void* const* bias_ptrs,
                                  const void* const* lead_ptrs, const int* bias_info,
                                  const long long* bias_strides, void* stream) {
  if (d <= 0 || lead <= 0 || sq <= 0 || sk < 0 || heads <= 0 || n_biases < 0 ||
      n_biases > kMaxBiases)
    return static_cast<int>(cudaErrorInvalidValue);
  if (simt ? d > kSimtMaxD : (d % 8 != 0 || d > 128))
    return static_cast<int>(cudaErrorInvalidValue);
  BiasIn in[kMaxBiases];
  for (int i = 0; i < n_biases; ++i) {
    const int bt = bias_info[3 * i], kind = bias_info[3 * i + 1];
    const long long* st = bias_strides + 4 * i;
    if (bt < 0 || bt > 2 || kind < kScalar || kind > kKeyAsync ||
        (kind == kTileTma && st[1] <= 0))
      return static_cast<int>(cudaErrorInvalidValue);
    in[i] = BiasIn{Bias{bias_ptrs[i], static_cast<const long long*>(lead_ptrs[i]), st[0], st[1],
                        st[2], bt},
                   kind, bias_info[3 * i + 2], st[3]};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(simt, q, k, v, o, lead, sq, sk, heads, d, in, n_biases, s);
  if (dtype == 1)
    return dispatch<__half>(simt, q, k, v, o, lead, sq, sk, heads, d, in, n_biases, s);
  if (dtype == 2)
    return dispatch<float>(simt, q, k, v, o, lead, sq, sk, heads, d, in, n_biases, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The last tensor-core launch, for reports: out[0..11] = blocks (persistent),
// threads a block, dynamic shared memory (bytes), query rows a block, ring
// stages, bias tiles staged in their own type (TMA or cp.async), tiles summed
// by the producer's lanes, key rows staged, resident tiles, blocks an SM,
// registers a thread at launch, local memory a thread (bytes: spills).
extern "C" int dstt_evoformer_launch_info(long long* out) {
  cudaFuncAttributes attr{};
  if (g_last.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncGetAttributes(&attr, g_last.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vals[12] = {g_last.grid,         g_last.threads,     g_last.smem,
                              g_last.block_rows,   g_last.stages,      g_last.staged_tiles,
                              g_last.summed_tiles, g_last.key_rows,    g_last.resident,
                              g_last.per_sm,       attr.numRegs,
                              static_cast<long long>(attr.localSizeBytes)};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  return 0;
}
