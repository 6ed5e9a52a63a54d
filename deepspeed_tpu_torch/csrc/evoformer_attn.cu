// Evoformer attention forward for Hopper (sm_90a): flash attention with
// broadcast additive biases, fp32 accumulators.  Two kernels:
//
// * evo_wgmma_kernel, the tensor-core kernel: Q/K/V bf16 or fp16, D a
//   multiple of 8 up to 128, up to kMaxBiases biases, each fp32, bf16 or
//   fp16, of any broadcast pattern;
// * evo_split_kernel, the general kernel: what the tensor-core kernel
//   does not take (fp32 Q/K/V, D not a multiple of 8, D from 136 to 256),
//   products on the tensor cores by mma.sync in TF32, each fp32 operand
//   split in two TF32 parts (3xTF32, fp32 accuracy).  The wrapper's route
//   name for it, "simt", is the one it had when it ran on the CUDA cores.
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
// Design of the general kernel (evo_split_kernel).  What bounds it: fp32
// Q/K/V at the triangle shape (crop 256, D = 32) carry 8.6 GFLOP, 0.128 ms
// at 67 TFLOP/s on the CUDA cores, or 3 x 8.6 GFLOP of TF32 products, 0.052
// ms at 495 TFLOP/s; 134 MB of fp32 operands and output, 0.040 ms.  Its
// predecessor, one key a lane with dot products over D from shared memory
// (about 1.25 shared-memory loads an FMA), a runtime bias loop with a global
// load at every score and synchronous 32-key tiles, ran at 10% of the
// CUDA-core bound.  So:
// * products on the tensor cores, mma.sync.m16n8k8 in TF32: an fp32 operand
//   x is hi = tf32(x) and lo = tf32(x - hi), and each product is hi.hi +
//   hi.lo + lo.hi in fp32 accumulators (3xTF32, the split of PyTorch's own
//   fp32 attention on tensor cores; lo.lo lies below fp32's last bit).
//   bf16 and fp16 values are exact in TF32, so for them one product (lo = 0)
//   is exact and the kernel issues just that;
// * a block is 4 warps of two 16-row tiles, 128 rows of one (lead slice,
//   head), while D pads to at most 64 (one tile, 64 rows, beyond), so each
//   K and V fragment a warp loads and splits serves two tiles, and K and V
//   are read twice a head at S = 256; the fragments come from shared
//   memory at row strides that put a warp's loads on distinct banks, their
//   k order permuted so that S's accumulators are P V's A fragments with
//   no shuffle;
// * K and V tiles of BK keys come in their own type by cp.async (16, 8 or
//   4 bytes a copy, by alignment; D padded with zeros to DP) through a ring
//   of two stages, loaded a step ahead by the block's threads;
// * the biases are staged by bias_plan's kind with the tensor-core kernel's
//   helpers: the row biases summed once a block, the key rows and tiles
//   copied by cp.async in their own types (or summed in fp32 where cp.async
//   cannot copy them), so a score reads each bias from shared memory;
// * the online softmax is the tensor-core kernel's (step_softmax), in fp32
//   registers, P rounded to the input type before P V (fp32: not rounded).
// Every sum runs in a fixed order: two runs give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBiases = 8;

// One additive bias as a broadcast view: element (l, h, r, c) is
// p[lead_off[l] + h * sh + r * sr + c * sc], of type `dtype` (0 bf16, 1
// fp16, 2 fp32).
struct Bias {
  const void* p;
  const long long* lead_off;
  long long sh, sr, sc;
  int dtype;
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

// The biases that vary over rows only (scalars and values a row) summed for
// rows q0 .. q0 + rows - 1, one fp32 a row in log2 units, by 128 threads
// (pt: this one); `off` holds each bias's plane offset of the item.
__device__ __forceinline__ void stage_row_sums(float* rowb, const TileBias* sb, const EvoArgs& a,
                                               const long long* off, int q0, int rows, int pt) {
  for (int rr = pt; rr < rows; rr += 128) {
    const int r = q0 + rr;
    float x = 0.f;
#pragma unroll 1
    for (int b = 0; b < a.n && r < a.sq; ++b)
      if (sb[b].kind == kScalar || sb[b].kind == kRowBias)
        x += bias_at(sb[b].b, off[b] + r * sb[b].b.sr);
    rowb[rr] = x * kLog2e;
  }
}

// One step's biases (keys c0 .. c0 + BK - 1 of rows q0 .. q0 + rows - 1)
// staged by 128 threads (pt: this one) into `stage`: the cp.async tiles
// that are not resident and the cp.async key rows in their own types; the
// key rows and tiles cp.async cannot copy each summed in fp32, in log2
// units; zeros past Sq and Sk.
template <int BK>
__device__ __forceinline__ void stage_step(unsigned char* stage, const TileBias* sb,
                                           const EvoArgs& a, const long long* off, int q0,
                                           int c0, int rows, int pt) {
#pragma unroll 1
  for (int b = 0; b < a.n; ++b) {
    const int kind = sb[b].kind;
    if ((kind == kTileAsync && !sb[b].resident) || kind == kKeyAsync)
      copy_async<BK>(stage + sb[b].off, sb[b], off[b], q0, c0, kind == kKeyAsync ? 1 : rows,
                     a.sq, a.sk, pt);
  }
  if (a.key_off >= 0 && pt < BK) {
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
    constexpr int kBatch = 8;                   // loads in flight a thread
#pragma unroll 1
    for (int e0 = pt; e0 < rows * BK; e0 += 128 * kBatch) {
      float x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) x[u] = 0.f;
#pragma unroll 1
      for (int b = 0; b < a.n; ++b) {
        if (sb[b].kind != kTileSum) continue;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + 128 * u, r = q0 + e / BK, c = c0 + e % BK;
          if (e < rows * BK && r < a.sq && c < a.sk)
            x[u] += bias_at(sb[b].b, off[b] + r * sb[b].b.sr + c * sb[b].b.sc);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + 128 * u;
        if (e < rows * BK)
          *reinterpret_cast<float*>(sum + swz_bias(e / BK, e % BK, rows, 4)) = x[u] * kLog2e;
      }
    }
  }
}

// Step i's scores (keys c0 = i BK on; this thread's rows lr and lr + 8 of
// the block's `rows`, the accumulator layout of add_tile) to probabilities
// in s, fp32, log2 units: the scale and the row biases by one FMA, each
// staged bias (from `stage`, or from the resident tiles at `res`) and the
// lanes' fp32 sums added, keys past Sk -inf; then the online softmax, the
// running max m guarded at -inf (a row with nothing seen yet subtracts 0),
// lsum rescaled and summed, corr the factor of the output's rescale.
template <int BK>
__device__ __forceinline__ void step_softmax(float (&s)[BK / 2], float (&m)[2], float (&lsum)[2],
                                             float (&corr)[2], const float (&rowb)[2],
                                             const TileBias* sb, const EvoArgs& a,
                                             const unsigned char* stage,
                                             const unsigned char* res, int i, int lr, int t,
                                             int rows) {
  const float kInf = __int_as_float(0x7f800000);
  const int c0 = i * BK;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) s[j] = fmaf(s[j], a.scale_log2, rowb[(j >> 1) & 1]);
#pragma unroll 1
  for (int b = 0; b < a.n; ++b) {
    const int kind = sb[b].kind, dt = sb[b].b.dtype;
    const unsigned char* at = sb[b].resident ? res + sb[b].off + i * rows * BK * (dt == 2 ? 4 : 2)
                                             : stage + sb[b].off;
    if (kind == kTileTma || kind == kTileAsync) {
      if (dt == 2) add_tile<float, BK>(s, at, lr, t, rows, kLog2e);
      else if (dt == 1) add_tile<__half, BK>(s, at, lr, t, rows, kLog2e);
      else add_tile<__nv_bfloat16, BK>(s, at, lr, t, rows, kLog2e);
    } else if (kind == kKeyAsync) {
      if (dt == 2) add_keys<float, BK>(s, at, t, kLog2e);
      else if (dt == 1) add_keys<__half, BK>(s, at, t, kLog2e);
      else add_keys<__nv_bfloat16, BK>(s, at, t, kLog2e);
    }
  }
  if (a.sum_off >= 0) add_tile<float, BK>(s, stage + a.sum_off, lr, t, rows, 1.f);
  if (a.key_off >= 0) add_keys<float, BK>(s, stage + a.key_off, t, 1.f);
  const int valid = a.sk - c0;                  // keys of this step inside Sk
  if (valid < BK) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = 8 * (j >> 2) + 2 * t + (j & 1) < valid ? s[j] : -kInf;
  }
  float mx[2] = {-kInf, -kInf};
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
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
  for (int j = 0; j < BK / 2; ++j) {
    const int hr = (j >> 1) & 1;
    s[j] = exp2_ftz(s[j] - base[hr]);
    lsum[hr] += s[j];
  }
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
        if (a.rows)
          stage_row_sums(reinterpret_cast<float*>(item_buf + kQBytes), sb, a, off, q0, kBlock, pt);
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
          stage_step<BK>(stage, sb, a, off, q0, c0, kBlock, pt);
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
      step_softmax<BK>(s, m, lsum, corr, rowb, sb, a, stage_of(step), res, i, lr, t, kBlock);
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

// ----------------------------------------------------------------------------
// The general kernel: split TF32 on mma.sync
// ----------------------------------------------------------------------------
constexpr int kGenWarps = 4;
constexpr int kGenThreads = 32 * kGenWarps;
constexpr int kGenMaxD = 256;

// Keys a step by operand type and padded head dim (the ring holds two
// steps), and 16-row tiles a warp: two while D pads to at most 64, so that
// every K and V fragment a warp loads and splits serves both (beyond, the
// second tile's accumulators do not fit the registers); measured on the
// card, PERF.md.
template <typename T, int DP>
struct GenTiles {
  static constexpr int kKeys = sizeof(T) == 4 || DP > 32 ? 32 : 64;
  static constexpr int kRowTiles = DP <= 64 ? 2 : 1;
  static constexpr int kRows = 16 * kGenWarps * kRowTiles;   // query rows a block
};

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// The shared memory of the general kernel: Q [rows x LDQ] and the row
// biases' sums, then two stages of K [BK x LDK] and V [BK x LDV] (elements
// of T, D padded with zeros to DP; row strides that put the fragments'
// loads on distinct banks) and the step's biases (plan_general).
template <typename T, int DP, int BK>
struct GenGeo {
  static constexpr int kRows = GenTiles<T, DP>::kRows;
  static constexpr int kLdq = DP + 8, kLdk = DP + 8;
  static constexpr int kLdv = sizeof(T) == 4 ? DP + 4 : DP + 8;
  static constexpr int kQBytes = align128(kRows * kLdq * static_cast<int>(sizeof(T)));
  static constexpr int kRing = kQBytes + kRows * 4;
  static constexpr int kKBytes = align128(BK * kLdk * static_cast<int>(sizeof(T)));
  static constexpr int kVBytes = align128(BK * kLdv * static_cast<int>(sizeof(T)));
};

// x rounded to TF32 (10 explicit mantissa bits, to nearest, ties away)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as TF32 parts: with SPLIT, a high part and the remainder x - hi rounded
// again (together ~21 bits of x's 24); without, x itself (bf16 and fp16
// values are exact in TF32) and no remainder
template <bool SPLIT>
__device__ __forceinline__ void tf32_parts(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b over one m16n8k8 tile from TF32 parts: with SPLIT the three
// products hi.hi + hi.lo + lo.hi (3xTF32, fp32 accumulators; lo.lo lies
// below fp32's last bit), the small ones first; without, hi.hi alone.  (A
// second accumulator for the small ones, two dependency chains a tile,
// measured slower: its registers cost a block an SM; PERF.md.)
template <bool SPLIT>
__device__ __forceinline__ void mma_parts(float (&c)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  if constexpr (SPLIT) {   // the split's cross terms
    mma_tf32(c, al, bh[0], bh[1]);
    mma_tf32(c, ah, bl[0], bl[1]);
  }
  mma_tf32(c, ah, bh[0], bh[1]);
}

template <typename T>
__device__ __forceinline__ float2 ld_pair(const T* p) {        // p[0], p[1] in fp32
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float2*>(p);
  } else if constexpr (std::is_same<T, __half>::value) {
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
}

// elements 4j .. 4j + 3 of a fragment-ordered accumulator as one m16n8 tile
template <int N>
__device__ __forceinline__ float (&quad(float (&x)[N], int j))[4] {
  return *reinterpret_cast<float(*)[4]>(&x[4 * j]);
}

// `bytes` (4, 8 or 16) global -> shared, asynchronously; zeros when !in
template <int BYTES>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, bool in) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(in ? BYTES : 0)
                 : "memory");
  }
}

// This thread's copies of an [n x chunks] grid of copies, the block's 128
// threads taking every 128th: (row, chunk) of each, walked without a
// division a copy.
struct Chunks {
  int r, c, dr, dc, n, chunks;
  __device__ __forceinline__ Chunks(int n_, int chunks_)
      : r(threadIdx.x / chunks_), c(threadIdx.x % chunks_), dr(kGenThreads / chunks_),
        dc(kGenThreads % chunks_), n(n_), chunks(chunks_) {}
  __device__ __forceinline__ bool more() const { return r < n; }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= chunks) {
      c -= chunks;
      ++r;
    }
  }
};

// Rows r0 .. r0 + n - 1 of one head (row pitch `pitch` elements, d columns)
// into shared memory at row stride LD, by the block's threads, `vec` bytes
// a copy (16, 8 or 4 by cp.async; 0: 2-byte elements read and stored one by
// one); rows past `rows` are zeros.
template <typename T, int LD>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long pitch, int r0, int n,
                                          int rows, int d, int vec) {
  if (vec == 0) {
    for (Chunks x(n, d); x.more(); x.next())
      dst[x.r * LD + x.c] = r0 + x.r < rows ? src[(r0 + x.r) * pitch + x.c] : from_f<T>(0.f);
    return;
  }
  const int per = vec / static_cast<int>(sizeof(T));
  for (Chunks x(n, d / per); x.more(); x.next()) {
    const bool in = r0 + x.r < rows;
    const T* from = in ? src + (r0 + x.r) * pitch + x.c * per : src;
    T* to = dst + x.r * LD + x.c * per;
    if (vec == 16) cp_async_n<16>(to, from, in);
    else if (vec == 8) cp_async_n<8>(to, from, in);
    else cp_async_n<4>(to, from, in);
  }
}

// Rows q0 .. q0 + rows - 1, keys c0 .. c0 + BK - 1 of a tile bias whose
// rows start on 16 bytes (bias_plan's "tile_tma") into `dst` as swz_bias
// lays it, 16 bytes a cp.async by the block's threads; zeros past Sq and Sk.
template <int BK>
__device__ __forceinline__ void copy_tile16(unsigned char* dst, const TileBias& tb, long long off,
                                            int q0, int c0, int rows, int sq, int sk) {
  const int elt = tb.b.dtype == 2 ? 4 : 2, per = 16 / elt;
  const unsigned char* base = static_cast<const unsigned char*>(tb.b.p);
  for (Chunks x(rows, BK / per); x.more(); x.next()) {
    const int cc = x.c * per, c = c0 + cc;
    const int bytes = q0 + x.r < sq ? max(0, min(16, (sk - c) * elt)) : 0;
    const unsigned char* src =
        bytes ? base + (off + static_cast<long long>(q0 + x.r) * tb.b.sr + c) * elt : base;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + swz_bias(x.r, cc, rows, elt))),
                 "l"(src), "r"(bytes)
                 : "memory");
  }
}

// Columns d .. DP - 1 of `n` rows at stride LD set to zero (the padding of
// D that the products read).
template <typename T, int DP, int LD>
__device__ __forceinline__ void zero_pad(T* dst, int n, int d) {
  for (int i = threadIdx.x; i < n * (DP - d); i += kGenThreads)
    dst[(i / (DP - d)) * LD + d + i % (DP - d)] = from_f<T>(0.f);
}

// One block: 64 or 128 query rows of one (lead slice, head), 4 warps of one
// or two 16-row tiles, walking the keys in steps of BK through a ring of two
// stages that the block's threads fill by cp.async one step ahead (K, V and
// the step's biases; the row biases summed once).  S = Q K^T and O += P V
// on mma.sync.m16n8k8 in TF32, each fp32 operand split in two parts and each
// product the sum of three (mma_parts); the fragments' k order is permuted
// (column t holds element 2t, column t + 4 element 2t + 1, in A and B
// alike), so an S accumulator is P V's A fragment with no shuffle.  The
// softmax is step_softmax, the tensor-core kernel's, a tile at a time; P
// rounded to T before P V (fp32: not rounded).
template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kGenThreads)
evo_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, const __grid_constant__ EvoArgs a, int vec) {
  using G = GenGeo<T, DP, BK>;
  constexpr int TL = GenTiles<T, DP>::kRowTiles, kRows = G::kRows;
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char gsm[];
  __shared__ TileBias gb[kMaxBiases];
  __shared__ long long goff[kMaxBiases];
  T* q_s = reinterpret_cast<T*>(gsm);
  float* rowb_s = reinterpret_cast<float*>(gsm + G::kQBytes);
  unsigned char* ring = gsm + G::kRing;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  int lr[TL];                                     // this thread's rows lr[u], lr[u] + 8
#pragma unroll
  for (int u = 0; u < TL; ++u) lr[u] = 16 * (TL * warp + u) + g;
  const int nrb = cdiv(a.sq, kRows);
  const long long item = blockIdx.x;
  const int q0 = static_cast<int>(item % nrb) * kRows;
  const int h = static_cast<int>((item / nrb) % a.heads);
  const long long l = item / (static_cast<long long>(nrb) * a.heads);
  const long long pitch = static_cast<long long>(a.heads) * a.d;
  const T* qb = q + l * a.sq * pitch + static_cast<long long>(h) * a.d;
  const T* kb = k + l * a.sk * pitch + static_cast<long long>(h) * a.d;
  const T* vb = v + l * a.sk * pitch + static_cast<long long>(h) * a.d;
  auto stage_of = [&](int i) { return ring + (i & 1) * a.stage_bytes; };

  if (threadIdx.x < a.n) {
    gb[threadIdx.x] = a.tb[threadIdx.x];
    goff[threadIdx.x] = plane(a.tb[threadIdx.x], l, h);
  }
  if (a.d < DP) {
    zero_pad<T, DP, G::kLdq>(q_s, kRows, a.d);
    for (int st = 0; st < 2; ++st) {
      zero_pad<T, DP, G::kLdk>(reinterpret_cast<T*>(stage_of(st)), BK, a.d);
      zero_pad<T, DP, G::kLdv>(reinterpret_cast<T*>(stage_of(st) + G::kKBytes), BK, a.d);
    }
  }
  __syncthreads();

  auto load = [&](int i) {                        // step i's K, V and biases
    unsigned char* st = stage_of(i);
    copy_rows<T, G::kLdk>(reinterpret_cast<T*>(st), kb, pitch, i * BK, BK, a.sk, a.d, vec);
    copy_rows<T, G::kLdv>(reinterpret_cast<T*>(st + G::kKBytes), vb, pitch, i * BK, BK, a.sk,
                          a.d, vec);
    stage_step<BK>(st, gb, a, goff, q0, i * BK, kRows, threadIdx.x);
#pragma unroll 1
    for (int b = 0; b < a.n; ++b)
      if (gb[b].kind == kTileTma) copy_tile16<BK>(st + gb[b].off, gb[b], goff[b], q0, i * BK,
                                                  kRows, a.sq, a.sk);
    cp_async_commit();
  };
  const int steps = cdiv(a.sk, BK);               // key steps
  copy_rows<T, G::kLdq>(q_s, qb, pitch, q0, kRows, a.sq, a.d, vec);
  if (a.rows) stage_row_sums(rowb_s, gb, a, goff, q0, kRows, threadIdx.x);
  load(0);

  float m[TL][2], lsum[TL][2], rowb[TL][2], acc[TL][DP / 2], s[TL][BK / 2];
#pragma unroll
  for (int u = 0; u < TL; ++u) {
    m[u][0] = m[u][1] = -__int_as_float(0x7f800000);
    lsum[u][0] = lsum[u][1] = rowb[u][0] = rowb[u][1] = 0.f;
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc[u][j] = 0.f;
  }
  // Q's A fragment of tile u and k step kk, split (read again each step:
  // held in registers instead, they cost a block an SM; PERF.md)
  auto q_frag = [&](int u, int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    const float2 x0 = ld_pair(q_s + lr[u] * G::kLdq + 8 * kk + 2 * t);
    const float2 x1 = ld_pair(q_s + (lr[u] + 8) * G::kLdq + 8 * kk + 2 * t);
    tf32_parts<kSplit>(x0.x, ah[0], al[0]);
    tf32_parts<kSplit>(x1.x, ah[1], al[1]);
    tf32_parts<kSplit>(x0.y, ah[2], al[2]);
    tf32_parts<kSplit>(x1.y, ah[3], al[3]);
  };
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<0>();
    __syncthreads();                              // step i landed; step i - 1 read
    if (i + 1 < steps) load(i + 1);
    if (i == 0 && a.rows) {
#pragma unroll
      for (int u = 0; u < TL; ++u) {
        rowb[u][0] = rowb_s[lr[u]];
        rowb[u][1] = rowb_s[lr[u] + 8];
      }
    }
    const unsigned char* st = stage_of(i);
    const T* k_t = reinterpret_cast<const T*>(st);
    const T* v_t = reinterpret_cast<const T*>(st + G::kKBytes);

    // S = Q K^T: k step kk takes dims 8 kk .. 8 kk + 7, each K fragment
    // split once for the warp's tiles
#pragma unroll
    for (int u = 0; u < TL; ++u)
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[u][j] = 0.f;
    auto s_step = [&](int kk, const uint32_t (&ah)[TL][4], const uint32_t (&al)[TL][4]) {
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb) {
        const float2 y = ld_pair(k_t + (8 * nb + g) * G::kLdk + 8 * kk + 2 * t);
        uint32_t bh[2], bl[2];
        tf32_parts<kSplit>(y.x, bh[0], bl[0]);
        tf32_parts<kSplit>(y.y, bh[1], bl[1]);
#pragma unroll
        for (int u = 0; u < TL; ++u) mma_parts<kSplit>(quad(s[u], nb), ah[u], al[u], bh, bl);
      }
    };
#pragma unroll 2
    for (int kk = 0; kk < DP / 8; ++kk) {
      uint32_t ah[TL][4], al[TL][4];
#pragma unroll
      for (int u = 0; u < TL; ++u) q_frag(u, kk, ah[u], al[u]);
      s_step(kk, ah, al);
    }
#pragma unroll
    for (int u = 0; u < TL; ++u) {
      float corr[2];
      step_softmax<BK>(s[u], m[u], lsum[u], corr, rowb[u], gb, a, st, nullptr, i, lr[u], t,
                       kRows);
      if (__any_sync(kFull, corr[0] != 1.f || corr[1] != 1.f)) {   // x 1 changes no bit
#pragma unroll
        for (int j = 0; j < DP / 2; ++j) acc[u][j] *= corr[(j >> 1) & 1];
      }
    }

    // O += round(P) V: key block kb takes keys 8 kb .. 8 kb + 7 (P's column
    // t: key 2t, its S accumulator element 0 / 2; t + 4: key 2t + 1), each
    // V fragment split once for the warp's tiles
#pragma unroll
    for (int kb_ = 0; kb_ < BK / 8; ++kb_) {
      uint32_t ah[TL][4], al[TL][4];
#pragma unroll
      for (int u = 0; u < TL; ++u) {
        tf32_parts<kSplit>(to_f(from_f<T>(s[u][4 * kb_])), ah[u][0], al[u][0]);
        tf32_parts<kSplit>(to_f(from_f<T>(s[u][4 * kb_ + 2])), ah[u][1], al[u][1]);
        tf32_parts<kSplit>(to_f(from_f<T>(s[u][4 * kb_ + 1])), ah[u][2], al[u][2]);
        tf32_parts<kSplit>(to_f(from_f<T>(s[u][4 * kb_ + 3])), ah[u][3], al[u][3]);
      }
      const T* v0 = v_t + (8 * kb_ + 2 * t) * G::kLdv + g;
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        uint32_t bh[2], bl[2];
        tf32_parts<kSplit>(to_f(v0[8 * nd]), bh[0], bl[0]);
        tf32_parts<kSplit>(to_f(v0[G::kLdv + 8 * nd]), bh[1], bl[1]);
#pragma unroll
        for (int u = 0; u < TL; ++u) mma_parts<kSplit>(quad(acc[u], nd), ah[u], al[u], bh, bl);
      }
    }
  }
  cp_async_wait<0>();                             // (no step: nothing left in flight)

  // normalise (a row whose sum is 0 gives zeros) and write this thread's
  // columns 8 nd + 2t, + 1 of its rows
  const long long ob = (l * a.sq + q0) * pitch + static_cast<long long>(h) * a.d;
#pragma unroll
  for (int u = 0; u < TL; ++u) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float sum = lsum[u][hr];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const float inv = 1.f / (sum == 0.f ? 1.f : sum);
      const int r = lr[u] + 8 * hr;
      if (q0 + r >= a.sq) continue;
      T* orow = o + ob + r * pitch;
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        const int c = 8 * nd + 2 * t;
        if (c < a.d) orow[c] = from_f<T>(acc[u][4 * nd + 2 * hr] * inv);
        if (c + 1 < a.d) orow[c + 1] = from_f<T>(acc[u][4 * nd + 2 * hr + 1] * inv);
      }
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

// The general kernel's shared memory: GenGeo's Q and row sums, then two
// stages of K, V and the step's biases.  A tile that cp.async copies (16
// bytes a copy where TMA could read it, else 4) is staged in its own type,
// up to kMaxStaged of them; the others, and those past what lets two
// stages fit, are summed by the threads in fp32 (the last first).  Key rows as the
// tensor-core kernel's.  Fills `a` and returns the dynamic shared bytes, or
// -1 when even the K and V tiles do not fit.
template <typename T, int DP, int BK>
int plan_general(EvoArgs& a, const BiasIn* in, int nb) {
  using G = GenGeo<T, DP, BK>;
  constexpr int kBudget = 232448 - 1024;
  int kinds[kMaxBiases];
  int staged = 0;
  auto tile = [&](int i) { return kinds[i] == kTileTma || kinds[i] == kTileAsync; };
  for (int i = 0; i < nb; ++i) {
    kinds[i] = in[i].kind;
    if (tile(i) && ++staged > kMaxStaged) kinds[i] = kTileSum;
  }
  auto tile_bytes = [&](int i) {
    return G::kRows * align128(BK * (in[i].b.dtype == 2 ? 4 : 2));
  };
  auto stage_bytes = [&]() {
    int bytes = G::kKBytes + G::kVBytes;
    bool sum = false, key_sum = false;
    for (int i = 0; i < nb; ++i) {
      bytes += tile(i) ? tile_bytes(i) : kinds[i] == kKeyAsync ? BK * 4 : 0;
      sum |= kinds[i] == kTileSum;
      key_sum |= kinds[i] == kKeySum;
    }
    return bytes + (sum ? G::kRows * BK * 4 : 0) + (key_sum ? BK * 4 : 0);
  };
  for (int i = nb - 1; i >= 0 && G::kRing + 2 * stage_bytes() > kBudget; --i)
    if (tile(i)) kinds[i] = kTileSum;
  if (G::kRing + 2 * stage_bytes() > kBudget) return -1;
  a.stages = 2;
  a.stage_bytes = stage_bytes();
  int off = G::kKBytes + G::kVBytes;
  bool sum = false, key_sum = false, rows = false;
  for (int i = 0; i < nb; ++i) {
    a.tb[i] = TileBias{in[i].b, kinds[i], -1, 0, 0};
    if (tile(i)) {
      a.tb[i].off = off;
      off += tile_bytes(i);
    }
    sum |= kinds[i] == kTileSum;
    key_sum |= kinds[i] == kKeySum;
    rows |= kinds[i] == kScalar || kinds[i] == kRowBias;
  }
  a.sum_off = sum ? off : -1;
  off += sum ? G::kRows * BK * 4 : 0;
  a.key_off = key_sum ? off : -1;
  off += key_sum ? BK * 4 : 0;
  for (int i = 0; i < nb; ++i) {
    if (kinds[i] == kKeyAsync) {
      a.tb[i].off = off;
      off += BK * 4;
    }
  }
  a.rows = rows ? 1 : 0;
  return G::kRing + 2 * a.stage_bytes;
}

template <typename T, int DP>
int fwd_general(const void* q, const void* k, const void* v, void* o, int lead, int sq, int sk,
                int heads, int d, const BiasIn* in, int nb, cudaStream_t stream) {
  constexpr int BK = GenTiles<T, DP>::kKeys;
  using G = GenGeo<T, DP, BK>;
  const long long items = static_cast<long long>(cdiv(sq, G::kRows)) * heads * lead;
  if (items == 0) return 0;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  EvoArgs a{};
  a.n = nb;
  a.items = items;
  a.sq = sq;
  a.sk = sk;
  a.heads = heads;
  a.d = d;
  a.scale_log2 = kLog2e / sqrtf(static_cast<float>(d));
  const int smem = plan_general<T, DP, BK>(a, in, nb);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  // the widest copy every row of Q, K and V starts on
  const int row = d * static_cast<int>(sizeof(T));
  const uintptr_t at = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v);
  int vec = 0;
  for (int w = 16; w >= 4 && vec == 0; w /= 2) vec = row % w == 0 && at % w == 0 ? w : 0;
  auto kernel = evo_split_kernel<T, DP, BK>;
  const dim3 grid(static_cast<unsigned>(items));
  if (int rc = prepare(kernel, grid, smem)) return rc;
  kernel<<<grid, kGenThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                              static_cast<const T*>(v), static_cast<T*>(o), a,
                                              vec);
  int per_sm = 0, staged = 0, summed = 0, keys = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGenThreads, smem);
  for (int i = 0; i < nb; ++i) {
    staged += a.tb[i].kind == kTileTma || a.tb[i].kind == kTileAsync;
    summed += a.tb[i].kind == kTileSum;
    keys += a.tb[i].kind == kKeySum || a.tb[i].kind == kKeyAsync;
  }
  g_last = LaunchInfo{reinterpret_cast<const void*>(kernel), items, kGenThreads, smem, G::kRows,
                      2, staged, summed, keys, 0, per_sm};
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(bool simt, const void* q, const void* k, const void* v, void* o, int lead,
             int sq, int sk, int heads, int d, const BiasIn* in, int nb, cudaStream_t stream) {
  if (simt) {
#define DSTT_GENERAL(DP) fwd_general<T, DP>(q, k, v, o, lead, sq, sk, heads, d, in, nb, stream)
    if (d <= 16) return DSTT_GENERAL(16);
    if (d <= 32) return DSTT_GENERAL(32);
    if (d <= 64) return DSTT_GENERAL(64);
    if (d <= 128) return DSTT_GENERAL(128);
    return DSTT_GENERAL(256);
#undef DSTT_GENERAL
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
  if (simt ? d > kGenMaxD : (d % 8 != 0 || d > 128))
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

// The last launch of either kernel, for reports: out[0..11] = blocks
// (persistent for the tensor-core kernel), threads a block, dynamic shared
// memory (bytes), query rows a block, ring stages, bias tiles staged in
// their own type (TMA or cp.async), tiles summed in fp32, key rows staged,
// resident tiles, blocks an SM, registers a thread at launch, local memory
// a thread (bytes: spills).
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
