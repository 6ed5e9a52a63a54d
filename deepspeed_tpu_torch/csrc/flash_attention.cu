// Flash attention forward and backward for Hopper (sm_90a): bf16 or fp16 in,
// fp32 accumulators, products on wgmma fed by TMA.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py that the
// training path runs, for all three of its layouts:
//
// * forward, `dstt_flash_fwd`, one CUDA block per 128 query rows of one
//   (batch, head): `_fwd_kernel_onepass` / `_fwd_kernel` (bshd, :119/:148,
//   pallas_call :233), `_fwd_kernel_folded_onepass` / `_fwd_kernel_folded`
//   (folded, :568/:600, :699), `_fwd_kernel_paired_onepass` /
//   `_fwd_kernel_paired` (paired, :1091/:1133, :1251);
// * dQ, `dstt_flash_bwd_dq`, one block per 128 query rows of one (batch,
//   head): `_bwd_dq_kernel` (:260, :364), `_bwd_dq_kernel_folded` (:720,
//   :843), `_bwd_dq_kernel_paired` (:1272, :1423);
// * dK/dV, `dstt_flash_bwd_dkv`, one block per 128 keys of one (batch, KV
//   head): `_bwd_dkv_kernel` (:302, :391), `_bwd_dkv_kernel_folded` (:766,
//   :871), `_bwd_dkv_kernel_paired` (:1334, :1451).
//
// One kernel family serves the three layouts.  The folded layout exists on
// the TPU to avoid the BSHD <-> BHSD transposes around its kernels; these
// kernels read BSHD in place through one 4-D TMA tensor map per operand,
// (D, head, S, B) with the operand's own row stride, so column slices of one
// fused [B, S, (H + 2 Hkv) D] projection output (GPT-2's c_attn, Llama's
// qkv_proj) take the same path as a contiguous tensor, without a copy.  The
// paired layout exists to fill the TPU's 128-lane MXU tile at d = 64; a
// wgmma consumes d in 16-wide steps, so there is nothing to pair: the paired
// entry launches the same kernels and keeps only its own eligibility rule
// (ops/flash_attention.py).
//
// What they compute, with q pre-scaled by the softmax scale and rounded to
// the input type (done once outside, as the TPU path does):
//
//   keep(r, c) = c < Sk and, when causal, r + (Sk - Sq) >= c (end-aligned),
//                and with a window w > 0, c > r + (Sk - Sq) - w;
//   s = q k^T (fp32);  p = exp(s - m) on kept entries, 0 elsewhere;
//   o = (round(p) @ v) / l,  lse = m + log(l)   (l == 0: a row that sees no
//   key comes out as zeros with lse = -1e30, never NaN);
//   backward: p = exp(s - lse), dp = do v^T, ds = p (dp - delta) with
//   delta = rowsum(do * o) (fp32; the dQ kernel computes it for its rows
//   and writes it for the dK/dV kernel, which runs after it on the same
//   stream), then dq = scale * round(ds) @ k, dv = round(p)^T @ do,
//   dk = round(ds)^T @ q.
//   round() is the input type: P and dS are rounded before their products,
//   as the TPU kernels round them (flash_attention.py:292, :332, :338).
//   exp is taken as exp2 with log2(e) folded into one fp32 multiply-add
//   (the running max m is kept in log2 units); lse and delta stay natural,
//   fp32 [B, H, Sq].
//
// Layout: q / o / do / dq are [B, Sq, H, D] and k / v / dk / dv [B, Sk, Hkv,
// D], each with its own row stride (the distance between two consecutive
// positions, in elements; the batch stride is S times it, a head's D values
// are contiguous at offset h * D).  The contiguous case is stride = H * D.
// The wrapper writes o, dq, dk and dv contiguous.  Every row must start on 16
// bytes (base pointer and stride): TMA needs both.  A TMA box that reaches
// past S reads zeros (S is a dimension of the map of its own, so a box never
// reads the next batch's rows), and every S works.
//
// What bounds them on the H100: at the training shapes (S 1024-2048, D 64-
// 128) the products, ~4 B H Sq Sk D flops forward (halved when causal), 1.5x
// that for dQ and 2x for dK/dV, at 989 TFLOP/s bf16 dense; the bytes (q, k,
// v, o once) are an order of magnitude below.  At D = 64 the forward's
// exponentials (one MUFU op a score, 16 a clock an SM) take as long as its
// products.  So the design keeps the tensor cores fed and the softmax lean:
//
// * a block is one producer warpgroup, whose first thread keeps a 3-stage
//   ring of TMA loads in flight (full / empty mbarriers, 128-byte swizzle,
//   so each tile lands as a wgmma operand), and C consumer warpgroups of 64
//   rows each, which run the products on wgmma; `setmaxnreg` moves the
//   producer's registers to the consumers.  C = 2 (one block an SM, the
//   two warpgroups sharing each streamed tile) or C = 1 (two blocks an SM,
//   one's start and drain overlapping the other's work), per launch and
//   head dim as `Tiles` says (measured on the card, PERF.md);
// * forward: Q is loaded once; S = Q K^T by wgmma from shared memory (both
//   operands K-major); P, rounded to T in registers, is the A operand of
//   O += P V (V MN-major); O stays in fp32 registers.  Tile j's softmax
//   runs while tile j - 1's P V product does, and with C = 2 the two
//   warpgroups take turns issuing, so one's softmax runs beside the other's
//   products;
// * dQ: Q and dO are loaded once, K and V stream; S = Q K^T and dP = dO V^T
//   from shared memory, dS = P (dP - delta) rounded and fed from registers
//   against K into dQ, tile j's dS formed while tile j - 1's dQ product runs;
// * dK/dV: K and V are loaded once, and for each query head of the GQA
//   group and each q tile the tiles of Q and dO (by TMA) and the rows of
//   lse and delta (copied by the producer warp's lanes) stream through the
//   ring (across the group boundary, without a drain); S^T = K Q^T and
//   dP^T = V dO^T from shared memory, P^T and dS^T rounded and fed from
//   registers against dO and Q into dV and dK, which stay in fp32 registers
//   over the whole group and are written once (at D = 128 a step is 32 q
//   rows, so that the two sums and both score tiles fit the registers
//   without serialising the products).  So every sum runs in a fixed
//   order: two runs give the same bits, and dQ is never accumulated by
//   atomics across blocks;
// * every register a product reads or accumulates into is fenced just
//   before wgmma.fence (`operands_ready`), else the compiler inserts its
//   own fences and serialises the products;
// * the tile walk skips tiles wholly outside the causal band or the window,
//   and only tiles that cross the diagonal, the window's edge or the end of
//   S pay the mask (`whole_tile`), as two compares a score against the
//   row's visible span (`row_keys`, `key_rows`), without a branch; the
//   causal q tiles are launched longest first (forward and dQ: the last q
//   tile first; dK/dV: the first k tile first).  `flash_tile_walk` in
//   ops/flash_attention.py mirrors the loop bounds, the mask decision and
//   the order, and is tested on the CPU.
//
// GQA: the dK/dV block sums the whole group in fp32 and rounds once (the
// TPU's folded and paired backward writes each query head's dk / dv in the
// input type and sums the group outside, flash_attention.py:905-909).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>
#include <type_traits>

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 64;                         // rows of one warpgroup's wgmma tile
constexpr int kProducerRegs = 24;
constexpr float kNegInf = -1e30f;                 // the TPU kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

// A block: one producer warpgroup and C consumer warpgroups of kRows rows
// each.  With C = 1 two blocks share an SM (each its own half of the
// registers and shared memory), so one block's start and drain overlap the
// other's products; with C = 2 one block fills the SM and its two
// warpgroups share each K / V (or Q / dO) tile.
template <int C>
struct Block {
  static constexpr int kThreads = 128 * (1 + C);
  static constexpr int kRowsAll = C * kRows;      // q rows (fwd, dQ) or keys (dK/dV)
  static constexpr int kPerSm = C == 1 ? 2 : 1;
  static constexpr int kConsumerRegs = C == 1 ? 232 : 240;   // after setmaxnreg
};

// The launches' shapes by head dim: consumer warpgroups a block (C), the
// forward's and dQ's keys a step, the dK/dV launch's query rows a step, and
// the ring's stages.
template <int D>
struct Tiles;
template <>
struct Tiles<64> {
  static constexpr int kFwdC = 1, kFwdKeys = 128, kFwdStages = 3;
  static constexpr int kDqC = 1, kDqKeys = 64, kDqStages = 3;
  static constexpr int kDkvC = 1, kDkvRows = 64, kDkvStages = 3;
};
template <>
struct Tiles<128> {
  static constexpr int kFwdC = 2, kFwdKeys = 128, kFwdStages = 3;
  static constexpr int kDqC = 2, kDqKeys = 64, kDqStages = 3;
  static constexpr int kDkvC = 1, kDkvRows = 32, kDkvStages = 3;
};

struct Shape {
  int batch, sq, sk, heads, kv_heads, causal, window;
};

// Row strides in elements of each [B, S, *] operand: row s of batch b starts
// at b * S * stride + s * stride, and head h's D values at offset h * D in
// the row.
struct Rows {
  long long q, k, v, o, dout, dq, dk, dv;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// -------------------------------------------------------------- the tile walk

// The k tiles [begin, end) of `bk` keys that rows [r0, r1) see (r1 <= Sq).
__device__ __forceinline__ void k_tiles(const Shape& sh, int r0, int r1, int bk, int& begin,
                                        int& end) {
  const int off = sh.sk - sh.sq;
  begin = 0;
  end = cdiv(sh.sk, bk);
  if (!sh.causal) return;
  const int hi = r1 - 1 + off;                    // the last key row r1 - 1 sees
  end = hi < 0 ? 0 : min(end, hi / bk + 1);
  const int lo = r0 + off - sh.window + 1;        // the first key row r0 sees
  if (sh.window > 0 && lo > 0) begin = lo / bk;
}

// The q tiles [begin, end) of `bq` rows whose rows see keys [c0, c1) (c1 <= Sk).
__device__ __forceinline__ void q_tiles(const Shape& sh, int c0, int c1, int bq, int& begin,
                                        int& end) {
  const int off = sh.sk - sh.sq;
  begin = 0;
  end = cdiv(sh.sq, bq);
  if (!sh.causal) return;
  const int lo = c0 - off;                        // the first row that sees key c0
  if (lo > 0) begin = min(lo / bq, end);
  if (sh.window > 0) {
    const int hi = c1 - 1 - off + sh.window - 1;  // the last row that sees key c1 - 1
    end = hi < 0 ? 0 : min(end, hi / bq + 1);
  }
}

// The keys [lo, hi] that row r sees (none when hi < lo): the mask of a tile
// that is not whole is two compares a score against these, without a branch.
__device__ __forceinline__ void row_keys(const Shape& sh, int r, int& lo, int& hi) {
  const int off = sh.sk - sh.sq;
  lo = 0;
  hi = r < sh.sq ? sh.sk - 1 : -1;
  if (sh.causal) {
    hi = min(hi, r + off);
    if (sh.window > 0) lo = r + off - sh.window + 1;
  }
}

// The rows [lo, hi] that see key c (none when hi < lo).
__device__ __forceinline__ void key_rows(const Shape& sh, int c, int& lo, int& hi) {
  const int off = sh.sk - sh.sq;
  lo = 0;
  hi = c < sh.sk ? sh.sq - 1 : -1;
  if (sh.causal) {
    lo = c - off;
    if (sh.window > 0) hi = min(hi, c - off + sh.window - 1);
  }
}

// Whether every (row, key) of rows [r0, r0 + nr) x keys [c0, c0 + nc) is
// visible and in range: such a tile skips the per-score mask.
__device__ __forceinline__ bool whole_tile(const Shape& sh, int r0, int nr, int c0, int nc) {
  if (r0 + nr > sh.sq || c0 + nc > sh.sk) return false;
  if (!sh.causal) return true;
  const int off = sh.sk - sh.sq;
  return r0 + off >= c0 + nc - 1 && (sh.window <= 0 || c0 > r0 + nr - 1 + off - sh.window);
}

// ----------------------------------------------------------------- helpers

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

// K-major descriptor of k-step kk (16 columns) of a swizzled [rows x D] tile
// (D / 64 column blocks of rows x 128 bytes), from row `row0` on
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int rows, int row0, int kk) {
  return wgmma_desc(tile + (kk / 4) * rows * 128 + row0 * 128 + (kk % 4) * 32, 16, 1024);
}

// MN-major descriptor of rows [16 ks, 16 ks + 16) of a swizzled [rows x D]
// tile, as the B operand whose N is D
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile, int rows, int ks) {
  return wgmma_desc(tile + ks * 16 * 128, rows * 128, 1024);
}

// this warpgroup's `kRows` rows of a swizzled [rows x D] staging tile to
// global memory, 16 bytes a thread: row rr goes to dst + (row0 + rr) *
// stride, when row0 + rr < n
template <int D>
__device__ __forceinline__ void store_rows(const unsigned char* tile, int rows, int wg_row,
                                           void* dst, long long stride_bytes, int row0, int n,
                                           int ct) {
  for (int c = ct; c < kRows * D / 8; c += 128) {
    const int rr = c / (D / 8), col = (c % (D / 8)) * 8;
    if (row0 + rr < n)
      *reinterpret_cast<int4*>(static_cast<unsigned char*>(dst)
                               + static_cast<long long>(row0 + rr) * stride_bytes + col * 2) =
          *reinterpret_cast<const int4*>(tile + swizzle128(wg_row + rr, col, rows));
  }
}

// ----------------------------------------------------------------------------
// Forward
// ----------------------------------------------------------------------------
template <int D, int BK, int NS, int C>
struct FwdSmem {
  static constexpr int kBlock = Block<C>::kRowsAll;
  static constexpr int kQ = 0;                        // [D / 64][kBlock][128 B]
  static constexpr int kTile = BK * D * 2;            // one K or V tile
  static constexpr int kK = kQ + kBlock * D * 2;      // [NS] K tiles
  static constexpr int kV = kK + NS * kTile;          // [NS] V tiles
  static constexpr int kBars = kV + NS * kTile;       // q, full[NS], empty[NS]
  static constexpr int kBytes = kBars + (1 + 2 * NS) * 8 + 1024;
};

template <typename T, int D, int BK, int NS, int C>
__global__ void __launch_bounds__(Block<C>::kThreads, Block<C>::kPerSm)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, T* __restrict__ o,
                 float* __restrict__ lse, const Shape sh, const long long o_stride) {
  using L = FwdSmem<D, BK, NS, C>;
  constexpr int kBlock = Block<C>::kRowsAll;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* q_s = sm + L::kQ;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + NS;

  // block -> (q tile, head, batch), the causal q tiles longest first
  const int bh = sh.heads * sh.batch;
  const int h = blockIdx.x % sh.heads, b = (blockIdx.x / sh.heads) % sh.batch;
  const int q0 = (cdiv(sh.sq, kBlock) - 1 - static_cast<int>(blockIdx.x) / bh) * kBlock;
  const int kh = h / (sh.heads / sh.kv_heads);
  int begin, end;                                 // the k tiles the block's rows see
  k_tiles(sh, q0, min(q0 + kBlock, sh.sq), BK, begin, end);
  const int n = end - begin;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C);                // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: Q once, then K and V through the ring
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_bar, kBlock * D * 2);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(q_s + c * kBlock * 128, &q_map, q_bar, 64 * c, h, q0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % NS;
        if (i >= NS) mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
        const int c0 = (begin + i) * BK;
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sm + L::kK + s * L::kTile + c * BK * 128, &k_map, &full[s], 64 * c, kh, c0,
                      b);
          tma_load_4d(sm + L::kV + s * L::kTile + c * BK * 128, &v_map, &full[s], 64 * c, kh, c0,
                      b);
        }
      }
    }
  } else {
    setmaxnreg_inc<Block<C>::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;         // consumer warpgroup
    const int ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32, g = lane / 4, t = lane % 4;
    const int r_wg = q0 + cw * kRows;             // this warpgroup's first row
    const int r_a = r_wg + 16 * warp + g;         // this thread's rows r_a, r_a + 8

    float m[2] = {kNegInf, kNegInf};              // running max, log2 units
    float l[2] = {0.f, 0.f};                      // this thread's part of the row sums
    float acc[D / 2], s[BK / 2];
    uint32_t p[BK / 16][4];
    zero(acc);
    zero(s);

    auto qk = [&](int i) {                        // S = Q K_i^T
      const unsigned char* k_t = sm + L::kK + (i % NS) * L::kTile;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_t<T, BK>(s, kmajor(q_s, kBlock, cw * kRows, kk), kmajor(k_t, BK, 0, kk), kk);
    };
    auto pv = [&](int i) {                        // O += round(P) V_i
      const unsigned char* v_t = sm + L::kV + (i % NS) * L::kTile;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) wgmma_rs_t<T, D>(acc, p[ks], mnmajor(v_t, BK, ks));
    };
    // tile i's scores -> probabilities in s (fp32), the new max, corr
    auto softmax = [&](int i, float (&corr)[2]) {
      const int c0 = (begin + i) * BK;
      const float kInf = __int_as_float(0x7f800000);
      float mx[2] = {-kInf, -kInf};
      if (whole_tile(sh, r_wg, kRows, c0, BK)) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
      } else {
        // this thread's columns of the tile are c0 + 2t + x, x = 8 (j / 4) + j % 2
        int lo[2], hi[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          row_keys(sh, r_a + 8 * hr, lo[hr], hi[hr]);
          lo[hr] -= c0 + 2 * t;
          hi[hr] -= c0 + 2 * t;
        }
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int hr = (j >> 1) & 1, x = 8 * (j >> 2) + (j & 1);
          s[j] = (x >= lo[hr]) & (x <= hi[hr]) ? s[j] : -kInf;
          mx[hr] = fmaxf(mx[hr], s[j]);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 2));
        const float m_new = fmaxf(m[hr], mx[hr] * kLog2e);
        corr[hr] = exp2_ftz(m[hr] - m_new);
        m[hr] = m_new;
        l[hr] *= corr[hr];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int hr = (j >> 1) & 1;
        s[j] = exp2_ftz(fmaf(s[j], kLog2e, -m[hr]));
        l[hr] += s[j];
      }
    };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % NS]);
    };

    // Every register a product reads or accumulates into is fenced right
    // before wgmma.fence, so that the compiler keeps its definitions above
    // it (else it fences again itself and serialises the products).
    auto operands_ready = [&]() {
      fence_all(s);
      fence_all(acc);
      fence_all(p);
      wgmma_fence();
    };
    // Two consumer warpgroups take turns issuing their products (named
    // barriers 3 and 4, of both warpgroups' 256 threads), so that one's
    // softmax runs while the tensor cores work on the other's products.
    // Warpgroup 1 passes once before its first turn and skips its last
    // pass, so warpgroup 0 goes first and every arrival is waited for.
    auto turn_wait = [&]() {
      if constexpr (C == 2) named_barrier(3 + cw, 256);
    };
    auto turn_pass = [&]() {
      if constexpr (C == 2) named_barrier_arrive(4 - cw, 256);
    };
    mbar_wait(q_bar, 0);
    if (n > 0) {
      float corr[2];
      if (cw == 1) turn_pass();
      mbar_wait(&full[0], 0);
      turn_wait();
      operands_ready();
      qk(0);
      wgmma_commit();
      turn_pass();
      wgmma_wait<0>();
      fence_all(s);
      softmax(0, corr);
      to_a<T, BK>(p, s);
      // step i issues tile i's S beside tile i - 1's P V, then runs tile
      // i's softmax while the P V product runs
      for (int i = 1; i < n; ++i) {
        mbar_wait(&full[i % NS], (i / NS) & 1);
        turn_wait();
        operands_ready();
        qk(i);
        wgmma_commit();
        pv(i - 1);
        wgmma_commit();
        turn_pass();
        wgmma_wait<1>();
        fence_all(s);
        softmax(i, corr);
        wgmma_wait<0>();
        fence_all(acc);
        fence_all(p);
        release(i - 1);
#pragma unroll
        for (int j = 0; j < D / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
        to_a<T, BK>(p, s);
      }
      turn_wait();
      operands_ready();
      pv(n - 1);
      wgmma_commit();
      if (cw == 0) turn_pass();
      wgmma_wait<0>();
      fence_all(acc);
      fence_all(p);
      release(n - 1);
    }

    // normalise, stage the rows (rounded) in this warpgroup's rows of the q
    // tile, which no product reads any more, and write them 16 bytes a thread
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(kFull, l[hr], 1);
      l[hr] += __shfl_xor_sync(kFull, l[hr], 2);
      const int row = cw * kRows + 16 * warp + g + 8 * hr;
      const float inv = 1.f / (l[hr] == 0.f ? 1.f : l[hr]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(q_s + swizzle128(row, 8 * j + 2 * t, kBlock)) =
            pack2<T>(acc[4 * j + 2 * hr] * inv, acc[4 * j + 2 * hr + 1] * inv);
      const int r = r_a + 8 * hr;
      if (t == 0 && r < sh.sq)
        lse[(static_cast<size_t>(b) * sh.heads + h) * sh.sq + r] =
            l[hr] == 0.f ? kNegInf : m[hr] * kLn2 + logf(l[hr]);
    }
    named_barrier(1 + cw, 128);
    store_rows<D>(q_s, kBlock, cw * kRows,
                  o + static_cast<size_t>(b) * sh.sq * o_stride + static_cast<size_t>(h) * D,
                  o_stride * 2, r_wg, sh.sq, ct);
  }
}

// ----------------------------------------------------------------------------
// Backward: dQ
// ----------------------------------------------------------------------------
template <int D, int BK, int NS, int C>
struct DqSmem {
  static constexpr int kBlock = Block<C>::kRowsAll;
  static constexpr int kQ = 0;                        // [D / 64][kBlock][128 B]
  static constexpr int kDo = kQ + kBlock * D * 2;     // the same
  static constexpr int kTile = BK * D * 2;
  static constexpr int kK = kDo + kBlock * D * 2;     // [NS] K tiles
  static constexpr int kV = kK + NS * kTile;          // [NS] V tiles
  static constexpr int kBars = kV + NS * kTile;       // q, full[NS], empty[NS]
  static constexpr int kBytes = kBars + (1 + 2 * NS) * 8 + 1024;
};

template <typename T, int D, int BK, int NS, int C>
__global__ void __launch_bounds__(Block<C>::kThreads, Block<C>::kPerSm)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, const Shape sh,
                    const float scale, const Rows rs) {
  using L = DqSmem<D, BK, NS, C>;
  constexpr int kBlock = Block<C>::kRowsAll;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* q_s = sm + L::kQ;
  unsigned char* do_s = sm + L::kDo;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + NS;

  const int bh = sh.heads * sh.batch;
  const int h = blockIdx.x % sh.heads, b = (blockIdx.x / sh.heads) % sh.batch;
  const int q0 = (cdiv(sh.sq, kBlock) - 1 - static_cast<int>(blockIdx.x) / bh) * kBlock;
  const int kh = h / (sh.heads / sh.kv_heads);
  int begin, end;
  k_tiles(sh, q0, min(q0 + kBlock, sh.sq), BK, begin, end);
  const int n = end - begin;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_bar, 2 * kBlock * D * 2);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(q_s + c * kBlock * 128, &q_map, q_bar, 64 * c, h, q0, b);
        tma_load_4d(do_s + c * kBlock * 128, &do_map, q_bar, 64 * c, h, q0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % NS;
        if (i >= NS) mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
        const int c0 = (begin + i) * BK;
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sm + L::kK + s * L::kTile + c * BK * 128, &k_map, &full[s], 64 * c, kh, c0,
                      b);
          tma_load_4d(sm + L::kV + s * L::kTile + c * BK * 128, &v_map, &full[s], 64 * c, kh, c0,
                      b);
        }
      }
    }
  } else {
    setmaxnreg_inc<Block<C>::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32, g = lane / 4, t = lane % 4;
    const int r_wg = q0 + cw * kRows;
    const int r_a = r_wg + 16 * warp + g;
    const size_t row_base = (static_cast<size_t>(b) * sh.heads + h) * sh.sq;

    // delta = rowsum(do * o) of rows r_a and r_a + 8, written for dK/dV:
    // each lane of the row's quad takes every fourth 16-byte vector
    float lse2[2], dlt[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r_a + 8 * hr;
      float part = 0.f;
      if (r < sh.sq) {
        const T* orow =
            o + (static_cast<size_t>(b) * sh.sq + r) * rs.o + static_cast<size_t>(h) * D;
        const T* drow =
            dout + (static_cast<size_t>(b) * sh.sq + r) * rs.dout + static_cast<size_t>(h) * D;
#pragma unroll
        for (int c = 8 * t; c < D; c += 32)
          part += dot8<T>(*reinterpret_cast<const int4*>(orow + c),
                          *reinterpret_cast<const int4*>(drow + c));
      }
      part += __shfl_xor_sync(kFull, part, 1);
      part += __shfl_xor_sync(kFull, part, 2);
      dlt[hr] = part;
      lse2[hr] = r < sh.sq ? lse[row_base + r] * kLog2e : 0.f;
      if (t == 0 && r < sh.sq) delta[row_base + r] = part;
    }

    float acc[D / 2], s[BK / 2], dp[BK / 2];
    uint32_t ds[BK / 16][4];
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
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_t<T, BK>(s, kmajor(q_s, kBlock, cw * kRows, kk), kmajor(k_t, BK, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_t<T, BK>(dp, kmajor(do_s, kBlock, cw * kRows, kk), kmajor(v_t, BK, 0, kk), kk);
    };
    auto dq_step = [&](int i) {                   // dQ += round(dS) K_i
      const unsigned char* k_t = sm + L::kK + (i % NS) * L::kTile;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) wgmma_rs_t<T, D>(acc, ds[ks], mnmajor(k_t, BK, ks));
    };
    // tile i's dS = P (dP - delta), fp32, in s
    auto to_ds = [&](int i) {
      const int c0 = (begin + i) * BK;
      // a whole tile's bounds let every score through
      int lo[2] = {0, 0}, hi[2] = {BK, BK};
      if (!whole_tile(sh, r_wg, kRows, c0, BK)) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          row_keys(sh, r_a + 8 * hr, lo[hr], hi[hr]);
          lo[hr] -= c0 + 2 * t;
          hi[hr] -= c0 + 2 * t;
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int hr = (j >> 1) & 1, x = 8 * (j >> 2) + (j & 1);
        const float pr = exp2_ftz(fmaf(s[j], kLog2e, -lse2[hr]));
        s[j] = (x >= lo[hr]) & (x <= hi[hr]) ? pr * (dp[j] - dlt[hr]) : 0.f;
      }
    };
    auto operands_ready = [&]() {                 // as in the forward
      fence_all(s);
      fence_all(dp);
      fence_all(acc);
      fence_all(ds);
      wgmma_fence();
    };

    mbar_wait(q_bar, 0);
    if (n > 0) {
      mbar_wait(&full[0], 0);
      operands_ready();
      s_dp(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(s);
      fence_all(dp);
      to_ds(0);
      to_a<T, BK>(ds, s);
      // step i issues tile i's S and dP beside tile i - 1's dQ product,
      // then forms tile i's dS while the dQ product runs
      for (int i = 1; i < n; ++i) {
        mbar_wait(&full[i % NS], (i / NS) & 1);
        operands_ready();
        s_dp(i);
        wgmma_commit();
        dq_step(i - 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_all(s);
        fence_all(dp);
        to_ds(i);
        wgmma_wait<0>();
        fence_all(acc);
        fence_all(ds);
        release(i - 1);
        to_a<T, BK>(ds, s);
      }
      operands_ready();
      dq_step(n - 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(acc);
      fence_all(ds);
      release(n - 1);
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = cw * kRows + 16 * warp + g + 8 * hr;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(q_s + swizzle128(row, 8 * j + 2 * t, kBlock)) =
            pack2<T>(acc[4 * j + 2 * hr] * scale, acc[4 * j + 2 * hr + 1] * scale);
    }
    named_barrier(1 + cw, 128);
    store_rows<D>(q_s, kBlock, cw * kRows,
                  dq + static_cast<size_t>(b) * sh.sq * rs.dq + static_cast<size_t>(h) * D,
                  rs.dq * 2, r_wg, sh.sq, ct);
  }
}

// ----------------------------------------------------------------------------
// Backward: dK, dV
// ----------------------------------------------------------------------------
template <int D, int BQ, int NS, int C>
struct DkvSmem {
  static constexpr int kBlock = Block<C>::kRowsAll;
  static constexpr int kK = 0;                        // [D / 64][kBlock][128 B]
  static constexpr int kV = kK + kBlock * D * 2;      // the same
  static constexpr int kTile = BQ * D * 2;            // one Q or dO tile
  static constexpr int kQ = kV + kBlock * D * 2;      // [NS] Q tiles
  static constexpr int kDo = kQ + NS * kTile;         // [NS] dO tiles
  static constexpr int kStats = kDo + NS * kTile;     // [NS] lse[BQ], delta[BQ] (fp32)
  static constexpr int kBars = kStats + NS * 2 * BQ * 4;  // kv, full[NS], empty[NS]
  static constexpr int kBytes = kBars + (1 + 2 * NS) * 8 + 1024;
};

template <typename T, int D, int BQ, int NS, int C>
__global__ void __launch_bounds__(Block<C>::kThreads, Block<C>::kPerSm)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, const Shape sh, const Rows rs) {
  using L = DkvSmem<D, BQ, NS, C>;
  constexpr int kBlock = Block<C>::kRowsAll;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* k_s = sm + L::kK;
  unsigned char* v_s = sm + L::kV;
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + NS;

  // block -> (k tile, KV head, batch), the causal k tiles longest first
  const int bh = sh.kv_heads * sh.batch;
  const int kh = blockIdx.x % sh.kv_heads, b = (blockIdx.x / sh.kv_heads) % sh.batch;
  const int k0 = static_cast<int>(blockIdx.x) / bh * kBlock;
  const int group = sh.heads / sh.kv_heads;
  int begin, end;
  q_tiles(sh, k0, min(k0 + kBlock, sh.sk), BQ, begin, end);
  const int per_head = max(end - begin, 0);
  const int n = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);                    // the producer warp's lanes
      mbar_init(&empty[s], 4 * C);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      // lane 0 issues the TMA loads; every lane copies its share of the
      // step's lse and delta rows (a head's rows start anywhere, and a TMA
      // box wants its start 16-byte aligned), then arrives
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_bar, 2 * kBlock * D * 2);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(k_s + c * kBlock * 128, &k_map, kv_bar, 64 * c, kh, k0, b);
          tma_load_4d(v_s + c * kBlock * 128, &v_map, kv_bar, 64 * c, kh, k0, b);
        }
      }
      // every query head of the group, every q tile: one ring, no drain
      for (int i = 0; i < n; ++i) {
        const int s = i % NS;
        const int h = kh * group + i / per_head;
        const int r0 = (begin + i % per_head) * BQ;
        if (i >= NS) mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        float* st = reinterpret_cast<float*>(sm + L::kStats) + s * 2 * BQ;
        const size_t rows = (static_cast<size_t>(b) * sh.heads + h) * sh.sq;
        for (int q = lane; q < BQ; q += 32) {
          const bool in = r0 + q < sh.sq;
          st[q] = in ? lse[rows + r0 + q] : 0.f;
          st[BQ + q] = in ? delta[rows + r0 + q] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(sm + L::kQ + s * L::kTile + c * BQ * 128, &q_map, &full[s], 64 * c, h,
                        r0, b);
            tma_load_4d(sm + L::kDo + s * L::kTile + c * BQ * 128, &do_map, &full[s], 64 * c,
                        h, r0, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<Block<C>::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32, g = lane / 4, t = lane % 4;
    const int k_wg = k0 + cw * kRows;             // this warpgroup's first key
    const int c_a = k_wg + 16 * warp + g;         // this thread's keys c_a, c_a + 8

    float dk_acc[D / 2], dv_acc[D / 2], st[BQ / 2], dpt[BQ / 2];
    uint32_t fr[BQ / 16][4];
    zero(dk_acc);
    zero(dv_acc);
    zero(st);
    zero(dpt);
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % NS]);
    };
    auto operands_ready = [&]() {                 // as in the forward
      fence_all(st);
      fence_all(dpt);
      fence_all(dk_acc);
      fence_all(dv_acc);
      fence_all(fr);
      wgmma_fence();
    };

    mbar_wait(kv_bar, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % NS;
      const int r0 = (begin + i % per_head) * BQ;
      const unsigned char* q_t = sm + L::kQ + s * L::kTile;
      const unsigned char* do_t = sm + L::kDo + s * L::kTile;
      const float* lse_t = reinterpret_cast<const float*>(sm + L::kStats) + s * 2 * BQ;
      const float* delta_t = lse_t + BQ;
      mbar_wait(&full[s], (i / NS) & 1);
      operands_ready();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_t<T, BQ>(st, kmajor(k_s, kBlock, cw * kRows, kk), kmajor(q_t, BQ, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_t<T, BQ>(dpt, kmajor(v_s, kBlock, cw * kRows, kk), kmajor(do_t, BQ, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();                            // and step i - 1's dK product
      fence_all(st);
      fence_all(dpt);
      fence_all(dk_acc);
      fence_all(dv_acc);
      fence_all(fr);
      if (i > 0) release(i - 1);

      // P^T: this thread's keys (rows) against the step's queries (columns
      // r0 + 2t + x, x = 8 (j / 4) + j % 2); a whole tile's bounds let every
      // score through
      int lo[2] = {0, 0}, hi[2] = {BQ, BQ};
      if (!whole_tile(sh, r0, BQ, k_wg, kRows)) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          key_rows(sh, c_a + 8 * hr, lo[hr], hi[hr]);
          lo[hr] -= r0 + 2 * t;
          hi[hr] -= r0 + 2 * t;
        }
      }
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int hr = (j >> 1) & 1, x = 8 * (j >> 2) + (j & 1);
        const float pr = exp2_ftz(fmaf(st[j], kLog2e, -lse_t[x + 2 * t] * kLog2e));
        st[j] = (x >= lo[hr]) & (x <= hi[hr]) ? pr : 0.f;
      }
      to_a<T, BQ>(fr, st);
      operands_ready();
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks)           // dV += round(P^T) dO
        wgmma_rs_t<T, D>(dv_acc, fr[ks], mnmajor(do_t, BQ, ks));
      wgmma_commit();
      // dS^T = P^T (dP^T - delta) while the tensor cores run dV
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j)
        dpt[j] = st[j] * (dpt[j] - delta_t[8 * (j >> 2) + 2 * t + (j & 1)]);
      wgmma_wait<0>();
      fence_all(dv_acc);
      fence_all(fr);
      to_a<T, BQ>(fr, dpt);
      operands_ready();
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks)           // dK += round(dS^T) q
        wgmma_rs_t<T, D>(dk_acc, fr[ks], mnmajor(q_t, BQ, ks));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_all(dk_acc);
    fence_all(fr);
    if (n > 0) release(n - 1);

    // stage dK and dV (rounded once) in this warpgroup's rows of the K and
    // V tiles, which no product reads any more
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = cw * kRows + 16 * warp + g + 8 * hr;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t off = swizzle128(row, 8 * j + 2 * t, kBlock);
        *reinterpret_cast<uint32_t*>(k_s + off) =
            pack2<T>(dk_acc[4 * j + 2 * hr], dk_acc[4 * j + 2 * hr + 1]);
        *reinterpret_cast<uint32_t*>(v_s + off) =
            pack2<T>(dv_acc[4 * j + 2 * hr], dv_acc[4 * j + 2 * hr + 1]);
      }
    }
    named_barrier(1 + cw, 128);
    store_rows<D>(k_s, kBlock, cw * kRows,
                  dk + static_cast<size_t>(b) * sh.sk * rs.dk + static_cast<size_t>(kh) * D,
                  rs.dk * 2, k_wg, sh.sk, ct);
    store_rows<D>(v_s, kBlock, cw * kRows,
                  dv + static_cast<size_t>(b) * sh.sk * rs.dv + static_cast<size_t>(kh) * D,
                  rs.dv * 2, k_wg, sh.sk, ct);
  }
}

// ----------------------------------------------------------------------------
// Launchers
// ----------------------------------------------------------------------------

// What the last launch was, for `dstt_flash_launch_info`.
struct LaunchInfo {
  const void* fn;
  long long grid, threads, smem, block_rows, step_rows, stages, encode_ns;
};
LaunchInfo g_last{};

// TMA needs every row to start on 16 bytes: each stride a multiple of 8
// elements (the wrapper checks the base pointers too).
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

// The 4-D map (D, heads, S, B) of a [B, S, heads, D] operand with row stride
// `rs` elements: a box is 64 columns (128 bytes, swizzled for wgmma) of
// `rows` rows of one head; rows past S read zeros.
template <typename T>
bool encode_rows(CUtensorMap* map, const void* base, int d, int heads, int s, int b,
                 long long rs, int rows) {
  const cuuint64_t s1 = static_cast<cuuint64_t>(s > 0 ? s : 1);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads), s1,
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rs) * 2,
                                 s1 * static_cast<cuuint64_t>(rs) * 2};
  const cuuint32_t box[4] = {64u, 1u, static_cast<cuuint32_t>(rows), 1u};
  const auto type = std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode_tiled(map, type, 4, const_cast<void*>(base), dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B) == CUDA_SUCCESS;
}

template <typename K>
int prepare(K kernel, int smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

inline long long ns_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(std::chrono::steady_clock::now()
                                                              - t0)
      .count();
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, const Shape& sh,
        const Rows& rs, cudaStream_t stream) {
  constexpr int C = Tiles<D>::kFwdC, BK = Tiles<D>::kFwdKeys, NS = Tiles<D>::kFwdStages;
  constexpr int kBlock = Block<C>::kRowsAll;
  if (!rows_aligned(rs)) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long blocks = static_cast<long long>(cdiv(sh.sq, kBlock)) * sh.heads * sh.batch;
  if (blocks == 0) return 0;
  const auto t0 = std::chrono::steady_clock::now();
  CUtensorMap q_map, k_map, v_map;
  if (!encode_rows<T>(&q_map, q, D, sh.heads, sh.sq, sh.batch, rs.q, kBlock)
      || !encode_rows<T>(&k_map, k, D, sh.kv_heads, sh.sk, sh.batch, rs.k, BK)
      || !encode_rows<T>(&v_map, v, D, sh.kv_heads, sh.sk, sh.batch, rs.v, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long encode_ns = ns_since(t0);
  constexpr int smem = FwdSmem<D, BK, NS, C>::kBytes;
  auto kernel = flash_fwd_kernel<T, D, BK, NS, C>;
  if (int rc = prepare(kernel, smem)) return rc;
  kernel<<<static_cast<unsigned>(blocks), Block<C>::kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(o), static_cast<float*>(lse), sh, rs.o);
  g_last = LaunchInfo{reinterpret_cast<const void*>(kernel), blocks, Block<C>::kThreads, smem,
                      kBlock, BK, NS, encode_ns};
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, const Shape& sh, float scale, const Rows& rs,
           cudaStream_t stream) {
  constexpr int C = Tiles<D>::kDqC, BK = Tiles<D>::kDqKeys, NS = Tiles<D>::kDqStages;
  constexpr int kBlock = Block<C>::kRowsAll;
  if (!rows_aligned(rs)) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long blocks = static_cast<long long>(cdiv(sh.sq, kBlock)) * sh.heads * sh.batch;
  if (blocks == 0) return 0;
  const auto t0 = std::chrono::steady_clock::now();
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!encode_rows<T>(&q_map, q, D, sh.heads, sh.sq, sh.batch, rs.q, kBlock)
      || !encode_rows<T>(&do_map, dout, D, sh.heads, sh.sq, sh.batch, rs.dout, kBlock)
      || !encode_rows<T>(&k_map, k, D, sh.kv_heads, sh.sk, sh.batch, rs.k, BK)
      || !encode_rows<T>(&v_map, v, D, sh.kv_heads, sh.sk, sh.batch, rs.v, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long encode_ns = ns_since(t0);
  constexpr int smem = DqSmem<D, BK, NS, C>::kBytes;
  auto kernel = flash_bwd_dq_kernel<T, D, BK, NS, C>;
  if (int rc = prepare(kernel, smem)) return rc;
  kernel<<<static_cast<unsigned>(blocks), Block<C>::kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<T*>(dq), sh, scale,
      rs);
  g_last = LaunchInfo{reinterpret_cast<const void*>(kernel), blocks, Block<C>::kThreads, smem,
                      kBlock, BK, NS, encode_ns};
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, const Shape& sh, const Rows& rs,
            cudaStream_t stream) {
  constexpr int C = Tiles<D>::kDkvC, BQ = Tiles<D>::kDkvRows, NS = Tiles<D>::kDkvStages;
  constexpr int kBlock = Block<C>::kRowsAll;
  if (!rows_aligned(rs)) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long blocks = static_cast<long long>(cdiv(sh.sk, kBlock)) * sh.kv_heads * sh.batch;
  if (blocks == 0) return 0;
  const auto t0 = std::chrono::steady_clock::now();
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!encode_rows<T>(&k_map, k, D, sh.kv_heads, sh.sk, sh.batch, rs.k, kBlock)
      || !encode_rows<T>(&v_map, v, D, sh.kv_heads, sh.sk, sh.batch, rs.v, kBlock)
      || !encode_rows<T>(&q_map, q, D, sh.heads, sh.sq, sh.batch, rs.q, BQ)
      || !encode_rows<T>(&do_map, dout, D, sh.heads, sh.sq, sh.batch, rs.dout, BQ))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long encode_ns = ns_since(t0);
  constexpr int smem = DkvSmem<D, BQ, NS, C>::kBytes;
  auto kernel = flash_bwd_dkv_kernel<T, D, BQ, NS, C>;
  if (int rc = prepare(kernel, smem)) return rc;
  kernel<<<static_cast<unsigned>(blocks), Block<C>::kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), sh, rs);
  g_last = LaunchInfo{reinterpret_cast<const void*>(kernel), blocks, Block<C>::kThreads, smem,
                      kBlock, BQ, NS, encode_ns};
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = bf16, 1 = fp16; head_dim 64 or 128.
#define DSTT_DISPATCH(FN, ...)                                                   \
  do {                                                                           \
    if (heads <= 0 || kv_heads <= 0 || heads % kv_heads)                         \
      return static_cast<int>(cudaErrorInvalidValue);                            \
    if (dtype == 0 && head_dim == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__);  \
    if (dtype == 0 && head_dim == 128) return FN<__nv_bfloat16, 128>(__VA_ARGS__); \
    if (dtype == 1 && head_dim == 64) return FN<__half, 64>(__VA_ARGS__);        \
    if (dtype == 1 && head_dim == 128) return FN<__half, 128>(__VA_ARGS__);      \
    return static_cast<int>(cudaErrorInvalidValue);                              \
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
  const Shape sh{batch, sq, sk, heads, kv_heads, causal, window};
  DSTT_DISPATCH(fwd, q, k, v, o, lse, sh, to_rows(row_strides),
                static_cast<cudaStream_t>(stream));
}

// Writes dq and delta (fp32 [B, H, Sq]) for the dK/dV kernel.
extern "C" int dstt_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq, int batch,
                                 int sq, int sk, int heads, int kv_heads, int causal,
                                 int window, float scale, const long long* row_strides,
                                 void* stream) {
  const Shape sh{batch, sq, sk, heads, kv_heads, causal, window};
  DSTT_DISPATCH(bwd_dq, q, k, v, o, dout, lse, delta, dq, sh, scale, to_rows(row_strides),
                static_cast<cudaStream_t>(stream));
}

extern "C" int dstt_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                  const void* v, const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int batch,
                                  int sq, int sk, int heads, int kv_heads, int causal,
                                  int window, const long long* row_strides,
                                  void* stream) {
  const Shape sh{batch, sq, sk, heads, kv_heads, causal, window};
  DSTT_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, sh, to_rows(row_strides),
                static_cast<cudaStream_t>(stream));
}

// The last launch of this library, for reports: out[0..8] = blocks, threads
// a block, dynamic shared memory (bytes), rows of the block's tile (q rows or
// keys), rows of a step's tile (keys, or q rows for dK/dV), ring stages,
// registers a thread at launch, local memory a thread (bytes: spills), and
// the host ns spent encoding the launch's tensor maps.
extern "C" int dstt_flash_launch_info(long long* out) {
  cudaFuncAttributes attr{};
  if (g_last.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncGetAttributes(&attr, g_last.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vals[9] = {g_last.grid,       g_last.threads,   g_last.smem,
                             g_last.block_rows, g_last.step_rows, g_last.stages,
                             attr.numRegs,      static_cast<long long>(attr.localSizeBytes),
                             g_last.encode_ns};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}
