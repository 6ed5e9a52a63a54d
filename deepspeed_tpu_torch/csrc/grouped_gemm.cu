// Grouped (ragged) expert GEMM for Hopper (sm_90a) and both of its
// gradients, bf16 in, fp32 accumulators, bf16 out.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/grouped_gemm.py:
//
//   `_gmm_kernel` (pallas_call in `_gmm_fwd_kernel_call`), the forward
//       out[start_e:end_e] = lhs[start_e:end_e] @ rhs[e],   e = 0 .. E-1;
//   `_gmm_dlhs_kernel` (pallas_call in `_gmm_dlhs_kernel_call`)
//       dlhs[start_e:end_e] = dout[start_e:end_e] @ rhs[e]^T;
//   `_gmm_drhs_kernel` (pallas_call in `_gmm_drhs_kernel_call`), the "tgmm"
//       drhs[e] = lhs[start_e:end_e]^T @ dout[start_e:end_e],
//
// where start/end are the running offsets of group_sizes [E] (int32, on the
// device: token routing decides them).  Rows of out and dlhs past
// sum(group_sizes) are zeros; an empty group's drhs is zeros.  No output
// element is left unwritten, so the wrappers allocate with torch.empty.
//
// Forward and dlhs: one kernel, `gmm_kernel<BM, kBT>`, computing
// C[M, N] = A[M, K] @ B_g per row group, with B_g = rhs[g] [K, N] (the
// forward) or B_g = rhs[g]^T, rhs[g] [N, K] (kBT: dlhs, where A = dout, K
// is the forward's N and N the forward's K).  Work units, as the TPU
// kernel enumerates them (`make_group_metadata`): the grid is static,
// W = ceil(M / BM) + E - 1 units by N / 128 n-tiles, so nothing is read
// back to the host.  Every block derives its unit from group_sizes itself
// (an O(E) scan, E = 8 for Mixtral): unit w is the (group, m-tile) pair of
// rank w among the m-tiles each non-empty group touches, in group order.  A
// boundary m-tile shared by two groups is visited once per group, and each
// visit writes only its group's rows, so every output row is written by
// exactly one unit: a row of group e by e's unit; the rows of the last
// touched tile past sum(group_sizes) by the last valid unit (as zeros);
// each m-tile wholly past the sum by one of the units left over (there are
// at least as many spare units as such tiles), as zeros.  Any M: rows past
// M are loaded as zeros and never written, so the ragged edge needs no
// fallback (the TPU path sends an M that is not a multiple of its tile to
// the dense reference; that is a TPU rule).  The TPU dlhs kernel carries
// its sum over n-tiles in VMEM scratch across grid steps; here the
// reduction over the forward's N is the k loop inside the block.
//
// What bounds them on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at a decode
// step the expert weights (a Mixtral-8x7B gate projection reads 0.94 GB for
// 16 rows); at training sizes (M = 8192 routed rows) the tensor cores: a
// 4096 x 14336 expert product is 0.96 TFLOP (0.97 ms) against 1.24 GB of
// operands (0.37 ms).  So each group's weight slice must come from device
// memory once per n-tile, not once per m-tile: blockIdx.x is the unit and
// blockIdx.y the n-tile, so the units of one group at one n-tile run side
// by side and share the slice through the 50 MB L2.  A decode-sized M takes
// 16-row m-tiles (BM = 16: W = E units, each streaming one group's 128
// columns) and larger M 64-row tiles (BM = 64).  A 4-stage cp.async ring
// keeps three k-steps of copies in flight behind the tensor cores, which
// multiply by mma.sync m16n8k16 with operands from ldmatrix: .trans for
// the forward's [K, N] weight tile, plain for dlhs's [N, K] one (mma's
// column-major B is rhs[g] read along the forward's N).
//
// drhs: the TPU kernel walks the work units in order and accumulates a
// group's units in a VMEM scratch, flushing at the group's last unit.
// Blocks here run in no order, so the walk moves inside the block: one
// block per (64-row K-tile, 128-column N-tile, group), which finds its
// group's [start, end) from group_sizes, walks those rows in 32-row chunks
// (rows outside the group load as zeros), and writes its tile once; an
// empty group walks nothing and writes zeros.  No atomics, no second pass.
// lhs^T comes from ldmatrix.trans of the [rows, K] tile.  blockIdx.x is the
// K-tile, so the blocks of one group and N-tile run side by side: they share
// the group's dout columns, and the group's lhs rows stay in L2 across
// N-tiles.  Load balance across groups of unequal size is later work, as
// are TMA, wgmma and split-K.
//
// Shapes (the wrappers check them): lhs bf16 [M, K], rhs bf16 [E, K, N]
// (N contiguous, the Flax layout), dout bf16 [M, N], group_sizes int32 [E],
// all contiguous; K % 8 == 0 and N % 8 == 0 (16-byte vectors; the edges in
// K and N are masked).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kBN = 128;               // columns of an n-tile
constexpr int kBK = 32;                // depth of one k step
constexpr int kStages = 4;             // cp.async ring depth
constexpr int kLDA = kBK + 8;          // smem row strides in elements: the
constexpr int kLDB = kBN + 8;          // 16 bytes of padding keep ldmatrix
constexpr int kLDBT = kBK + 8;         // free of bank conflicts
constexpr int kDM = 64;                // drhs: K rows of an output tile
constexpr int kLDD = kDM + 8;

// What one work unit does: its group and m-tile, the rows it writes with
// the product [lo, hi), and the rows it writes as zeros [zlo, zhi).
struct Unit {
  int group, m_tile, lo, hi, zlo, zhi;
};

template <int BM>
__device__ __forceinline__ Unit find_unit(const int* __restrict__ group_sizes,
                                          int e_count, int m, int w) {
  Unit u{-1, 0, 0, 0, 0, 0};
  int start = 0, work = 0;
  for (int e = 0; e < e_count; ++e) {
    const int end = min(start + max(group_sizes[e], 0), m);
    if (end > start) {
      const int first = start / BM;
      const int tiles = (end - 1) / BM - first + 1;
      if (u.group < 0 && w < work + tiles) {
        u.group = e;
        u.m_tile = first + (w - work);
        u.lo = start;
        u.hi = end;
      }
      work += tiles;
    }
    start = end;
  }
  const int total = start;                       // rows that belong to a group
  if (u.group >= 0) {
    if (w == work - 1) {                         // the last valid unit
      u.zlo = total;
      u.zhi = min(m, (u.m_tile + 1) * BM);
    }
  } else {
    // spare unit w - work zeros the m-tile of that rank past the sum
    u.m_tile = (total + BM - 1) / BM + (w - work);
    u.zlo = u.m_tile * BM;
    u.zhi = min(m, u.zlo + BM);
  }
  return u;
}

// C[M, N] = A[M, K] @ B_g per row group; B_g = rhs[g] [K, N], or with kBT
// rhs[g]^T where rhs[g] is [N, K]
template <int BM, bool kBT>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const __nv_bfloat16* __restrict__ lhs, const __nv_bfloat16* __restrict__ rhs,
           const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ out,
           int m, int k, int n, int e_count) {
  constexpr int WM = BM / 16;                  // warps along M
  constexpr int WN = 4 / WM;                   // warps along N
  constexpr int MF = BM / (16 * WM);           // m16 fragments a warp holds
  constexpr int NF = kBN / (8 * WN);           // n8 fragments a warp holds
  constexpr int kBStage = kBT ? kBN * kLDBT : kBK * kLDB;
  static_assert(WM * WN == 4 && MF == 1 && NF % 2 == 0, "warp layout");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);    // [stages][BM][kLDA]
  __nv_bfloat16* b_s = a_s + kStages * BM * kLDA;  // [stages][kBK][kLDB] or [kBN][kLDBT]

  const Unit u = find_unit<BM>(group_sizes, e_count, m, blockIdx.x);
  const int n0 = blockIdx.y * kBN;
  const int m0 = u.m_tile * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int row_base = m0 + wm * 16 + g;        // this lane's rows: +0, +8
  const int col_base = n0 + wn * (NF * 8) + 2 * t;

  float acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (u.group >= 0) {
    const __nv_bfloat16* b_g = rhs + static_cast<size_t>(u.group) * k * n;
    const int k_steps = (k + kBK - 1) / kBK;
    // copies of k step `ks` into ring slot `slot`: BM x 32 of A and the
    // 32 x 128 block of the group's B_g, zero-filled past M, K and N
    auto load = [&](int ks, int slot) {
      const int k0 = ks * kBK;
      __nv_bfloat16* as = a_s + slot * BM * kLDA;
      __nv_bfloat16* bs = b_s + slot * kBStage;
      for (int i = threadIdx.x; i < BM * (kBK / 8); i += kThreads) {
        const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
        const bool ok = m0 + r < m && k0 + c < k;
        cp_async16(as + r * kLDA + c,
                   ok ? lhs + static_cast<size_t>(m0 + r) * k + k0 + c : lhs, ok);
      }
      if constexpr (kBT) {                      // rows of rhs[g] are N, K contiguous
#pragma unroll
        for (int i = threadIdx.x; i < kBN * (kBK / 8); i += kThreads) {
          const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
          const bool ok = n0 + r < n && k0 + c < k;
          cp_async16(bs + r * kLDBT + c,
                     ok ? b_g + static_cast<size_t>(n0 + r) * k + k0 + c : b_g, ok);
        }
      } else {                                  // rows of rhs[g] are K, N contiguous
#pragma unroll
        for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
          const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
          const bool ok = k0 + r < k && n0 + c < n;
          cp_async16(bs + r * kLDB + c,
                     ok ? b_g + static_cast<size_t>(k0 + r) * n + n0 + c : b_g, ok);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < k_steps) load(s, s);
      cp_async_commit();                        // empty groups keep the count
    }
    for (int ks = 0; ks < k_steps; ++ks) {
      cp_async_wait<kStages - 2>();             // this thread's copies of step ks
      __syncthreads();                          // everyone's; step ks-1 is consumed
      if (ks + kStages - 1 < k_steps) load(ks + kStages - 1, (ks + kStages - 1) % kStages);
      cp_async_commit();
      const __nv_bfloat16* as = a_s + (ks % kStages) * BM * kLDA + wm * 16 * kLDA;
      const __nv_bfloat16* bs = b_s + (ks % kStages) * kBStage
                                + wn * (NF * 8) * (kBT ? kLDBT : 1);
#pragma unroll
      for (int k0 = 0; k0 < kBK; k0 += 16) {
        uint32_t af[4];
        ldsm_x4(af, as + (lane % 16) * kLDA + k0 + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < NF; j += 2) {
          uint32_t bf[4];
          if constexpr (kBT)
            ldsm_x4(bf, bs + (j * 8 + (lane / 16) * 8 + lane % 8) * kLDBT + k0
                            + ((lane / 8) % 2) * 8);
          else
            ldsm_x4_trans(bf, bs + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * kLDB
                                  + j * 8 + (lane / 16) * 8);
          mma16816(acc[j], af, bf[0], bf[1]);
          mma16816(acc[j + 1], af, bf[2], bf[3]);
        }
      }
    }
    cp_async_wait<0>();
  }

  // each row goes out once: the product for the unit's group rows, zeros
  // for the rows it owns past the groups, nothing for the rest
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row_base + 8 * i;
    const bool prod = r >= u.lo && r < u.hi;
    if (!prod && !(r >= u.zlo && r < u.zhi)) continue;
    __nv_bfloat16* orow = out + static_cast<size_t>(r) * n;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int c = col_base + 8 * j;
      if (c >= n) continue;
      const __nv_bfloat162 v = prod ? __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1])
                                    : __floats2bfloat162_rn(0.f, 0.f);
      *reinterpret_cast<__nv_bfloat162*>(orow + c) = v;
    }
  }
}

// drhs[e][K, N] = lhs[start_e:end_e]^T @ dout[start_e:end_e]; one block per
// (K-tile, N-tile, group); each warp holds 16 rows of K by 128 columns
__global__ void __launch_bounds__(kThreads)
gmm_drhs_kernel(const __nv_bfloat16* __restrict__ lhs, const __nv_bfloat16* __restrict__ dout,
                const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ out,
                int m, int k, int n) {
  constexpr int NF = kBN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);    // [stages][kBK][kLDD]
  __nv_bfloat16* b_s = a_s + kStages * kBK * kLDD;                 // [stages][kBK][kLDB]

  const int e = blockIdx.z;
  int start = 0;
  for (int i = 0; i < e; ++i) start = min(start + max(group_sizes[i], 0), m);
  const int end = min(start + max(group_sizes[blockIdx.z], 0), m);
  const int k0 = blockIdx.x * kDM, n0 = blockIdx.y * kBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  float acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int steps = (end - start + kBK - 1) / kBK;   // 0 for an empty group
  // copies of row chunk `s` into ring slot `slot`: 32 rows x 64 of lhs and
  // 32 rows x 128 of dout, zero-filled past the group's rows, K and N
  auto load = [&](int s, int slot) {
    const int r0 = start + s * kBK;
    __nv_bfloat16* as = a_s + slot * kBK * kLDD;
    __nv_bfloat16* bs = b_s + slot * kBK * kLDB;
#pragma unroll
    for (int i = threadIdx.x; i < kBK * (kDM / 8); i += kThreads) {
      const int r = i / (kDM / 8), c = (i % (kDM / 8)) * 8;
      const bool ok = r0 + r < end && k0 + c < k;
      cp_async16(as + r * kLDD + c,
                 ok ? lhs + static_cast<size_t>(r0 + r) * k + k0 + c : lhs, ok);
    }
#pragma unroll
    for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const bool ok = r0 + r < end && n0 + c < n;
      cp_async16(bs + r * kLDB + c,
                 ok ? dout + static_cast<size_t>(r0 + r) * n + n0 + c : dout, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < steps) load(s + kStages - 1, (s + kStages - 1) % kStages);
    cp_async_commit();
    const __nv_bfloat16* as = a_s + (s % kStages) * kBK * kLDD + warp * 16;
    const __nv_bfloat16* bs = b_s + (s % kStages) * kBK * kLDB;
#pragma unroll
    for (int r0 = 0; r0 < kBK; r0 += 16) {
      // A = lhs^T: the [rows, K] tile read transposed
      uint32_t af[4];
      ldsm_x4_trans(af, as + (r0 + lane % 8 + (lane / 16) * 8) * kLDD + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int j = 0; j < NF; j += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, bs + (r0 + lane % 8 + ((lane / 8) % 2) * 8) * kLDB + j * 8
                              + (lane / 16) * 8);
        mma16816(acc[j], af, bf[0], bf[1]);
        mma16816(acc[j + 1], af, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* out_e = out + static_cast<size_t>(e) * k * n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = k0 + warp * 16 + g + 8 * i;
    if (r >= k) continue;
    __nv_bfloat16* orow = out_e + static_cast<size_t>(r) * n;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      if (c >= n) continue;
      *reinterpret_cast<__nv_bfloat162*>(orow + c) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int BM, bool kBT>
int launch(const void* lhs, const void* rhs, const void* group_sizes, void* out, int m,
           int k, int n, int e_count, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kStages)
                      * (BM * kLDA + (kBT ? kBN * kLDBT : kBK * kLDB))
                      * sizeof(__nv_bfloat16);
  auto kernel = gmm_kernel<BM, kBT>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + BM - 1) / BM + e_count - 1, (n + kBN - 1) / kBN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(lhs), static_cast<const __nv_bfloat16*>(rhs),
      static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(out), m, k, n,
      e_count);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBT>
int launch_tiled(const void* a, const void* rhs, const void* group_sizes, void* out, int m,
                 int k, int n, int e_count, int tile_m, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || e_count <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (tile_m == 16) return launch<16, kBT>(a, rhs, group_sizes, out, m, k, n, e_count, s);
  if (tile_m == 64) return launch<64, kBT>(a, rhs, group_sizes, out, m, k, n, e_count, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The forward: lhs [M, K], rhs [E, K, N] -> out [M, N].  tile_m: 16 or 64
// rows an m-tile.  Return: the CUDA error code (0 ok).
extern "C" int dstt_grouped_gemm_bf16(const void* lhs, const void* rhs,
                                      const void* group_sizes, void* out, int m, int k,
                                      int n, int e_count, int tile_m, void* stream) {
  return launch_tiled<false>(lhs, rhs, group_sizes, out, m, k, n, e_count, tile_m, stream);
}

// dlhs: dout [M, N], rhs [E, K, N] -> dlhs [M, K] (the forward's K and N).
extern "C" int dstt_grouped_gemm_dlhs_bf16(const void* dout, const void* rhs,
                                           const void* group_sizes, void* dlhs, int m,
                                           int k, int n, int e_count, int tile_m,
                                           void* stream) {
  return launch_tiled<true>(dout, rhs, group_sizes, dlhs, m, n, k, e_count, tile_m, stream);
}

// drhs: lhs [M, K], dout [M, N] -> drhs [E, K, N].  M may be 0 (every
// group empty: zeros).
extern "C" int dstt_grouped_gemm_drhs_bf16(const void* lhs, const void* dout,
                                           const void* group_sizes, void* drhs, int m,
                                           int k, int n, int e_count, void* stream) {
  if (m < 0 || k <= 0 || n <= 0 || e_count <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kStages) * kBK * (kLDD + kLDB)
                      * sizeof(__nv_bfloat16);
  const cudaError_t err = set_smem(gmm_drhs_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((k + kDM - 1) / kDM, (n + kBN - 1) / kBN, e_count);
  gmm_drhs_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(lhs), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(drhs), m, k, n);
  return static_cast<int>(cudaGetLastError());
}
