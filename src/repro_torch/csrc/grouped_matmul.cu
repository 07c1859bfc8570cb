// Grouped (ragged) expert GEMM y[i] = x[i] @ W[g(i)], written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_matmul.py::grouped_matmul,
// the expert GEMM of the drop-free MoE dispatch: the T·k routed rows are sorted by
// expert, so expert e owns the contiguous row segment [offs[e], offs[e+1]) of x.
//
// The TPU kernel walks a static list of M/bm + E - 1 (row block x expert) tiles
// built from the group sizes ahead of the grid (scalar prefetch), revisiting a row
// block once per expert it touches while the output block stays resident in VMEM.
// Hopper has no sequential grid to carry a resident block through, so this kernel
// is laid out the other way round:
//
//   grid = (f / BN column tiles, M / BM row tiles), every block independent;
//   a block reads the E + 1 segment offsets (an exclusive cumsum of the group
//   sizes, made on the device: nothing about the routing reaches the host),
//   binary-searches the first segment that overlaps its rows, and for each
//   segment that does accumulates (its rows of x, the others masked to zero)
//   @ W[g] into ONE set of fp32 accumulators, looping over d in K-chunks;
//   it writes its tile once.
//
// A row's output is the product of its row with its own expert's columns,
// contracted over d in a fixed order; the masked visits of other experts add
// exact zeros.  So a row does not depend on which rows share its tile, and the
// drop-free layer stays batch-size invariant on the card.  Empty segments are
// skipped; rows past sum(group sizes) belong to no segment and come out zero (as
// jax.lax.ragged_dot gives them); segment ends are clamped to M.
//
// Bound on an H100: 2·M·d·f flops against (M·d + E·d·f + M·f)·eb bytes.  At the
// main path's shapes (M = 24,576 routed rows, d, f in {2048, 1408, 504}) the
// weight bank is read once per row tile in the worst case and the bound is bytes
// or close to it.  Two bodies, both with fp32 accumulation:
//   bf16 — tensor cores through WMMA (16x16x16 bf16 fragments, fp32 accumulators):
//          128 x 128 block tiles, 8 warps of 64 x 32, 32-deep K steps staged in
//          shared memory with 16-byte loads;
//   fp32 — the FMA units (TF32 stays off): 64 x 64 block tiles, 16-deep K steps,
//          a 4x4 register micro-tile per thread.
// A block straddling s segments runs s K-loops (at most M/BM + E - 1 block
// visits in all, as on the TPU).  No load pipeline and no wgmma / TMA: later work.
//
// Contract (checked by the Python wrapper, kernels/ops.py::grouped_matmul): x (M, d),
// w (E, d, f), y (M, f) contiguous, 16-byte aligned, one dtype; d and f multiples
// of 8 (the wrapper zero-pads, which is exact); offs (E + 1,) int32 on the device,
// non-decreasing, offs[0] = 0.  Returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int THREADS = 256;

// smallest g in [0, e) whose segment ends past row r0, or e when none does
__device__ __forceinline__ int first_segment(const int* __restrict__ offs, int e, int r0) {
  int lo = 0;
  int hi = e;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (offs[mid + 1] > r0) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// ---------------------------------------------------------------------------
// fp32 on the FMA units

constexpr int BM = 64;   // block tile rows
constexpr int BN = 64;   // block tile columns
constexpr int BK = 16;   // K depth per shared-memory step
constexpr int APAD = 4;  // keeps the transposed A tile off one bank

__global__ void __launch_bounds__(THREADS)
grouped_f32(const float* __restrict__ x, const float* __restrict__ w,
            const int* __restrict__ offs, float* __restrict__ y, int m, int d, int f,
            int e) {
  __shared__ __align__(16) float sa[BK][BM + APAD];  // x tile, transposed
  __shared__ __align__(16) float sb[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int row_end = min(row0 + BM, m);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int g = first_segment(offs, e, row0); g < e; ++g) {
    const int seg_lo = offs[g];
    if (seg_lo >= row_end) break;
    const int lo = max(seg_lo, row0);
    const int hi = min(offs[g + 1], row_end);
    if (lo >= hi) continue;  // empty segment
    const float* wg = w + static_cast<size_t>(g) * d * f;
    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
      for (int q = 0; q < (BM * BK) / THREADS; ++q) {
        const int idx = tid + q * THREADS;
        const int ar = idx / BK;
        const int ac = idx % BK;
        const int r = row0 + ar;
        float av = 0.f;
        if (r >= lo && r < hi && k0 + ac < d) av = x[static_cast<size_t>(r) * d + k0 + ac];
        sa[ac][ar] = av;
        const int br = idx / BN;
        const int bc = idx % BN;
        float bv = 0.f;
        if (k0 + br < d && col0 + bc < f) bv = wg[static_cast<size_t>(k0 + br) * f + col0 + bc];
        sb[br][bc] = bv;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(&sa[kk][ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&sb[kk][tx * 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < f) y[static_cast<size_t>(r) * f + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (WMMA)

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int TM = 128;  // block tile rows
constexpr int TN = 128;  // block tile columns
constexpr int TK = 32;   // K depth per shared-memory step
constexpr int TPAD = 8;  // row padding (elements) against bank conflicts
constexpr int FR = 16;   // WMMA fragment edge

// Warp w owns rows (w / 4) * 64 .. +64 and columns (w % 4) * 32 .. +32 of the tile.
__global__ void __launch_bounds__(THREADS)
grouped_bf16_tc(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const int* __restrict__ offs, bf16* __restrict__ y, int m, int d, int f,
                int e) {
  __shared__ __align__(128) bf16 sa[TM][TK + TPAD];
  __shared__ __align__(128) bf16 sb[TK][TN + TPAD];
  __shared__ __align__(128) float scratch[THREADS / 32][FR * FR];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wrow = (warp / 4) * 64;
  const int wcol = (warp % 4) * 32;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;
  const int row_end = min(row0 + TM, m);

  wmma::fragment<wmma::accumulator, FR, FR, FR, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int g = first_segment(offs, e, row0); g < e; ++g) {
    const int seg_lo = offs[g];
    if (seg_lo >= row_end) break;
    const int lo = max(seg_lo, row0);
    const int hi = min(offs[g + 1], row_end);
    if (lo >= hi) continue;  // empty segment
    const bf16* wg = w + static_cast<size_t>(g) * d * f;
    for (int k0 = 0; k0 < d; k0 += TK) {
      // 128 x 32 x tile and 32 x 128 w tile: 512 16-byte vectors each; d and f
      // are multiples of 8, so a vector is wholly inside or wholly outside
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int vec = tid + q * THREADS;
        const int ar = vec / (TK / 8);
        const int ac = (vec % (TK / 8)) * 8;
        const int r = row0 + ar;
        uint4 av = zero;
        if (r >= lo && r < hi && k0 + ac < d) {
          av = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * d + k0 + ac);
        }
        *reinterpret_cast<uint4*>(&sa[ar][ac]) = av;
        const int br = vec / (TN / 8);
        const int bc = (vec % (TN / 8)) * 8;
        uint4 bv = zero;
        if (k0 + br < d && col0 + bc < f) {
          bv = *reinterpret_cast<const uint4*>(wg + static_cast<size_t>(k0 + br) * f + col0 +
                                               bc);
        }
        *reinterpret_cast<uint4*>(&sb[br][bc]) = bv;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; kk += FR) {
        wmma::fragment<wmma::matrix_a, FR, FR, FR, bf16, wmma::row_major> fa[4];
        wmma::fragment<wmma::matrix_b, FR, FR, FR, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wmma::load_matrix_sync(fa[i], &sa[wrow + i * FR][kk], TK + TPAD);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::load_matrix_sync(fb[j], &sb[kk][wcol + j * FR], TN + TPAD);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  // epilogue, one 16 x 16 fragment at a time through a per-warp fp32 scratch:
  // each lane rounds 8 consecutive outputs of one row and stores them as one
  // 16-byte vector
  float* sc = scratch[warp];
  const int r = lane / 2;
  const int cb = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], FR, wmma::mem_row_major);
      __syncwarp();
      const int gr = row0 + wrow + i * FR + r;
      const int gc = col0 + wcol + j * FR + cb;
      if (gr < m && gc < f) {
        __align__(16) bf16 out[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) out[k] = __float2bfloat16(sc[r * FR + cb + k]);
        *reinterpret_cast<uint4*>(y + static_cast<size_t>(gr) * f + gc) =
            *reinterpret_cast<const uint4*>(out);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, w and y share it).
extern "C" int grouped_matmul_launch(const void* x, const void* w, const void* offs, void* y,
                                     int m, int d, int f, int e, int dtype, void* stream) {
  if (m <= 0 || d <= 0 || f <= 0 || e <= 0 || d % 8 != 0 || f % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    grouped_f32<<<grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                         static_cast<const float*>(w),
                                         static_cast<const int*>(offs), static_cast<float*>(y),
                                         m, d, f, e);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1) {
    const dim3 grid((f + TN - 1) / TN, (m + TM - 1) / TM);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    grouped_bf16_tc<<<grid, THREADS, 0, s>>>(static_cast<const bf16*>(x),
                                             static_cast<const bf16*>(w),
                                             static_cast<const int*>(offs), static_cast<bf16*>(y),
                                             m, d, f, e);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
