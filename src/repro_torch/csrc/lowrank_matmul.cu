// Factorized linear y = (x @ V) @ U (+ bias + residual), written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/lowrank_matmul.py::lowrank_matmul,
// the AA-SVD inference GEMM behind every compressed linear.
//
// The TPU kernel keeps the whole (bt x k) fp32 intermediate t = x @ V in VMEM
// and streams U tiles against it.  On Hopper that needs bt·k·4 <= 227 KB of
// shared memory, i.e. at most ~27 token rows at k = 2048, too few to feed the
// tensor cores.  This first version therefore runs TWO launches of one tiled
// GEMM from a single host call:
//
//     t = x @ V        written to device memory in U's dtype (the same rounding
//                      as kernels/ref.py::lowrank_matmul_ref)
//     y = t @ U        with the bias and residual added in fp32 inside the
//                      epilogue, before the one store of y
//
// The round trip of t costs 2·T·k·eb extra bytes; keeping t on chip (split-k
// with a cluster, or a persistent block per row stripe) is a later PR's work.
//
// Bound on an H100: 2·T·k·(n + m) flops against (T·n + n·k + k·m + T·m)·eb bytes.
// At the main path's shapes (T = 4096, n = 4096, k = 1232 / 1792) that is a few
// hundred flops a byte, so the bound is arithmetic and the tensor cores are
// what matter.  Two GEMM bodies, both with fp32 accumulation:
//   bf16 — tensor cores through WMMA (16x16x16 bf16 fragments, fp32
//          accumulators): 128 x 128 block tiles, 8 warps of 64 x 32, 32-deep
//          k steps staged in shared memory with 16-byte loads;
//   fp32 — the FMA units (TF32 stays off for fp32 parity): 64 x 64 block
//          tiles, 16-deep k steps, a 4x4 register micro-tile per thread.
// Neither pipelines its loads (no cp.async / TMA ring) and neither uses
// wgmma; that, and keeping t on chip, is the work of later PRs.
//
// Contract (checked by the Python wrapper, kernels/ops.py::lowrank_matmul):
//   x (T, n), v (n, k), u (k, m), t (T, k) scratch, y (T, m), all contiguous,
//   16-byte aligned and of one dtype; bias (m,) and residual (T, m) of the
//   same dtype or null.  bf16: T, k, m multiples of 128 and n of 32; fp32:
//   T, k, m multiples of 64 and n of 16 (the wrapper zero-pads, which is
//   exact).  Returns cudaGetLastError() after both launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int BM = 64;        // block tile rows
constexpr int BN = 64;        // block tile columns
constexpr int BK = 16;        // contraction depth per shared-memory step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int APAD = 4;       // keeps the transposed A tile off one bank

// ---------------------------------------------------------------------------
// fp32 on the FMA units

// C (M, N) = A (M, K) @ B (K, N) [+ bias (N)] [+ res (M, N)], all fp32.
__global__ void __launch_bounds__(THREADS)
gemm_f32(const float* __restrict__ a, const float* __restrict__ b,
         float* __restrict__ c, const float* __restrict__ bias,
         const float* __restrict__ res, int m, int n, int k) {
  __shared__ __align__(16) float sa[BK][BM + APAD];  // A tile, transposed
  __shared__ __align__(16) float sb[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int q = 0; q < (BM * BK) / THREADS; ++q) {
      const int idx = tid + q * THREADS;
      const int ar = idx / BK;
      const int ac = idx % BK;
      sa[ac][ar] = a[static_cast<size_t>(row0 + ar) * k + k0 + ac];
      const int br = idx / BN;
      const int bc = idx % BN;
      sb[br][bc] = b[static_cast<size_t>(k0 + br) * n + col0 + bc];
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      const size_t o = static_cast<size_t>(r) * n + col;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[col];
      if (res != nullptr) v += res[o];
      c[o] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (WMMA)

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int TM = 128;       // block tile rows
constexpr int TN = 128;       // block tile columns
constexpr int TK = 32;        // contraction depth per shared-memory step
constexpr int TPAD = 8;       // row padding (elements) against bank conflicts
constexpr int FR = 16;        // WMMA fragment edge

// C (M, N) = A (M, K) @ B (K, N) [+ bias (N)] [+ res (M, N)], bf16 in and
// out, fp32 accumulation on the tensor cores.  Warp w owns rows
// (w / 4) * 64 .. +64 and columns (w % 4) * 32 .. +32 of the block tile.
__global__ void __launch_bounds__(THREADS)
gemm_bf16_tc(const bf16* __restrict__ a, const bf16* __restrict__ b,
             bf16* __restrict__ c, const bf16* __restrict__ bias,
             const bf16* __restrict__ res, int m, int n, int k) {
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

  wmma::fragment<wmma::accumulator, FR, FR, FR, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }

  for (int k0 = 0; k0 < k; k0 += TK) {
    // 128 x 32 A tile and 32 x 128 B tile: 512 16-byte vectors each
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int vec = tid + q * THREADS;
      const int ar = vec / (TK / 8);
      const int ac = (vec % (TK / 8)) * 8;
      *reinterpret_cast<uint4*>(&sa[ar][ac]) = *reinterpret_cast<const uint4*>(
          a + static_cast<size_t>(row0 + ar) * k + k0 + ac);
      const int br = vec / (TN / 8);
      const int bc = (vec % (TN / 8)) * 8;
      *reinterpret_cast<uint4*>(&sb[br][bc]) = *reinterpret_cast<const uint4*>(
          b + static_cast<size_t>(k0 + br) * n + col0 + bc);
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

  // epilogue, one 16 x 16 fragment at a time through a per-warp fp32
  // scratch: each lane finishes 8 consecutive outputs of one row
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
      const size_t o = static_cast<size_t>(gr) * n + gc;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float val = sc[r * FR + cb + e];
        if (bias != nullptr) val += __bfloat162float(bias[gc + e]);
        if (res != nullptr) val += __bfloat162float(res[o + e]);
        c[o + e] = __float2bfloat16(val);
      }
      __syncwarp();
    }
  }
}

int lowrank_f32(const void* x, const void* v, const void* u, void* t, void* y,
                const void* bias, const void* res, int rows, int n, int k,
                int m, cudaStream_t s) {
  if (rows % BM != 0 || k % BN != 0 || m % BN != 0 || n % BK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gemm_f32<<<dim3(k / BN, rows / BM), THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(v),
      static_cast<float*>(t), nullptr, nullptr, rows, k, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_f32<<<dim3(m / BN, rows / BM), THREADS, 0, s>>>(
      static_cast<const float*>(t), static_cast<const float*>(u),
      static_cast<float*>(y), static_cast<const float*>(bias),
      static_cast<const float*>(res), rows, m, k);
  return static_cast<int>(cudaGetLastError());
}

int lowrank_bf16(const void* x, const void* v, const void* u, void* t, void* y,
                 const void* bias, const void* res, int rows, int n, int k,
                 int m, cudaStream_t s) {
  if (rows % TM != 0 || k % TN != 0 || m % TN != 0 || n % TK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gemm_bf16_tc<<<dim3(k / TN, rows / TM), THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(v),
      static_cast<bf16*>(t), nullptr, nullptr, rows, k, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_bf16_tc<<<dim3(m / TN, rows / TM), THREADS, 0, s>>>(
      static_cast<const bf16*>(t), static_cast<const bf16*>(u),
      static_cast<bf16*>(y), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(res), rows, m, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (every operand of one call shares it).
extern "C" int lowrank_matmul_launch(const void* x, const void* v,
                                     const void* u, void* t, void* y,
                                     const void* bias, const void* res,
                                     int rows, int n, int k, int m, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return lowrank_f32(x, v, u, t, y, bias, res, rows, n, k, m, s);
  if (dtype == 1) return lowrank_bf16(x, v, u, t, y, bias, res, rows, n, k, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
