// Streaming covariance triple for AA-SVD calibration, written for Hopper (sm_90a).
//
//     xx = Xᵀ X      xxp = Xᵀ X'      xpxp = X'ᵀ X'        X, X': (T, n) token rows
//
// Replaces the Pallas TPU kernel src/repro/kernels/cov_accum.py::cov_accum.
// What it keeps from that kernel: ONE pass over the token stream, every loaded
// tile of X / X' feeding all three products (XLA would issue three GEMMs and
// read X and X' twice each).  What differs: the TPU grid walks T sequentially
// and carries the sum in VMEM; here each block owns one (BI x BI) tile of all
// three outputs and loops over T inside the block, with three fp32 register
// accumulators.  When the output has too few tiles to fill the card's 132 SMs
// (n = 64 gives one tile), T is split across blocks along grid z and the
// partial sums are added into the outputs with atomicAdd -- the summation
// order then changes from run to run (fp32 tolerance, never bitwise).
//
// Bound on an H100: the function needs 2·T·n² flops for xxp plus 2·T·n·(n+1)
// for the distinct halves of the symmetric xx and xpxp (≈ 4·T·n² in all; this
// kernel does 6·T·n², computing both halves), against
// (2·T·n·eb + 3·n²·4) bytes.  At the main path's shapes (T = 4096,
// n = 4096 / 11008) that is ~10^3 flops a byte,
// far above the card's ridge point, so it is bound by arithmetic.  Two
// bodies, both accumulating in fp32:
//   bf16 inputs — tensor cores through WMMA (16x16x16 bf16 fragments, fp32
//     accumulators; bf16 products are exact in fp32).  8 warps; warp w owns
//     a 16 x 32 slice of all three 64 x 64 output tiles; 32-row token tiles
//     of x_i, x_j, xp_i, xp_j staged in shared memory with 16-byte loads;
//   fp32 inputs — the FMA units (TF32 stays off for fp32 parity): a 4x4
//     register micro-tile per thread, 16-row token tiles.
// Neither pipelines its loads nor exploits the symmetry of xx and xpxp;
// wgmma with a TMA ring is the work of later PRs.
//
// Contract (checked by the Python wrapper, kernels/ops.py::cov_accum):
//   x, xp contiguous, 16-byte aligned (T, n), fp32 or bf16, T % 32 == 0,
//   n % BI == 0; outputs contiguous (n, n) fp32;
//   mode 0: out = sum;  mode 1: out += sum;  mode 2: atomicAdd(out, sum)
//   (mode 2 is required whenever splits > 1; the wrapper zero-fills first
//   unless it accumulates into the caller's buffers).
// Returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int BI = 64;        // output tile edge (rows and columns)
constexpr int BT = 16;        // token rows staged per step (fp32 body)
constexpr int BT_TC = 32;     // token rows staged per step (bf16 body)
constexpr int THREADS = 256;  // fp32 body: 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ void put(float* out, size_t o, float v, int mode) {
  if (mode == 2) {
    atomicAdd(out + o, v);
  } else if (mode == 1) {
    out[o] += v;
  } else {
    out[o] = v;
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs on the FMA units

__global__ void __launch_bounds__(THREADS)
cov_accum_f32(const float* __restrict__ x, const float* __restrict__ xp,
              float* __restrict__ xx, float* __restrict__ xxp,
              float* __restrict__ xpxp, int t_rows, int n,
              int rows_per_split, int mode) {
  __shared__ __align__(16) float xi[BT][BI];
  __shared__ __align__(16) float xj[BT][BI];
  __shared__ __align__(16) float pi[BT][BI];
  __shared__ __align__(16) float pj[BT][BI];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = blockIdx.y * BI;
  const int j0 = blockIdx.x * BI;
  const int t_begin = blockIdx.z * rows_per_split;
  const int t_end = min(t_rows, t_begin + rows_per_split);

  float a_xx[4][4], a_xxp[4][4], a_pp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a_xx[i][j] = 0.f;
      a_xxp[i][j] = 0.f;
      a_pp[i][j] = 0.f;
    }
  }

  for (int t0 = t_begin; t0 < t_end; t0 += BT) {
#pragma unroll
    for (int q = 0; q < (BT * BI) / THREADS; ++q) {
      const int idx = tid + q * THREADS;
      const int r = idx / BI;
      const int c = idx % BI;
      const size_t row = static_cast<size_t>(t0 + r) * n;
      xi[r][c] = x[row + i0 + c];
      xj[r][c] = x[row + j0 + c];
      pi[r][c] = xp[row + i0 + c];
      pj[r][c] = xp[row + j0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float4 a4 = *reinterpret_cast<const float4*>(&xi[r][ty * 4]);
      const float4 pa4 = *reinterpret_cast<const float4*>(&pi[r][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&xj[r][tx * 4]);
      const float4 pb4 = *reinterpret_cast<const float4*>(&pj[r][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float pa[4] = {pa4.x, pa4.y, pa4.z, pa4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
      const float pb[4] = {pb4.x, pb4.y, pb4.z, pb4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a_xx[i][j] = fmaf(a[i], b[j], a_xx[i][j]);
          a_xxp[i][j] = fmaf(a[i], pb[j], a_xxp[i][j]);
          a_pp[i][j] = fmaf(pa[i], pb[j], a_pp[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t o = static_cast<size_t>(i0 + ty * 4 + i) * n + (j0 + tx * 4 + j);
      put(xx, o, a_xx[i][j], mode);
      put(xxp, o, a_xxp[i][j], mode);
      put(xpxp, o, a_pp[i][j], mode);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs on the tensor cores (WMMA)

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int FR = 16;        // WMMA fragment edge
constexpr int TPAD = 8;       // row padding (elements) against bank conflicts
constexpr int LD = BI + TPAD;

__global__ void __launch_bounds__(THREADS)
cov_accum_bf16_tc(const bf16* __restrict__ x, const bf16* __restrict__ xp,
                  float* __restrict__ xx, float* __restrict__ xxp,
                  float* __restrict__ xpxp, int t_rows, int n,
                  int rows_per_split, int mode) {
  __shared__ __align__(128) bf16 xi[BT_TC][LD];
  __shared__ __align__(128) bf16 xj[BT_TC][LD];
  __shared__ __align__(128) bf16 pi[BT_TC][LD];
  __shared__ __align__(128) bf16 pj[BT_TC][LD];
  __shared__ __align__(128) float scratch[THREADS / 32][FR * FR];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wrow = (warp / 2) * FR;   // 4 row slices of 16
  const int wcol = (warp % 2) * 32;   // 2 column slices of 32
  const int i0 = blockIdx.y * BI;
  const int j0 = blockIdx.x * BI;
  const int t_begin = blockIdx.z * rows_per_split;
  const int t_end = min(t_rows, t_begin + rows_per_split);

  // acc[0] = xx, acc[1] = xxp, acc[2] = xpxp; two 16 x 16 column fragments
  wmma::fragment<wmma::accumulator, FR, FR, FR, float> acc[3][2];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    wmma::fill_fragment(acc[q][0], 0.0f);
    wmma::fill_fragment(acc[q][1], 0.0f);
  }

  // one 16-byte vector per thread per tile: 32 rows x 8 vectors of 8
  const int lr = tid / (BI / 8);
  const int lc = (tid % (BI / 8)) * 8;
  for (int t0 = t_begin; t0 < t_end; t0 += BT_TC) {
    const size_t row = static_cast<size_t>(t0 + lr) * n;
    *reinterpret_cast<uint4*>(&xi[lr][lc]) =
        *reinterpret_cast<const uint4*>(x + row + i0 + lc);
    *reinterpret_cast<uint4*>(&xj[lr][lc]) =
        *reinterpret_cast<const uint4*>(x + row + j0 + lc);
    *reinterpret_cast<uint4*>(&pi[lr][lc]) =
        *reinterpret_cast<const uint4*>(xp + row + i0 + lc);
    *reinterpret_cast<uint4*>(&pj[lr][lc]) =
        *reinterpret_cast<const uint4*>(xp + row + j0 + lc);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BT_TC; kk += FR) {
      // A = X_iᵀ: element (i, t) sits at xi[t][i], i.e. column-major
      wmma::fragment<wmma::matrix_a, FR, FR, FR, bf16, wmma::col_major> ax, ap;
      wmma::load_matrix_sync(ax, &xi[kk][wrow], LD);
      wmma::load_matrix_sync(ap, &pi[kk][wrow], LD);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        wmma::fragment<wmma::matrix_b, FR, FR, FR, bf16, wmma::row_major> bx, bp;
        wmma::load_matrix_sync(bx, &xj[kk][wcol + c * FR], LD);
        wmma::load_matrix_sync(bp, &pj[kk][wcol + c * FR], LD);
        wmma::mma_sync(acc[0][c], ax, bx, acc[0][c]);
        wmma::mma_sync(acc[1][c], ax, bp, acc[1][c]);
        wmma::mma_sync(acc[2][c], ap, bp, acc[2][c]);
      }
    }
    __syncthreads();
  }

  // epilogue through a per-warp fp32 scratch: each lane finishes 8
  // consecutive entries of one row of each fragment
  float* sc = scratch[warp];
  float* outs[3] = {xx, xxp, xpxp};
  const int r = lane / 2;
  const int cb = (lane % 2) * 8;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      wmma::store_matrix_sync(sc, acc[q][c], FR, wmma::mem_row_major);
      __syncwarp();
      const size_t o = static_cast<size_t>(i0 + wrow + r) * n + j0 + wcol +
                       c * FR + cb;
#pragma unroll
      for (int e = 0; e < 8; ++e) put(outs[q], o + e, sc[r * FR + cb + e], mode);
      __syncwarp();
    }
  }
}

}  // namespace

// dtype: 0 = fp32 inputs, 1 = bf16 inputs.  Outputs are always fp32.
extern "C" int cov_accum_launch(const void* x, const void* xp, void* xx,
                                void* xxp, void* xpxp, int t_rows, int n,
                                int splits, int rows_per_split, int mode,
                                int dtype, void* stream) {
  if (t_rows % BT_TC != 0 || n % BI != 0 || rows_per_split % BT_TC != 0 ||
      splits < 1 || (splits > 1 && mode != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n / BI, n / BI, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    cov_accum_f32<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(xp),
        static_cast<float*>(xx), static_cast<float*>(xxp),
        static_cast<float*>(xpxp), t_rows, n, rows_per_split, mode);
  } else if (dtype == 1) {
    cov_accum_bf16_tc<<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(xp),
        static_cast<float*>(xx), static_cast<float*>(xxp),
        static_cast<float*>(xpxp), t_rows, n, rows_per_split, mode);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
