// Blockwise online-softmax attention (flash), written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// and computes what the JAX model path computes (src/repro/models/attention.py:31,
// the kernel's own oracle): scores q·kᵀ with fp32 accumulation times 1/√D at the
// TRUE head dim, an optional soft cap tanh(s/c)·c, causal / sliding-window /
// key-padding masks against absolute positions (a scalar query offset or one per
// slot), masked scores -1e30, running (max, denominator, accumulator) in fp32, and
// the probabilities cast to v's dtype before the PV product.  The Pallas kernel
// instead scales q first and multiplies in fp32 throughout; this one keeps the
// model path's rounding, which is what the port's callers are held to.
//
// Layouts are the model's, read in place: q, o (B, Lq, H, D) and k, v (B, Lk, KV, D)
// contiguous; query head h reads KV head h / (H / KV) (GQA).
//
// Bound on an H100: 4·B·H·Lq·Lk_live·D flops against (q + k + v + o) bytes.  Prefill
// (Lq = Lk = 1024, D = 128) is above the card's ~295 flops a byte in bf16, so the
// tensor cores matter there; one-token decode (Lq = 1) reads the whole cache for
// 4·Lk·D flops a head and is bound by bytes.
//
// Design: one block of 4 warps per (batch·head, 64 query rows) loops over 64-key
// tiles of its KV head staged in shared memory:
//   S = Q Kᵀ    bf16: WMMA on the tensor cores (16x16x16 fragments, fp32
//               accumulators), each warp 16 query rows; fp32: FMA units, each
//               thread an 8 x 4 micro-tile (TF32 stays off)
//   softmax     two threads a row: scale, cap, mask, running max / sum in fp32,
//               p written in v's dtype, the row of O rescaled by exp(m_old - m_new)
//   O += P V    bf16: WMMA accumulating onto the fp32 O tile loaded from shared
//               memory; fp32: FMA, each thread 8 rows x D/16 columns
// Key tiles wholly past the causal limit of the block's last row, or wholly before
// the window of its first row, are skipped; that is exact (their weights are 0, or
// are zeroed by the correction factor once a live key arrives).  Rows and keys past
// Lq / Lk load as zeros; keys past Lk are masked, rows past Lq are not stored.  A
// row wholly masked in one tile takes m = -1e30 there and exp(-1e30 - m_new) = 0
// clears what it gathered once a live key arrives, as in the reference.  Nothing
// is pipelined (no cp.async / TMA ring) and one-row decode blocks use 1/64 of their
// tile; a split-K decode path and wgmma are later work.
//
// Contract (checked by the wrapper, kernels/ops.py::flash_attention): q, k, v, o of
// one dtype, contiguous, 16-byte aligned; D one of 16, 32, 64, 128, 192 (the wrapper
// zero-pads the head dim and passes the scale of the true one; 192 is MLA prefill's
// qk_nope 128 + qk_rope 64, with v zero-padded to it); q_off null (every
// slot at q_off0) or a (B,) int32 device vector.  Returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // query rows per block
constexpr int BKEY = 64;      // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int FR = 16;        // WMMA fragment edge
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_off;  // (B,) or null
  int q_off0;
  int b, lq, lk, h, kv;
  int causal, window;
  float scale, softcap;
};

// row padding (elements) of the tiles: keeps rows 16-byte aligned for vector
// stores and the WMMA leading dimensions legal (8 bf16 / 4 fp32 multiples)
template <typename T>
__host__ __device__ constexpr int pad() { return std::is_same<T, bf16>::value ? 8 : 4; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// fp32 tiles write p over the scores they were made from (sP aliases sS): each
// softmax thread reads its half-row of s into registers before it writes p there,
// and no other thread touches that half-row.  That keeps the fp32 D = 192 tile
// set (213.5 KB) under the 227 KB a block may have; bf16 keeps a separate sP.
template <typename T, int D>
struct Layout {
  static constexpr bool P_IN_S = std::is_same<T, float>::value;
  static constexpr int LD = D + pad<T>();       // sQ, sK, sV rows
  static constexpr int LS = BKEY + 4;           // sS rows (fp32)
  static constexpr int LP = P_IN_S ? LS : BKEY + pad<T>();  // sP rows
  static constexpr int LO = D + 4;              // sO rows (fp32)
  static constexpr size_t q_bytes = sizeof(T) * BQ * LD;
  static constexpr size_t kv_bytes = sizeof(T) * BKEY * LD;
  static constexpr size_t s_bytes = sizeof(float) * BQ * LS;
  static constexpr size_t p_bytes = P_IN_S ? 0 : sizeof(T) * BQ * LP;
  static constexpr size_t o_bytes = sizeof(float) * BQ * LO;
  static constexpr size_t s_off = q_bytes + 2 * kv_bytes;
  static constexpr size_t p_off = P_IN_S ? s_off : s_off + s_bytes;
  static constexpr size_t o_off = s_off + s_bytes + p_bytes;
  static constexpr size_t bytes = o_off + o_bytes + 2 * sizeof(float) * BQ;
};

// S (BQ x BKEY, fp32, unscaled) = Q Kᵀ
template <typename T, int D>
__device__ __forceinline__ void scores(const T* sQ, const T* sK, float* sS, int tid) {
  using Lay = Layout<T, D>;
  if constexpr (std::is_same<T, bf16>::value) {
    const int w = tid / 32;
    wmma::fragment<wmma::accumulator, FR, FR, FR, float> acc[BKEY / FR];
#pragma unroll
    for (int j = 0; j < BKEY / FR; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += FR) {
      wmma::fragment<wmma::matrix_a, FR, FR, FR, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sQ + (w * FR) * Lay::LD + kk, Lay::LD);
#pragma unroll
      for (int j = 0; j < BKEY / FR; ++j) {
        // Kᵀ as a column-major B operand: element (d, key) at sK[key][d]
        wmma::fragment<wmma::matrix_b, FR, FR, FR, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, sK + (j * FR) * Lay::LD + kk, Lay::LD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BKEY / FR; ++j) {
      wmma::store_matrix_sync(sS + (w * FR) * Lay::LS + j * FR, acc[j], Lay::LS,
                              wmma::mem_row_major);
    }
  } else {
    const int ty = tid / 16;  // rows ty*8 .. +8
    const int tx = tid % 16;  // keys tx*4 .. +4
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int d = 0; d < D; ++d) {
      float a[8], bk[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sQ[(ty * 8 + i) * Lay::LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx * 4 + j) * Lay::LD + d];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sS[(ty * 8 + i) * Lay::LS + tx * 4 + j] = acc[i][j];
    }
  }
}

// O (BQ x D, fp32) += P V
template <typename T, int D>
__device__ __forceinline__ void accumulate_pv(const T* sP, const T* sV, float* sO,
                                              int tid) {
  using Lay = Layout<T, D>;
  if constexpr (std::is_same<T, bf16>::value) {
    const int w = tid / 32;
#pragma unroll
    for (int n = 0; n < D / FR; ++n) {
      wmma::fragment<wmma::accumulator, FR, FR, FR, float> acc;
      float* o_tile = sO + (w * FR) * Lay::LO + n * FR;
      wmma::load_matrix_sync(acc, o_tile, Lay::LO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKEY; kk += FR) {
        wmma::fragment<wmma::matrix_a, FR, FR, FR, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, FR, FR, FR, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + (w * FR) * Lay::LP + kk, Lay::LP);
        wmma::load_matrix_sync(fb, sV + kk * Lay::LD + n * FR, Lay::LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(o_tile, acc, Lay::LO, wmma::mem_row_major);
    }
  } else {
    constexpr int CPT = D / 16;  // columns per thread
    const int ty = tid / 16;     // rows ty*8 .. +8
    const int tx = tid % 16;     // columns tx*CPT .. +CPT
    float acc[8][CPT];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = sO[(ty * 8 + i) * Lay::LO + tx * CPT + c];
    }
    for (int key = 0; key < BKEY; ++key) {
      float pv[8], vv[CPT];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = sP[(ty * 8 + i) * Lay::LP + key];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = sV[key * Lay::LD + tx * CPT + c];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) sO[(ty * 8 + i) * Lay::LO + tx * CPT + c] = acc[i][c];
    }
  }
}

// copy `rows` rows of D elements (row r at src + r * stride) into a padded
// shared tile, 16 bytes a thread; rows past `valid` are zero
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t stride, int valid,
                                          int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  constexpr int LD = Layout<T, D>::LD;
  for (int idx = tid; idx < ROWS * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd(Args a) {
  using Lay = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + Lay::q_bytes);
  T* sV = reinterpret_cast<T*>(smem + Lay::q_bytes + Lay::kv_bytes);
  float* sS = reinterpret_cast<float*>(smem + Lay::s_off);
  T* sP = reinterpret_cast<T*>(smem + Lay::p_off);
  float* sO = reinterpret_cast<float*>(smem + Lay::o_off);
  float* sM = sO + BQ * Lay::LO;
  float* sL = sM + BQ;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.h;
  const int head = bh % a.h;
  const int kvh = head / (a.h / a.kv);
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, a.lq - q0);
  const int off = a.q_off != nullptr ? a.q_off[b] : a.q_off0;

  const size_t q_stride = static_cast<size_t>(a.h) * D;   // between query rows
  const size_t k_stride = static_cast<size_t>(a.kv) * D;  // between keys
  const T* q_base = q + (static_cast<size_t>(b) * a.lq + q0) * q_stride +
                    static_cast<size_t>(head) * D;
  load_tile<T, D, BQ>(sQ, q_base, q_stride, rows, tid);
  for (int i = tid; i < BQ * Lay::LO; i += THREADS) sO[i] = 0.f;
  for (int i = tid; i < BQ; i += THREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }

  // live key tiles of this block's rows
  const int q_lo = off + q0;
  const int q_hi = off + q0 + rows - 1;
  int kt_end = (a.lk + BKEY - 1) / BKEY;
  if (a.causal) kt_end = min(kt_end, q_hi / BKEY + 1);
  int kt_begin = 0;
  if (a.window > 0) {
    const int first = q_lo - a.window + 1;  // first key any row may see
    if (first > 0) kt_begin = first / BKEY;
  }
  __syncthreads();

  const T* k_head = k + static_cast<size_t>(b) * a.lk * k_stride +
                    static_cast<size_t>(kvh) * D;
  const T* v_head = v + static_cast<size_t>(b) * a.lk * k_stride +
                    static_cast<size_t>(kvh) * D;
  const int r = tid / 2;     // softmax: two threads a row
  const int part = tid % 2;  // ... each half of the keys
  const int qpos = off + q0 + r;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKEY;
    const int live = min(BKEY, a.lk - k0);
    load_tile<T, D, BKEY>(sK, k_head + k0 * k_stride, k_stride, live, tid);
    load_tile<T, D, BKEY>(sV, v_head + k0 * k_stride, k_stride, live, tid);
    __syncthreads();
    scores<T, D>(sQ, sK, sS, tid);
    __syncthreads();

    float sv[BKEY / 2];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < BKEY / 2; ++c) {
      const int col = part * (BKEY / 2) + c;
      const int kp = k0 + col;
      float s = sS[r * Lay::LS + col] * a.scale;
      if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
      bool ok = kp < a.lk;
      if (a.causal) ok = ok && kp <= qpos;
      if (a.window > 0) ok = ok && kp > qpos - a.window;
      s = ok ? s : NEG_INF;
      sv[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = sM[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < BKEY / 2; ++c) {
      const float e = expf(sv[c] - m_new);
      sP[r * Lay::LP + part * (BKEY / 2) + c] = from_f<T>(e);
      sum += e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = expf(m_old - m_new);
    for (int d = part * (D / 2); d < (part + 1) * (D / 2); ++d) sO[r * Lay::LO + d] *= corr;
    __syncwarp();
    if (part == 0) {
      sM[r] = m_new;
      sL[r] = sL[r] * corr + sum;
    }
    __syncthreads();
    accumulate_pv<T, D>(sP, sV, sO, tid);
    __syncthreads();
  }

  T* o_base = o + (static_cast<size_t>(b) * a.lq + q0) * q_stride +
              static_cast<size_t>(head) * D;
  for (int idx = tid; idx < rows * D; idx += THREADS) {
    const int rr = idx / D;
    const int d = idx % D;
    o_base[rr * q_stride + d] = from_f<T>(sO[rr * Lay::LO + d] / fmaxf(sL[rr], 1e-20f));
  }
}

template <typename T, int D>
int launch_typed(const Args& a, cudaStream_t s) {
  const size_t bytes = Layout<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.lq + BQ - 1) / BQ, a.b * a.h);
  flash_fwd<T, D><<<grid, THREADS, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const Args& a, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_typed<T, 16>(a, s);
    case 32: return launch_typed<T, 32>(a, s);
    case 64: return launch_typed<T, 64>(a, s);
    case 128: return launch_typed<T, 128>(a, s);
    case 192: return launch_typed<T, 192>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v and o share it).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const void* q_off, int q_off0, int b, int lq, int lk,
                                      int h, int kv, int d, int causal, int window,
                                      float scale, float softcap, int dtype, void* stream) {
  if (b <= 0 || lq <= 0 || lk <= 0 || kv <= 0 || h % kv != 0 || b * h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, o, static_cast<const int*>(q_off), q_off0, b, lq, lk, h, kv,
         causal, window, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(a, d, s);
  if (dtype == 1) return launch_dim<bf16>(a, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
