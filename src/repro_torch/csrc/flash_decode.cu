// One decode step against the factorized latent KV cache, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py::flash_decode and
// computes what its oracle src/repro/kernels/ref.py:82 computes, all arithmetic in
// fp32.  The cache holds only the rank-r latents l_k = x V_k and l_v = x V_v of every
// token; the kernel keeps the two halves of the TPU design:
//
//   key side    each key tile is up-projected in the kernel, K = l_k U_k[:, head],
//               and RoPE'd (rotate-half at the TRUE head dim, at the keys' absolute
//               positions) before scoring; the rotation ties dims d and d + D/2 of
//               the up-projected key, so it cannot be folded into U_k
//   value side  the accumulator stays in latent space, acc (g, r_v) += p l_v, and
//               U_v is applied once per head in the epilogue: H·L·r_v + H·r_v·D
//               flops a step instead of L·r_v·KV·D + H·L·D
//
// U_k and U_v are read in their STORED (r, KV·D) layout by stride: transposing them
// to (KV, r, D) first, as the JAX wrapper does, would copy 2 x 1232 x 4096 x 4 B =
// 40 MB per layer per step at llama-7b.  Ranks are arbitrary (loops are bounded);
// keys of slot b at positions >= lengths[b] are masked.
//
// Bound on an H100: 2·Σ_b len_b·(r_k·KV·D + H·D + H·r_v) + 2·B·H·r_v·D fp32 flops
// (the key up-projection dominates: ~83 GFLOP per layer at 8 slots x 1024 positions,
// r_k 1232) against the live latents, U_k, U_v, q and out once each: it is bound by
// the fp32 operations (67 TFLOP/s outside the tensor cores), not by the bytes.
//
// Design: one block of 256 threads per (slot, KV head), covering the g query heads of
// that KV head and looping over the slot's live key tiles (64 keys) inside the block:
// no atomics, a deterministic sum.  Per tile:
//   1. K (64 x D) = l_k tile @ U_k[:, kvh], streamed in 32-rank chunks through shared
//      memory (U_k[kvh] is r_k x D x 4 B = 630 KB at llama-7b, too large to keep);
//      each thread owns a register micro-tile of 4 keys x 8 columns (at D 128), so
//      one shared load feeds 4-8 FMAs
//   2. RoPE on the K tile in shared memory
//   3. scores (g x 64) = q · K / √D, masked past lengths[b]
//   4. online softmax, one warp a head
//   5. acc (g x r_v) = acc·corr + p l_v, threads over r_v, l_v read straight from
//      device memory (coalesced along r)
// then out[h] = (acc[h] / l[h]) U_v[:, kvh].  At llama-7b (KV = 32) and 8 slots that
// is 256 blocks for 132 SMs.  Every product runs on the FMA units; splitting L
// across blocks (flash-decoding) and the tensor cores are later work.
//
// Contract (checked by the wrapper, kernels/ops.py::flash_decode): q (B, H, D), lk
// (B, L, r_k), lv (B, L, r_v) and out (B, H, D) of one dtype (fp32 or bf16); uk
// (r_k, KV·D), uv (r_v, KV·D), cos, sin (L, D/2) fp32; lengths (B,) int32; all
// contiguous; D one of 16, 32, 64, 128.  A slot with length 0 gets zeros (the
// serving path always has length >= 1).  Returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int BK = 64;   // keys per tile
constexpr int RC = 32;   // ranks per shared-memory chunk of the up-projection
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;

struct Args {
  const void* q;
  const void* lk;
  const void* lv;
  const float* uk;
  const float* uv;
  const int* lengths;
  const float* cos;
  const float* sin;
  void* out;
  int b, l, h, kv, rk, rv, rope;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// shared floats of one block
template <int D>
size_t smem_floats(int g, int rv) {
  return static_cast<size_t>(g) * D + RC * (BK + 1) + RC * D + BK * (D + 1) +
         static_cast<size_t>(g) * BK + static_cast<size_t>(g) * rv + 3 * g;
}

// Up-projection micro-tile: each thread owns KPT keys x CPT columns of the
// (BK x D) key tile, so one shared load of l_k feeds CPT FMAs and one of U_k
// feeds KPT.
template <int D>
struct Tile {
  static constexpr int CPT = D >= 32 ? 8 : 4;  // columns per thread
  static constexpr int TX = D / CPT;           // threads across D
  static constexpr int TY = THREADS / TX;      // threads across keys
  static constexpr int KPT = BK / TY;          // keys per thread
  static_assert(KPT >= 1 && TY * KPT == BK, "tile does not cover the keys");
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(Args a) {
  using Ti = Tile<D>;
  constexpr int HALF = D / 2;
  constexpr int LT = BK + 1;  // row stride of the rank-major l_k chunk
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = a.h / a.kv;
  const int tid = threadIdx.x;
  const size_t ld_u = static_cast<size_t>(a.kv) * D;

  extern __shared__ __align__(16) float smem[];
  float* sUK = smem;                  // RC x D (16-byte aligned rows)
  float* sLK = sUK + RC * D;          // RC x LT, l_k chunk rank-major
  float* sQ = sLK + RC * LT;          // g x D
  float* sK = sQ + g * D;             // BK x (D + 1)
  float* sP = sK + BK * (D + 1);      // g x BK
  float* sAcc = sP + g * BK;          // g x rv
  float* sM = sAcc + g * a.rv;        // g
  float* sL = sM + g;                 // g
  float* sC = sL + g;                 // g

  const int len = min(a.lengths[b], a.l);
  const T* q = static_cast<const T*>(a.q) + (static_cast<size_t>(b) * a.h + kvh * g) * D;
  for (int i = tid; i < g * D; i += THREADS) sQ[i] = to_f(q[i]);
  for (int i = tid; i < g * a.rv; i += THREADS) sAcc[i] = 0.f;
  for (int i = tid; i < g; i += THREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }
  __syncthreads();

  const T* lk = static_cast<const T*>(a.lk) + static_cast<size_t>(b) * a.l * a.rk;
  const T* lv = static_cast<const T*>(a.lv) + static_cast<size_t>(b) * a.l * a.rv;
  const float* uk = a.uk + static_cast<size_t>(kvh) * D;
  const float* uv = a.uv + static_cast<size_t>(kvh) * D;
  const int tx = tid % Ti::TX;  // columns tx*CPT .. +CPT
  const int ty = tid / Ti::TX;  // keys ty*KPT .. +KPT
  const float sqrt_d = sqrtf(static_cast<float>(D));
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int k0 = 0; k0 < len; k0 += BK) {
    const int live = min(BK, len - k0);

    // 1. key up-projection, K = l_k @ U_k[:, kvh*D : (kvh+1)*D]
    float acc[Ti::KPT][Ti::CPT];
#pragma unroll
    for (int i = 0; i < Ti::KPT; ++i) {
#pragma unroll
      for (int c = 0; c < Ti::CPT; ++c) acc[i][c] = 0.f;
    }
    for (int r0 = 0; r0 < a.rk; r0 += RC) {
      for (int idx = tid; idx < BK * RC; idx += THREADS) {
        const int key = idx / RC;
        const int rr = idx % RC;
        float x = 0.f;
        if (key < live && r0 + rr < a.rk) {
          x = to_f(lk[static_cast<size_t>(k0 + key) * a.rk + r0 + rr]);
        }
        sLK[rr * LT + key] = x;
      }
      for (int idx = tid; idx < RC * D; idx += THREADS) {
        const int rr = idx / D;
        const int dd = idx % D;
        sUK[idx] = r0 + rr < a.rk ? uk[static_cast<size_t>(r0 + rr) * ld_u + dd] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int rr = 0; rr < RC; ++rr) {
        float lkv[Ti::KPT];
        float u[Ti::CPT];
#pragma unroll
        for (int i = 0; i < Ti::KPT; ++i) lkv[i] = sLK[rr * LT + ty * Ti::KPT + i];
#pragma unroll
        for (int c = 0; c < Ti::CPT; c += 4) {
          const float4 u4 = *reinterpret_cast<const float4*>(sUK + rr * D + tx * Ti::CPT + c);
          u[c] = u4.x;
          u[c + 1] = u4.y;
          u[c + 2] = u4.z;
          u[c + 3] = u4.w;
        }
#pragma unroll
        for (int i = 0; i < Ti::KPT; ++i) {
#pragma unroll
          for (int c = 0; c < Ti::CPT; ++c) acc[i][c] = fmaf(lkv[i], u[c], acc[i][c]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < Ti::KPT; ++i) {
#pragma unroll
      for (int c = 0; c < Ti::CPT; ++c) {
        sK[(ty * Ti::KPT + i) * (D + 1) + tx * Ti::CPT + c] = acc[i][c];
      }
    }
    __syncthreads();

    // 2. RoPE (rotate-half) at the keys' absolute positions
    if (a.rope) {
      for (int idx = tid; idx < live * HALF; idx += THREADS) {
        const int key = idx / HALF;
        const int j = idx % HALF;
        const size_t t = static_cast<size_t>(k0 + key) * HALF + j;
        const float c = a.cos[t];
        const float s = a.sin[t];
        float* row = sK + key * (D + 1);
        const float k1 = row[j];
        const float k2 = row[j + HALF];
        row[j] = k1 * c - k2 * s;
        row[j + HALF] = k2 * c + k1 * s;
      }
      __syncthreads();
    }

    // 3. scores of the g query heads, masked past the slot's length
    for (int o = tid; o < g * BK; o += THREADS) {
      const int hh = o / BK;
      const int key = o % BK;
      float s = NEG_INF;
      if (key < live) {
        float dot = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < D; ++dd) dot = fmaf(sQ[hh * D + dd], sK[key * (D + 1) + dd], dot);
        s = dot / sqrt_d;
      }
      sP[o] = s;
    }
    __syncthreads();

    // 4. online softmax, one warp a head
    for (int hh = warp; hh < g; hh += THREADS / 32) {
      const float s0 = sP[hh * BK + lane];
      const float s1 = sP[hh * BK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int w = 16; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = sM[hh];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      sP[hh * BK + lane] = p0;
      sP[hh * BK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int w = 16; w > 0; w /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sC[hh] = corr;
        sL[hh] = sL[hh] * corr + sum;
        sM[hh] = m_new;
      }
    }
    __syncthreads();

    // 5. value absorption: the accumulator stays in latent space
    for (int r = tid; r < a.rv; r += THREADS) {
      for (int hh = 0; hh < g; ++hh) {
        float v_acc = sAcc[hh * a.rv + r] * sC[hh];
        const float* p = sP + hh * BK;
        for (int key = 0; key < live; ++key) {
          v_acc = fmaf(p[key], to_f(lv[static_cast<size_t>(k0 + key) * a.rv + r]), v_acc);
        }
        sAcc[hh * a.rv + r] = v_acc;
      }
    }
    __syncthreads();
  }

  // epilogue: out[h] = (acc[h] / l[h]) @ U_v[:, kvh*D : (kvh+1)*D]
  T* out = static_cast<T*>(a.out) + (static_cast<size_t>(b) * a.h + kvh * g) * D;
  for (int o = tid; o < g * D; o += THREADS) {
    const int hh = o / D;
    const int dd = o % D;
    const float denom = fmaxf(sL[hh], 1e-20f);
    float y = 0.f;
    for (int r = 0; r < a.rv; ++r) {
      y = fmaf(sAcc[hh * a.rv + r] / denom, uv[static_cast<size_t>(r) * ld_u + dd], y);
    }
    out[o] = from_f<T>(y);
  }
}

template <typename T, int D>
int launch_typed(const Args& a, cudaStream_t s) {
  const size_t bytes = smem_floats<D>(a.h / a.kv, a.rv) * sizeof(float);
  if (bytes > static_cast<size_t>(MAX_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_kernel<T, D><<<dim3(a.kv, a.b), THREADS, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const Args& a, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_typed<T, 16>(a, s);
    case 32: return launch_typed<T, 32>(a, s);
    case 64: return launch_typed<T, 64>(a, s);
    case 128: return launch_typed<T, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, lk, lv and out share it; uk, uv, cos, sin fp32).
extern "C" int flash_decode_launch(const void* q, const void* lk, const void* lv,
                                   const void* uk, const void* uv, const void* lengths,
                                   const void* cos, const void* sin, void* out, int b, int l,
                                   int h, int kv, int d, int rk, int rv, int rope, int dtype,
                                   void* stream) {
  if (b <= 0 || b > 65535 || l <= 0 || kv <= 0 || h % kv != 0 || rk <= 0 || rv <= 0 ||
      (rope && (cos == nullptr || sin == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, lk, lv, static_cast<const float*>(uk), static_cast<const float*>(uv),
         static_cast<const int*>(lengths), static_cast<const float*>(cos),
         static_cast<const float*>(sin), out, b, l, h, kv, rk, rv, rope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(a, d, s);
  if (dtype == 1) return launch_dim<bf16>(a, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
