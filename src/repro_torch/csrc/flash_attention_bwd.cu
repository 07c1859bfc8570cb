// Backward of blockwise attention (flash), written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the Pallas kernel src/repro/kernels/flash_attention.py
// has no backward (no custom_vjp), and the JAX package trains and refines
// through its model-path scan (src/repro/models/attention.py:31), which XLA
// differentiates.  This is the port's counterpart of that gradient: (dq, dk,
// dv) of flash_attention.cu's function, from q, k, v, the forward's output O,
// the upstream gradient dO and the forward's softmax statistics LSE = m +
// log(l) per query row (flash_attention_launch's lse), so nothing of the
// forward is stored but O and LSE.  Scores are q·kᵀ·scale at the TRUE head
// dim, optionally soft-capped as tanh(s/c)·c; P = exp(s - LSE) on live keys,
// 0 on masked ones (causal, window, keys past Lk, rows past Lq);
// dS = P ∘ (dP - Δ) with dP = dO·vᵀ and Δ = rowsum(dO ∘ O), times 1 - tanh²
// under the cap; dq = scale·dS·k, dk = scale·dSᵀ·q, dv = Pᵀ·dO.  A row with
// no live key (a causal row before key 0, a windowed row past Lk's window)
// follows the plain version's -1e30 semantics: its scores are all equal, so
// P = 1/Lk on every key and dS = 0 (the mask stops the score's gradient),
// which adds dO/Lk to every key's dv and nothing to dq or dk (dead_rows).
//
// Layouts are the forward's, read in place: q, o, dO, dq (B, Lq, H·D) and k,
// v, dk, dv (B, Lk, KV·D) contiguous, query head h on KV head h / (H / KV);
// LSE and the Δ scratch (B, H, Lq) fp32.
//
// Bound on an H100: max(10·B·H·Σ live (query, key)·D flops / peak, (q, k, v,
// o, dO read, dq, dk, dv written) bytes / 3.35 TB/s): 2.5x the forward's
// products.  At training shapes (qwen3-0.6b: B 8, 16 heads, L 512, D 128,
// causal) that is ~22 GFLOP over ~25 MB in bf16: the tensor cores bound it.
// This design recomputes S in both passes and dP in both, and takes dS's
// products twice (hi and lo) in bf16: 9 products where the bound counts 5.
//
// Determinism: two passes and no atomics.  Each gradient element is written
// once by one block, every sum runs in a fixed order (FlashAttention-3's
// atomicAdd into dQ would not), so two calls give the same bits and a slot's
// gradients do not depend on the slots around it.
//
//   fab_delta: Δ = rowsum(dO ∘ O) in fp32, one warp a row (lanes stride the
//     head dim, then a fixed shuffle tree).
//   dK/dV pass: one block a (key tile, KV head, slot).  For each query head
//     of its group in order it walks the query tiles that can see its keys
//     (query_tiles, the mirror of the forward's key_tiles: causal, window,
//     per-slot offsets), recomputes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, and adds
//     dV += Pᵀ·dO, dK += dSᵀ·Q: the group's sum over its query heads stays
//     inside the block.
//   dQ pass: one block a (query tile, head, slot) over the forward's key
//     tiles: S = Q·Kᵀ, dP = dO·Vᵀ, dQ += dS·K.
//
// Precision: P is rounded to the input dtype before dV += Pᵀ·dO, as the
// forward rounds it before P·V (dv is the derivative of the function the
// forward computes).  dS stays fp32: in bf16 it is split into hi = bf16(dS)
// and lo = bf16(dS - hi), and dK and dQ take both products (about 17
// significant bits of dS where one bf16 operand keeps 8), so dq and dk carry
// no more rounding than the plain backward's fp32 scan.
//
// Bodies (kernels/flash_attention.py::plan_backward):
//   wgmma (bf16, D 64 / 96 / 112 / 128 / 192 / 256): two warpgroups (256
//     threads, 255 registers a thread); the first warp issues the TMA loads,
//     each stage's refill once both warpgroups released it, through 4D
//     tensor maps on (B, L, heads, D) in 64-column boxes (D 96 and 112 read at
//     their true width: the second box of a row arrives zero-filled past D).
//     dK/dV: the block's 64 keys (K and V loaded once) are the M side of
//     every product; its two warpgroups share them, one accumulating dK (it
//     computes Sᵀ and dPᵀ), the other dV (it computes Sᵀ alone), so each
//     holds one D-wide accumulator: 2·64·D fp32 (dK and dV) would overflow a
//     thread's registers at D 192 and 256.  Q, dO and their rows' LSE and Δ
//     stream through a 2-stage ring, 64 rows a step (32 at D 256, for the dK
//     warpgroup's registers).  Sᵀ and dPᵀ are wgmma with both operands
//     K-major; Pᵀ and dSᵀ's hi and lo, packed to bf16 in pairs in the
//     accumulator registers, are already wgmma's register A fragments of dV
//     += Pᵀ·dO and dK += dSᵀ_hi·Q + dSᵀ_lo·Q, where dO and Q are read MN-major
//     through the transpose bit (as the forward reads V in P·V).  dQ: the
//     forward's layout, 128 query rows a block (64 a warpgroup), Q and dO
//     loaded once, K and V through a 2-stage ring of 64 keys (32 at D 256); S
//     and dP as the forward's Q·Kᵀ, dQ += dS_hi·K + dS_lo·K with K read
//     MN-major.  Each step's products are issued and waited on in turn: no
//     wgmma sits under a branch (ptxas would serialize it).
//   fma (fp32 at every D, bf16 at D 16 / 32): 256 threads, 32 keys and 32
//     query rows a tile staged in shared memory as fp32, every product on the
//     FMA units (TF32 off), P rounded to the input dtype before dV, dS fp32.
//
// Contract (checked by the wrapper, kernels/ops.py::flash_attention_bwd; the
// launcher refuses what plan_backward never makes): all of q, k, v, o, dO, dq,
// dk, dv one dtype, contiguous, 16-byte aligned; D one of 16, 32, 64, 96,
// 112, 128, 192, 256 (the wrapper zero-pads any other and passes the scale of
// the true one); q_off null (every slot at q_off0) or a (B,) int32 device
// vector.  passes: 1 the dQ pass, 2 the dK/dV pass, 3 both (dq, or dk and dv,
// may be null when their pass is not asked for).  Returns the first non-zero
// cudaError of the call, checked after every launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const float* lse;  // (B, H, Lq)
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* delta;      // (B, H, Lq)
  const int* q_off;  // (B,) or null
  int q_off0;
  int b, lq, lk, h, kv;
  int causal, window;
  float scale, softcap;
};

__device__ __forceinline__ int slot_offset(const BwdArgs& a, int b) {
  return a.q_off != nullptr ? a.q_off[b] : a.q_off0;
}

// key kp is live for the query row at absolute position qp
__device__ __forceinline__ bool live(const BwdArgs& a, int kp, int qp) {
  return (kp < a.lk) & (!a.causal | (kp <= qp)) & ((a.window <= 0) | (kp > qp - a.window));
}

// The forward's key tiles [begin, end) of width bkey that the query rows at
// absolute positions [first, last] walk (flash_attention.cu::key_tiles)
__device__ __forceinline__ int2 key_tiles(int first, int last, int lk, int causal,
                                          int window, int bkey) {
  int end = (lk + bkey - 1) / bkey;
  if (causal) end = min(end, last / bkey + 1);
  int begin = 0;
  if (window > 0 && first - window + 1 > 0) begin = (first - window + 1) / bkey;
  return make_int2(begin, max(begin, end));
}

// Its mirror: the query tiles [begin, end) of bq rows whose rows (at
// positions off + row) see a key of the tile [k0, k0 + bkey): none before the
// first row at or past k0 (causal), none past the last row whose window
// still holds the tile's last key.  Plan.query_tiles is the same arithmetic.
__device__ __forceinline__ int2 query_tiles(int k0, int lk, int off, int lq, int causal,
                                            int window, int bkey, int bq) {
  const int k1 = min(k0 + bkey, lk);
  int lo = causal ? k0 - off : 0;
  int hi = window > 0 ? k1 + window - 2 - off : lq - 1;
  lo = max(lo, 0);
  hi = min(hi, lq - 1);
  if (lo > hi) return make_int2(0, 0);
  return make_int2(lo / bq, hi / bq + 1);
}

// The rows of a slot at offset off that see no key: [0, x) before key 0
// (causal) and [y, lq) past the window of the last key (window > 0).  Each
// adds dO/Lk to every key's dv (P = 1/Lk, the plain version's -1e30 scores
// all equal); Plan.dead_rows is the same arithmetic.
__device__ __forceinline__ int2 dead_rows(int off, int lq, int lk, int causal, int window) {
  const int x = causal ? min(max(-off, 0), lq) : 0;
  const int y = window > 0 ? min(max(lk + window - 1 - off, 0), lq) : lq;
  return make_int2(x, y);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back: a product's operand in T's precision
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// ---------------------------------------------------------------------------
// Δ = rowsum(dO ∘ O): one warp a (slot, row, head), rows contiguous in o and dO

template <typename T>
__global__ void __launch_bounds__(256) fab_delta(BwdArgs a, int d) {
  const long long warp = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= static_cast<long long>(a.b) * a.lq * a.h) return;
  const T* o = static_cast<const T*>(a.o) + warp * d;
  const T* g = static_cast<const T*>(a.dout) + warp * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(to_f(o[c]), to_f(g[c]), s);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) {
    const int head = static_cast<int>(warp % a.h);
    const long long br = warp / a.h;
    const int row = static_cast<int>(br % a.lq);
    const int b = static_cast<int>(br / a.lq);
    a.delta[(static_cast<size_t>(b) * a.h + head) * a.lq + row] = s;
  }
}

// ---------------------------------------------------------------------------
// fma: fp32 at every D, bf16 at D 16 / 32

namespace bt {

constexpr int TILE = 32;      // keys and query rows a tile
constexpr int THREADS = 256;  // 8 threads a tile row

template <int D>
struct Lay {
  static constexpr int LD = D + 1;                  // fp32 rows of K, V, Q, dO
  static constexpr int LS = TILE + 1;               // rows of the P / dS tiles
  static constexpr int TILE_FLOATS = TILE * LD;
  static constexpr size_t bytes = sizeof(float) * (4 * TILE_FLOATS + 2 * TILE * LS + 2 * TILE);
};

// rows [0, valid) of a (rows, heads·D) slice starting at src, a row `stride`
// elements apart, into a fp32 tile; rows past `valid` zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, size_t stride, int valid,
                                          int tid) {
  for (int i = tid; i < TILE * D; i += THREADS) {
    const int r = i / D;
    const int c = i % D;
    dst[r * Lay<D>::LD + c] = r < valid ? to_f(src[r * stride + c]) : 0.f;
  }
}

// One score's (P, dS): s the unscaled q·k, dp = dO·v
__device__ __forceinline__ float2 grad_score(const BwdArgs& a, float s, float dp, float lse,
                                             float delta, bool ok) {
  s *= a.scale;
  float t = 0.f;
  if (a.softcap > 0.f) {
    t = tanhf(s / a.softcap);
    s = t * a.softcap;
  }
  const float p = ok ? expf(s - lse) : 0.f;
  float ds = p * (dp - delta);
  if (a.softcap > 0.f) ds *= 1.f - t * t;
  return make_float2(p, ds);
}

// grid (key tiles, B·KV): block (x, y) takes key tile x of slot·KV head y
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2) bwd_kv_tile(BwdArgs a) {
  using L = Lay<D>;
  constexpr int CPT = D / 8;  // accumulator columns a thread
  extern __shared__ float sm[];
  float* sK = sm;
  float* sV = sK + L::TILE_FLOATS;
  float* sQ = sV + L::TILE_FLOATS;
  float* sG = sQ + L::TILE_FLOATS;
  float* sP = sG + L::TILE_FLOATS;
  float* sS = sP + TILE * L::LS;
  float* sLse = sS + TILE * L::LS;
  float* sDel = sLse + TILE;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / a.kv;
  const int kvh = blockIdx.y % a.kv;
  const int k0 = blockIdx.x * TILE;
  const int keys = min(TILE, a.lk - k0);
  const int g = a.h / a.kv;
  const int off = slot_offset(a, b);
  const size_t kstride = static_cast<size_t>(a.kv) * D;
  const size_t qstride = static_cast<size_t>(a.h) * D;
  const size_t kbase = (static_cast<size_t>(b) * a.lk + k0) * kstride + static_cast<size_t>(kvh) * D;
  load_rows<T, D>(sK, static_cast<const T*>(a.k) + kbase, kstride, keys, tid);
  load_rows<T, D>(sV, static_cast<const T*>(a.v) + kbase, kstride, keys, tid);
  const int2 qt = query_tiles(k0, a.lk, off, a.lq, a.causal, a.window, TILE, TILE);

  const int kk = tid / 8;  // the thread's key: a row of Sᵀ and of dK / dV
  const int c8 = tid % 8;  // its queries c8 + 8j, its columns c8 + 8i
  float acc_k[CPT], acc_v[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int head = kvh * g + hh;
    for (int t = qt.x; t < qt.y; ++t) {
      const int q0 = t * TILE;
      const int rows = min(TILE, a.lq - q0);
      __syncthreads();  // the last tile's reads are done
      const size_t qbase = (static_cast<size_t>(b) * a.lq + q0) * qstride +
                           static_cast<size_t>(head) * D;
      load_rows<T, D>(sQ, static_cast<const T*>(a.q) + qbase, qstride, rows, tid);
      load_rows<T, D>(sG, static_cast<const T*>(a.dout) + qbase, qstride, rows, tid);
      if (tid < TILE) {
        const size_t idx = (static_cast<size_t>(b) * a.h + head) * a.lq + q0 + tid;
        sLse[tid] = tid < rows ? a.lse[idx] : 0.f;
        sDel[tid] = tid < rows ? a.delta[idx] : 0.f;
      }
      __syncthreads();
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < D; ++d) {
        const float kd = sK[kk * L::LD + d];
        const float vd = sV[kk * L::LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[j] = fmaf(sQ[(c8 + 8 * j) * L::LD + d], kd, s[j]);
          dp[j] = fmaf(sG[(c8 + 8 * j) * L::LD + d], vd, dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = c8 + 8 * j;
        const bool ok = qj < rows && live(a, k0 + kk, off + q0 + qj);
        const float2 r = grad_score(a, s[j], dp[j], sLse[qj], sDel[qj], ok);
        sP[kk * L::LS + qj] = round_to<T>(r.x);
        sS[kk * L::LS + qj] = r.y;
      }
      __syncthreads();
      for (int qj = 0; qj < rows; ++qj) {
        const float pv = sP[kk * L::LS + qj];
        const float dsv = sS[kk * L::LS + qj];
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          acc_v[i] = fmaf(pv, sG[qj * L::LD + c8 + 8 * i], acc_v[i]);
          acc_k[i] = fmaf(dsv, sQ[qj * L::LD + c8 + 8 * i], acc_k[i]);
        }
      }
    }
  }
  // the rows that see no key add Σ dO/Lk (each head of the group in order,
  // then the rows) to every key's dv
  const int2 dead = dead_rows(off, a.lq, a.lk, a.causal, a.window);
  const float inv_lk = 1.f / a.lk;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    float c = 0.f;
    for (int hh = 0; hh < g; ++hh) {
      const T* go = static_cast<const T*>(a.dout) + static_cast<size_t>(b) * a.lq * qstride +
                    static_cast<size_t>(kvh * g + hh) * D + c8 + 8 * i;
      for (int r = 0; r < dead.x; ++r) c += to_f(go[r * qstride]) * inv_lk;
      for (int r = dead.y; r < a.lq; ++r) c += to_f(go[r * qstride]) * inv_lk;
    }
    acc_v[i] += c;
  }
  if (kk < keys) {
    T* dk = static_cast<T*>(a.dk) + kbase + kk * kstride;
    T* dv = static_cast<T*>(a.dv) + kbase + kk * kstride;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      dk[c8 + 8 * i] = from_f<T>(acc_k[i] * a.scale);
      dv[c8 + 8 * i] = from_f<T>(acc_v[i]);
    }
  }
}

// grid (query tiles, B·H): block (x, y) takes query tile x of slot·head y
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2) bwd_q_tile(BwdArgs a) {
  using L = Lay<D>;
  constexpr int CPT = D / 8;
  extern __shared__ float sm[];
  float* sK = sm;
  float* sV = sK + L::TILE_FLOATS;
  float* sQ = sV + L::TILE_FLOATS;
  float* sG = sQ + L::TILE_FLOATS;
  float* sS = sG + L::TILE_FLOATS + TILE * L::LS;
  float* sLse = sS + TILE * L::LS;
  float* sDel = sLse + TILE;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / a.h;
  const int head = blockIdx.y % a.h;
  const int kvh = head / (a.h / a.kv);
  const int q0 = blockIdx.x * TILE;
  const int rows = min(TILE, a.lq - q0);
  const int off = slot_offset(a, b);
  const size_t kstride = static_cast<size_t>(a.kv) * D;
  const size_t qstride = static_cast<size_t>(a.h) * D;
  const size_t qbase = (static_cast<size_t>(b) * a.lq + q0) * qstride + static_cast<size_t>(head) * D;
  load_rows<T, D>(sQ, static_cast<const T*>(a.q) + qbase, qstride, rows, tid);
  load_rows<T, D>(sG, static_cast<const T*>(a.dout) + qbase, qstride, rows, tid);
  if (tid < TILE) {
    const size_t idx = (static_cast<size_t>(b) * a.h + head) * a.lq + q0 + tid;
    sLse[tid] = tid < rows ? a.lse[idx] : 0.f;
    sDel[tid] = tid < rows ? a.delta[idx] : 0.f;
  }
  const int2 kt = key_tiles(off + q0, off + q0 + rows - 1, a.lk, a.causal, a.window, TILE);

  const int qq = tid / 8;  // the thread's query row: a row of S and of dQ
  const int c8 = tid % 8;  // its keys c8 + 8j, its columns c8 + 8i
  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;
  for (int t = kt.x; t < kt.y; ++t) {
    const int k0 = t * TILE;
    const int keys = min(TILE, a.lk - k0);
    __syncthreads();
    const size_t kbase = (static_cast<size_t>(b) * a.lk + k0) * kstride +
                         static_cast<size_t>(kvh) * D;
    load_rows<T, D>(sK, static_cast<const T*>(a.k) + kbase, kstride, keys, tid);
    load_rows<T, D>(sV, static_cast<const T*>(a.v) + kbase, kstride, keys, tid);
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    float dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[qq * L::LD + d];
      const float gd = sG[qq * L::LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = fmaf(qd, sK[(c8 + 8 * j) * L::LD + d], s[j]);
        dp[j] = fmaf(gd, sV[(c8 + 8 * j) * L::LD + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = c8 + 8 * j;
      const bool ok = qq < rows && live(a, k0 + kj, off + q0 + qq);
      sS[qq * L::LS + kj] = grad_score(a, s[j], dp[j], sLse[qq], sDel[qq], ok).y;
    }
    __syncthreads();
    for (int kj = 0; kj < keys; ++kj) {
      const float dsv = sS[qq * L::LS + kj];
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[i] = fmaf(dsv, sK[kj * L::LD + c8 + 8 * i], acc[i]);
    }
  }
  if (qq < rows) {
    T* dq = static_cast<T*>(a.dq) + qbase + qq * qstride;
#pragma unroll
    for (int i = 0; i < CPT; ++i) dq[c8 + 8 * i] = from_f<T>(acc[i] * a.scale);
  }
}

}  // namespace bt

// ---------------------------------------------------------------------------
// wgmma: bf16 at D 64 / 96 / 112 / 128 / 192 / 256

namespace bw {

// two warpgroups and no producer warp: with a ninth warp ptxas gives each
// thread at most 168 registers (3 warps share a quarter of the register
// file) and the D-192 / D-256 accumulators spill; with 8 warps a thread may
// have 255.  The first warp issues the loads, each stage's refill as soon as
// both warpgroups are done with it.
constexpr int THREADS = 256;
constexpr int KEYS = 64;      // dK/dV: keys a block (the M side of its products)
constexpr int QROWS = 128;    // dQ: query rows a block, 64 a warpgroup
constexpr int STAGES = 2;

template <int D>
struct Cfg {
  static constexpr int DC = (D + 63) / 64;       // 64-column (128-byte) boxes of a row
  static constexpr int DP = 64 * DC;             // accumulator columns
  static constexpr int KSTEPS = (D + 15) / 16;   // k16 steps over the head dim
  static constexpr int ROWS = D == 256 ? 32 : 64;   // dK/dV: query rows a step
  static constexpr int QKEYS = D == 256 ? 32 : 64;  // dQ: keys a step
  // dK/dV: K and V (once), then STAGES of (Q, dO), then each stage's LSE and Δ
  static constexpr int K_BOX = KEYS * 128;
  static constexpr int R_BOX = ROWS * 128;
  static constexpr int KV_BYTES = DC * K_BOX;
  static constexpr int STEP_BYTES = 2 * DC * R_BOX;
  static constexpr int STAT_OFF = 2 * KV_BYTES + STAGES * STEP_BYTES;
  static constexpr int KVP_BAR = STAT_OFF + STAGES * 2 * 4 * ROWS;
  // then the barriers, then the dead rows' Σ dO/Lk, one fp32 a column
  static constexpr int DEAD_OFF = (KVP_BAR + 8 * (2 * STAGES + 1) + 15) & ~15;
  static constexpr int KVP_SMEM = 1024 + DEAD_OFF + 4 * D;
  // dQ: Q and dO (once), then STAGES of (K, V)
  static constexpr int Q_BOX = QROWS * 128;
  static constexpr int QK_BOX = QKEYS * 128;
  static constexpr int QP_STAGE = 2 * DC * QK_BOX;
  static constexpr int QP_BAR = 2 * DC * Q_BOX + STAGES * QP_STAGE;
  static constexpr int QP_SMEM = 1024 + QP_BAR + 8 * (2 * STAGES + 1);
};

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// 2^x on the special function unit (flushes subnormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) less their bf16 pair hi (pack_bf16(x0, x1)), packed to bf16: the
// low part of a split operand, hi + lo within 2^-17 of x
__device__ __forceinline__ uint32_t pack_lo(uint32_t hi, float x0, float x1) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return pack_bf16(x0 - h.x, x1 - h.y);
}

// d (64 x 32, fp32) = A (64 x 16) @ B (16 x 32) (+ d): as m64n64k16, a
// quarter of m64n128k16's columns (d[4j + 2h + e] is row (lane / 4) + 8h,
// column 8j + 2·(lane % 4) + e, j < 4)
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TransA), "n"(TransB));
}

// acc (64 x N) = A (64 rows at sa) · B (N rows at sb)ᵀ over the head dim, both
// K-major in 64-column boxes a_box / b_box bytes apart: a k16 step is 32
// bytes along each swizzled 128-byte row; steps wholly past D are skipped
template <int D, int N>
__device__ __forceinline__ void ss(float (&acc)[N / 2], uint32_t sa, uint32_t a_box, uint32_t sb,
                                   uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < Cfg<D>::KSTEPS; ++kk) {
    const int c = kk / 4;
    const int j = kk % 4;
    const uint64_t da = smem_desc(sa + c * a_box + j * 32, 16, 1024);
    const uint64_t db = smem_desc(sb + c * b_box + j * 32, 16, 1024);
    if constexpr (N == 64) {
      wgmma_m64n64k16<0, 0>(acc, da, db, kk != 0);
    } else {
      wgmma_m64n32k16<0, 0>(acc, da, db, kk != 0);
    }
  }
}

// acc (64 x DP) += A (64 x R, registers: 4u..4u+3 hold depth 16u..16u+15) ·
// B (R rows at sb, MN-major: its 64-column boxes b_box bytes apart (LBO),
// 8-row groups 1024 (SBO), a k16 step 16 rows further)
template <int D, int R>
__device__ __forceinline__ void rs(float (&acc)[Cfg<D>::DP / 2], const uint32_t (&a)[R / 4],
                                   uint32_t sb, uint32_t b_box) {
  constexpr int DP = Cfg<D>::DP;
#pragma unroll
  for (int u = 0; u < R / 16; ++u) {
    const uint32_t f[4] = {a[4 * u], a[4 * u + 1], a[4 * u + 2], a[4 * u + 3]};
    const uint64_t db = smem_desc(sb + u * 16 * 128, b_box, 1024);
    if constexpr (DP == 64) {
      wgmma_rs_m64n64k16<1>(acc, f, db, 1);
    } else if constexpr (DP == 128) {
      wgmma_rs_m64n128k16<1>(acc, f, db, 1);
    } else if constexpr (DP == 192) {
      wgmma_rs_m64n192k16<1>(acc, f, db, 1);
    } else {
      wgmma_rs_m64n256k16<1>(acc, f, db, 1);
    }
  }
}

// scores of an accumulator tile, scaled and soft-capped as the forward does
template <int N>
__device__ __forceinline__ void scale_cap(float (&s)[N], const BwdArgs& a) {
#pragma unroll
  for (int j = 0; j < N; ++j) s[j] *= a.scale;
  if (a.softcap > 0.f) {
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] = tanhf(s[j] / a.softcap) * a.softcap;
  }
}

// dK/dV.  Block w takes slot·KV head w % (B·KV) and key tile w / (B·KV): the
// first key tiles (the most causal query tiles) first.  Warpgroup 0
// accumulates dK, warpgroup 1 dV, over the same 64 keys.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
             BwdArgs a) {
  using C = Cfg<D>;
  constexpr int R = C::ROWS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* const stats = reinterpret_cast<float*>(smem_raw + (base - raw) + C::STAT_OFF);
  const uint32_t sk = base;
  const uint32_t sv = base + C::KV_BYTES;
  auto sq = [&](int i) { return base + 2 * C::KV_BYTES + (i % STAGES) * C::STEP_BYTES; };
  auto sdo = [&](int i) { return sq(i) + C::DC * C::R_BOX; };
  auto stat = [&](int i) { return stats + (i % STAGES) * 2 * R; };  // LSE, then Δ
  const uint32_t bars = base + C::KVP_BAR;
  auto full = [&](int i) { return bars + 8u * (i % STAGES); };
  auto empty = [&](int i) { return bars + 8u * (STAGES + i % STAGES); };
  const uint32_t kvbar = bars + 8u * (2 * STAGES);
  auto parity = [&](int i) { return static_cast<uint32_t>((i / STAGES) & 1); };
  float* const dead_sum = reinterpret_cast<float*>(smem_raw + (base - raw) + C::DEAD_OFF);

  const int slots = a.b * a.kv;
  const int w = blockIdx.x;
  const int b = (w % slots) / a.kv;
  const int kvh = (w % slots) % a.kv;
  const int k0 = (w / slots) * KEYS;
  const int g = a.h / a.kv;
  const int off = slot_offset(a, b);
  const int2 qt = query_tiles(k0, a.lk, off, a.lq, a.causal, a.window, KEYS, R);
  const int nt = qt.y - qt.x;
  const int n = g * nt;  // steps: the group's heads in order, each head's query tiles

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // step i's Q and dO boxes (TMA, lane 0) and its rows' LSE and Δ (the
  // warp's lanes, then lane 0's arrival publishes them): the first warp
  auto load_step = [&](int i) {
    const int head = kvh * g + i / nt;
    const int q0 = (qt.x + i % nt) * R;
    float* st = stat(i);
    for (int r = tid; r < R; r += 32) {
      const bool in = q0 + r < a.lq;
      const size_t idx = (static_cast<size_t>(b) * a.h + head) * a.lq + q0 + r;
      st[r] = in ? a.lse[idx] : 0.f;
      st[R + r] = in ? a.delta[idx] : 0.f;
    }
    __syncwarp();
    if (tid == 0) {
      mbar_expect_tx(full(i), C::STEP_BYTES);
      for (int c = 0; c < C::DC; ++c) {
        tma_load_4d(sq(i) + c * C::R_BOX, &tq, full(i), 64 * c, head, q0, b);
        tma_load_4d(sdo(i) + c * C::R_BOX, &tdo, full(i), 64 * c, head, q0, b);
      }
    }
    __syncwarp();
  };
  if (tid < 32) {
    if (tid == 0) {
      mbar_expect_tx(kvbar, 2 * C::KV_BYTES);
      for (int c = 0; c < C::DC; ++c) {
        tma_load_4d(sk + c * C::K_BOX, &tk, kvbar, 64 * c, kvh, k0, b);
        tma_load_4d(sv + c * C::K_BOX, &tv, kvbar, 64 * c, kvh, k0, b);
      }
    }
    for (int i = 0; i < n && i < STAGES; ++i) load_step(i);
  }

  const int group = tid / 128;
  const int lane = tid % 128;
  const int r_in = (lane / 32) * 16 + (lane % 32) / 4;  // accumulator row (h = 0); h = 1 at +8
  const int cq = (lane % 4) * 2;                        // its first accumulator column
  const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;
  mbar_wait(kvbar, 0);

  auto run = [&](auto role) {
    constexpr bool DK = decltype(role)::value;
    float acc[C::DP / 2];
#pragma unroll
    for (int j = 0; j < C::DP / 2; ++j) acc[j] = 0.f;
    float st[R / 2];
    float dpt[R / 2];
    uint32_t frag[R / 4];
    uint32_t lo[R / 4];  // dSᵀ's low part (the dK warpgroup)
    for (int i = 0; i < n; ++i) {
      const int q0 = (qt.x + i % nt) * R;
      mbar_wait(full(i), parity(i));
#pragma unroll
      for (int j = 0; j < R / 2; ++j) st[j] = 0.f;
      fence_acc(st);
      if constexpr (DK) {
#pragma unroll
        for (int j = 0; j < R / 2; ++j) dpt[j] = 0.f;
        fence_acc(dpt);
      }
      wgmma_fence();
      ss<D, R>(st, sk, C::K_BOX, sq(i), C::R_BOX);  // Sᵀ = K·Qᵀ
      if constexpr (DK) ss<D, R>(dpt, sv, C::K_BOX, sdo(i), C::R_BOX);  // dPᵀ = V·dOᵀ
      wgmma_commit();
      wgmma_wait0();
      fence_acc(st);
      if constexpr (DK) fence_acc(dpt);
      scale_cap(st, a);
      const float* lse = stat(i);
      const float* del = lse + R;
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + cq + e;  // the query row q0 + col
          const float l = lse[col];
          const float dl = del[col];
          const int qp = off + q0 + col;
          const bool in = q0 + col < a.lq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int idx = 4 * j + 2 * h + e;
            const float s = st[idx];
            const bool ok = in & live(a, k0 + r_in + 8 * h, qp);
            const float p = ok ? ex2((s - l) * LOG2E) : 0.f;
            if constexpr (DK) {
              const float u = s * inv_cap;
              st[idx] = p * (dpt[idx] - dl) * (1.f - u * u);
            } else {
              st[idx] = p;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < R / 4; ++u) {
        frag[u] = pack_bf16(st[2 * u], st[2 * u + 1]);
        if constexpr (DK) lo[u] = pack_lo(frag[u], st[2 * u], st[2 * u + 1]);
      }
      fence_acc(acc);
      fence_regs(frag);
      if constexpr (DK) fence_regs(lo);
      wgmma_fence();
      rs<D, R>(acc, frag, DK ? sq(i) : sdo(i), C::R_BOX);  // dK += dSᵀ_hi·Q, dV += Pᵀ·dO
      if constexpr (DK) rs<D, R>(acc, lo, sq(i), C::R_BOX);  // dK += dSᵀ_lo·Q
      wgmma_commit();
      wgmma_wait0();
      fence_acc(acc);
      fence_regs(frag);
      if constexpr (DK) fence_regs(lo);
      if (lane == 0) mbar_arrive(empty(i));
      if constexpr (DK) {
        // the first warp refills the stage once both warpgroups released it
        if (tid < 32 && i + STAGES < n) {
          mbar_wait(empty(i), parity(i));
          load_step(i + STAGES);
        }
      }
    }
    if constexpr (!DK) {
      // the rows that see no key add Σ dO/Lk (each head of the group in
      // order, then the rows) to every key's dv: a column a thread, summed
      // into shared memory for the epilogue (so no column's sum sits in
      // registers beside the accumulator)
      const int2 dead = dead_rows(off, a.lq, a.lk, a.causal, a.window);
      const float inv_lk = 1.f / a.lk;
      for (int col = lane; col < D; col += 128) {
        float c = 0.f;
        for (int hh = 0; hh < g; ++hh) {
          const bf16* go = static_cast<const bf16*>(a.dout) + static_cast<size_t>(b) * a.lq * a.h * D +
                           static_cast<size_t>(kvh * g + hh) * D + col;
          for (int r = 0; r < dead.x; ++r)
            c += __bfloat162float(go[static_cast<size_t>(r) * a.h * D]) * inv_lk;
          for (int r = dead.y; r < a.lq; ++r)
            c += __bfloat162float(go[static_cast<size_t>(r) * a.h * D]) * inv_lk;
        }
        dead_sum[col] = c;
      }
      asm volatile("bar.sync 1, 128;" ::: "memory");  // the dV warpgroup alone
    }
    const float mul = DK ? a.scale : 1.f;
    bf16* const out = static_cast<bf16*>(DK ? a.dk : a.dv);
#pragma unroll
    for (int j = 0; j < C::DP / 8; ++j) {
      const int col = 8 * j + cq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = k0 + r_in + 8 * h;
        if (key < a.lk && col < D) {
          float x0 = acc[4 * j + 2 * h] * mul;
          float x1 = acc[4 * j + 2 * h + 1] * mul;
          if constexpr (!DK) {
            x0 += dead_sum[col];
            x1 += dead_sum[col + 1];
          }
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((static_cast<size_t>(b) * a.lk + key) * a.kv + kvh) * D + col) =
              __floats2bfloat162_rn(x0, x1);
        }
      }
    }
  };
  if (group == 0) {
    run(std::true_type{});
  } else {
    run(std::false_type{});
  }
}

// dQ.  Block w takes slot·head w % (B·H) and query block nqb - 1 - w / (B·H):
// the last (longest causal) query blocks first, as the forward.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_q_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
            BwdArgs a) {
  using C = Cfg<D>;
  constexpr int NK = C::QKEYS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = base + C::DC * C::Q_BOX;
  auto sk = [&](int i) { return base + 2 * C::DC * C::Q_BOX + (i % STAGES) * C::QP_STAGE; };
  auto sv = [&](int i) { return sk(i) + C::DC * C::QK_BOX; };
  const uint32_t bars = base + C::QP_BAR;
  auto full = [&](int i) { return bars + 8u * (i % STAGES); };
  auto empty = [&](int i) { return bars + 8u * (STAGES + i % STAGES); };
  const uint32_t qbar = bars + 8u * (2 * STAGES);
  auto parity = [&](int i) { return static_cast<uint32_t>((i / STAGES) & 1); };

  const int heads = a.b * a.h;
  const int w = blockIdx.x;
  const int bh = w % heads;
  const int q0 = ((a.lq + QROWS - 1) / QROWS - 1 - w / heads) * QROWS;
  const int b = bh / a.h;
  const int head = bh % a.h;
  const int kvh = head / (a.h / a.kv);
  const int rows = min(QROWS, a.lq - q0);
  const int off = slot_offset(a, b);
  const int2 kt = key_tiles(off + q0, off + q0 + rows - 1, a.lk, a.causal, a.window, NK);
  const int n = kt.y - kt.x;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // stage i's K and V: thread 0 issues every load
  auto load_keys = [&](int i) {
    mbar_expect_tx(full(i), C::QP_STAGE);
    const int k0 = (kt.x + i) * NK;
    for (int c = 0; c < C::DC; ++c) {
      tma_load_4d(sk(i) + c * C::QK_BOX, &tk, full(i), 64 * c, kvh, k0, b);
      tma_load_4d(sv(i) + c * C::QK_BOX, &tv, full(i), 64 * c, kvh, k0, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, 2 * C::DC * C::Q_BOX);
    for (int c = 0; c < C::DC; ++c) {
      tma_load_4d(sq + c * C::Q_BOX, &tq, qbar, 64 * c, head, q0, b);
      tma_load_4d(sdo + c * C::Q_BOX, &tdo, qbar, 64 * c, head, q0, b);
    }
    for (int i = 0; i < n && i < STAGES; ++i) load_keys(i);
  }

  const int group = tid / 128;
  const int lane = tid % 128;
  const int r_in = (lane / 32) * 16 + (lane % 32) / 4;
  const int cq = (lane % 4) * 2;
  const int row0 = q0 + group * 64;  // this warpgroup's first query row
  if (row0 >= a.lq) {
    // every row of this warpgroup lies past Lq: keep the ring's counts only
    for (int i = 0; i < n; ++i) {
      mbar_wait(full(i), parity(i));
      if (lane == 0) mbar_arrive(empty(i));
    }
    return;
  }
  float lse[2], del[2];
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + r_in + 8 * h;
    const size_t idx = (static_cast<size_t>(b) * a.h + head) * a.lq + r;
    lse[h] = r < a.lq ? a.lse[idx] : 0.f;
    del[h] = r < a.lq ? a.delta[idx] : 0.f;
    qp[h] = r < a.lq ? off + r : -(1 << 30);  // rows past Lq see no key
  }
  const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;
  const uint32_t sq_wg = sq + group * 64 * 128;  // this warpgroup's rows in each box
  const uint32_t sdo_wg = sdo + group * 64 * 128;

  float acc[C::DP / 2];
#pragma unroll
  for (int j = 0; j < C::DP / 2; ++j) acc[j] = 0.f;
  float s[NK / 2];
  float dp[NK / 2];
  uint32_t frag[NK / 4];
  uint32_t lo[NK / 4];  // dS's low part
  mbar_wait(qbar, 0);
  for (int i = 0; i < n; ++i) {
    const int k0 = (kt.x + i) * NK;
    mbar_wait(full(i), parity(i));
#pragma unroll
    for (int j = 0; j < NK / 2; ++j) s[j] = dp[j] = 0.f;
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
    ss<D, NK>(s, sq_wg, C::Q_BOX, sk(i), C::QK_BOX);     // S = Q·Kᵀ
    ss<D, NK>(dp, sdo_wg, C::Q_BOX, sv(i), C::QK_BOX);   // dP = dO·Vᵀ
    wgmma_commit();
    wgmma_wait0();
    fence_acc(s);
    fence_acc(dp);
    scale_cap(s, a);
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * h + e;
          const float sc = s[idx];
          const bool ok = live(a, k0 + 8 * j + cq + e, qp[h]) & (qp[h] > -(1 << 30));
          const float p = ok ? ex2((sc - lse[h]) * LOG2E) : 0.f;
          const float u = sc * inv_cap;
          s[idx] = p * (dp[idx] - del[h]) * (1.f - u * u);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < NK / 4; ++u) {
      frag[u] = pack_bf16(s[2 * u], s[2 * u + 1]);
      lo[u] = pack_lo(frag[u], s[2 * u], s[2 * u + 1]);
    }
    fence_acc(acc);
    fence_regs(frag);
    fence_regs(lo);
    wgmma_fence();
    rs<D, NK>(acc, frag, sk(i), C::QK_BOX);  // dQ += dS_hi·K
    rs<D, NK>(acc, lo, sk(i), C::QK_BOX);    // dQ += dS_lo·K
    wgmma_commit();
    wgmma_wait0();
    fence_acc(acc);
    fence_regs(frag);
    fence_regs(lo);
    if (lane == 0) mbar_arrive(empty(i));
    // the first warp refills the stage once both warpgroups released it
    // (the whole warp waits, so it stays converged for the next wgmma)
    if (tid < 32 && i + STAGES < n) {
      if (tid == 0) {
        mbar_wait(empty(i), parity(i));
        load_keys(i + STAGES);
      }
      __syncwarp();
    }
  }
  bf16* const out = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int j = 0; j < C::DP / 8; ++j) {
    const int col = 8 * j + cq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + r_in + 8 * h;
      if (r < a.lq && col < D) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + ((static_cast<size_t>(b) * a.lq + r) * a.h + head) * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * a.scale, acc[4 * j + 2 * h + 1] * a.scale);
      }
    }
  }
}

}  // namespace bw

// ---------------------------------------------------------------------------
// host side

enum Body { FMA = 0, WGMMA = 1 };

template <typename T, int D>
int launch_fma(const BwdArgs& a, int passes, cudaStream_t s) {
  const int bytes = static_cast<int>(bt::Lay<D>::bytes);
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(bt::bwd_kv_tile<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(bt::bwd_q_tile<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  if (passes & 2) {
    const dim3 grid((a.lk + bt::TILE - 1) / bt::TILE, a.b * a.kv);
    bt::bwd_kv_tile<T, D><<<grid, bt::THREADS, bytes, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 1) {
    const dim3 grid((a.lq + bt::TILE - 1) / bt::TILE, a.b * a.h);
    bt::bwd_q_tile<T, D><<<grid, bt::THREADS, bytes, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int D>
int launch_wgmma(const BwdArgs& a, int passes, cudaStream_t s) {
  using C = bw::Cfg<D>;
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        bw::bwd_kv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::KVP_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(bw::bwd_q_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::QP_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  CUtensorMap tq, tdo, tk, tv;
  if (passes & 2) {
    int rc = tensor_map_heads(&tq, a.q, a.b, a.lq, a.h, D, C::ROWS);
    if (rc == 0) rc = tensor_map_heads(&tdo, a.dout, a.b, a.lq, a.h, D, C::ROWS);
    if (rc == 0) rc = tensor_map_heads(&tk, a.k, a.b, a.lk, a.kv, D, bw::KEYS);
    if (rc == 0) rc = tensor_map_heads(&tv, a.v, a.b, a.lk, a.kv, D, bw::KEYS);
    if (rc != 0) return rc;
    const long long blocks = static_cast<long long>((a.lk + bw::KEYS - 1) / bw::KEYS) * a.b * a.kv;
    bw::bwd_kv_wgmma<D><<<static_cast<unsigned>(blocks), bw::THREADS, C::KVP_SMEM, s>>>(
        tq, tdo, tk, tv, a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 1) {
    int rc = tensor_map_heads(&tq, a.q, a.b, a.lq, a.h, D, bw::QROWS);
    if (rc == 0) rc = tensor_map_heads(&tdo, a.dout, a.b, a.lq, a.h, D, bw::QROWS);
    if (rc == 0) rc = tensor_map_heads(&tk, a.k, a.b, a.lk, a.kv, D, C::QKEYS);
    if (rc == 0) rc = tensor_map_heads(&tv, a.v, a.b, a.lk, a.kv, D, C::QKEYS);
    if (rc != 0) return rc;
    const long long blocks = static_cast<long long>((a.lq + bw::QROWS - 1) / bw::QROWS) * a.b * a.h;
    bw::bwd_q_wgmma<D><<<static_cast<unsigned>(blocks), bw::THREADS, C::QP_SMEM, s>>>(
        tq, tdo, tk, tv, a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
int launch_dim(const BwdArgs& a, int d, int body, int passes, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (body == WGMMA) {
      switch (d) {
        case 64: return launch_wgmma<64>(a, passes, s);
        case 96: return launch_wgmma<96>(a, passes, s);
        case 112: return launch_wgmma<112>(a, passes, s);
        case 128: return launch_wgmma<128>(a, passes, s);
        case 192: return launch_wgmma<192>(a, passes, s);
        case 256: return launch_wgmma<256>(a, passes, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  switch (d) {
    case 16: return launch_fma<T, 16>(a, passes, s);
    case 32: return launch_fma<T, 32>(a, passes, s);
    default: break;
  }
  if constexpr (std::is_same<T, bf16>::value) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64: return launch_fma<T, 64>(a, passes, s);
    case 96: return launch_fma<T, 96>(a, passes, s);
    case 112: return launch_fma<T, 112>(a, passes, s);
    case 128: return launch_fma<T, 128>(a, passes, s);
    case 192: return launch_fma<T, 192>(a, passes, s);
    case 256: return launch_fma<T, 256>(a, passes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One backward call under a plan (kernels/flash_attention.py::plan_backward).
// dtype: 0 = fp32, 1 = bf16.  body: 0 = fma (fp32, or bf16 at d 16 / 32; every
// tile 32: kv_keys = kv_rows = q_rows = q_keys = 32), 1 = wgmma (bf16 at d 64
// / 96 / 112 / 128 / 192 / 256; kv_keys 64, kv_rows 64 (32 at d 256), q_rows
// 128, q_keys 64 (32 at d 256)).  passes: 1 dQ, 2 dK/dV, 3 both.  delta:
// (b, h, lq) fp32 scratch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* delta, const void* q_off, int q_off0,
    int b, int lq, int lk, int h, int kv, int d, int causal, int window, float scale,
    float softcap, int dtype, int body, int kv_keys, int kv_rows, int q_rows, int q_keys,
    int passes, void* stream) {
  if (b <= 0 || lq <= 0 || lk <= 0 || kv <= 0 || h % kv != 0 || (dtype != 0 && dtype != 1) ||
      (d != 16 && d != 32 && d != 64 && d != 96 && d != 112 && d != 128 && d != 192 &&
       d != 256) ||
      passes < 1 || passes > 3 || q == nullptr || k == nullptr || v == nullptr ||
      o == nullptr || lse == nullptr || dout == nullptr || delta == nullptr ||
      ((passes & 1) && dq == nullptr) || ((passes & 2) && (dk == nullptr || dv == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bool ok = false;
  if (body == FMA) {
    ok = (dtype == 0 || d <= 32) && kv_keys == bt::TILE && kv_rows == bt::TILE &&
         q_rows == bt::TILE && q_keys == bt::TILE && static_cast<long long>(b) * h <= 65535;
  } else if (body == WGMMA) {
    ok = dtype == 1 && d >= 64 && kv_keys == bw::KEYS && kv_rows == (d == 256 ? 32 : 64) &&
         q_rows == bw::QROWS && q_keys == (d == 256 ? 32 : 64) &&
         static_cast<long long>((lk + bw::KEYS - 1) / bw::KEYS) * b * kv <= 0x7fffffffll &&
         static_cast<long long>((lq + bw::QROWS - 1) / bw::QROWS) * b * h <= 0x7fffffffll;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q, k, v, o, static_cast<const float*>(lse), dout, dq, dk, dv,
            static_cast<float*>(delta), static_cast<const int*>(q_off), q_off0,
            b, lq, lk, h, kv, causal, window, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(b) * lq * h;
  const unsigned blocks = static_cast<unsigned>((rows * 32 + 255) / 256);
  if (dtype == 0) {
    fab_delta<float><<<blocks, 256, 0, s>>>(a, d);
  } else {
    fab_delta<bf16><<<blocks, 256, 0, s>>>(a, d);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0) return launch_dim<float>(a, d, body, passes, s);
  return launch_dim<bf16>(a, d, body, passes, s);
}
