// Blockwise online-softmax attention (flash), written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (its pallas_call at :100) and computes what the JAX model path computes
// (src/repro/models/attention.py:31, the kernel's own oracle): scores q·kᵀ with
// fp32 accumulation times 1/√D at the TRUE head dim, an optional soft cap
// tanh(s/c)·c, causal / sliding-window / key-padding masks against absolute
// positions (a scalar query offset or one per slot), masked scores -1e30,
// running (max, denominator, accumulator) in fp32, the probabilities cast to
// v's dtype before the PV product, and the output divided by max(l, 1e-20).
// The Pallas kernel instead scales q first and multiplies in fp32 throughout;
// this one keeps the model path's rounding, which is what the port's callers
// are held to.
//
// Layouts are the model's, read in place: q, o (B, Lq, H·D) and k, v
// (B, Lk, KV·D) contiguous; query head h reads KV head h / (H / KV) (GQA).
//
// Bound on an H100: max(4·B·H·Σ live keys·D flops / peak, (q + k + v + o)
// bytes / 3.35 TB/s).  Prefill (Lq = Lk = 1024, D 128 or 192) does ~500
// flops a byte in bf16, above the card's ~295: the tensor cores bound it.  A
// one-token decode reads the whole live cache for 4·D flops a key and head:
// bytes bound it.  The launch plan (kernels/flash_attention.py::plan) picks
// one of five bodies a call:
//
//   wgmma (bf16, D 64 / 96 / 112 / 128 / 192 / 256; prefill, chunked prefill,
//     latent and MLA prefill, and any Lq under ops.batch_invariant): one block
//     a (batch·head, 128 query rows), issued longest first (the last query
//     blocks carry the most causal key tiles).  A producer thread loads Q once
//     and keeps a 2-stage ring of K and V tiles filled by TMA (at D 64 a K
//     ring and a V ring), all three read in place through 4D tensor maps on
//     (B, L, heads, D) in 64-column boxes, whose zero fill ends each head at
//     D and each batch's sequence (D 96 and 112 run the D-128 layout at their
//     true width: the second box of a row arrives zero-filled past D, Q·Kᵀ
//     takes ⌈D/16⌉ k16 steps).  Two consumer warpgroups of 64 query rows
//     each run S = Q·Kᵀ as wgmma with both operands K-major (128 keys a tile
//     at D <= 128, 64 at D 192 / 256 to fit the registers), the softmax in
//     the accumulator registers (a row is held by 4 lanes, reduced with
//     shuffles), then O += P·V as wgmma with P in registers (the S
//     accumulator rounded to bf16 in pairs is already wgmma's A fragment)
//     and V read MN-major through the transpose bit; O stays in registers
//     across the key loop and is rescaled there.  At D 64 a score's exponential costs as much as its 256
//     tensor-core flops, and the tile-at-a-time order (Q·Kᵀ, wait, softmax,
//     P·V, wait) leaves the tensor cores idle under every softmax: there a
//     warpgroup issues S_t = Q·K_tᵀ together with O += P_{t-1}·V_{t-1} and
//     runs the softmax of tile t under the latter, and the two warpgroups
//     take turns to issue (FlashAttention-3's ping-pong, on two named
//     barriers), so one's softmax runs beside the other's products.  Each
//     element sees the same operations in the same order as one tile at a
//     time: the bits do not change.  Register reallocation gives the
//     consumers 232 registers a thread; at D 256, where O alone is 128 of
//     them, the block is the two consumer warpgroups alone (255 registers a
//     thread), and lane 0 of the first issues the loads.  Epilogue: o /
//     max(l, 1e-20) in registers, staged in the warpgroup's own rows of the
//     Q tile once its last Q·Kᵀ is done (in Q's 128-byte swizzle, so neither
//     side conflicts on banks), stored with 16-byte accesses, rows past Lq
//     not stored.  Shared memory at D 256: Q 64 KB and two stages of 64-key
//     K + V tiles, 128 KB.
//   split (Lq 1 outside batch_invariant where split_mma does not take it:
//     fp32, D 16 / 32, one query head a KV head; dense-cache decode): one
//     block a (slot, KV head, key span) takes the G = H / KV query heads of
//     its group; K and V rows of the span's live keys are read once, by
//     16-byte cp.async into a 2-stage ring of shared-memory tiles; scores and
//     P·V on the FMA units in fp32 (bytes bound the work: about 2·D flops a
//     byte), p rounded to v's dtype before P·V.  Each span writes its fp32
//     partial (m, l, acc); a span with no live key writes l = 0.  A second
//     launch (flash_merge, a programmatic dependent launch, one block a row
//     and 64 columns) reads a row's span m and l once, weighs each live span
//     once and adds the partials in span order, skipping empty ones: no
//     atomics, so two calls give the same bits.
//   split_mma (the same calls in bf16 at D 64 / 96 / 112 / 128 / 192 / 256
//     with 2 to 16 query heads a KV head: GQA decode): split's blocks and
//     partials, the group's heads zero-padded to one m16 tile on the tensor
//     cores.  The FMA body spends two shared-memory loads a multiply-add in
//     P·V and one in the scores, which binds it at G > 1; here S = Q·Kᵀ and
//     O += P·V run as mma.sync m16n8k16 (ldmatrix, V transposed), O in
//     registers, K and V through a 3-stage ring of 64-key tiles (32 at D >
//     128), so each K and V row is read once for all G heads.  Its spans
//     hold at least 4 tiles and aim at one wave of resident blocks.
//   fma32 (fp32, Lq > 1 or batch_invariant) and wmma (bf16 at D 16 / 32):
//     the first version: one block of 4 warps a (batch·head, 64 query rows),
//     64-key tiles (32 at D 256, whose fp32 tiles would need 272 KB at 64)
//     staged in shared memory through registers; S and P·V on WMMA 16x16x16
//     fragments (bf16) or the FMA units (fp32, TF32 off).
//
// Key tiles start at absolute key 0 and are walked in one fixed order; tiles
// wholly past the causal limit of the block's last row, or wholly before the
// window of its first row, are skipped (key_tiles; Plan.key_tiles is the same
// arithmetic).  That is exact: a tile past a row's causal limit comes after a
// live key and adds exactly 0 (p = exp(-1e30 - m) = 0, the correction 1); one
// before its window is cleared by a correction of exp(-1e30 - m) = 0 once a
// live key arrives.  So in the tile bodies a query row's bits depend neither
// on Lq, nor on where its block starts, nor on B: chunked prefill equals whole
// prefill bit for bit.
//
// Contract (checked by the wrapper, kernels/ops.py::flash_attention; the
// launcher refuses what kernels/flash_attention.py::plan never makes): q, k,
// v, o of one dtype, contiguous, 16-byte aligned; D one of 16, 32, 64, 96,
// 112, 128, 192, 256 (the wrapper zero-pads any other head dim and passes the
// scale of the true one; 96 is phi-3-vision's, 112 kimi-k2's and zamba2's,
// both read in place; 192 is MLA prefill's qk_nope 128 + qk_rope 64, with v
// zero-padded to it; 256 is gemma3's head dim); q_off null (every slot at
// q_off0) or a (B,) int32 device vector; the
// split body's scratch B·H·spans·(D + 2) floats.  Returns the first non-zero
// cudaError of the call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

namespace wmma = nvcuda::wmma;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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
  float* lse;  // (B, H, Lq) fp32 or null: each row's m + log(l) (tile bodies)
};

// The key tiles [begin, end) of width `bkey` that the query rows at absolute
// positions [first, last] walk: none past the causal limit of the last row,
// none wholly before the window of the first.
__device__ __forceinline__ int2 key_tiles(int first, int last, int lk, int causal,
                                          int window, int bkey) {
  int end = (lk + bkey - 1) / bkey;
  if (causal) end = min(end, last / bkey + 1);
  int begin = 0;
  if (window > 0 && first - window + 1 > 0) begin = (first - window + 1) / bkey;
  return make_int2(begin, max(begin, end));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// fma32 / wmma: the first version (fp32 at every D, bf16 at D 16 / 32)

namespace ft {

constexpr int BQ = 64;        // query rows per block
constexpr int THREADS = 128;  // 4 warps
constexpr int FR = 16;        // WMMA fragment edge

// row padding (elements) of the tiles: keeps rows 16-byte aligned for vector
// stores and the WMMA leading dimensions legal (8 bf16 / 4 fp32 multiples)
template <typename T>
__host__ __device__ constexpr int pad() { return std::is_same<T, bf16>::value ? 8 : 4; }

// keys per tile: 64, and 32 at D 256 (at 64 its fp32 tiles need 272 KB)
template <int D>
__host__ __device__ constexpr int bkey() { return D == 256 ? 32 : 64; }

// fp32 tiles write p over the scores they were made from (sP aliases sS): each
// softmax thread reads its half-row of s into registers before it writes p there,
// and no other thread touches that half-row.  That keeps the fp32 D = 192 tile
// set (213.5 KB) under the 227 KB a block may have; bf16 keeps a separate sP.
template <typename T, int D>
struct Layout {
  static constexpr bool P_IN_S = std::is_same<T, float>::value;
  static constexpr int BKEY = bkey<D>();
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
  constexpr int BKEY = Lay::BKEY;
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
    constexpr int KPT = BKEY / 16;  // keys per thread
    const int ty = tid / 16;        // rows ty*8 .. +8
    const int tx = tid % 16;        // keys tx*KPT .. +KPT
    float acc[8][KPT];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < KPT; ++j) acc[i][j] = 0.f;
    }
    for (int d = 0; d < D; ++d) {
      float a[8], bk[KPT];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sQ[(ty * 8 + i) * Lay::LD + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) bk[j] = sK[(tx * KPT + j) * Lay::LD + d];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < KPT; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < KPT; ++j) sS[(ty * 8 + i) * Lay::LS + tx * KPT + j] = acc[i][j];
    }
  }
}

// O (BQ x D, fp32) += P V
template <typename T, int D>
__device__ __forceinline__ void accumulate_pv(const T* sP, const T* sV, float* sO,
                                              int tid) {
  using Lay = Layout<T, D>;
  constexpr int BKEY = Lay::BKEY;
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

// grid (query blocks, B·H): block (x, y) takes query block x of batch·head y
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_tile(Args a) {
  using Lay = Layout<T, D>;
  constexpr int BKEY = Lay::BKEY;
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
  const int2 kt = key_tiles(off + q0, off + q0 + rows - 1, a.lk, a.causal, a.window, BKEY);
  __syncthreads();

  const T* k_head = k + static_cast<size_t>(b) * a.lk * k_stride +
                    static_cast<size_t>(kvh) * D;
  const T* v_head = v + static_cast<size_t>(b) * a.lk * k_stride +
                    static_cast<size_t>(kvh) * D;
  const int r = tid / 2;     // softmax: two threads a row
  const int part = tid % 2;  // ... each half of the keys
  const int qpos = off + q0 + r;

  for (int t = kt.x; t < kt.y; ++t) {
    const int k0 = t * BKEY;
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
  if (a.lse != nullptr) {
    for (int rr = tid; rr < rows; rr += THREADS) {
      a.lse[(static_cast<size_t>(b) * a.h + head) * a.lq + q0 + rr] = sM[rr] + logf(sL[rr]);
    }
  }
}

}  // namespace ft

// ---------------------------------------------------------------------------
// wgmma (bf16, D 64 / 96 / 112 / 128 / 192 / 256): a TMA ring of K and V
// tiles, wgmma for S and for P·V with P in registers

namespace fw {

constexpr int BQ = 128;  // query rows a block: two consumer warpgroups of 64
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128·40 + 256·232 <= 65536

// D 96 and 112 run the D-128 layout: a row's second 64-column box arrives
// zero-filled past D (the 4D tensor maps end each head at D), Q·Kᵀ stops
// at the last k16 step that holds a column below D, and P·V keeps its
// m64n128 product, whose columns past D are zero and never stored.
template <int D>
struct Cfg {
  static constexpr int DC = (D + 63) / 64;          // 64-column (128-byte) boxes of a row
  static constexpr int DP = 64 * DC;                // columns of the boxes and of O
  static constexpr int KSTEPS = (D + 15) / 16;      // k16 steps of Q·Kᵀ
  static constexpr int BKEY = DP <= 128 ? 128 : 64;  // keys a tile
  // D 64, where a score's exponential costs as much as its 256 tensor-core
  // flops, overlaps each warpgroup's tensor-core work with its softmax and
  // lets the two warpgroups take turns to issue.  A warpgroup then holds V
  // of one tile and K of the next at once, so K and V have rings of their
  // own: a K tile is free once its Q·Kᵀ is done, a V tile once its P·V is.
  static constexpr bool OVERLAP = D == 64;
  static constexpr int STAGES = 2;
  // two consumer warpgroups and a producer warpgroup whose registers go to
  // them (setmaxnreg).  At D 256 no producer warpgroup: ptxas gives each
  // thread of a 12-warp block at most 168 registers (3 warps share a
  // quarter of the register file), O alone takes 128 of them, and it
  // spills; with 8 warps a thread may have 255.  Lane 0 of the first
  // consumer warp then issues the loads, each stage's refill as soon as
  // both warpgroups are done with it.
  static constexpr bool PRODUCER_WARPGROUP = D != 256;
  static constexpr int THREADS = PRODUCER_WARPGROUP ? 384 : 256;
  static constexpr int Q_BOX = BQ * 128;            // bytes: 128 rows x 64 columns
  static constexpr int KV_BOX = BKEY * 128;         // bytes: BKEY rows x 64 columns
  static constexpr int Q_BYTES = DC * Q_BOX;
  static constexpr int KV_BYTES = DC * KV_BOX;      // K (or V) of one stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  // full and empty a stage (a K and a V stage with OVERLAP), then Q's
  static constexpr int BARS = (OVERLAP ? 4 : 2) * STAGES + 1;
  // the 128-byte swizzle repeats every 1024 bytes: boxes start 1024-aligned
  static constexpr int SMEM = 1024 + BAR_OFF + BARS * 8;
};

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int Id>
__device__ __forceinline__ void warpgroup_sync() {  // one consumer warpgroup
  asm volatile("bar.sync %0, 128;" ::"n"(Id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {  // at most N groups still pending
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
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

// S (64 x BKEY, fp32) = Q (the warpgroup's 64 rows) Kᵀ, both K-major: a k16
// step is 32 bytes along each swizzled 128-byte row, the next 64 columns of
// D the next box; steps wholly past D (zeros in both operands) are skipped
template <int D>
__device__ __forceinline__ void qk(float (&s)[Cfg<D>::BKEY / 2], uint32_t sq, uint32_t sk) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::KSTEPS; ++kk) {
    const int c = kk / 4;
    const int j = kk % 4;
    const uint64_t da = smem_desc(sq + c * C::Q_BOX + j * 32, 16, 1024);
    const uint64_t db = smem_desc(sk + c * C::KV_BOX + j * 32, 16, 1024);
    if constexpr (C::BKEY == 128) {
      wgmma_m64n128k16<0, 0>(s, da, db, kk != 0);
    } else {
      wgmma_m64n64k16<0, 0>(s, da, db, kk != 0);
    }
  }
}

// O (64 x DP) += P (64 x BKEY, registers) V (BKEY x DP): V MN-major, its
// 64-column chunks (one box each) KV_BOX bytes apart (LBO), 8-key groups 1024
// (SBO), a k16 step 16 rows further; registers 4u..4u+3 of P hold keys
// 16u..16u+15
template <int D>
__device__ __forceinline__ void pv(float (&o)[Cfg<D>::DP / 2],
                                   const uint32_t (&p)[Cfg<D>::BKEY / 4], uint32_t sv) {
  using C = Cfg<D>;
#pragma unroll
  for (int u = 0; u < C::BKEY / 16; ++u) {
    const uint32_t a[4] = {p[4 * u], p[4 * u + 1], p[4 * u + 2], p[4 * u + 3]};
    const uint64_t db = smem_desc(sv + u * 16 * 128, C::KV_BOX, 1024);
    if constexpr (C::DP == 64) {
      wgmma_rs_m64n64k16<1>(o, a, db, 1);
    } else if constexpr (C::DP == 128) {
      wgmma_rs_m64n128k16<1>(o, a, db, 1);
    } else if constexpr (C::DP == 192) {
      wgmma_rs_m64n192k16<1>(o, a, db, 1);
    } else {
      wgmma_rs_m64n256k16<1>(o, a, db, 1);
    }
  }
}

// A thread's rows: accumulator rows r_in and r_in + 8 at absolute positions
// pos and pos + 8; q_first the block's first row (its last nominal row is
// q_first + BQ - 1)
struct Rows {
  int pos;
  int q_first;
};

// One key tile's online softmax in the accumulator registers: scale, cap,
// mask (each a pass of its own under one uniform branch: a branch an element
// costs more than the element; a tile live for every row of the block skips
// the mask), the running max m, corr = 2^((m_old - m_new)·log2e), s replaced
// by p = 2^((s - m_new)·log2e) in fp32 and l = l·corr + Σ p
template <int D>
__device__ __forceinline__ void softmax(float (&sc)[Cfg<D>::BKEY / 2], const Args a,
                                        const Rows& rw, int k0, float (&m)[2],
                                        float (&l)[2], float (&corr)[2]) {
  using C = Cfg<D>;
  const int cq = (threadIdx.x % 4) * 2;  // the thread's accumulator column pair
#pragma unroll
  for (int j = 0; j < C::BKEY / 2; ++j) sc[j] *= a.scale;
  if (a.softcap > 0.f) {
#pragma unroll
    for (int j = 0; j < C::BKEY / 2; ++j) sc[j] = tanhf(sc[j] / a.softcap) * a.softcap;
  }
  if (!(k0 + C::BKEY <= a.lk && (!a.causal || k0 + C::BKEY - 1 <= rw.q_first) &&
        (a.window <= 0 || k0 > rw.q_first + BQ - 1 - a.window))) {
    const bool any_key = !a.causal;
    const bool any_past = a.window <= 0;
#pragma unroll
    for (int j = 0; j < C::BKEY / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + cq + e;
          const int pos = rw.pos + 8 * h;
          const bool ok = (kp < a.lk) & (any_key | (kp <= pos)) &
                          (any_past | (kp > pos - a.window));
          sc[4 * j + 2 * h + e] = ok ? sc[4 * j + 2 * h + e] : NEG_INF;
        }
      }
    }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < C::BKEY / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    }
  }
  float m_new[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    m_new[h] = fmaxf(m[h], mx[h]);
    corr[h] = ex2((m[h] - m_new[h]) * LOG2E);
    m[h] = m_new[h];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < C::BKEY / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // s - m first: a masked score against a row max still at -1e30
      // gives exactly 2^0 = 1, as the reference's exp(s - m)
      const float e0 = ex2((sc[4 * j + 2 * h] - m_new[h]) * LOG2E);
      const float e1 = ex2((sc[4 * j + 2 * h + 1] - m_new[h]) * LOG2E);
      sum[h] += e0;
      sum[h] += e1;
      sc[4 * j + 2 * h] = e0;
      sc[4 * j + 2 * h + 1] = e1;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * corr[h] + sum[h];
  }
}

// O·corr by row, then p rounded to bf16 in pairs: the A fragment of P·V
template <int D>
__device__ __forceinline__ void rescale_pack(float (&o)[Cfg<D>::DP / 2],
                                             uint32_t (&p)[Cfg<D>::BKEY / 4],
                                             const float (&sc)[Cfg<D>::BKEY / 2],
                                             const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < Cfg<D>::DP / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
#pragma unroll
  for (int i = 0; i < Cfg<D>::BKEY / 4; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// The two consumer warpgroups' turns to issue: warpgroup g waits on named
// barrier 3 + g (bar.sync, 256 threads), which the other warpgroup's
// threads arrive at (bar.arrive) once their products are issued (off: the
// warpgroup goes alone; barriers 1 and 2 are the epilogue's)
struct Turns {
  int group;
  bool on;
  __device__ __forceinline__ void take() {
    if (on) asm volatile("bar.sync %0, 256;" ::"r"(3 + group) : "memory");
  }
  __device__ __forceinline__ void pass() {
    if (on) asm volatile("bar.arrive %0, 256;" ::"r"(3 + (group ^ 1)) : "memory");
  }
};

// Issue S = Q·Kᵀ of the tile at sk into s (its first k16 step overwrites s)
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<D>::BKEY / 2], uint32_t sq_wg,
                                         uint32_t sk, Turns& turns) {
  turns.take();
#pragma unroll
  for (int j = 0; j < Cfg<D>::BKEY / 2; ++j) s[j] = 0.f;
  fence_acc(s);
  wgmma_fence();
  qk<D>(s, sq_wg, sk);
  wgmma_commit();
  turns.pass();
}

// Issue O += P·V of the tile whose V is at sv (pass: hand the turn on)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Cfg<D>::DP / 2],
                                         uint32_t (&p)[Cfg<D>::BKEY / 4], uint32_t sv,
                                         Turns& turns, bool pass) {
  turns.take();
  fence_acc(o);
  fence_regs(p);
  wgmma_fence();
  pv<D>(o, p, sv);
  wgmma_commit();
  if (pass) turns.pass();
}

// Block w of the launch order takes batch·head w % (B·H) and query block
// nqb - 1 - w / (B·H): heads innermost, the last (longest causal) query
// blocks first.  Plan.tile_at is the same arithmetic.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, Args a) {
  using C = Cfg<D>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t sq = base;
  const uint32_t ring = base + C::Q_BYTES;
  const uint32_t bars = base + C::BAR_OFF;
  // K (v = 0) or V (v = 1) of the warpgroup's i-th tile: its address, its
  // barriers (full: landed; empty: released by both warpgroups) and their
  // phase parity.  One ring of (K, V) stages, or with OVERLAP a K ring
  // and a V ring, each with barriers of its own.
  constexpr int RINGS = C::OVERLAP ? 2 : 1;
  auto stage = [&](int v, int i) {
    return ring + (C::OVERLAP ? v * STAGES + i % STAGES : 2 * (i % STAGES) + v) * C::KV_BYTES;
  };
  auto full = [&](int v, int i) { return bars + 8u * ((v % RINGS) * STAGES + i % STAGES); };
  auto empty = [&](int v, int i) {
    return bars + 8u * ((RINGS + v % RINGS) * STAGES + i % STAGES);
  };
  auto parity = [&](int i) { return static_cast<uint32_t>((i / STAGES) & 1); };
  const uint32_t qbar = bars + 8u * (2 * RINGS * STAGES);

  const int heads = a.b * a.h;
  const int w = blockIdx.x;
  const int bh = w % heads;
  const int q0 = ((a.lq + BQ - 1) / BQ - 1 - w / heads) * BQ;
  const int b = bh / a.h;
  const int head = bh % a.h;
  const int kvh = head / (a.h / a.kv);
  const int rows = min(BQ, a.lq - q0);
  const int off = a.q_off != nullptr ? a.q_off[b] : a.q_off0;
  const int2 kt = key_tiles(off + q0, off + q0 + rows - 1, a.lk, a.causal, a.window,
                            C::BKEY);
  const int n = kt.y - kt.x;

  const int tid = threadIdx.x;
  const int group = tid / 128;
  if (tid == 0) {
    for (int v = 0; v < RINGS; ++v) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full(v, s), 1);
        mbar_init(empty(v, s), 2);
      }
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Q (once), and the i-th tile's K and V (v = 0, 1; both with one ring, v
  // = -1): one thread issues each; a box is (column 64·c of a head, the
  // head, the first row, the batch)
  auto load_q = [&]() {
    mbar_expect_tx(qbar, C::Q_BYTES);
    for (int c = 0; c < C::DC; ++c) {
      tma_load_4d(sq + c * C::Q_BOX, &tq, qbar, 64 * c, head, q0, b);
    }
  };
  auto load = [&](int v, int i) {
    const int v0 = v < 0 ? 0 : v;
    const int v1 = v < 0 ? 1 : v;
    mbar_expect_tx(full(v0, i), (v1 - v0 + 1) * C::KV_BYTES);
    for (int u = v0; u <= v1; ++u) {
      for (int c = 0; c < C::DC; ++c) {
        tma_load_4d(stage(u, i) + c * C::KV_BOX, u ? &tv : &tk, full(v0, i), 64 * c, kvh,
                    (kt.x + i) * C::BKEY, b);
      }
    }
  };
  if constexpr (C::PRODUCER_WARPGROUP) {
    if (group == 2) {  // producer warpgroup: one thread issues every load
      reg_dealloc<PRODUCER_REGS>();
      if (tid == 2 * 128) {
        load_q();
        for (int i = 0; i < n; ++i) {
          for (int v = 0; v < RINGS; ++v) {
            if (i >= STAGES) mbar_wait(empty(v, i), parity(i) ^ 1);
            load(RINGS == 2 ? v : -1, i);
          }
        }
      }
      return;
    }
    reg_alloc<CONSUMER_REGS>();
  } else if (tid == 0) {  // the first stages; the rest as stages drain
    load_q();
    for (int i = 0; i < n && i < STAGES; ++i) load(-1, i);
  }

  const int lane = tid % 128;
  const int r_in = (lane / 32) * 16 + (lane % 32) / 4;  // accumulator row (h = 0); h = 1 at +8
  const int row0 = q0 + group * 64;                     // this warpgroup's first query row
  // the warpgroup is done with K or V of its i-th tile (with one ring, V
  // releases the stage); without a producer warpgroup the first warp
  // refills the stage with tile i + STAGES once both warpgroups have
  // released it (the whole warp waits, so it stays converged for the next
  // wgmma)
  auto release = [&](int v, int i) {
    if (lane == 0) mbar_arrive(empty(v, i));
    if constexpr (!C::PRODUCER_WARPGROUP) {
      if (tid < 32 && i + STAGES < n) {
        if (tid == 0) {
          mbar_wait(empty(v, i), parity(i));
          load(-1, i + STAGES);
        }
        __syncwarp();
      }
    }
  };
  if (row0 >= a.lq) {
    // every row of this warpgroup lies past Lq: keep the rings' counts only
    for (int i = 0; i < n; ++i) {
      for (int v = 0; v < RINGS; ++v) {
        mbar_wait(full(v, i), parity(i));
        if (lane == 0) mbar_arrive(empty(v, i));
      }
    }
    return;
  }
  const Rows rw{off + row0 + r_in, off + q0};
  const uint32_t sq_wg = sq + group * 64 * 128;  // this warpgroup's rows in each Q box
  auto k0 = [&](int i) { return (kt.x + i) * C::BKEY; };

  float o[C::DP / 2];
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float sc[C::BKEY / 2];
  uint32_t p[C::BKEY / 4];
  float corr[2];
  mbar_wait(qbar, 0);

  if constexpr (C::OVERLAP) {
    // S_i = Q·K_iᵀ is issued with O += P_{i-1}·V_{i-1}; the softmax of
    // tile i runs under the latter, then O·corr_i and P_i.  Each element
    // sees the same operations in the same order as one tile at a time.
    // The first and last tiles are peeled, so no wgmma sits under a branch
    // of its own (ptxas would serialize them).  The two warpgroups take
    // turns to issue (warpgroup 1's first arrival opens warpgroup 0's first
    // turn; its own last turn is nobody's), so that one's softmax runs
    // beside the other's products; with one of them idle (rows <= 64) the
    // other goes alone.
    Turns turns{group, rows > 64};
    if (n > 0) {
      if (group == 1) turns.pass();
      mbar_wait(full(0, 0), 0);
      issue_qk<D>(sc, sq_wg, stage(0, 0), turns);
      wgmma_wait<0>();
      fence_acc(sc);
      release(0, 0);
      softmax<D>(sc, a, rw, k0(0), m, l, corr);
      rescale_pack<D>(o, p, sc, corr);
      for (int i = 1; i < n; ++i) {
        mbar_wait(full(0, i), parity(i));
        mbar_wait(full(1, i - 1), parity(i - 1));
        turns.take();
#pragma unroll
        for (int j = 0; j < C::BKEY / 2; ++j) sc[j] = 0.f;
        fence_acc(sc);
        fence_acc(o);
        fence_regs(p);
        wgmma_fence();
        qk<D>(sc, sq_wg, stage(0, i));
        wgmma_commit();
        pv<D>(o, p, stage(1, i - 1));
        wgmma_commit();
        turns.pass();
        wgmma_wait<1>();
        fence_acc(sc);
        release(0, i);
        softmax<D>(sc, a, rw, k0(i), m, l, corr);
        wgmma_wait<0>();
        fence_acc(o);
        fence_regs(p);
        release(1, i - 1);
        rescale_pack<D>(o, p, sc, corr);
      }
      mbar_wait(full(1, n - 1), parity(n - 1));
      issue_pv<D>(o, p, stage(1, n - 1), turns, group == 0);
      wgmma_wait<0>();
      fence_acc(o);
      fence_regs(p);
      release(1, n - 1);
    }
  } else {
    for (int i = 0; i < n; ++i) {
      mbar_wait(full(0, i), parity(i));
#pragma unroll
      for (int j = 0; j < C::BKEY / 2; ++j) sc[j] = 0.f;
      fence_acc(sc);
      wgmma_fence();
      qk<D>(sc, sq_wg, stage(0, i));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      softmax<D>(sc, a, rw, k0(i), m, l, corr);
      rescale_pack<D>(o, p, sc, corr);
      fence_acc(o);
      fence_regs(p);
      wgmma_fence();
      pv<D>(o, p, stage(1, i));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      fence_regs(p);
      release(1, i);
    }
  }

  // o / max(l, 1e-20), rounded once, staged in this warpgroup's own rows of
  // the Q tile (its last Q·Kᵀ has completed; the other warpgroup reads only
  // its own rows) in Q's layout: row r of box c at c·Q_BOX + r·128 bytes, its
  // 16-byte chunk k at chunk k ^ (r % 8); then stored row-masked, D columns a
  // row (the columns past D are never staged nor stored)
  if (a.lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + r_in + 8 * h;
      if (r < a.lq) {
        a.lse[(static_cast<size_t>(b) * a.h + head) * a.lq + r] = m[h] + logf(l[h]);
      }
    }
  }
  uint8_t* const mine = base_ptr + group * 64 * 128;
  const float lm[2] = {fmaxf(l[0], 1e-20f), fmaxf(l[1], 1e-20f)};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_in + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(
          mine + (j / 8) * C::Q_BOX + r * 128 + (((j % 8) ^ (r % 8)) * 16) + (lane % 4) * 4) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] / lm[h], o[4 * j + 2 * h + 1] / lm[h]);
    }
  }
  if (group == 0) {
    warpgroup_sync<1>();
  } else {
    warpgroup_sync<2>();
  }
  bf16* const out = static_cast<bf16*>(a.o);
  const size_t stride = static_cast<size_t>(a.h) * D;
  for (int vi = lane; vi < 64 * (D / 8); vi += 128) {
    const int r = vi / (D / 8);
    const int k = vi % (D / 8);  // the row's 16-byte chunk
    if (row0 + r < a.lq) {
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * a.lq + row0 + r) * stride +
                                static_cast<size_t>(head) * D + 8 * k) =
          *reinterpret_cast<const uint4*>(mine + (k / 8) * C::Q_BOX + r * 128 +
                                          (((k % 8) ^ (r % 8)) * 16));
    }
  }
}

}  // namespace fw

// ---------------------------------------------------------------------------
// split (Lq 1): a block a (slot, KV head, key span), then the merge

namespace fs {

constexpr int THREADS = 128;
constexpr int GMAX = 16;  // query heads a KV head

// GM: the query heads a KV head the instance holds accumulators for (1, or
// GMAX for grouped-query attention)
template <typename T, int D, int GM>
struct Cfg {
  static constexpr int VEC = 16 / sizeof(T);                   // elements a 16-byte load
  static constexpr int CPR = D / VEC;                          // 16-byte chunks a row
  static constexpr int BK = D * sizeof(T) <= 256 ? 64 : 32;    // keys a tile
  static constexpr int TPK = THREADS / BK;                     // threads a key's score
  static constexpr int PITCH = D + VEC;                        // staged row (+16 bytes)
  static constexpr int TILE = BK * PITCH;                      // elements of a K or V tile
  static constexpr int OPT = (GM * D + THREADS - 1) / THREADS;  // outputs a thread, at most
  static size_t smem(int g) {
    return sizeof(T) * 4 * TILE + sizeof(float) * (g * D + g * BK + 3 * g);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Partials of row (b, head) and span sp at ((b·H + head)·spans + sp): m and l
// (np floats each), then acc (np·D floats).  A span with no live key of its
// slot writes l = 0 and nothing else.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(THREADS)
flash_split(Args a, int span, int spans, float* __restrict__ part) {
  using C = Cfg<T, D, GM>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const sK = reinterpret_cast<T*>(smem);  // [2][TILE]
  T* const sV = sK + 2 * C::TILE;            // [2][TILE]
  const int g_count = a.h / a.kv;
  float* const sQ = reinterpret_cast<float*>(sV + 2 * C::TILE);  // [G][D]
  float* const sS = sQ + g_count * D;                             // [G][BK]
  float* const sM = sS + g_count * C::BK;
  float* const sL = sM + g_count;
  float* const sC = sL + g_count;

  // the merge may start its blocks now; it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int tid = threadIdx.x;
  const int sp = blockIdx.x;
  const int b = blockIdx.y / a.kv;
  const int kvh = blockIdx.y % a.kv;
  const int qpos = a.q_off != nullptr ? a.q_off[b] : a.q_off0;
  int lo = 0;
  int hi = a.lk;  // the slot's live keys [lo, hi)
  if (a.causal) hi = min(hi, qpos + 1);
  if (a.window > 0) lo = max(lo, qpos - a.window + 1);
  const int k_begin = max(lo, sp * span);
  const int k_end = min(hi, sp * span + span);
  const size_t np = static_cast<size_t>(a.b) * a.h * spans;
  const size_t row0 = (static_cast<size_t>(b) * a.h + static_cast<size_t>(kvh) * g_count) *
                      spans + sp;  // partial of the group's first head
  if (k_begin >= k_end) {
    if (tid < g_count) part[np + row0 + static_cast<size_t>(tid) * spans] = 0.f;
    return;
  }

  const T* q = static_cast<const T*>(a.q) + (static_cast<size_t>(b) * a.h +
                                            static_cast<size_t>(kvh) * g_count) * D;
  for (int i = tid; i < g_count * D; i += THREADS) sQ[i] = to_f(q[i]);
  for (int g = tid; g < g_count; g += THREADS) {
    sM[g] = NEG_INF;
    sL[g] = 0.f;
  }
  const size_t k_stride = static_cast<size_t>(a.kv) * D;
  const T* const k_head = static_cast<const T*>(a.k) + static_cast<size_t>(b) * a.lk * k_stride +
                          static_cast<size_t>(kvh) * D;
  const T* const v_head = static_cast<const T*>(a.v) + static_cast<size_t>(b) * a.lk * k_stride +
                          static_cast<size_t>(kvh) * D;
  // rows [k0, k0 + n) of K and V into stage st, 16 bytes a copy
  auto load = [&](int st, int k0, int n) {
    for (int idx = tid; idx < n * C::CPR; idx += THREADS) {
      const int r = idx / C::CPR;
      const int c = (idx % C::CPR) * C::VEC;
      const size_t src = static_cast<size_t>(k0 + r) * k_stride + c;
      cp_async16(sK + st * C::TILE + r * C::PITCH + c, k_head + src);
      cp_async16(sV + st * C::TILE + r * C::PITCH + c, v_head + src);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float acc[C::OPT];
#pragma unroll
  for (int i = 0; i < C::OPT; ++i) acc[i] = 0.f;
  const int key = tid / C::TPK;  // scores: TPK threads a key,
  const int sub = tid % C::TPK;  // interleaved 16-byte chunks each
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int tiles = (k_end - k_begin + C::BK - 1) / C::BK;
  load(0, k_begin, min(C::BK, k_end - k_begin));
  for (int t = 0; t < tiles; ++t) {
    const int st = t % 2;
    const int k0 = k_begin + t * C::BK;
    const int n = min(C::BK, k_end - k0);
    if (t + 1 < tiles) {
      load(st ^ 1, k0 + C::BK, min(C::BK, k_end - k0 - C::BK));
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();

    // scores of the G heads against key `key` of the tile, fp32: each of
    // the key's TPK threads sums its chunks in order, then a shuffle tree
    const T* kr = sK + st * C::TILE + key * C::PITCH;
    for (int g = 0; g < g_count; ++g) {
      const float* qg = sQ + g * D;
      float s = 0.f;
      for (int c = sub; c < C::CPR; c += C::TPK) {
        const uint4 raw4 = *reinterpret_cast<const uint4*>(kr + c * C::VEC);
        const T* kc = reinterpret_cast<const T*>(&raw4);
#pragma unroll
        for (int e = 0; e < C::VEC; ++e) s = fmaf(qg[c * C::VEC + e], to_f(kc[e]), s);
      }
#pragma unroll
      for (int o = 1; o < C::TPK; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (sub == 0) {
        float x = s * a.scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        sS[g * C::BK + key] = key < n ? x : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one warp a head: p rounded to v's dtype in place
    for (int g = warp; g < g_count; g += THREADS / 32) {
      float mx = NEG_INF;
      for (int j = lane; j < C::BK; j += 32) mx = fmaxf(mx, sS[g * C::BK + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < C::BK; j += 32) {
        const float p = j < n ? expf(sS[g * C::BK + j] - m_new) : 0.f;
        sum += p;
        sS[g * C::BK + j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sM[g] = m_new;
        sL[g] = sL[g] * corr + sum;
        sC[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc·corr + Σ_j p_j v_j, thread-owned outputs (head, column)
    const T* vt = sV + st * C::TILE;
#pragma unroll
    for (int i = 0; i < C::OPT; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < g_count * D) {
        const int g = idx / D;
        const int d = idx % D;
        float x = acc[i] * sC[g];
        for (int j = 0; j < n; ++j) x = fmaf(sS[g * C::BK + j], to_f(vt[j * C::PITCH + d]), x);
        acc[i] = x;
      }
    }
    __syncthreads();  // the stage is free for the load after next
  }

#pragma unroll
  for (int i = 0; i < C::OPT; ++i) {
    const int idx = tid + i * THREADS;
    if (idx < g_count * D) {
      const size_t r = row0 + static_cast<size_t>(idx / D) * spans;
      part[2 * np + r * D + idx % D] = acc[i];
    }
  }
  if (tid < g_count) {
    part[row0 + static_cast<size_t>(tid) * spans] = sM[tid];
    part[np + row0 + static_cast<size_t>(tid) * spans] = sL[tid];
  }
}

constexpr int MERGE_COLS = 64;  // columns of a row a merge block takes (one a thread)

// Shared memory of a merge block: l and the weight of every span, two warps'
// maxima.
inline size_t merge_smem(int spans) { return sizeof(float) * (2 * spans + 2); }

// Block (x, y): row x = b·H + head, columns [y·64, +64).  The row's m and l of
// every span are read once into shared memory and each live span's weight
// w = e^(m - M) computed once (M: the largest m of a live span); then each
// thread sums its column over the live spans in span order, empty ones (l = 0,
// their acc never written) skipped: o = Σ acc·w / max(Σ l·w, 1e-20).  The same
// expf values are added in the same order as when every column recomputed
// them, so the bits do not depend on how the columns are spread over blocks.
template <typename T, int D>
__global__ void __launch_bounds__(MERGE_COLS) flash_merge(Args a, int spans, const float* part) {
  extern __shared__ float merge_sm[];
  float* const sl = merge_sm;       // [spans] l
  float* const sw = sl + spans;     // [spans] m, then the weight
  float* const sx = sw + spans;     // [2] the warps' maxima
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int tid = threadIdx.x;
  const size_t np = static_cast<size_t>(a.b) * a.h * spans;
  const size_t r0 = static_cast<size_t>(blockIdx.x) * spans;
  const float* pm = part + r0;
  const float* pl = part + np + r0;
  const float* pacc = part + 2 * np + r0 * D;
  float mx = NEG_INF;
  for (int s = tid; s < spans; s += MERGE_COLS) {
    const float l = pl[s];
    const float m = pm[s];
    sl[s] = l;
    sw[s] = m;
    if (l > 0.f) mx = fmaxf(mx, m);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (tid % 32 == 0) sx[tid / 32] = mx;
  __syncthreads();
  mx = fmaxf(sx[0], sx[1]);
  for (int s = tid; s < spans; s += MERGE_COLS) {
    if (sl[s] > 0.f) sw[s] = expf(sw[s] - mx);
  }
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < spans; ++s) {
    if (sl[s] > 0.f) l += sl[s] * sw[s];
  }
  const int d = blockIdx.y * MERGE_COLS + tid;
  if (d >= D) return;
  float x = 0.f;
#pragma unroll 8
  for (int s = 0; s < spans; ++s) {
    if (sl[s] > 0.f) x += pacc[static_cast<size_t>(s) * D + d] * sw[s];
  }
  static_cast<T*>(a.o)[static_cast<size_t>(blockIdx.x) * D + d] = from_f<T>(x / fmaxf(l, 1e-20f));
}

// The merge of a split launch's partials, programmatically after it.
template <typename T, int D>
int launch_merge(const Args& a, int spans, const float* part, cudaStream_t s) {
  return launch(flash_merge<T, D>, dim3(a.b * a.h, (D + MERGE_COLS - 1) / MERGE_COLS),
                dim3(MERGE_COLS), static_cast<int>(merge_smem(spans)), s, true, a, spans, part);
}

}  // namespace fs

// ---------------------------------------------------------------------------
// split_mma: the split body's blocks for a group of 2..16 query heads a KV
// head, bf16, on the tensor cores

namespace fm {

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;     // the ring of K and V tiles
constexpr int ROWS = 16;      // the group's query heads, zero-padded to one m16 tile

template <int D>
struct Cfg {
  static constexpr int BK = D <= 128 ? 64 : 32;  // keys a tile
  static constexpr int PITCH = D + 8;             // staged row: +16 bytes, so the 8 rows
                                                  // of an ldmatrix fall on distinct banks
  static constexpr int TILE = BK * PITCH;         // elements of a K or V tile
  static constexpr int SP = BK + 4;               // score row (floats)
  static constexpr int CPR = D / 8;               // 16-byte chunks a row
  static constexpr int KS = D / 16;               // k16 steps of Q·Kᵀ
  static constexpr int KW = BK / WARPS;           // a warp's keys of a tile's scores
  static constexpr int NT = D / 8;                // n8 column tiles of O
  static constexpr int NTW = (NT + WARPS - 1) / WARPS;  // a warp's column tiles, at most
  static constexpr int SMEM =
      static_cast<int>(sizeof(bf16) * (2 * STAGES * TILE + ROWS * PITCH) +
                       sizeof(float) * ROWS * SP);
  static_assert(D % 16 == 0 && KW % 8 == 0, "tile shape");
};

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(const void* p, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(const void* p, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row-major) · b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from src, or zeros where !full (src must still be a valid address)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Block (sp, b·KV + kvh): the G = H / KV query heads of KV head kvh of slot b
// over key span sp, the partials written as flash_split writes them (the
// merge reads either body's).  Q's G rows are staged once, zero-padded to 16;
// K and V tiles of the span's live keys stream through a 3-stage cp.async
// ring (rows past the span's end zero-filled).  A tile: warp w computes the
// scores of keys [w·KW, +KW) for the 16 rows (mma.sync m16n8k16, Q by
// ldmatrix, K by ldmatrix as the col-major operand), scales, caps and masks
// them into shared memory; then every warp reads the whole tile's scores in
// the A-fragment order, takes each row's tile maximum across its quad, and
// forms p = e^(s - m) (the sum l of the unrounded p, p rounded to bf16 as the
// A operand) — every warp computes the same (m, l) in the same order — and
// adds P·V into its own n8 column tiles of O (V through ldmatrix.trans), which
// stay in registers.  Two barriers a tile: the tile has landed (and the stage
// read two tiles ago is free), and the scores are written.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_split_mma(Args a, int span, int spans, float* __restrict__ part) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const sK = reinterpret_cast<bf16*>(smem);            // [STAGES][TILE]
  bf16* const sV = sK + STAGES * C::TILE;                    // [STAGES][TILE]
  bf16* const sQ = sV + STAGES * C::TILE;                    // [ROWS][PITCH]
  float* const sS = reinterpret_cast<float*>(sQ + ROWS * C::PITCH);  // [ROWS][SP]

  // the merge may start its blocks now; it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;  // fragment rows gr and gr + 8
  const int tq = lane % 4;  // fragment column pair
  const int sp = blockIdx.x;
  const int b = blockIdx.y / a.kv;
  const int kvh = blockIdx.y % a.kv;
  const int g_count = a.h / a.kv;
  const int qpos = a.q_off != nullptr ? a.q_off[b] : a.q_off0;
  int lo = 0;
  int hi = a.lk;  // the slot's live keys [lo, hi)
  if (a.causal) hi = min(hi, qpos + 1);
  if (a.window > 0) lo = max(lo, qpos - a.window + 1);
  const int k_begin = max(lo, sp * span);
  const int k_end = min(hi, sp * span + span);
  const size_t np = static_cast<size_t>(a.b) * a.h * spans;
  const size_t row0 = (static_cast<size_t>(b) * a.h + static_cast<size_t>(kvh) * g_count) *
                      spans + sp;  // partial of the group's first head
  if (k_begin >= k_end) {
    if (tid < g_count) part[np + row0 + static_cast<size_t>(tid) * spans] = 0.f;
    return;
  }

  const bf16* q = static_cast<const bf16*>(a.q) + (static_cast<size_t>(b) * a.h +
                                                  static_cast<size_t>(kvh) * g_count) * D;
  for (int i = tid; i < ROWS * C::CPR; i += THREADS) {
    const int r = i / C::CPR;
    const int c = (i % C::CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < g_count) val = *reinterpret_cast<const uint4*>(q + static_cast<size_t>(r) * D + c);
    *reinterpret_cast<uint4*>(sQ + r * C::PITCH + c) = val;
  }
  const size_t k_stride = static_cast<size_t>(a.kv) * D;
  const bf16* const k_head = static_cast<const bf16*>(a.k) +
                             static_cast<size_t>(b) * a.lk * k_stride +
                             static_cast<size_t>(kvh) * D;
  const bf16* const v_head = static_cast<const bf16*>(a.v) +
                             static_cast<size_t>(b) * a.lk * k_stride +
                             static_cast<size_t>(kvh) * D;
  const int tiles = (k_end - k_begin + BK - 1) / BK;
  // tile t into its stage (a commit group even past the last tile, so that
  // the wait below always counts STAGES - 2 groups in flight)
  auto load = [&](int t) {
    if (t < tiles) {
      const int st = t % STAGES;
      const int k0 = k_begin + t * BK;
      const int n = min(BK, k_end - k0);
      for (int idx = tid; idx < BK * C::CPR; idx += THREADS) {
        const int r = idx / C::CPR;
        const int c = (idx % C::CPR) * 8;
        const bool live = r < n;
        const size_t src = static_cast<size_t>(live ? k0 + r : k0) * k_stride + c;
        cp_async16_zfill(sK + st * C::TILE + r * C::PITCH + c, k_head + src, live);
        cp_async16_zfill(sV + st * C::TILE + r * C::PITCH + c, v_head + src, live);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float o[C::NTW][4];
#pragma unroll
  for (int j = 0; j < C::NTW; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // rows gr, gr + 8
  float l0 = 0.f, l1 = 0.f;
  const int nt0 = warp * C::NTW;  // the warp's first column tile
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load(t);

  for (int t = 0; t < tiles; ++t) {
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // tile t landed for every thread; tile t - 1's stage is free
    load(t + STAGES - 1);
    const int st = t % STAGES;
    const int n = min(BK, k_end - (k_begin + t * BK));
    const bf16* const kt = sK + st * C::TILE;
    const bf16* const vt = sV + st * C::TILE;

    // scores of the warp's keys: S = Q·Kᵀ over the k16 steps, even and odd
    // steps in two accumulators (two independent chains of mma.sync), then
    // added
    float s[2][C::KW / 8][4];
#pragma unroll
    for (int j = 0; j < C::KW / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][j][e] = s[1][j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      uint32_t af[4];
      ldsm_x4(sQ + (lane % 16) * C::PITCH + kk * 16 + (lane / 16) * 8, af);
#pragma unroll
      for (int j = 0; j < C::KW / 8; ++j) {
        uint32_t bfr[2];
        ldsm_x2(kt + (warp * C::KW + j * 8 + lane % 8) * C::PITCH + kk * 16 +
                    ((lane / 8) % 2) * 8,
                bfr);
        mma16816(s[kk % 2][j], af, bfr);
      }
    }
#pragma unroll
    for (int j = 0; j < C::KW / 8; ++j) {
      const int key = warp * C::KW + j * 8 + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (s[0][j][e] + s[1][j][e]) * a.scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        s[0][j][e] = key + (e % 2) < n ? x : NEG_INF;
      }
      *reinterpret_cast<float2*>(sS + gr * C::SP + key) = make_float2(s[0][j][0], s[0][j][1]);
      *reinterpret_cast<float2*>(sS + (gr + 8) * C::SP + key) =
          make_float2(s[0][j][2], s[0][j][3]);
    }
    __syncthreads();  // the tile's scores are written

    // the online softmax of rows gr and gr + 8 over the whole tile, in the
    // A-fragment order: chunk c holds keys 16c + 2tq (+1) and 16c + 8 + 2tq (+1)
    float2 sv[BK / 16][4];
    float x0 = NEG_INF, x1 = NEG_INF;
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const int key = 16 * c + 2 * tq;
      sv[c][0] = *reinterpret_cast<const float2*>(sS + gr * C::SP + key);
      sv[c][1] = *reinterpret_cast<const float2*>(sS + (gr + 8) * C::SP + key);
      sv[c][2] = *reinterpret_cast<const float2*>(sS + gr * C::SP + key + 8);
      sv[c][3] = *reinterpret_cast<const float2*>(sS + (gr + 8) * C::SP + key + 8);
      x0 = fmaxf(x0, fmaxf(fmaxf(sv[c][0].x, sv[c][0].y), fmaxf(sv[c][2].x, sv[c][2].y)));
      x1 = fmaxf(x1, fmaxf(fmaxf(sv[c][1].x, sv[c][1].y), fmaxf(sv[c][3].x, sv[c][3].y)));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, w));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, w));
    }
    const float mn0 = fmaxf(m0, x0);
    const float mn1 = fmaxf(m1, x1);
    const float c0 = expf(m0 - mn0);
    const float c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    uint32_t pa[BK / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e % 2 ? mn1 : mn0;
        const float px = expf(sv[c][e].x - mn);
        const float py = expf(sv[c][e].y - mn);
        if (e % 2) {
          sum1 += px + py;
        } else {
          sum0 += px + py;
        }
        pa[c][e] = pack_bf16(px, py);
      }
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, w);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, w);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;

    // O = O·corr + P·V on the warp's column tiles
#pragma unroll
    for (int j = 0; j < C::NTW; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
#pragma unroll
      for (int j = 0; j < C::NTW; ++j) {
        if (nt0 + j < C::NT) {  // D 112's last warp holds 2 of its 4
          uint32_t bfr[2];
          ldsm_x2_trans(vt + (16 * c + lane % 16) * C::PITCH + (nt0 + j) * 8, bfr);
          mma16816(o[j], pa[c], bfr);
        }
      }
    }
  }

  // the G rows' partials; rows past G are never stored
#pragma unroll
  for (int j = 0; j < C::NTW; ++j) {
    if (nt0 + j >= C::NT) continue;
    const int col = (nt0 + j) * 8 + 2 * tq;
    if (gr < g_count) {
      *reinterpret_cast<float2*>(part + 2 * np + (row0 + static_cast<size_t>(gr) * spans) * D +
                                 col) = make_float2(o[j][0], o[j][1]);
    }
    if (gr + 8 < g_count) {
      *reinterpret_cast<float2*>(part + 2 * np +
                                 (row0 + static_cast<size_t>(gr + 8) * spans) * D + col) =
          make_float2(o[j][2], o[j][3]);
    }
  }
  if (warp == 0 && tq == 0) {
    if (gr < g_count) {
      part[row0 + static_cast<size_t>(gr) * spans] = m0;
      part[np + row0 + static_cast<size_t>(gr) * spans] = l0;
    }
    if (gr + 8 < g_count) {
      part[row0 + static_cast<size_t>(gr + 8) * spans] = m1;
      part[np + row0 + static_cast<size_t>(gr + 8) * spans] = l1;
    }
  }
}

}  // namespace fm

// ---------------------------------------------------------------------------
// host side

enum Body { FMA32 = 0, WMMA = 1, WGMMA = 2, SPLIT = 3, SPLIT_MMA = 4 };

template <typename T, int D>
int launch_tile(const Args& a, cudaStream_t s) {
  const size_t bytes = ft::Layout<T, D>::bytes;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        ft::flash_tile<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid((a.lq + ft::BQ - 1) / ft::BQ, a.b * a.h);
  ft::flash_tile<T, D><<<grid, ft::THREADS, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_wgmma(const Args& a, cudaStream_t s) {
  using C = fw::Cfg<D>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        fw::flash_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  CUtensorMap tq, tk, tv;
  int rc = tensor_map_heads(&tq, a.q, a.b, a.lq, a.h, D, fw::BQ);
  if (rc != 0) return rc;
  rc = tensor_map_heads(&tk, a.k, a.b, a.lk, a.kv, D, C::BKEY);
  if (rc != 0) return rc;
  rc = tensor_map_heads(&tv, a.v, a.b, a.lk, a.kv, D, C::BKEY);
  if (rc != 0) return rc;
  const int blocks = (a.lq + fw::BQ - 1) / fw::BQ * a.b * a.h;
  fw::flash_wgmma<D><<<blocks, C::THREADS, C::SMEM, s>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int GM>
int launch_split(const Args& a, int span, int spans, float* part, cudaStream_t s) {
  using C = fs::Cfg<T, D, GM>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        fs::flash_split<T, D, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::smem(GM)));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid(spans, a.b * a.kv);
  fs::flash_split<T, D, GM><<<grid, fs::THREADS, C::smem(a.h / a.kv), s>>>(a, span, spans,
                                                                         part);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return fs::launch_merge<T, D>(a, spans, part, s);
}

template <int D>
int launch_split_mma(const Args& a, int span, int spans, float* part, cudaStream_t s) {
  using C = fm::Cfg<D>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        fm::flash_split_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid(spans, a.b * a.kv);
  fm::flash_split_mma<D><<<grid, fm::THREADS, C::SMEM, s>>>(a, span, spans, part);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return fs::launch_merge<bf16, D>(a, spans, part, s);
}

template <typename T, int D>
int launch_body(const Args& a, int body, int span, int spans, float* part, cudaStream_t s) {
  if (body == SPLIT) {
    return a.h == a.kv ? launch_split<T, D, 1>(a, span, spans, part, s)
                       : launch_split<T, D, fs::GMAX>(a, span, spans, part, s);
  }
  if constexpr (std::is_same<T, bf16>::value && D >= 64) {
    if (body == SPLIT_MMA) return launch_split_mma<D>(a, span, spans, part, s);
    return launch_wgmma<D>(a, s);
  } else {
    return launch_tile<T, D>(a, s);
  }
}

template <typename T>
int launch_dim(const Args& a, int d, int body, int span, int spans, float* part,
               cudaStream_t s) {
  switch (d) {
    case 16: return launch_body<T, 16>(a, body, span, spans, part, s);
    case 32: return launch_body<T, 32>(a, body, span, spans, part, s);
    case 64: return launch_body<T, 64>(a, body, span, spans, part, s);
    case 96: return launch_body<T, 96>(a, body, span, spans, part, s);
    case 112: return launch_body<T, 112>(a, body, span, spans, part, s);
    case 128: return launch_body<T, 128>(a, body, span, spans, part, s);
    case 192: return launch_body<T, 192>(a, body, span, spans, part, s);
    case 256: return launch_body<T, 256>(a, body, span, spans, part, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int split_keys(int d) {
  return d * static_cast<int>(sizeof(T)) <= 256 ? 64 : 32;
}

}  // namespace

// One call under a launch plan (kernels/flash_attention.py::plan).  dtype: 0 =
// fp32, 1 = bf16 (q, k, v and o share it).  body: 0 = fma32 (fp32; bq 64, bkey
// 64, 32 at d 256), 1 = wmma (bf16 at d 16 / 32; bq 64, bkey 64), 2 = wgmma
// (bf16 at d 64 / 96 / 112 / 128 / 192 / 256; bq 128, bkey 128 at d <= 128
// else 64), 3 = split (lq 1, at most 16 query heads a KV head; bq 1, bkey the
// split tile (64 keys when a row is at most 256 bytes, else 32), span a
// multiple of bkey, spans = ⌈lk / span⌉, scratch b·h·spans·(d + 2) floats), 4 =
// split_mma (as split, bf16 at d 64 / 96 / 112 / 128 / 192 / 256 with 2 to 16
// query heads a KV head; bkey 64 at d <= 128, else 32).  span, spans and
// scratch are 0 / null for the other bodies.  lse: null, or (b, h, lq) fp32
// that a tile body (fma32, wmma, wgmma) fills with each row's m + log(l), the
// softmax statistics the backward (flash_attention_bwd.cu) reads; the split
// bodies refuse it.  The output is the same bits with or without it.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const void* q_off, int q_off0, int b, int lq, int lk,
                                      int h, int kv, int d, int causal, int window,
                                      float scale, float softcap, int dtype, int body,
                                      int bq, int bkey, int span, int spans, void* scratch,
                                      void* lse, void* stream) {
  if (b <= 0 || lq <= 0 || lk <= 0 || kv <= 0 || h % kv != 0 || (dtype != 0 && dtype != 1) ||
      (d != 16 && d != 32 && d != 64 && d != 96 && d != 112 && d != 128 && d != 192 &&
       d != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long heads = static_cast<long long>(b) * h;
  bool ok = false;
  switch (body) {
    case FMA32:
    case WMMA:
      ok = (body == FMA32 ? dtype == 0 : dtype == 1 && d <= 32) && bq == ft::BQ &&
           bkey == (d == 256 ? 32 : 64) && span == 0 && spans == 0 && scratch == nullptr &&
           heads <= 65535;
      break;
    case WGMMA:
      ok = dtype == 1 && d >= 64 && bq == fw::BQ && bkey == (d <= 128 ? 128 : 64) &&
           span == 0 && spans == 0 && scratch == nullptr &&
           (lq + fw::BQ - 1) / fw::BQ * heads <= 0x7fffffffll;
      break;
    case SPLIT:
    case SPLIT_MMA: {
      const int bk = body == SPLIT_MMA ? (d <= 128 ? 64 : 32)
                     : dtype == 0      ? split_keys<float>(d)
                                       : split_keys<bf16>(d);
      ok = lq == 1 && h / kv <= fs::GMAX && bq == 1 && bkey == bk && span > 0 &&
           span % bk == 0 && spans == (lk + span - 1) / span && scratch != nullptr &&
           static_cast<long long>(b) * kv <= 65535 && heads <= 0x7fffffffll;
      if (body == SPLIT_MMA) ok = ok && dtype == 1 && d >= 64 && h / kv >= 2;
      break;
    }
    default:
      break;
  }
  // the split bodies (Lq 1) keep no row statistics: asked for them, refuse
  if (lse != nullptr && (body == SPLIT || body == SPLIT_MMA)) ok = false;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, static_cast<const int*>(q_off), q_off0, b, lq, lk, h, kv,
         causal, window, scale, softcap, static_cast<float*>(lse)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  if (dtype == 0) return launch_dim<float>(a, d, body, span, spans, part, s);
  return launch_dim<bf16>(a, d, body, span, spans, part, s);
}
