// One decode step against the factorized latent KV cache, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py::flash_decode (its
// pallas_call at :120, body _kernel at :39) and computes what its oracle computes
// (src/repro/kernels/ref.py:82; the port's kernels/ref.py::flash_decode_ref), all
// arithmetic in fp32.  The cache holds only the rank-r latents l_k = x V_k and
// l_v = x V_v of every token; the kernel keeps the two halves of the TPU design:
//
//   key side    keys are up-projected on chip, K = l_k U_k[:, head], and RoPE'd
//               (rotate-half at the TRUE head dim, at the keys' absolute positions)
//               before scoring; the up-projected keys never reach device memory
//   value side  the accumulator stays in latent space, ctx (H, r_v) = Σ p l_v, and
//               U_v is applied once per head at the end
//
// U_k and U_v are read in their STORED (r, KV·D) fp32 layout, never transposed.
//
// Bound on an H100: the key up-projection, 2·Σ_b len_b·r_k·KV·D flops (93.0 GFLOP at
// 8 slots of 256..2048 keys, r_k 1232, KV·D 4096; 93.9 with the scores, values and
// U_v) dominates the bytes (the live latents and the two factors once, ~85 MB):
// 1.40 ms on the fp32 FMA units, 0.094 ms for one bf16 tensor-core pass, 0.188 ms for
// the two this kernel issues.
//
// The work is cut into key spans of SPAN = 256 keys from absolute key 0, whatever B,
// L or the other slots' lengths; a work item is (slot, KV head, span) and a span at or
// past its slot's length exits at once.  So a slot's bits depend on its own q,
// latents, length and the factors alone (continuous batching needs no second body).
// One call is four or five launches on the stream, no atomics anywhere:
//
//   fdec_split_u (wgmma body only)  U_k fp32 -> two bf16 terms U_hi + U_lo (scratch,
//     2 x r_k·KV·D bf16, ~40 MB of traffic): TMA cannot convert, and the two terms
//     keep the keys at fp32 quality (l_k is exact in bf16: the cache holds bf16)
//   fdec_keys_wgmma<D> (bf16, D 64 / 96 / 112 / 128, r_k a multiple of 8): one block a work item.
//     A producer thread keeps a ring of stages filled by TMA, each the span's l_k tile
//     (256 keys x 64 ranks, K-major, read in place through a 3D map on (B, L, r_k)
//     whose zero fill ends the cache) and U_hi, U_lo [64 ranks, kvh·D .. + D] (MN-major,
//     the transpose bit); two consumer warpgroups of 128 keys each issue
//     K += l_k·U_hi + l_k·U_lo on wgmma into fp32 registers (two m64nD tiles each),
//     one stage in flight while the next is issued.  D 112 (kimi-k2) and D 96
//     (phi-3-vision) stage U as two 64-column boxes, like D 128: the second box's last
//     16 / 32 columns (the next head's, or TMA's zero fill past the last) ride through
//     m64n128 products whose columns D..127 are never read, so RoPE pairs and scores
//     see the true D columns (an N-112 or N-96 MN-major operand is not a whole number
//     of 128-byte swizzle atoms).  RoPE
//     in registers: an m64nD accumulator holds columns j and j + D/2 of a key row in
//     one thread.  Scores q·k / √D by quad shuffles, q from shared memory.
//   fdec_keys_fma<T, D> (fp32 at every D; bf16 at D 8 / 16 / 20 / 32 or other ranks): the same
//     work item on the FMA units, 64-key tiles up-projected in 32-rank chunks through
//     shared memory, U_k fp32 as stored.
//     Both keys bodies end with the span's softmax: fp32 (m, l, p[256]) per query head
//     to scratch, p = 0 past the slot's length.
//   fdec_values<T>: one block a (128 ranks, 32 query heads, slot·span): the span's
//     latent partial Σ_k p l_v over its live keys on the FMA units, the span's p
//     staged once in shared memory, a thread one rank of the 32 heads, l_v read 8
//     keys ahead.  l_v is read once a call for all heads, not once a KV head; p is
//     256 floats a span and head where a latent partial is r_v.
//   fdec_merge: one block a (slot·head, 128 ranks): ctx = Σ_span e^(m - M) partial /
//     max(Σ_span l e^(m - M), 1e-20), the spans in order.
//   fdec_out<T, D>: one block a (32 columns, KV head) over all slots: out = ctx U_v
//     [:, kvh], fp32 FMA, 4 columns a thread, the ranks split over 32 thread groups
//     whose sums are added in split order; U_v is read once a call.
//
// Reads per call at the llama-7b case (8 slots, 36 live spans, KV 32, D 128, r 1232;
// the keys launch in the order kvh fastest, then span, then slot): the 32 work items
// of a (slot, span) run side by side and share its l_k tile in L2, so from device
// memory l_k, l_v and U_hi / U_lo (20 MB, resident in the 50 MB L2) come once each,
// ~65 MB; from L2 each work item reads its l_k tile (630 KB) and its U head slice's
// two terms (630 KB): 1.45 GB a call, 161 MFLOP per 1.26 MB, 128 flops an L2 byte.
//
// Contract (checked by the wrapper, kernels/ops.py::flash_decode; the launcher refuses
// what kernels/flash_decode.py::plan never makes): q (B, H, D), lk (B, L, r_k), lv
// (B, L, r_v) and out (B, H, D) of one dtype (fp32 or bf16), 16-byte aligned; uk
// (r_k, KV·D), uv (r_v, KV·D), cos, sin (L, D/2) fp32; lengths (B,) int32 (clamped to
// [0, L]; a slot of length 0 gets zeros); all contiguous; D one of 8, 16, 20, 32, 64,
// 96, 112, 128 (8 and 20: granite's and phi3-medium's smoke configs; 96
// phi-3-vision's; 112 kimi-k2's); cos and sin may be null when rope is 0;
// scratch fp32 as kernels/flash_decode.py::Plan.offsets lays it out.  Returns the
// first non-zero cudaError of the call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int SPAN = 256;  // keys a work item, from absolute key 0
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;
constexpr long long ALIGN_FLOATS = 64;  // scratch regions start 256 bytes apart

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
  int b, l, h, kv, rk, rv, rope, spans;
  bf16* u2;     // (2, r_k, KV·D): U_k's hi and lo terms (wgmma body)
  float* m;     // (B, H, spans): a span's max score
  float* lsum;  // (B, H, spans): its Σ p
  float* p;     // (B, H, spans, SPAN): its probabilities, 0 past the length
  float* pv;    // (B, H, spans, r_v): its latent partial Σ p l_v
  float* ctx;   // (B, H, r_v): the merged latent context
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int slot_len(const Args& a, int b) {
  return max(0, min(a.lengths[b], a.l));
}

// Work item w of the keys launch: KV head fastest, then span, then slot
// (Plan.item_at is the same arithmetic).
__device__ __forceinline__ int3 work_item(const Args& a, int w) {
  return make_int3(w / a.kv / a.spans, (w / a.kv) % a.spans, w % a.kv);
}

__device__ __forceinline__ size_t part_row(const Args& a, int b, int h, int sp) {
  return (static_cast<size_t>(b) * a.h + h) * a.spans + sp;
}

// The span's softmax by 8 warps (threads 0..255): warp w takes the group's heads
// w, w + 8, ...; lane i keys i, i + 32, ....  sS holds g x SPAN scores; keys at or past
// `live` are masked here (their scores are never read).  Writes m, l and p (0 past
// `live`) of each head.
__device__ void span_softmax(const float* sS, int g, int live, const Args& a, int b,
                             int kvh, int sp, int tid) {
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int j = warp; j < g; j += 8) {
    float s[SPAN / 32];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < SPAN / 32; ++i) {
      const int key = lane + 32 * i;
      s[i] = key < live ? sS[j * SPAN + key] : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const size_t row = part_row(a, b, kvh * g + j, sp);
    float* const prow = a.p + row * SPAN;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < SPAN / 32; ++i) {
      const int key = lane + 32 * i;
      const float e = key < live ? expf(s[i] - mx) : 0.f;
      sum += e;
      prow[key] = e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      a.m[row] = mx;
      a.lsum[row] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// U_k -> U_hi + U_lo, two bf16 terms (hi the nearest bf16, lo the nearest to the rest)

__global__ void __launch_bounds__(256) fdec_split_u(const float4* __restrict__ u,
                                                    bf16* __restrict__ hi,
                                                    bf16* __restrict__ lo, size_t n4) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float4 x = u[i];
    const float v[4] = {x.x, x.y, x.z, x.w};
    bf16 h4[4];
    bf16 l4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h4[e] = __float2bfloat16_rn(v[e]);
      l4[e] = __float2bfloat16_rn(v[e] - __bfloat162float(h4[e]));
    }
    *reinterpret_cast<uint2*>(hi + 4 * i) = *reinterpret_cast<const uint2*>(h4);
    *reinterpret_cast<uint2*>(lo + 4 * i) = *reinterpret_cast<const uint2*>(l4);
  }
}

// ---------------------------------------------------------------------------
// keys, wgmma body (bf16, D 64 / 96 / 112 / 128)

namespace kw {

constexpr int THREADS = 384;  // two consumer warpgroups (128 keys each) + a producer one
constexpr int RC = 64;        // ranks a stage: one 128-byte swizzled row of bf16
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128·40 + 256·232 <= 65536

template <int D>
struct Cfg {
  static constexpr int DC = (D + 63) / 64;         // 64-column boxes of a U row
  static constexpr int NC = 64 * DC;               // accumulator columns (D 96, 112: 128)
  static constexpr int LK_BYTES = SPAN * 128;      // 256 keys x 64 ranks
  static constexpr int U_BOX = RC * 128;           // 64 ranks x 64 columns
  static constexpr int U_BYTES = 2 * DC * U_BOX;   // the hi and lo terms
  static constexpr int STAGE = LK_BYTES + U_BYTES;
  static constexpr int STAGES = DC == 2 ? 3 : 4;
  static constexpr int RING = STAGES * STAGE;
  // the 128-byte swizzle repeats every 1024 bytes: the ring starts 1024-aligned
  static int smem(int g) { return 1024 + RING + 4 * g * (D + SPAN) + 16 * STAGES; }
};

__device__ __forceinline__ void consumer_sync() {  // both consumer warpgroups
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// K (64 keys x NC) += l_k (64 x 16 ranks, K-major) U (16 x NC, MN-major)
template <int NC>
__device__ __forceinline__ void up(float (&acc)[NC / 2], uint64_t da, uint64_t db) {
  if constexpr (NC == 128) {
    wgmma_m64n128k16<0, 1>(acc, da, db, 1);
  } else {
    wgmma_m64n64k16<0, 1>(acc, da, db, 1);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fdec_keys_wgmma(const __grid_constant__ CUtensorMap tlk, const __grid_constant__ CUtensorMap tu,
                Args a) {
  using C = Cfg<D>;
  const int3 it = work_item(a, blockIdx.x);
  const int b = it.x;
  const int sp = it.y;
  const int kvh = it.z;
  const int len = slot_len(a, b);
  const int k0 = sp * SPAN;
  if (k0 >= len) return;  // no live key: no work
  const int live = min(SPAN, len - k0);
  const int g = a.h / a.kv;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  float* const sQ = reinterpret_cast<float*>(base_ptr + C::RING);  // g x D
  float* const sS = sQ + g * D;                                      // g x SPAN
  const uint32_t bars = smem_u32(sS + g * SPAN);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::STAGES + s); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int chunks = (a.rk + RC - 1) / RC;

  if (tid >= 256) {  // producer warpgroup: one thread issues every load
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 256) {
      for (int c = 0; c < chunks; ++c) {
        const int s = c % C::STAGES;
        if (c >= C::STAGES) mbar_wait(empty(s), ((c / C::STAGES) - 1) & 1);
        const uint32_t st = base + s * C::STAGE;
        mbar_expect_tx(full(s), C::STAGE);
        tma_load_3d(st, &tlk, full(s), c * RC, k0, b);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int cc = 0; cc < C::DC; ++cc) {
            tma_load_3d(st + C::LK_BYTES + (u * C::DC + cc) * C::U_BOX, &tu, full(s),
                        kvh * D + 64 * cc, c * RC, u);
          }
        }
      }
    }
    return;
  }
  reg_alloc<CONSUMER_REGS>();

  const bf16* q = static_cast<const bf16*>(a.q) +
                  (static_cast<size_t>(b) * a.h + static_cast<size_t>(kvh) * g) * D;
  for (int i = tid; i < g * D; i += 256) sQ[i] = to_f(q[i]);

  const int wg = tid / 128;    // keys 128·wg .. + 127 of the span
  const int lane = tid % 128;
  const int r_in = (lane / 32) * 16 + (lane % 32) / 4;  // accumulator row (h = 0); h = 1 at +8
  const int cq = (lane % 4) * 2;                        // accumulator column pair

  float acc[2][C::NC / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int i = 0; i < C::NC / 2; ++i) acc[t][i] = 0.f;
  }
  for (int c = 0; c < chunks; ++c) {
    const int s = c % C::STAGES;
    mbar_wait(full(s), (c / C::STAGES) & 1);
    const uint32_t st = base + s * C::STAGE;
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint32_t lk_t = st + (wg * 128 + t * 64) * 128;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint32_t u_t = st + C::LK_BYTES + u * C::DC * C::U_BOX;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // A: a k16 step is 32 bytes along each swizzled row; B: 16 rank rows
          // (2048 bytes) further, its 64-column boxes U_BOX apart
          up<C::NC>(acc[t], smem_desc(lk_t + j * 32, 16, 1024),
                smem_desc(u_t + j * 2048, C::U_BOX, 1024));
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // the previous stage's products are done: hand its buffers back
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (c > 0 && lane == 0) mbar_arrive(empty((c - 1) % C::STAGES));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc[0]);
  fence_acc(acc[1]);

  // RoPE in registers: acc[t][4j + 2h + e] is key row r_in + 8h of tile t, column
  // 8j + cq + e; column c pairs with c + D/2, register group j with j + D/16 (D a
  // multiple of 16; the groups of columns D .. NC - 1 are never read)
  if (a.rope) {
    constexpr int HALF = D / 2;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int key = wg * 128 + t * 64 + r_in + 8 * hh;
        if (key < live) {
          const size_t tab = static_cast<size_t>(k0 + key) * HALF + cq;
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            const float2 cs = __ldg(reinterpret_cast<const float2*>(a.cos + tab + 8 * j));
            const float2 sn = __ldg(reinterpret_cast<const float2*>(a.sin + tab + 8 * j));
            const float c2[2] = {cs.x, cs.y};
            const float s2[2] = {sn.x, sn.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x1 = acc[t][4 * j + 2 * hh + e];
              float& x2 = acc[t][4 * (j + D / 16) + 2 * hh + e];
              const float k1 = x1;
              const float k2 = x2;
              x1 = k1 * c2[e] - k2 * s2[e];
              x2 = k2 * c2[e] + k1 * s2[e];
            }
          }
        }
      }
    }
  }

  consumer_sync();  // sQ written
  // scores q·k / √D: a thread's columns summed in order, then the row's quad
  const float sqrt_d = sqrtf(static_cast<float>(D));
  for (int j = 0; j < g; ++j) {
    const float* qj = sQ + j * D;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float dot = 0.f;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          const float2 qv = *reinterpret_cast<const float2*>(qj + 8 * jj + cq);
          dot = fmaf(qv.x, acc[t][4 * jj + 2 * hh], dot);
          dot = fmaf(qv.y, acc[t][4 * jj + 2 * hh + 1], dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if ((lane & 3) == 0) sS[j * SPAN + wg * 128 + t * 64 + r_in + 8 * hh] = dot / sqrt_d;
      }
    }
  }
  consumer_sync();
  span_softmax(sS, g, live, a, b, kvh, sp, tid);
}

}  // namespace kw

// ---------------------------------------------------------------------------
// keys, FMA body (fp32 at every D; bf16 at D 8 / 16 / 20 / 32 and ranks off the TMA
// stride)

namespace kf {

constexpr int THREADS = 256;
constexpr int BK = 64;  // keys a tile (four a span)
constexpr int RC = 32;  // ranks a shared-memory chunk of the up-projection

template <int D>
int smem(int g) {
  return 4 * (RC * D + RC * (BK + 1) + g * D + BK * (D + 1) + g * SPAN);
}

// Up-projection micro-tile: each thread owns KPT keys x CPT columns of the
// (BK x D) key tile, so one shared load of l_k feeds CPT FMAs and one of U_k KPT.
// Below D 32 four threads span a row (CPT 2, 4, 5 at D 8, 16, 20).
// D 112: 7 columns a thread, 16 threads across D and 16 across the keys.
// D 96: 12 columns a thread, 8 threads across D and 32 across the keys.
template <int D>
struct Tile {
  static constexpr int CPT = D == 112 ? 7 : D == 96 ? 12 : D >= 32 ? 8 : D / 4;  // columns
  static constexpr int TX = D / CPT;           // threads across D
  static constexpr int TY = THREADS / TX;      // threads across keys
  static constexpr int KPT = BK / TY;          // keys per thread
  static_assert(KPT >= 1 && TY * KPT == BK, "tile does not cover the keys");
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) fdec_keys_fma(Args a) {
  using Ti = Tile<D>;
  constexpr int HALF = D / 2;
  constexpr int LT = BK + 1;  // row stride of the rank-major l_k chunk
  const int3 it = work_item(a, blockIdx.x);
  const int b = it.x;
  const int sp = it.y;
  const int kvh = it.z;
  const int len = slot_len(a, b);
  const int k0 = sp * SPAN;
  if (k0 >= len) return;
  const int live = min(SPAN, len - k0);
  const int g = a.h / a.kv;
  const int tid = threadIdx.x;
  const size_t ld_u = static_cast<size_t>(a.kv) * D;

  extern __shared__ __align__(16) float smem[];
  float* sUK = smem;              // RC x D (16-byte aligned rows)
  float* sLK = sUK + RC * D;      // RC x LT, l_k chunk rank-major
  float* sQ = sLK + RC * LT;      // g x D
  float* sK = sQ + g * D;         // BK x (D + 1)
  float* sS = sK + BK * (D + 1);  // g x SPAN

  const T* q = static_cast<const T*>(a.q) +
               (static_cast<size_t>(b) * a.h + static_cast<size_t>(kvh) * g) * D;
  for (int i = tid; i < g * D; i += THREADS) sQ[i] = to_f(q[i]);
  const T* lk = static_cast<const T*>(a.lk) + static_cast<size_t>(b) * a.l * a.rk;
  const float* uk = a.uk + static_cast<size_t>(kvh) * D;
  const int tx = tid % Ti::TX;  // columns tx·CPT .. + CPT
  const int ty = tid / Ti::TX;  // keys ty·KPT .. + KPT
  const float sqrt_d = sqrtf(static_cast<float>(D));

  for (int t0 = 0; t0 < live; t0 += BK) {
    const int kt = k0 + t0;  // absolute key of the tile's first row
    const int n = min(BK, live - t0);

    // K = l_k @ U_k[:, kvh·D .. + D], fp32
    float acc[Ti::KPT][Ti::CPT];
#pragma unroll
    for (int i = 0; i < Ti::KPT; ++i) {
#pragma unroll
      for (int c = 0; c < Ti::CPT; ++c) acc[i][c] = 0.f;
    }
    for (int r0 = 0; r0 < a.rk; r0 += RC) {
      __syncthreads();  // the previous chunk (or tile) is consumed
      for (int idx = tid; idx < BK * RC; idx += THREADS) {
        const int key = idx / RC;
        const int rr = idx % RC;
        float x = 0.f;
        if (key < n && r0 + rr < a.rk) x = to_f(lk[static_cast<size_t>(kt + key) * a.rk + r0 + rr]);
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
        if constexpr (Ti::CPT % 4 == 0) {
#pragma unroll
          for (int c = 0; c < Ti::CPT; c += 4) {
            const float4 u4 = *reinterpret_cast<const float4*>(sUK + rr * D + tx * Ti::CPT + c);
            u[c] = u4.x;
            u[c + 1] = u4.y;
            u[c + 2] = u4.z;
            u[c + 3] = u4.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < Ti::CPT; ++c) u[c] = sUK[rr * D + tx * Ti::CPT + c];
        }
#pragma unroll
        for (int i = 0; i < Ti::KPT; ++i) {
#pragma unroll
          for (int c = 0; c < Ti::CPT; ++c) acc[i][c] = fmaf(lkv[i], u[c], acc[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < Ti::KPT; ++i) {
#pragma unroll
      for (int c = 0; c < Ti::CPT; ++c) {
        sK[(ty * Ti::KPT + i) * (D + 1) + tx * Ti::CPT + c] = acc[i][c];
      }
    }
    __syncthreads();

    // RoPE (rotate-half) at the keys' absolute positions
    if (a.rope) {
      for (int idx = tid; idx < n * HALF; idx += THREADS) {
        const int key = idx / HALF;
        const int j = idx % HALF;
        const size_t tab = static_cast<size_t>(kt + key) * HALF + j;
        const float c = a.cos[tab];
        const float s = a.sin[tab];
        float* row = sK + key * (D + 1);
        const float k1 = row[j];
        const float k2 = row[j + HALF];
        row[j] = k1 * c - k2 * s;
        row[j + HALF] = k2 * c + k1 * s;
      }
      __syncthreads();
    }

    // scores of the g query heads
    for (int o = tid; o < g * BK; o += THREADS) {
      const int j = o / BK;
      const int key = o % BK;
      if (key < n) {
        float dot = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < D; ++dd) dot = fmaf(sQ[j * D + dd], sK[key * (D + 1) + dd], dot);
        sS[j * SPAN + t0 + key] = dot / sqrt_d;
      }
    }
  }
  __syncthreads();
  span_softmax(sS, g, live, a, b, kvh, sp, tid);
}

}  // namespace kf

// ---------------------------------------------------------------------------
// values: a span's latent partial Σ_k p l_v, one block a (128 ranks, 32 query heads,
// slot·span): the span's p staged once in shared memory, each thread one rank and
// the 32 heads, l_v read straight from device memory, the next 8 keys in flight
// while the current 8 are summed

namespace kval {

constexpr int THREADS = 128;   // ranks a block, one a thread
constexpr int HB = 32;         // query heads a block
constexpr int PITCH = HB + 4;  // staged p row [key][head] (16-byte aligned)
constexpr int KU = 8;          // keys a thread loads at once
constexpr int PL = HB * SPAN / 4 / THREADS;  // float4s of p a thread stages

template <typename T>
__global__ void __launch_bounds__(THREADS) fdec_values(Args a) {
  __shared__ __align__(16) float sP[SPAN * PITCH];
  const int tid = threadIdx.x;
  const int r = blockIdx.x * THREADS + tid;
  const int h0 = blockIdx.y * HB;
  const int b = blockIdx.z / a.spans;
  const int sp = blockIdx.z % a.spans;
  const int len = slot_len(a, b);
  const int k0 = sp * SPAN;
  if (k0 >= len) return;  // no live key: no work
  const int live = min(SPAN, len - k0);

  // p of the block's heads (zero past the heads; p is already 0 past the live keys):
  // a lane a head, so the transposed stores hit 32 banks
  float4 pr[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int idx = tid + j * THREADS;  // head idx % 32, keys 4·(idx / 32) .. + 3
    const int h = h0 + idx % HB;
    pr[j] = h < a.h ? reinterpret_cast<const float4*>(a.p + part_row(a, b, h, sp) * SPAN)
                          [idx / HB]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int idx = tid + j * THREADS;
    const int hh = idx % HB;
    const int kk = 4 * (idx / HB);
    sP[kk * PITCH + hh] = pr[j].x;
    sP[(kk + 1) * PITCH + hh] = pr[j].y;
    sP[(kk + 2) * PITCH + hh] = pr[j].z;
    sP[(kk + 3) * PITCH + hh] = pr[j].w;
  }
  __syncthreads();
  if (r >= a.rv) return;

  const T* lv = static_cast<const T*>(a.lv) + (static_cast<size_t>(b) * a.l + k0) * a.rv + r;
  // keys kc .. kc + KU - 1 of l_v (zero past the live keys)
  auto load = [&](float (&v)[KU], int kc) {
#pragma unroll
    for (int j = 0; j < KU; ++j) {
      v[j] = kc + j < live ? to_f(lv[static_cast<size_t>(kc + j) * a.rv]) : 0.f;
    }
  };
  float acc[HB];
#pragma unroll
  for (int i = 0; i < HB; ++i) acc[i] = 0.f;
  float next[KU];
  load(next, 0);
  for (int kc = 0; kc < live; kc += KU) {
    float v[KU];
#pragma unroll
    for (int j = 0; j < KU; ++j) v[j] = next[j];
    if (kc + KU < live) load(next, kc + KU);  // in flight while these keys are summed
#pragma unroll
    for (int j = 0; j < KU; ++j) {
      const float* pk = sP + (kc + j) * PITCH;
#pragma unroll
      for (int i = 0; i < HB; i += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pk + i);
        acc[i] = fmaf(p4.x, v[j], acc[i]);
        acc[i + 1] = fmaf(p4.y, v[j], acc[i + 1]);
        acc[i + 2] = fmaf(p4.z, v[j], acc[i + 2]);
        acc[i + 3] = fmaf(p4.w, v[j], acc[i + 3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < HB; ++i) {
    if (h0 + i < a.h) a.pv[part_row(a, b, h0 + i, sp) * a.rv + r] = acc[i];
  }
}

// ctx = Σ_span e^(m - M) partial / max(Σ_span l e^(m - M), 1e-20), the spans in
// order: one block a (slot·head, 128 ranks)
constexpr int MERGE_THREADS = 128;

__global__ void __launch_bounds__(MERGE_THREADS) fdec_merge(Args a) {
  const int bh = blockIdx.x;
  const int b = bh / a.h;
  const int r = blockIdx.y * MERGE_THREADS + threadIdx.x;
  const int nsp = (slot_len(a, b) + SPAN - 1) / SPAN;
  const size_t row0 = static_cast<size_t>(bh) * a.spans;
  float mx = NEG_INF;
  for (int sp = 0; sp < nsp; ++sp) mx = fmaxf(mx, a.m[row0 + sp]);
  float den = 0.f;
  for (int sp = 0; sp < nsp; ++sp) den += a.lsum[row0 + sp] * expf(a.m[row0 + sp] - mx);
  if (r < a.rv) {
    float x = 0.f;
    for (int sp = 0; sp < nsp; ++sp) {
      x = fmaf(a.pv[(row0 + sp) * a.rv + r], expf(a.m[row0 + sp] - mx), x);
    }
    a.ctx[static_cast<size_t>(bh) * a.rv + r] = x / fmaxf(den, 1e-20f);
  }
}

}  // namespace kval

// ---------------------------------------------------------------------------
// out = ctx U_v[:, kvh·D .. + D]: one block a (column block, KV head) over all
// slots.  A thread takes 4 columns (one 16-byte load of a U_v row) of 8 rows (slot,
// head) at once; the block's thread groups split the ranks, U_v rows loaded 8 ahead,
// and their sums are added in split order, so each output's bits depend on its own
// row alone.

namespace ko {

constexpr int THREADS = 256;
constexpr int RPT = 8;     // rows a pass
constexpr int UNROLL = 8;  // U_v rows a thread loads at once

// Columns a block: all of D below 32, else 32, or 16 where 32 does not divide D (112).
template <int D>
constexpr int OUT_COLS = D < 32 ? D : D % 32 == 0 ? 32 : 16;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) fdec_out(Args a) {
  constexpr int CB = OUT_COLS<D>;    // columns a block
  constexpr int TC = CB / 4;           // threads across them, 4 columns each
  constexpr int NS = THREADS / TC;     // rank splits (threads past NS·TC idle: D 20)
  __shared__ __align__(16) float red[NS * RPT * CB];
  const int tid = threadIdx.x;
  const int c4 = (tid % TC) * 4;
  const int si = min(tid / TC, NS);
  const int kvh = blockIdx.y;
  const int g = a.h / a.kv;
  const int rows = a.b * g;
  const size_t ld_u = static_cast<size_t>(a.kv) * D;
  const float* u = a.uv + static_cast<size_t>(kvh) * D + blockIdx.x * CB + c4;
  const int rs = (a.rv + NS - 1) / NS;
  const int r_begin = si < NS ? min(a.rv, si * rs) : a.rv;
  const int r_end = min(a.rv, r_begin + rs);
  T* out = static_cast<T*>(a.out);
  for (int row0 = 0; row0 < rows; row0 += RPT) {
    const float* c[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = min(row0 + i, rows - 1);  // past the rows: computed, not stored
      c[i] = a.ctx + (static_cast<size_t>(row / g) * a.h + kvh * g + row % g) * a.rv;
    }
    float y[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) y[i][e] = 0.f;
    }
    for (int r = r_begin; r < r_end; r += UNROLL) {
      float4 uu[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        uu[k] = r + k < r_end
                    ? __ldg(reinterpret_cast<const float4*>(u + static_cast<size_t>(r + k) * ld_u))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        if (r + k < r_end) {
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float x = c[i][r + k];
            y[i][0] = fmaf(x, uu[k].x, y[i][0]);
            y[i][1] = fmaf(x, uu[k].y, y[i][1]);
            y[i][2] = fmaf(x, uu[k].z, y[i][2]);
            y[i][3] = fmaf(x, uu[k].w, y[i][3]);
          }
        }
      }
    }
    if (si < NS) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        *reinterpret_cast<float4*>(&red[(si * RPT + i) * CB + c4]) =
            make_float4(y[i][0], y[i][1], y[i][2], y[i][3]);
      }
    }
    __syncthreads();
    for (int o = tid; o < RPT * CB; o += THREADS) {
      const int i = o / CB;
      const int row = row0 + i;
      if (row < rows) {
        float x = 0.f;
        for (int w = 0; w < NS; ++w) x += red[(w * RPT + i) * CB + o % CB];
        const size_t bh = static_cast<size_t>(row / g) * a.h + kvh * g + row % g;
        out[bh * D + blockIdx.x * CB + o % CB] = from_f<T>(x);
      }
    }
    __syncthreads();
  }
}

}  // namespace ko

// ---------------------------------------------------------------------------
// host side

enum Body { FMA = 0, WGMMA = 1 };

long long round_up(long long x) { return (x + ALIGN_FLOATS - 1) / ALIGN_FLOATS * ALIGN_FLOATS; }

template <typename T, int D>
int launch_tail(const Args& a, cudaStream_t s) {
  const dim3 vgrid((a.rv + kval::THREADS - 1) / kval::THREADS,
                   (a.h + kval::HB - 1) / kval::HB, a.b * a.spans);
  kval::fdec_values<T><<<vgrid, kval::THREADS, 0, s>>>(a);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const dim3 mgrid(a.b * a.h, (a.rv + kval::MERGE_THREADS - 1) / kval::MERGE_THREADS);
  kval::fdec_merge<<<mgrid, kval::MERGE_THREADS, 0, s>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  constexpr int CB = ko::OUT_COLS<D>;
  ko::fdec_out<T, D><<<dim3(D / CB, a.kv), ko::THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_fma(const Args& a, int blocks, cudaStream_t s) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kf::fdec_keys_fma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  kf::fdec_keys_fma<T, D><<<blocks, kf::THREADS, kf::smem<D>(a.h / a.kv), s>>>(a);
  const int rc = static_cast<int>(cudaGetLastError());
  return rc != 0 ? rc : launch_tail<T, D>(a, s);
}

template <int D>
int launch_wgmma(const Args& a, int blocks, cudaStream_t s) {
  using C = kw::Cfg<D>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kw::fdec_keys_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const size_t n = static_cast<size_t>(a.rk) * a.kv * D;
  const size_t want = (n / 4 + 255) / 256;  // blocks of 256 float4s, at most 8 an SM
  const int split_blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  fdec_split_u<<<split_blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(a.uk), a.u2,
                                            a.u2 + n, n / 4);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  CUtensorMap tlk, tu;
  rc = tensor_map_3d(&tlk, a.lk, a.b, a.l, a.rk, SPAN);
  if (rc != 0) return rc;
  rc = tensor_map_3d(&tu, a.u2, 2, a.rk, a.kv * D, kw::RC);
  if (rc != 0) return rc;
  kw::fdec_keys_wgmma<D><<<blocks, kw::THREADS, C::smem(a.h / a.kv), s>>>(tlk, tu, a);
  rc = static_cast<int>(cudaGetLastError());
  return rc != 0 ? rc : launch_tail<bf16, D>(a, s);
}

template <typename T>
int launch_body(const Args& a, int d, int body, int blocks, cudaStream_t s) {
  if (body == WGMMA) {
    if constexpr (sizeof(T) == 2) {
      if (d == 64) return launch_wgmma<64>(a, blocks, s);
      if (d == 96) return launch_wgmma<96>(a, blocks, s);
      if (d == 112) return launch_wgmma<112>(a, blocks, s);
      if (d == 128) return launch_wgmma<128>(a, blocks, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 8: return launch_fma<T, 8>(a, blocks, s);
    case 16: return launch_fma<T, 16>(a, blocks, s);
    case 20: return launch_fma<T, 20>(a, blocks, s);
    case 32: return launch_fma<T, 32>(a, blocks, s);
    case 64: return launch_fma<T, 64>(a, blocks, s);
    case 96: return launch_fma<T, 96>(a, blocks, s);
    case 112: return launch_fma<T, 112>(a, blocks, s);
    case 128: return launch_fma<T, 128>(a, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int smem_bytes(int body, int g, int d) {
  if (body == WGMMA) {
    return d == 64    ? kw::Cfg<64>::smem(g)
           : d == 96  ? kw::Cfg<96>::smem(g)
           : d == 112 ? kw::Cfg<112>::smem(g)
                      : kw::Cfg<128>::smem(g);
  }
  switch (d) {
    case 8: return kf::smem<8>(g);
    case 16: return kf::smem<16>(g);
    case 20: return kf::smem<20>(g);
    case 32: return kf::smem<32>(g);
    case 64: return kf::smem<64>(g);
    case 96: return kf::smem<96>(g);
    case 112: return kf::smem<112>(g);
    default: return kf::smem<128>(g);
  }
}

}  // namespace

// One call under a launch plan (kernels/flash_decode.py::plan).  dtype: 0 = fp32, 1 =
// bf16 (q, lk, lv and out share it; uk, uv, cos, sin fp32).  body: 0 = fma (any dtype,
// D 8 / 16 / 20 / 32 / 64 / 96 / 112 / 128), 1 = wgmma (bf16, D 64 / 96 / 112 / 128, r_k a
// multiple of 8).  span is 256 and spans = ⌈l / span⌉.  The scratch holds, each region rounded up to 64
// floats: (wgmma) the two bf16 terms of U_k in r_k·KV·D floats, then m and l
// (b·h·spans each), p (b·h·spans·span), pv (b·h·spans·rv) and ctx (b·h·rv);
// scratch_floats is its size.
extern "C" int flash_decode_launch(const void* q, const void* lk, const void* lv,
                                   const void* uk, const void* uv, const void* lengths,
                                   const void* cos, const void* sin, void* out, void* scratch,
                                   long long scratch_floats, int b, int l, int h, int kv, int d,
                                   int rk, int rv, int rope, int dtype, int body, int span,
                                   int spans, void* stream) {
  if (b <= 0 || l <= 0 || kv <= 0 || h <= 0 || h % kv != 0 || rk <= 0 || rv <= 0 ||
      (d != 8 && d != 16 && d != 20 && d != 32 && d != 64 && d != 96 && d != 112 &&
       d != 128) ||
      (dtype != 0 && dtype != 1) ||
      (body != FMA && body != WGMMA) || span != SPAN || spans != (l + SPAN - 1) / SPAN ||
      (rope && (cos == nullptr || sin == nullptr)) || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (body == WGMMA &&
      (dtype != 1 || (d != 64 && d != 96 && d != 112 && d != 128) || rk % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int g = h / kv;
  const long long blocks = static_cast<long long>(b) * spans * kv;
  if (smem_bytes(body, g, d) > MAX_SMEM || blocks > 0x7fffffffll ||
      static_cast<long long>(b) * spans > 65535 || (h + kval::HB - 1) / kval::HB > 65535 ||
      static_cast<long long>(b) * h > 0x7fffffffll ||
      (rv + kval::MERGE_THREADS - 1) / kval::MERGE_THREADS > 65535 || kv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(b) * h * spans;
  const long long off_m = body == WGMMA ? round_up(static_cast<long long>(rk) * kv * d) : 0;
  const long long off_l = off_m + round_up(rows);
  const long long off_p = off_l + round_up(rows);
  const long long off_pv = off_p + round_up(rows * SPAN);
  const long long off_ctx = off_pv + round_up(rows * rv);
  const long long need = off_ctx + round_up(static_cast<long long>(b) * h * rv);
  if (scratch_floats < need) return static_cast<int>(cudaErrorInvalidValue);
  float* sf = static_cast<float*>(scratch);
  Args a{q, lk, lv, static_cast<const float*>(uk), static_cast<const float*>(uv),
         static_cast<const int*>(lengths), static_cast<const float*>(cos),
         static_cast<const float*>(sin), out, b, l, h, kv, rk, rv, rope, spans,
         reinterpret_cast<bf16*>(sf), sf + off_m, sf + off_l, sf + off_p, sf + off_pv,
         sf + off_ctx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(blocks);
  if (dtype == 0) return launch_body<float>(a, d, body, n, s);
  return launch_body<bf16>(a, d, body, n, s);
}
