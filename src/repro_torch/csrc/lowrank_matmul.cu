// Factorized linear y = (x @ V) @ U (+ bias + residual), written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/lowrank_matmul.py::lowrank_matmul,
// the AA-SVD inference GEMM behind every compressed linear.  The rank-k
// intermediate t = x @ V is summed in fp32 and rounded ONCE, from its full
// sum, to U's dtype (kernels/ref.py::lowrank_matmul_ref); the bias and the
// residual are added in fp32 before the one rounding of y.
//
// The TPU kernel keeps the (bt x k) fp32 t in VMEM; Hopper's 227 KB of shared
// memory holds too few rows of it at k 1232-1792, so t round-trips device
// memory between two products (2·T·k·eb bytes, ~6 us at T 4096).
//
// Bound on an H100: max(2·T·k·(n + m) flops / 989 TFLOP/s,
// (T·n + n·k + k·m + T·m)·eb bytes / 3.35 TB/s).  Decode (T 8) is bound by
// the factors' bytes, compression's T 4096 by the tensor cores.  The launch
// plan (kernels/lowrank_matmul.py::plan) picks one of three bodies:
//
//   small_t (T <= 16 bf16 / 64 fp32): bandwidth-designed skinny products.
//       One producer thread streams the factor's slice through a TMA ring
//       (bf16: stages of 64 rows x 256 bytes, two 128-byte-swizzled boxes;
//       fp32: 128 rows x 64 bytes); 8 consumer warps run mma.sync m16n8k16
//       on x's rows zero-padded to 16 (bf16; the tensor cores sum over
//       depth, ldmatrix.trans reads the factor) or FMA register tiles
//       (fp32), then add their tiles in a fixed order.  Each product splits
//       its contraction so one wave of blocks covers the SMs; the slices'
//       fp32 partials go to a scratch that splitk_reduce sums in slice
//       order and rounds once.  Every launch after the first is a
//       programmatic dependent launch: it starts (and starts streaming its
//       factor) while the one before drains, then waits for it.
//   wgmma (bf16 above it): one GEMM kernel launched for each product.  A
//       4-stage ring of 64-deep A / B tiles in shared memory (128-byte
//       swizzle) filled by TMA from one producer thread, a "full" and an
//       "empty" mbarrier per stage; one or two consumer warpgroups each run
//       wgmma.mma_async m64n128k16 on a 64-row half of the block tile with
//       fp32 accumulators in registers, releasing a stage once the next
//       stage's wgmmas are issued (wait_group 1).  A = x or t is K-major;
//       B = V or U is row-major with N contiguous (MN-major), read through
//       the descriptor's transpose bit.  TMA fills out-of-bounds boxes with
//       zeros, so no dimension is padded in memory.  The epilogue adds bias
//       and residual in fp32 straight from the accumulators and stores bf16
//       pairs; a product whose tiles cannot fill the card splits its
//       contraction into the scratch and splitk_reduce (which then owns the
//       epilogue).
//   fma32 (fp32 above it): the FMA GEMM gemm_f32 (TF32 stays off, for fp32
//       parity), 64 x 64 tiles, rows masked.
//
// No sum uses atomics: every split is summed in a fixed order, so results
// do not change from run to run.  The TMA descriptors are encoded on the
// host per call (they hold the base pointers); the encoder is a driver
// entry point fetched once through the runtime, so nothing links libcuda.
//
// Contract (checked by the Python wrapper, kernels/ops.py::lowrank_matmul):
//   x (T, n), v (n, k), u (k, m), t (T, k), y (T, m), all contiguous,
//   16-byte aligned and of one dtype; bias (m,) and residual (T, m) of the
//   same dtype or null; scratch fp32 of the plan's size.  n, k, m multiples
//   of 16 bytes' worth of elements (fma32: k, m of 64 and n of 16; the
//   wrapper zero-pads, which is exact).  Returns the first non-zero
//   cudaError of the call's launches.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// ---------------------------------------------------------------------------
// shared-memory barriers and TMA

constexpr long long kWaitTimeout = 1ll << 34;  // cycles (~10 s) before a stuck wait traps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// Wait for the completion of the barrier's phase of this parity; a wait that
// never ends traps (a launch failure) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitTimeout) __trap();
  }
}

// 2D TMA load of one box at (inner, outer) element coordinates.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {  // the 8 consumer warps only
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// ---------------------------------------------------------------------------
// small_t: skinny products, bound by the factor's bytes

namespace skinny {
constexpr int CONSUMERS = 256;           // 8 warps of math
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int A_BYTES = 36 * 1024;       // staged A, then the reduction buffer
}  // namespace skinny

// A skinny kernel's ring of B tiles: STAGES stages of BR depth rows, each
// stage BOXES TMA boxes of BOX_COLS columns side by side.
template <int BR_, int BOXES_, int BOX_COLS_, int BOX_BYTES_, int STAGES_>
struct Ring {
  static constexpr int BR = BR_;
  static constexpr int BOXES = BOXES_;
  static constexpr int BOX_COLS = BOX_COLS_;
  static constexpr int BOX_BYTES = BOX_BYTES_;
  static constexpr int STAGES = STAGES_;
  static constexpr int STAGE_BYTES = BOXES * BOX_BYTES;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + skinny::A_BYTES + 2 * STAGES * 8;
};
// fp32: 128 rows x 16 columns (64 bytes) a box, six in flight
using FmaRing = Ring<128, 1, 16, 8192, 6>;
// bf16: 64 rows x 128 columns (256 bytes) a stage as two 128-byte-swizzled
// boxes (the wgmma body's B tiles), four in flight
using MmaRing = Ring<64, 2, 64, 8192, 4>;

// A skinny block's shared memory: the ring (1024-aligned, as the 128-byte
// swizzle needs), staged A (then the cross-warp reduction buffer), the
// ring's "full" / "empty" barriers.
template <typename R>
struct SkinnySmem {
  uint32_t ring;
  const uint8_t* ring_ptr;
  uint8_t* a;
  uint32_t bars;
  __device__ explicit SkinnySmem(uint8_t* raw) {
    const uint32_t base = smem_u32(raw);
    ring = (base + 1023u) & ~1023u;
    ring_ptr = raw + (ring - base);
    a = raw + (ring - base) + R::STAGES * R::STAGE_BYTES;
    bars = ring + R::STAGES * R::STAGE_BYTES + skinny::A_BYTES;
  }
  __device__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ uint32_t empty(int s) const { return bars + 8u * (R::STAGES + s); }
};

// Every skinny block starts here: a launch that follows this one
// programmatically (t @ U after x @ V) may start its blocks now (they wait
// for this grid before reading its output); the ring's barriers are set up;
// the producer warp's one thread streams B's rows [k0, k1) from column col0
// (B is a factor, never written by the launch before, so it starts at once)
// and the warp gets false.  Consumers get true once the launch before has
// completed.
template <typename R>
__device__ __forceinline__ bool skinny_start(const SkinnySmem<R>& sm,
                                             const CUtensorMap* tma_b, int col0,
                                             int k0, int k1) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), skinny::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= skinny::CONSUMERS) {
    if (tid == skinny::CONSUMERS) {
      const int stages = (k1 - k0 + R::BR - 1) / R::BR;
      for (int i = 0; i < stages; ++i) {
        const int s = i % R::STAGES;
        if (i >= R::STAGES) mbar_wait(sm.empty(s), ((i / R::STAGES) - 1) & 1);
        mbar_expect_tx(sm.full(s), R::STAGE_BYTES);
#pragma unroll
        for (int b = 0; b < R::BOXES; ++b) {
          tma_load(sm.ring + s * R::STAGE_BYTES + b * R::BOX_BYTES, tma_b,
                   sm.full(s), col0 + b * R::BOX_COLS, k0 + i * R::BR);
        }
      }
    }
    return false;
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  return true;
}

// ---- fp32: FMA register tiles

template <int TR>
struct Skinny {
  static constexpr int VEC = 4;                  // fp32 in a 16-byte vector
  static constexpr int CG = 4;                   // vectors across a row of B
  static constexpr int COLS = CG * VEC;          // 16 columns a block
  static constexpr int TS = 8;                   // rows of A per thread
  static constexpr int TG = TR / TS;             // thread groups over the rows of A
  static constexpr int LPR = CG * TG;            // lanes sharing one row of B
  static constexpr int RPW = 32 / LPR;           // rows of B a warp takes per step
  static constexpr int RG = 8 * RPW;             // rows of B the 8 warps take per step
  // depth of A staged per chunk: whole stages, rows 1 mod 32 floats apart
  static constexpr int CH = (skinny::A_BYTES / 4 / TR - 1) / FmaRing::BR * FmaRing::BR;
  static constexpr int LDX = CH + 1;
  static constexpr int SV = (TR * CH / VEC + skinny::CONSUMERS - 1) / skinny::CONSUMERS;
  static_assert(COLS == FmaRing::BOX_COLS, "one box a stage");
  static_assert(TR % TS == 0 && LPR <= 32 && FmaRing::BR % RG == 0, "row tile");
  static_assert(CH >= FmaRing::BR && 4 * TR * COLS * 4 <= skinny::A_BYTES, "staging");
};

// fp32 C (rows, N) = A (rows, K) @ B (K, N) for rows <= TR on the FMA units.
// Block (x, y) owns columns [x·16, +16) over the depth slice [y·kc, y·kc +
// kc) of K; split over depth (part != null) it stores fp32 partials to
// part[y][rows][N] for splitk_reduce, otherwise c = sum + bias + res.  The
// consumers
// stage A in shared memory chunk by chunk and keep an 8-row x 4-column
// register tile per thread over their rows of each box, then sum their row
// groups in a fixed order (shuffles, then a tree over the warps).
template <int TR>
__global__ void __launch_bounds__(skinny::THREADS, 2)
skinny_fma(const __grid_constant__ CUtensorMap tma_b, const float* __restrict__ a,
           float* __restrict__ part, float* __restrict__ c,
           const float* __restrict__ bias, const float* __restrict__ res,
           int rows, int K, int N, int kc) {
  using S = Skinny<TR>;
  using R = FmaRing;
  constexpr int VEC = S::VEC;
  constexpr int TS = S::TS;
  extern __shared__ uint8_t smem_raw[];
  const SkinnySmem<R> sm(smem_raw);
  float* xs = reinterpret_cast<float*>(sm.a);
  const int col0 = blockIdx.x * S::COLS;
  const int k0 = blockIdx.y * kc;
  const int k1 = min(K, k0 + kc);
  if (!skinny_start(sm, &tma_b, col0, k0, k1)) return;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int cg = lane % S::CG;
  const int tg = (lane / S::CG) % S::TG;
  const int rsub = lane / S::LPR;
  const int rg = warp * S::RPW + rsub;
  const int col = col0 + cg * VEC;
  const bool live = col < N;

  float acc[TS][VEC];
#pragma unroll
  for (int i = 0; i < TS; ++i) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
  }
  int stage = 0;
  for (int c0 = k0; c0 < k1; c0 += S::CH) {
    const int len = min(S::CH, k1 - c0);  // a multiple of VEC
    const int vecs = TR * (len / VEC);
    // A[:, c0:c0 + len) (rows past `rows` zero): 16-byte loads, all of a
    // thread's in flight before its stores; lanes take consecutive rows,
    // so the stores fall on distinct banks
    float4 ld[S::SV];
#pragma unroll
    for (int q = 0; q < S::SV; ++q) {
      const int i = tid + q * skinny::CONSUMERS;
      const int r = i % TR;
      ld[q] = (i < vecs && r < rows)
                  ? __ldg(reinterpret_cast<const float4*>(
                        a + static_cast<size_t>(r) * K + c0 + (i / TR) * VEC))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    consumer_sync();  // the previous chunk's readers are done
#pragma unroll
    for (int q = 0; q < S::SV; ++q) {
      const int i = tid + q * skinny::CONSUMERS;
      if (i < vecs) {
        float* dst = &xs[(i % TR) * S::LDX + (i / TR) * VEC];
        dst[0] = ld[q].x;
        dst[1] = ld[q].y;
        dst[2] = ld[q].z;
        dst[3] = ld[q].w;
      }
    }
    consumer_sync();
    for (int jb = 0; jb < len; jb += R::BR, ++stage) {
      const int s = stage % R::STAGES;
      mbar_wait(sm.full(s), (stage / R::STAGES) & 1);
      const float* bx = reinterpret_cast<const float*>(sm.ring_ptr + s * R::STAGE_BYTES);
#pragma unroll
      for (int q = 0; q < R::BR / S::RG; ++q) {
        const int r = rg + q * S::RG;
        if (jb + r < len) {
          const float4 b4 = *reinterpret_cast<const float4*>(bx + r * S::COLS + cg * VEC);
          const float bv[VEC] = {b4.x, b4.y, b4.z, b4.w};
          const float* xr = &xs[tg * TS * S::LDX + jb + r];
#pragma unroll
          for (int i = 0; i < TS; ++i) {
            const float xv = xr[i * S::LDX];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(xv, bv[e], acc[i][e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(s));
    }
  }

  // the warp's row groups (lanes LPR apart)
#pragma unroll
  for (int off = S::LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < TS; ++i) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
    }
  }
  // the 8 warps: ((w0 + w4) + (w2 + w6)) + ((w1 + w5) + (w3 + w7))
  float* red = xs;
#pragma unroll
  for (int half = 4; half >= 1; half >>= 1) {
    consumer_sync();
    if (warp >= half && warp < 2 * half && rsub == 0) {
#pragma unroll
      for (int i = 0; i < TS; ++i) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          red[((warp - half) * TR + tg * TS + i) * S::COLS + cg * VEC + e] = acc[i][e];
      }
    }
    consumer_sync();
    if (warp < half && rsub == 0) {
#pragma unroll
      for (int i = 0; i < TS; ++i) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[i][e] += red[(warp * TR + tg * TS + i) * S::COLS + cg * VEC + e];
      }
    }
  }
  if (warp == 0 && rsub == 0 && live) {
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      const int r = tg * TS + i;
      if (r >= rows) continue;
      const size_t o = static_cast<size_t>(r) * N + col;
      float v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = acc[i][e];
      if (part != nullptr) {
        *reinterpret_cast<float4*>(part + blockIdx.y * static_cast<size_t>(rows) * N + o) =
            make_float4(v[0], v[1], v[2], v[3]);
        continue;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (bias != nullptr) v[e] += bias[col + e];
        if (res != nullptr) v[e] += res[o + e];
      }
      *reinterpret_cast<float4*>(c + o) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// ---- bf16: mma.sync on the tensor cores

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0,
                                                  uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row-major) @ b (16 x 8, bf16)
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int TR>
struct SkinnyMma {
  static constexpr int MT = TR / 16;  // m16 tiles over the rows of A
  static constexpr int COLS = 128;    // two 64-column boxes a stage
  // depth of A staged per chunk: whole stages in 20 KB (few staging
  // registers); rows 16 bytes apart mod 128
  static constexpr int CH = (20480 / 2 / TR - 8) / 64 * 64;
  static constexpr int LDA = CH + 8;
  static constexpr int SV = (TR * CH / 8 + skinny::CONSUMERS - 1) / skinny::CONSUMERS;
  static_assert(TR % 16 == 0 && CH >= 64, "row tile");
  static_assert(2 * 2 * 32 * MT * 32 * 4 <= skinny::A_BYTES, "reduction buffer");
};

// bf16 C (rows, N) = A (rows, K) @ B (K, N) for rows <= TR, fp32 sums on the
// tensor cores: mma.sync m16n8k16 on A's rows zero-padded to TR.  Block
// (x, y) owns columns [x·128, +128) over the depth slice [y·kc, y·kc + kc);
// split over depth (part != null) it stores fp32 partials to
// part[y][rows][N] for splitk_reduce, otherwise c = round(sum + bias + res).  B streams in stages of 64 depth
// rows x 256 bytes (DRAM-friendly rows); warp w takes depth rows
// 16·(w % 4).. of each stage in column half w / 4 (eight n8 tiles,
// ldmatrix.trans through the 128-byte swizzle) against A staged in bf16, so
// the tensor cores sum over depth and the block only adds its four depth
// warps' tiles (a tree through shared memory).
template <int TR>
__global__ void __launch_bounds__(skinny::THREADS, 2)
skinny_mma(const __grid_constant__ CUtensorMap tma_b, const bf16* __restrict__ a,
           float* __restrict__ part, bf16* __restrict__ c,
           const bf16* __restrict__ bias, const bf16* __restrict__ res, int rows,
           int K, int N, int kc) {
  using S = SkinnyMma<TR>;
  using R = MmaRing;
  constexpr int MT = S::MT;
  extern __shared__ uint8_t smem_raw[];
  const SkinnySmem<R> sm(smem_raw);
  bf16* as = reinterpret_cast<bf16*>(sm.a);
  const int col0 = blockIdx.x * S::COLS;
  const int k0 = blockIdx.y * kc;
  const int k1 = min(K, k0 + kc);
  if (!skinny_start(sm, &tma_b, col0, k0, k1)) return;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int kq = warp % 4;  // depth rows 16·kq.. of each stage
  const int ch = warp / 4;  // column half: box ch of each stage
  const int g = lane / 4;   // fragment row group
  const int tq = lane % 4;  // fragment column pair

  float d[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[mt][j][e] = 0.f;
    }
  }
  int stage = 0;
  for (int c0 = k0; c0 < k1; c0 += S::CH) {
    const int len = min(S::CH, k1 - c0);  // a multiple of 8
    const int per_row = (len + 15) / 16 * 2;  // 16-byte vectors, to a multiple of 16 columns
    // A[:, c0:c0 + 16·ceil(len/16)) in bf16, zero past `rows` and past len:
    // 16-byte loads, all of a thread's in flight before its stores
    uint4 ld[S::SV];
#pragma unroll
    for (int q = 0; q < S::SV; ++q) {
      const int i = tid + q * skinny::CONSUMERS;
      const int r = i / per_row;
      const int j = (i % per_row) * 8;
      ld[q] = (r < rows && r < TR && j < len)
                  ? __ldg(reinterpret_cast<const uint4*>(
                        a + static_cast<size_t>(r) * K + c0 + j))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
    consumer_sync();  // the previous chunk's readers are done
#pragma unroll
    for (int q = 0; q < S::SV; ++q) {
      const int i = tid + q * skinny::CONSUMERS;
      if (i < TR * per_row) {
        *reinterpret_cast<uint4*>(&as[(i / per_row) * S::LDA + (i % per_row) * 8]) = ld[q];
      }
    }
    consumer_sync();
    for (int jb = 0; jb < len; jb += R::BR, ++stage) {
      const int s = stage % R::STAGES;
      mbar_wait(sm.full(s), (stage / R::STAGES) & 1);
      const int kk = jb + 16 * kq;  // this warp's 16 depth rows
      if (kk < len) {
        // B fragments of eight n8 tiles: ldmatrix.trans of 8 x 8 blocks
        // (depth rows x 8 columns); lane l addresses row l % 8 of block
        // l / 8 (depth half (l / 8) % 2, column group 2p + l / 16), whose
        // 16-byte chunk the 128-byte swizzle moves to chunk ^ (row % 8)
        uint32_t b[8][2];
        const int r = 16 * kq + ((lane / 8) % 2) * 8 + lane % 8;
        const uint32_t row = sm.ring + s * R::STAGE_BYTES + ch * R::BOX_BYTES + r * 128;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int chunk = 2 * p + lane / 16;
          ldmatrix_x4_trans(row + ((chunk ^ (r % 8)) * 16), b[2 * p][0], b[2 * p][1],
                            b[2 * p + 1][0], b[2 * p + 1][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const bf16* ar = &as[(mt * 16 + g) * S::LDA + kk + 2 * tq];
          uint32_t af[4];
          af[0] = *reinterpret_cast<const uint32_t*>(ar);
          af[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * S::LDA);
          af[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
          af[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * S::LDA + 8);
#pragma unroll
          for (int j = 0; j < 8; ++j) mma_m16n8k16(d[mt][j], af, b[j]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(s));
    }
  }

  // the four depth warps of each column half: (kq0 + kq2) + (kq1 + kq3)
  float* red = reinterpret_cast<float*>(sm.a);
#pragma unroll
  for (int half = 2; half >= 1; half >>= 1) {
    consumer_sync();
    if (kq >= half && kq < 2 * half) {
      float* dst = red + ((ch * 2 + kq - half) * 32 + lane) * (MT * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[(mt * 8 + j) * 4 + e] = d[mt][j][e];
        }
      }
    }
    consumer_sync();
    if (kq < half) {
      const float* src = red + ((ch * 2 + kq) * 32 + lane) * (MT * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) d[mt][j][e] += src[(mt * 8 + j) * 4 + e];
        }
      }
    }
  }
  // warps kq 0 hold their half's tile: d[mt][j][2h + e] is row
  // mt·16 + g + 8h, column col0 + 64·ch + 8j + 2·tq + e
  if (kq == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = col0 + 64 * ch + 8 * j + 2 * tq;
          if (col >= N) continue;  // N is a multiple of 8
          const size_t o = static_cast<size_t>(r) * N + col;
          float v0 = d[mt][j][2 * h];
          float v1 = d[mt][j][2 * h + 1];
          if (part != nullptr) {
            *reinterpret_cast<float2*>(part + blockIdx.y * static_cast<size_t>(rows) * N + o) =
                make_float2(v0, v1);
            continue;
          }
          if (bias != nullptr) {
            const float2 bv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(bias + col));
            v0 += bv.x;
            v1 += bv.y;
          }
          if (res != nullptr) {
            const float2 rv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(res + o));
            v0 += rv.x;
            v1 += rv.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(c + o) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// out (rows, cols) = round(sum over z in order of part[z] (+ bias + res)):
// the one rounding of a product whose contraction was split across blocks.
template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce(const float* __restrict__ part, int splits, int rows, int cols,
              T* __restrict__ out, const T* __restrict__ bias,
              const T* __restrict__ res) {
  // launched programmatically after the product that writes `part`: let
  // the next launch start, then wait for that product
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const size_t plane = static_cast<size_t>(rows) * cols;
  const size_t quads = plane / 4;
  for (size_t q = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       q < quads; q += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t o = q * 4;
    float4 s = *reinterpret_cast<const float4*>(part + o);
    for (int z = 1; z < splits; ++z) {
      const float4 p = *reinterpret_cast<const float4*>(part + z * plane + o);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    float v[4] = {s.x, s.y, s.z, s.w};
    const int col = static_cast<int>(o % cols);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (bias != nullptr) v[e] += to_f(bias[col + e]);
      if (res != nullptr) v[e] += to_f(res[o + e]);
      out[o + e] = from_f<T>(v[e]);
    }
  }
}

// ---------------------------------------------------------------------------
// fma32: fp32 on the FMA units

constexpr int BM = 64;        // block tile rows
constexpr int BN = 64;        // block tile columns
constexpr int BK = 16;        // contraction depth per shared-memory step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int APAD = 4;       // keeps the transposed A tile off one bank

// C (M, N) = A (M, K) @ B (K, N) [+ bias (N)] [+ res (M, N)], all fp32;
// rows past M read zeros and are not stored.
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
      sa[ac][ar] = row0 + ar < m
                       ? a[static_cast<size_t>(row0 + ar) * k + k0 + ac]
                       : 0.f;
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
    if (r >= m) continue;
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
// wgmma: bf16 on the tensor cores, fed by a TMA ring

namespace wg {
constexpr int BN = 128;                 // block tile columns: two 64-column swizzle atoms of B
constexpr int BK = 64;                  // depth per stage: one 128-byte swizzled row of A
constexpr int STAGES = 4;
constexpr int SLICE = 8;                // depth steps a slice: 512 rows
constexpr int BM = 128;                 // block tile rows: two consumer warpgroups of 64
constexpr int A_ROWS_BYTES = 64 * BK * 2;  // 8 KB: one warpgroup's 64 rows of A
constexpr int A_BYTES = 2 * A_ROWS_BYTES;
constexpr int B_ATOM = BK * 64 * 2;        // 8 KB: 64 depth rows x 64 columns of B
constexpr int STAGE_BYTES = A_BYTES + 2 * B_ATOM;
constexpr int THREADS = 3 * 128;           // + one producer warpgroup
// the 128-byte swizzle repeats every 1024 bytes: stages start 1024-aligned
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
}  // namespace wg

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset, stride byte offset (bytes, stored in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) = A (64 x 16, K-major) @ B (16 x 128, MN-major)
// (+ d when accumulate)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// C (M, N) = A (M, K) @ B (K, N), bf16 in, fp32 sums.  Block (x, y, z) owns
// rows [y·128, +128) and columns [x·128, +128) over the depth slice
// [z·kc, z·kc + kc).  With part != null it stores fp32 partial sums to
// part[z][M][N]; otherwise c = round(sum + bias + res) in bf16.  The depth
// is summed in slices of SLICE steps (512 rows), each slice's sum added to a
// running total in slice order; a split plan gives each block one slice and
// splitk_reduce adds them in the same order, so a row's result is the same
// bits whether its product was split or not, and whatever its batch's T.
__global__ void __launch_bounds__(wg::THREADS, 1)
gemm_wgmma(const __grid_constant__ CUtensorMap tma_a,
           const __grid_constant__ CUtensorMap tma_b, float* __restrict__ part,
           bf16* __restrict__ c, const bf16* __restrict__ bias,
           const bf16* __restrict__ res, int M, int N, int K, int kc) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + wg::STAGES * wg::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (wg::STAGES + s); };

  const int tid = threadIdx.x;
  const int group = tid / 128;
  const int m0 = blockIdx.y * wg::BM;
  const int n0 = blockIdx.x * wg::BN;
  const int k0 = blockIdx.z * kc;
  const int nk = (min(K, k0 + kc) - k0 + wg::BK - 1) / wg::BK;

  if (tid == 0) {
    for (int s = 0; s < wg::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (group == 2) {  // producer warpgroup: one thread issues every load
    if (tid == 2 * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % wg::STAGES;
        if (kt >= wg::STAGES) mbar_wait(empty(s), ((kt / wg::STAGES) - 1) & 1);
        const uint32_t sa = base + s * wg::STAGE_BYTES;
        const uint32_t sb = sa + wg::A_BYTES;
        const int kk = k0 + kt * wg::BK;
        mbar_expect_tx(full(s), wg::STAGE_BYTES);
        tma_load(sa, &tma_a, full(s), kk, m0);
        tma_load(sb, &tma_b, full(s), n0, kk);
        tma_load(sb + wg::B_ATOM, &tma_b, full(s), n0 + 64, kk);
      }
    }
    return;
  }

  float d[64];    // this slice's sum
  float tot[64];  // the slices so far, added in order
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = tot[i] = 0.f;
  int released = -1;  // stages up to this depth step are handed back
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % wg::STAGES;
    mbar_wait(full(s), (kt / wg::STAGES) & 1);
    const uint32_t sa = base + s * wg::STAGE_BYTES + group * wg::A_ROWS_BYTES;
    const uint32_t sb = base + s * wg::STAGE_BYTES + wg::A_BYTES;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int j = 0; j < wg::BK / 16; ++j) {
      // A: K-major, 16 columns = 32 bytes further along each swizzled row;
      // B: MN-major, 16 depth rows = 2048 bytes further; the second
      // 64-column atom lies B_ATOM bytes on (LBO), 8-row groups 1024 (SBO).
      // A slice's first step starts d afresh.
      wgmma_m64n128k16(d, smem_desc(sa + j * 32, 16, 1024),
                       smem_desc(sb + j * 16 * 128, wg::B_ATOM, 1024),
                       j > 0 || kt % wg::SLICE != 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_acc(d);
    int done = kt - 1;
    if (kt % wg::SLICE == wg::SLICE - 1 || kt == nk - 1) {
      // the slice is complete: add it to the running total
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(d);
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += d[i];
      done = kt;
    } else {
      // the previous step's wgmmas are done: hand its buffers back
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(d);
    }
    for (int r = released + 1; r <= done; ++r) {
      if (tid % 128 == 0) mbar_arrive(empty(r % wg::STAGES));
    }
    released = done;
  }

  // accumulator layout: warp w of the warpgroup holds rows 16w..16w+15;
  // d[4j + 2h + e] is row (lane / 4) + 8h, column 8j + 2·(lane % 4) + e
  const int t = tid % 128;
  const int row0 = m0 + group * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int col0 = n0 + (t % 4) * 2;
  float* zpart = part == nullptr
                     ? nullptr
                     : part + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int j = 0; j < wg::BN / 8; ++j) {
    const int col = col0 + j * 8;
    if (col >= N) continue;  // N is a multiple of 8: pairs never straddle it
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + h * 8;
      if (row >= M) continue;
      float v0 = tot[4 * j + 2 * h];
      float v1 = tot[4 * j + 2 * h + 1];
      const size_t o = static_cast<size_t>(row) * N + col;
      if (zpart != nullptr) {
        *reinterpret_cast<float2*>(zpart + o) = make_float2(v0, v1);
        continue;
      }
      if (bias != nullptr) {
        const float2 bv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bias + col));
        v0 += bv.x;
        v1 += bv.y;
      }
      if (res != nullptr) {
        const float2 rv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(res + o));
        v0 += rv.x;
        v1 += rv.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(c + o) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// ---------------------------------------------------------------------------
// host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: fetched once through the runtime,
// so the library links against no libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// Row-major (rows, cols) of T cut into (box_rows, box_cols) boxes, zeros out
// of bounds.  The map holds the base pointer: built per call.
template <typename T>
int tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
               int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, map_type<T>(), 2, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// wgmma's operands: (box_rows, 64) bf16 boxes, 128-byte swizzle
int tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
               int box_rows) {
  return tensor_map<bf16>(map, ptr, rows, cols, box_rows, 64,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

// Launch on stream s; with `after`, programmatically after the previous
// launch on the stream (programmatic dependent launch): it may start while
// that one drains, and waits for it (griddepcontrol.wait) before reading
// its output.  Returns the launch's cudaError.
template <typename... Args, typename... Params>
int launch(void (*kernel)(Params...), dim3 grid, dim3 block, int smem,
           cudaStream_t s, bool after, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = after ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

template <typename T>
int reduce(const float* part, int splits, int rows, int cols, T* out,
           const T* bias, const T* res, cudaStream_t s) {
  const size_t quads = static_cast<size_t>(rows) * cols / 4;
  const int blocks = static_cast<int>(
      quads / 256 + 1 < 132 * 8 ? quads / 256 + 1 : 132 * 8);
  return launch(splitk_reduce<T>, dim3(blocks), dim3(256), 0, s, true, part,
                splits, rows, cols, out, bias, res);
}

// One product through the wgmma body: direct (splits == 1) or one slice a
// block into the scratch, summed by splitk_reduce.
int gemm_bf16(const bf16* a, const bf16* b, bf16* c, const bf16* bias,
              const bf16* res, float* scratch, int M, int N, int K, int splits,
              int kc, cudaStream_t s) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  CUtensorMap ta, tb;
  int rc = tensor_map(&ta, a, M, K, wg::BM);
  if (rc != 0) return rc;
  rc = tensor_map(&tb, b, K, N, wg::BK);
  if (rc != 0) return rc;
  const dim3 grid((N + wg::BN - 1) / wg::BN, (M + wg::BM - 1) / wg::BM, splits);
  if (splits == 1) {
    gemm_wgmma<<<grid, wg::THREADS, wg::SMEM, s>>>(ta, tb, nullptr, c, bias,
                                                   res, M, N, K, K);
    return static_cast<int>(cudaGetLastError());
  }
  gemm_wgmma<<<grid, wg::THREADS, wg::SMEM, s>>>(ta, tb, scratch, nullptr,
                                                 nullptr, nullptr, M, N, K, kc);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return reduce<bf16>(scratch, splits, M, N, c, bias, res, s);
}

// The skinny body of an element type: FMA (fp32) or mma.sync (bf16), its
// ring, its column tile and the TMA boxes of its B.
template <int TR, typename T>
struct SkinnyKernel;
template <int TR>
struct SkinnyKernel<TR, float> {
  using R = FmaRing;
  static constexpr int COLS = Skinny<TR>::COLS;
  static constexpr auto fn = &skinny_fma<TR>;
  static int map(CUtensorMap* m, const float* b, int K, int N) {
    return tensor_map<float>(m, b, K, N, R::BR, R::BOX_COLS, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
};
template <int TR>
struct SkinnyKernel<TR, bf16> {
  using R = MmaRing;
  static constexpr int COLS = SkinnyMma<TR>::COLS;
  static constexpr auto fn = &skinny_mma<TR>;
  static int map(CUtensorMap* m, const bf16* b, int K, int N) {
    return tensor_map(m, b, K, N, R::BR);  // the wgmma body's B boxes
  }
};

// One skinny product: unsplit, or split over `splits` depth slices of kc
// rows into the scratch and summed by splitk_reduce (launched after it).
// `after` launches it programmatically after the previous launch on the
// stream (its B stream starts while that launch drains).
template <int TR, typename T>
int skinny_product(const T* a, const T* b, T* c, const T* bias, const T* res,
                   float* scratch, int rows, int N, int K, int splits, int kc,
                   bool after, cudaStream_t s) {
  using KS = SkinnyKernel<TR, T>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        KS::fn, cudaFuncAttributeMaxDynamicSharedMemorySize, KS::R::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  CUtensorMap tb;
  int rc = KS::map(&tb, b, K, N);
  if (rc != 0) return rc;
  const dim3 grid((N + KS::COLS - 1) / KS::COLS, splits);
  const dim3 block(skinny::THREADS);
  float* part = splits > 1 ? scratch : nullptr;
  T* out = splits > 1 ? nullptr : c;
  const int depth = splits > 1 ? kc : K;
  rc = launch(KS::fn, grid, block, KS::R::SMEM, s, after, tb, a, part, out,
              bias, res, rows, K, N, depth);
  if (rc != 0 || splits == 1) return rc;
  return reduce<T>(scratch, splits, rows, N, c, bias, res, s);
}

// t = x @ V split over n, then y = t @ U (+ bias + residual) split over k;
// every launch after the first is programmatic, so each starts (and the
// products start streaming their factor) while the one before drains
template <int TR, typename T>
int small_t(const T* x, const T* v, const T* u, T* t, T* y, const T* bias,
            const T* res, float* scratch, int rows, int n, int k, int m, int s1,
            int kc1, int s2, int kc2, cudaStream_t s) {
  const int rc = skinny_product<TR, T>(x, v, t, nullptr, nullptr, scratch, rows,
                                       k, n, s1, kc1, false, s);
  if (rc != 0 || m == 0) return rc;
  return skinny_product<TR, T>(t, u, y, bias, res, scratch, rows, m, k, s2, kc2,
                               true, s);
}

template <typename T>
int small_t_rows(const T* x, const T* v, const T* u, T* t, T* y, const T* bias,
                 const T* res, float* scratch, int rows, int n, int k, int m,
                 int tile_rows, int s1, int kc1, int s2, int kc2,
                 cudaStream_t s) {
  // fp32 (FMA) rows 8/16/32/64; bf16 (mma.sync, m16 tiles) rows 16/32
  constexpr bool fma = sizeof(T) == 4;
  switch (tile_rows) {
    case 8:
      if constexpr (fma) {
        return small_t<8, T>(x, v, u, t, y, bias, res, scratch, rows, n, k,
                             m, s1, kc1, s2, kc2, s);
      }
      break;
    case 16:
      return small_t<16, T>(x, v, u, t, y, bias, res, scratch, rows, n, k,
                            m, s1, kc1, s2, kc2, s);
    case 32:
      return small_t<32, T>(x, v, u, t, y, bias, res, scratch, rows, n, k,
                            m, s1, kc1, s2, kc2, s);
    case 64:
      if constexpr (fma) {
        return small_t<64, T>(x, v, u, t, y, bias, res, scratch, rows, n, k,
                              m, s1, kc1, s2, kc2, s);
      }
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One call of the factorized linear under a launch plan
// (kernels/lowrank_matmul.py::plan).  dtype: 0 = fp32, 1 = bf16.  body:
// 0 = fma32, 1 = small_t, 2 = wgmma.  tile_rows_xv / tile_rows_tu: each
// product's row tile, small_t's (8/16/32/64, the same for both) or wgmma's
// (128).  splits_xv / depth_xv: x @ V's
// contraction (n) cut into splits of depth rows; splits_tu / depth_tu the
// same for t @ U's (k); scratch holds max(splits·T·cols) fp32 when a
// product is split.  m = 0 runs x @ V alone (u, y, bias, res unused).
extern "C" int lowrank_matmul_launch(const void* x, const void* v, const void* u,
                                     void* t, void* y, const void* bias,
                                     const void* res, void* scratch, int rows,
                                     int n, int k, int m, int dtype, int body,
                                     int tile_rows_xv, int tile_rows_tu,
                                     int splits_xv, int depth_xv, int splits_tu,
                                     int depth_tu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (rows <= 0 || splits_xv < 1 || splits_tu < 1 ||
      ((splits_xv > 1 || splits_tu > 1) && sc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (body == 0 && dtype == 0) {
    if (k % BN != 0 || m % BN != 0 || n % BK != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 g1(k / BN, (rows + BM - 1) / BM), g2(m / BN, (rows + BM - 1) / BM);
    gemm_f32<<<g1, THREADS, 0, s>>>(static_cast<const float*>(x),
                                    static_cast<const float*>(v),
                                    static_cast<float*>(t), nullptr, nullptr,
                                    rows, k, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || m == 0) return static_cast<int>(err);
    gemm_f32<<<g2, THREADS, 0, s>>>(static_cast<const float*>(t),
                                    static_cast<const float*>(u),
                                    static_cast<float*>(y),
                                    static_cast<const float*>(bias),
                                    static_cast<const float*>(res), rows, m, k);
    return static_cast<int>(cudaGetLastError());
  }
  if (body == 1) {
    const int vec = dtype == 0 ? 4 : 8;
    if (rows > tile_rows_xv || tile_rows_tu != tile_rows_xv || n % vec != 0 ||
        k % vec != 0 || m % vec != 0 || depth_xv % 8 != 0 || depth_tu % 8 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (dtype == 0) {
      return small_t_rows<float>(
          static_cast<const float*>(x), static_cast<const float*>(v),
          static_cast<const float*>(u), static_cast<float*>(t),
          static_cast<float*>(y), static_cast<const float*>(bias),
          static_cast<const float*>(res), sc, rows, n, k, m, tile_rows_xv,
          splits_xv, depth_xv, splits_tu, depth_tu, s);
    }
    if (dtype == 1) {
      return small_t_rows<bf16>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(v),
          static_cast<const bf16*>(u), static_cast<bf16*>(t),
          static_cast<bf16*>(y), static_cast<const bf16*>(bias),
          static_cast<const bf16*>(res), sc, rows, n, k, m, tile_rows_xv,
          splits_xv, depth_xv, splits_tu, depth_tu, s);
    }
  }
  if (body == 2 && dtype == 1) {
    const int slice = wg::SLICE * wg::BK;
    if (n % 8 != 0 || k % 8 != 0 || m % 8 != 0 || tile_rows_xv != wg::BM ||
        tile_rows_tu != wg::BM || (splits_xv > 1 && depth_xv != slice) ||
        (splits_tu > 1 && depth_tu != slice)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int rc = gemm_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(v),
                             static_cast<bf16*>(t), nullptr, nullptr, sc, rows, k, n,
                             splits_xv, depth_xv, s);
    if (rc != 0 || m == 0) return rc;
    return gemm_bf16(static_cast<const bf16*>(t), static_cast<const bf16*>(u),
                     static_cast<bf16*>(y), static_cast<const bf16*>(bias),
                     static_cast<const bf16*>(res), sc, rows, m, k, splits_tu,
                     depth_tu, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
