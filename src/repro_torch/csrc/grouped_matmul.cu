// Grouped (ragged) expert GEMM y[i] = x[i] @ W[g(i)], written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_matmul.py::grouped_matmul
// (its pallas_call at :135), the expert GEMM of the drop-free MoE dispatch: the
// T·k routed rows are sorted by expert, so expert g owns the contiguous row
// segment [offs[g], offs[g+1]) of x, and y's rows are x's rows times their own
// expert's (d, f) weights, summed in fp32.
//
// The TPU kernel walks a static list of M/bm + E - 1 (row block x expert)
// tiles, visiting a row block once per expert it touches and masking the
// other experts' rows to zero, while the output block stays resident in VMEM
// down a sequential grid axis.  Hopper has no such axis, so this kernel cuts
// the work the other way round: a work item is (g, i, j), rows
// [offs[g] + i·BM, min(offs[g] + (i+1)·BM, offs[g+1])) of expert g and column
// tile j, and each output row is written once, by its own expert.
//
// Bound on an H100: max(2·M·d·f flops / 989 TFLOP/s,
// (M·d + E_live·d·f + M·f)·2 bytes / 3.35 TB/s), E_live the experts with rows.
// At the main path's shapes (M = 24,576 routed rows over 64 experts, d, f in
// {2048, 1408, 504}) the dense bank is bound by the tensor cores, the rank-504
// factors by their bytes; decode's 48 rows read the live experts' weights and
// little else.  What the design does about each:
//
//   grouped_wgmma (bf16): a persistent grid of at most one block an SM.  A
//     block's first warp reads the E group sizes (on the device: nothing of
//     the routing reaches the host), scans them into the segment offsets,
//     clamps those to M, and scans the experts' row tiles into each one's
//     first tile; a work item index w then maps to (g, i, j) by a binary search
//     (item_at; kernels/grouped_matmul.py::Plan.tile_at is the same
//     arithmetic).  Items run expert by expert, each expert's row tiles in
//     order, its column tiles innermost: the blocks in flight share one or
//     two experts' weights and each row tile of x in L2, so the bank is read
//     from device memory about once.  One producer thread fills a 4-stage
//     ring of 64-deep stages by TMA (a "full" and an "empty" mbarrier a
//     stage) and runs on into the next item while the consumers store the
//     last.  A, the x rows, is K-major, a 2D map on (M, K) whose 128-row box
//     starts at the segment's own first row: no row is masked in the K-loop.
//     The box's rows past the segment's end (the next expert's rows, or
//     TMA's zero fill past M) are computed and not stored, but a warpgroup
//     whose 64 rows lie wholly past it computes nothing: the waste is
//     Σ_g ⌈s_g/64⌉·64 - M rows of MMA work (s_g the clamped group sizes), at
//     most 63·E.  W is read in place through a 3D map on (E, d, f): its
//     out-of-bounds fill zeroes a K chunk past d inside each expert (a 2D
//     view of (E·d, f) would read the next expert's rows there; d 504 is not
//     a multiple of 64).  Forward, B = W[g] has f contiguous: MN-major, two
//     64-column boxes a stage, the transpose bit set.  For dx = dy @ W[g]ᵀ
//     (TransW) B = W[g]ᵀ is K-major from the same bank, one 128-row box of
//     W[g]'s rows a stage, the transpose bit clear: no transposed copy of the
//     bank.  Two consumer warpgroups each run wgmma.mma_async m64n128k16 on a
//     64-row half of the 128 x 128 tile, fp32 accumulators in registers.
//     A stage's 64-column boxes wholly past N are not loaded (their columns
//     are never stored).  BN 128 at every f: a 256-column tile needs 128
//     accumulators a consumer thread, more than the 168 registers a thread
//     has at one block of three warpgroups an SM; at f 504 the four column
//     tiles of a row tile run side by side, so x's re-reads come from L2.
//   grouped_f32 (fp32): the FMA units (TF32 stays off, for fp32 parity; only
//     the smoke recipe and the tests feed fp32): grid (f / 64, M / 64), a
//     block scans the group sizes into the offsets as above and visits every
//     segment that overlaps its rows with the others' rows masked to zero, a
//     4x4 register tile a thread.  It takes W as it lies: dx runs it on Wᵀ
//     made contiguous.
//
// Exact, deterministic, batch-invariant: each output element is summed over
// the contraction in one fixed order (64-deep chunks in order, four k16
// steps each), with no split and no atomics, and rounded once to bf16.  So a
// row's bits depend only on the row and its expert's weights, not on M, the
// segment's offset or the rows that share its tile: the drop-free layer
// stays batch-size invariant on the card.  Empty experts get no item; rows
// past sum(group sizes) belong to no segment and are written zero (as
// jax.lax.ragged_dot gives them); segment ends are clamped to M.
//
// Epilogue: each warpgroup rounds its 64 x 128 fp32 tile once to bf16,
// stages it in shared memory and stores it with 16-byte accesses, rows masked
// to [first row, segment end) (a TMA store cannot mask rows inside a box).
//
// Contract (checked by the Python wrapper, kernels/ops.py::grouped_matmul;
// the launcher refuses what kernels/grouped_matmul.py::plan never produces):
// x (M, K), w (E, d, f), y (M, N) contiguous, 16-byte aligned, one dtype;
// K, N = d, f (trans_w 0: y = x @ W[g]) or f, d (trans_w 1: y = x @ W[g]ᵀ,
// bf16 only); d and f multiples of 8 (the wrapper zero-pads, which is exact);
// sizes (E,) int32 on the device, none negative, E <= 1024.  Returns the
// first non-zero cudaError of the call.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 on the FMA units

constexpr int MAX_EXPERTS = 1024;  // the segment offsets' shared arrays

// Warp 0: the exclusive cumsum of the (e,) group sizes into offs[0, e), 32
// experts a step; returns the total (every lane).  Nothing of the routing
// reaches the host: each block scans the sizes itself.
__device__ __forceinline__ int segment_offsets(const int* __restrict__ sizes, int e,
                                               int* offs) {
  const int lane = threadIdx.x % 32;
  int carry = 0;
  for (int g0 = 0; g0 < e; g0 += 32) {
    const int g = g0 + lane;
    const int n = g < e ? sizes[g] : 0;
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (g < e) offs[g] = carry + incl - n;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  return carry;
}

namespace gf {

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

constexpr int THREADS = 256;
constexpr int BM = 64;   // block tile rows
constexpr int BN = 64;   // block tile columns
constexpr int BK = 16;   // K depth per shared-memory step
constexpr int APAD = 4;  // keeps the transposed A tile off one bank

__global__ void __launch_bounds__(THREADS)
grouped_f32(const float* __restrict__ x, const float* __restrict__ w,
            const int* __restrict__ sizes, float* __restrict__ y, int m, int d, int f,
            int e) {
  __shared__ __align__(16) float sa[BK][BM + APAD];  // x tile, transposed
  __shared__ __align__(16) float sb[BK][BN];
  __shared__ int offs[MAX_EXPERTS + 1];

  const int tid = threadIdx.x;
  if (tid < 32) {
    const int total = segment_offsets(sizes, e, offs);
    if (tid == 0) offs[e] = total;
  }
  __syncthreads();
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

}  // namespace gf

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring, a persistent grid of per-expert row tiles

namespace gw {
constexpr int BM = 128;                    // tile rows: two consumer warpgroups of 64
constexpr int BN = 128;                    // tile columns
constexpr int BK = 64;                     // depth a stage: one 128-byte swizzled row
constexpr int STAGES = 4;
constexpr int A_HALF = 64 * BK * 2;        // 8 KB: one warpgroup's 64 rows of x
constexpr int A_BYTES = 2 * A_HALF;
constexpr int B_ATOM = BK * 64 * 2;        // 8 KB: 64 depth rows x 64 columns (MN-major)
constexpr int B_BYTES = BN * BK * 2;       // two atoms, or 128 rows x 64 depth (K-major)
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int LD = BN + 8;                 // staged row pitch (bf16): rows 16 bytes apart mod 128
constexpr int STAGED_BYTES = BM * LD * 2;
constexpr int MAP_BYTES = 2 * (MAX_EXPERTS + 1) * 4;  // the tile map's arrays
constexpr int THREADS = 3 * 128;           // two consumer warpgroups + a producer one
constexpr int CONSUMERS = 256;
// the 128-byte swizzle repeats every 1024 bytes: stages start 1024-aligned
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + STAGED_BYTES + 2 * STAGES * 8 + MAP_BYTES;
}  // namespace gw

// One work item: expert g's rows [r0, r1) (r1 - r0 <= BM), columns [n0, +BN).
struct Item {
  int g, r0, r1, n0;
};

// Item w of the launch order over `cols` column tiles: lo[g] is expert g's
// first row (the offsets clamped to M, lo[e] the end of the last segment),
// start[g] its first row tile (start[e] all of them).  kernels/
// grouped_matmul.py::Plan.tile_at is the same arithmetic.
__device__ __forceinline__ Item item_at(int w, const int* lo, const int* start, int e,
                                        int cols) {
  const int rt = w / cols;
  const int j = w - rt * cols;
  int a = 0;  // the smallest g with start[g + 1] > rt
  int b = e - 1;
  while (a < b) {
    const int mid = (a + b) / 2;
    if (start[mid + 1] > rt) {
      b = mid;
    } else {
      a = mid + 1;
    }
  }
  const int r0 = lo[a] + (rt - start[a]) * gw::BM;
  return {a, r0, min(r0 + gw::BM, lo[a + 1]), j * gw::BN};
}

template <int Id>
__device__ __forceinline__ void warpgroup_sync() {  // one consumer warpgroup
  asm volatile("bar.sync %0, 128;" ::"n"(Id) : "memory");
}

// y (M, N) = x (M, K) @ W[g] (TransW 0: K = d, N = f) or W[g]ᵀ (TransW 1:
// K = f, N = d) for each row's expert g, bf16 in and out, fp32 sums.  A
// persistent grid: block b walks the items w = b, b + gridDim.x, ... of the
// (row tile, column tile) list, then zeroes its share of the rows past the
// last segment.
template <int TransW>
__global__ void __launch_bounds__(gw::THREADS, 1)
grouped_wgmma(const __grid_constant__ CUtensorMap tma_x,
              const __grid_constant__ CUtensorMap tma_w, const int* __restrict__ sizes,
              bf16* __restrict__ y, int m, int K, int N, int e) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  bf16* const staged = reinterpret_cast<bf16*>(base_ptr + gw::STAGES * gw::STAGE_BYTES);
  const uint32_t bars = base + gw::STAGES * gw::STAGE_BYTES + gw::STAGED_BYTES;
  int* const lo = reinterpret_cast<int*>(base_ptr + gw::STAGES * gw::STAGE_BYTES +
                                         gw::STAGED_BYTES + 2 * gw::STAGES * 8);
  int* const start = lo + MAX_EXPERTS + 1;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (gw::STAGES + s); };

  const int tid = threadIdx.x;
  const int group = tid / 128;
  if (tid < 32) {
    // the tile map: each expert's first row, the offsets clamped to M, and
    // the exclusive scan of its row tiles, 32 experts a step
    const int total = segment_offsets(sizes, e, lo);
    __syncwarp();
    int carry = 0;
    for (int g0 = 0; g0 < e; g0 += 32) {
      const int g = g0 + tid;
      int n = 0;
      if (g < e) {
        const int a = min(lo[g], m);
        const int b = min(g + 1 < e ? lo[g + 1] : total, m);
        n = b > a ? (b - a + gw::BM - 1) / gw::BM : 0;
      }
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      if (g < e) start[g] = carry + incl - n;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    __syncwarp();
    for (int g = tid; g < e; g += 32) lo[g] = min(lo[g], m);
    if (tid == 0) {
      lo[e] = min(total, m);
      start[e] = carry;
      for (int s = 0; s < gw::STAGES; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), 2);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();

  const int cols = (N + gw::BN - 1) / gw::BN;
  const int items = start[e] * cols;
  const int nk = (K + gw::BK - 1) / gw::BK;

  if (group == 2) {  // producer warpgroup: one thread issues every load
    if (tid == 2 * 128) {
      int it = 0;  // stages filled so far, over every item
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const Item t = item_at(w, lo, start, e, cols);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % gw::STAGES;
          if (it >= gw::STAGES) mbar_wait(empty(s), ((it / gw::STAGES) - 1) & 1);
          const uint32_t sa = base + s * gw::STAGE_BYTES;
          const uint32_t sb = sa + gw::A_BYTES;
          const int k0 = kt * gw::BK;
          if constexpr (TransW) {
            // W[g]ᵀ's columns n0.. are W[g]'s rows: 128 rows x 64 depth
            mbar_expect_tx(full(s), gw::STAGE_BYTES);
            tma_load(sa, &tma_x, full(s), k0, t.r0);
            tma_load_3d(sb, &tma_w, full(s), k0, t.n0, t.g);
          } else {
            // the atoms wholly past N are not loaded: their columns of the
            // product are never stored
            const int atoms = min(gw::BN / 64, (N - t.n0 + 63) / 64);
            mbar_expect_tx(full(s), gw::A_BYTES + atoms * gw::B_ATOM);
            tma_load(sa, &tma_x, full(s), k0, t.r0);
            for (int a = 0; a < atoms; ++a) {
              tma_load_3d(sb + a * gw::B_ATOM, &tma_w, full(s), t.n0 + 64 * a, k0, t.g);
            }
          }
        }
      }
    }
    return;
  }

  const int lane = tid % 128;
  bf16* const mine = staged + group * 64 * gw::LD;  // this warpgroup's 64 staged rows
  int it = 0;  // stages consumed so far, over every item
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item t = item_at(w, lo, start, e, cols);
    const int row0 = t.r0 + group * 64;  // this warpgroup's first row
    if (row0 >= t.r1) {
      // a tail tile of at most 64 rows: the other warpgroup's half holds
      // them all; this one keeps the ring's count and computes nothing
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % gw::STAGES;
        mbar_wait(full(s), (it / gw::STAGES) & 1);
        if (lane == 0) mbar_arrive(empty(s));
      }
      continue;
    }
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % gw::STAGES;
      mbar_wait(full(s), (it / gw::STAGES) & 1);
      const uint32_t sa = base + s * gw::STAGE_BYTES + group * gw::A_HALF;
      const uint32_t sb = base + s * gw::STAGE_BYTES + gw::A_BYTES;
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int j = 0; j < gw::BK / 16; ++j) {
        // A: K-major, 16 depth values = 32 bytes further along each swizzled
        // row.  B MN-major (forward): 16 depth rows = 2048 bytes further, the
        // second 64-column atom B_ATOM bytes on (LBO), 8-row groups 1024
        // (SBO); B K-major (TransW): as A, its 128 rows in 8-row groups 1024
        // bytes apart
        if constexpr (TransW) {
          wgmma_m64n128k16<0, 0>(d, smem_desc(sa + j * 32, 16, 1024),
                                 smem_desc(sb + j * 32, 16, 1024), 1);
        } else {
          wgmma_m64n128k16<0, 1>(d, smem_desc(sa + j * 32, 16, 1024),
                                 smem_desc(sb + j * 16 * 128, gw::B_ATOM, 1024), 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_acc(d);
      // the previous step's wgmmas are done: hand its stage back
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(d);
      if (kt > 0 && lane == 0) mbar_arrive(empty((it - 1) % gw::STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    if (lane == 0) mbar_arrive(empty((it - 1) % gw::STAGES));

    // round once and stage: d[4j + 2h + e] is row r + 8h, column c + 8j + e
    if (group == 0) {
      warpgroup_sync<1>();  // the last item's stores are done reading `mine`
    } else {
      warpgroup_sync<2>();
    }
    {
      const int r = (lane / 32) * 16 + (lane % 32) / 4;
      const int c = (lane % 4) * 2;
#pragma unroll
      for (int j = 0; j < gw::BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<__nv_bfloat162*>(&mine[(r + 8 * h) * gw::LD + c + 8 * j]) =
              __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        }
      }
    }
    if (group == 0) {
      warpgroup_sync<1>();
    } else {
      warpgroup_sync<2>();
    }
    // 64 rows x 16 vectors of 8 columns, 8 a thread; rows past the segment's
    // end and columns past N (a multiple of 8) are not stored
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int v = lane + q * 128;
      const int r = v / (gw::BN / 8);
      const int c = (v % (gw::BN / 8)) * 8;
      if (row0 + r < t.r1 && t.n0 + c < N) {
        *reinterpret_cast<uint4*>(y + static_cast<size_t>(row0 + r) * N + t.n0 + c) =
            *reinterpret_cast<const uint4*>(&mine[r * gw::LD + c]);
      }
    }
  }

  // rows past the last segment belong to no expert: zeros
  const size_t tail = static_cast<size_t>(m - lo[e]) * (N / 8);
  uint4* const out = reinterpret_cast<uint4*>(y + static_cast<size_t>(lo[e]) * N);
  for (size_t v = static_cast<size_t>(blockIdx.x) * gw::CONSUMERS + tid; v < tail;
       v += static_cast<size_t>(gridDim.x) * gw::CONSUMERS) {
    out[v] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// host side

template <int TransW>
int launch_wgmma(const bf16* x, const bf16* w, const int* sizes, bf16* y, int m, int d,
                 int f, int e, int ctas, cudaStream_t s) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_wgmma<TransW>, cudaFuncAttributeMaxDynamicSharedMemorySize, gw::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int K = TransW ? f : d;
  const int N = TransW ? d : f;
  CUtensorMap tx, tw;
  int rc = tensor_map(&tx, x, m, K, gw::BM);
  if (rc != 0) return rc;
  // forward: 64 depth rows (of d) x 64 columns (of f); TransW: 128 rows of
  // W[g] (columns of y) x 64 depth (of f)
  rc = tensor_map_3d(&tw, w, e, d, f, TransW ? gw::BN : gw::BK);
  if (rc != 0) return rc;
  grouped_wgmma<TransW><<<ctas, gw::THREADS, gw::SMEM, s>>>(tx, tw, sizes, y, m, K, N, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One call under a launch plan (kernels/grouped_matmul.py::plan), with the
// (e,) int32 group sizes on the device.  dtype: 0 = fp32, 1 = bf16 (x, w
// and y share it).  body: 0 = grouped_f32 (row tile bm 64, column tile bn
// 64, stages 0, ctas 0: one block a tile), 1 = grouped_wgmma (bm 128, bn
// 128, 4 stages, ctas persistent blocks, at most the items ((M + 127) / 128
// + E) · ⌈N / 128⌉ could be).  trans_w 1: y = x @ W[g]ᵀ (bf16 only).
extern "C" int grouped_matmul_launch(const void* x, const void* w, const void* sizes, void* y,
                                     int m, int d, int f, int e, int dtype, int trans_w,
                                     int body, int bm, int bn, int stages, int ctas,
                                     void* stream) {
  if (m <= 0 || d <= 0 || f <= 0 || e <= 0 || e > MAX_EXPERTS || d % 8 != 0 ||
      f % 8 != 0 || (trans_w != 0 && trans_w != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && body == 0) {
    const dim3 grid((f + gf::BN - 1) / gf::BN, (m + gf::BM - 1) / gf::BM);
    if (trans_w != 0 || bm != gf::BM || bn != gf::BN || stages != 0 || ctas != 0 ||
        grid.y > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    gf::grouped_f32<<<grid, gf::THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const int*>(sizes), static_cast<float*>(y), m, d, f, e);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1 && body == 1) {
    const long long n = trans_w ? d : f;
    const long long most = ((m + gw::BM - 1) / gw::BM + static_cast<long long>(e)) *
                           ((n + gw::BN - 1) / gw::BN);
    if (bm != gw::BM || bn != gw::BN || stages != gw::STAGES || ctas < 1 || ctas > most ||
        most > 0x7fffffffll) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    const int* sb = static_cast<const int*>(sizes);
    bf16* yb = static_cast<bf16*>(y);
    return trans_w ? launch_wgmma<1>(xb, wb, sb, yb, m, d, f, e, ctas, s)
                   : launch_wgmma<0>(xb, wb, sb, yb, m, d, f, e, ctas, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
