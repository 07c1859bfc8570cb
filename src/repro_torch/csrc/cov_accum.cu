// Streaming covariance triple for AA-SVD calibration, written for Hopper (sm_90a).
//
//     xx = Xᵀ X      xxp = Xᵀ X'      xpxp = X'ᵀ X'        X, X': (T, n) token rows
//
// and, with a bank axis, the same triple for each of E banks at once:
// X, X' (E, C, n) -> xx, xxp, xpxp (E, n, n), one launch for all E.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cov_accum.py::cov_accum
// (its pallas_call at :73) and its vmap over an expert axis,
// src/repro/kernels/ops.py::_cov_triple_banked (:182), the capacity MoE
// dispatch's per-expert triples (one launch whose grid carries the bank
// axis, on the TPU as here).  What it keeps from that kernel: one pass over
// the token stream with fp32 sums, `acc=` folding into existing
// accumulators, and a fixed summation order.  What differs: the TPU kernel
// keeps three accumulators per (i, j) tile in VMEM and computes all of xx,
// xxp and xpxp (6·T·n² flops).  Here the triple is the Gram matrix of
// Z = [X | X'] (T, 2n):
//
//     Zᵀ Z = [[xx, xxp], [xxpᵀ, xpxp]]
//
// whose upper block triangle holds the upper halves of the symmetric xx and
// xpxp and all of xxp: 4·T·n² flops.  Z's columns are cut into strips of
// EDGE columns (⌈n/EDGE⌉ from X, then as many from X'); each block computes
// one tile (a ≤ b) of the triangle with ONE fp32 accumulator.  Z is never
// built: a strip's operand is read from X or X' directly.
//
// Bound on an H100: max(4·T·n² flops / 989 TFLOP/s (bf16),
// (2·T·n·eb + 3·n²·4·(1 + acc)) bytes / 3.35 TB/s).  At the main path's
// shapes (T 4096, n 4096 / 11008) it is bound by the tensor cores, by ~10x;
// one expert segment (T ~384, n 2048) reads and writes its three fp32
// accumulators for few flops and is bound by their bytes.  Two bodies:
//
//   bf16 — cov_wgmma: 128 x 128 tiles, the TMA ring and wgmma machinery of
//     lowrank_matmul's wgmma body (hopper.cuh).  One producer thread fills a
//     4-stage ring: a stage is 64 token rows of strip a and of strip b, each
//     two 64-column boxes with the 128-byte swizzle (a diagonal tile loads
//     its strip once and reads it as both operands).  Two consumer
//     warpgroups run wgmma.mma_async m64n128k16, both operands MN-major:
//     A = Z[:, strip a]ᵀ (warpgroup g takes strip a's columns 64g..64g+63,
//     one swizzle atom, through the transpose bit) and B = Z[:, strip b].
//     TMA zero-fills boxes past T and past n, so nothing is padded in memory
//     beyond the 16-byte row alignment TMA needs (n % 8 == 0).  The grid is
//     persistent (a block an SM walks the tiles), so the producer loads the
//     next tile while the consumers store the last; a tile is staged in
//     shared memory and stored (or added) with 16-byte accesses, every load
//     of a pass in flight at once.  Tiles are ordered in square super-tiles
//     of GROUP x GROUP strips, so the blocks in flight share their strips in
//     L2.
//   fp32 — cov_fma: 64 x 64 tiles on the FMA units (TF32 stays off, for fp32
//     parity; only the smoke recipe and the tests feed fp32), a 4 x 4
//     register tile per thread over 16-row token steps, rows and columns
//     masked.
//
// Banks: a work item is (bank, tile, slice), the bank slowest, so the blocks
// in flight share one bank's strips in L2.  The bf16 body reads X and X'
// through 3D tensor maps (n, C, E): TMA zero-fills a box's rows past C
// within its own bank and never reads the next bank's rows (laid flat as
// (E·C, n), a 64-row step past C would).  The fp32 body bounds its rows per
// bank.  Each bank's triple is written at bank·n² (outputs) from bank·C·n
// (inputs): both contiguous.  One expert bank of the capacity dispatch
// (C ~480, n 2048) reads its rows for few flops and writes 3·n² fp32 (read
// too at acc=): bound by the accumulators' bytes.
//
// Epilogue: the output is written exactly symmetric.  A tile of xx or xpxp
// off the diagonal is stored at (i, j) and, transposed, at (j, i); a diagonal
// tile stores its upper half and mirrors it; xxp tiles are stored once.  So
// xx == xxᵀ and xpxp == xpxpᵀ bit for bit (torch.linalg.eigh reads the lower
// triangle), as the TPU kernel gives them, whenever acc= is symmetric.
//
// No atomics.  When the triangle's tiles leave the card under-filled (n up
// to ~1024 in bf16), the plan (kernels/cov_accum.py::plan) splits T into
// slices; each (tile, slice) writes its fp32 partial sum to a scratch, and
// cov_reduce adds the slices in slice order and owns the epilogue.  Two
// calls on the same inputs give the same bits.
//
// Contract (checked by the Python wrappers, kernels/ops.py::cov_accum and
// ::cov_accum_banked; the launcher refuses what the plan never produces):
//   x, xp contiguous (banks, T, n) (banks 1: (T, n)), 16-byte aligned, bf16 (edge 128, n % 8 == 0) or
//   fp32 (edge 64, n % 4 == 0); outputs contiguous, 16-byte aligned
//   (banks, n, n) fp32; 1 <= banks <= 65535;
//   accumulate 0: out = sum, 1: out += sum;  splits > 1 needs the scratch,
//   banks · splits · edge² · tiles floats, and slices of rows_per_split rows, a
//   multiple of the body's step (64 / 16), that cover T with none empty.
// Returns the first non-zero cudaError of the call's launches.

#include "hopper.cuh"

namespace {

constexpr int GROUP = 8;  // strips a side of a super-tile

// Tile t of the upper block triangle over `strips` strips, in launch order:
// super-tile rows of GROUP strips a0.., each the triangle of its diagonal
// super-tile (row by row) and then the super-tiles to its right (GROUP
// columns wide but the last), each row by row.  kernels/cov_accum.py::
// Plan.tile_at is the same arithmetic.
struct Tile {
  int a, b;
};

__device__ __forceinline__ Tile tile_at(int t, int strips) {
  for (int a0 = 0; a0 < strips; a0 += GROUP) {
    const int na = min(GROUP, strips - a0);
    const int diag = na * (na + 1) / 2;
    const int row = diag + na * (strips - a0 - na);
    if (t >= row) {
      t -= row;
      continue;
    }
    if (t < diag) {
      int i = 0;
      while (t >= na - i) {
        t -= na - i;
        ++i;
      }
      return {a0 + i, a0 + i + t};
    }
    t -= diag;
    const int right = t / (na * GROUP);  // full super-tiles before this one
    t -= right * na * GROUP;
    const int b0 = a0 + na + right * GROUP;
    const int nb = min(GROUP, strips - b0);
    return {a0 + t / nb, b0 + t % nb};
  }
  return {0, 0};  // past the triangle: the launcher sizes the grid to it
}

__device__ __forceinline__ void store(float* out, size_t o, float v, int accumulate) {
  out[o] = accumulate ? out[o] + v : v;
}

// Entry (r, c) of tile (a, b) of Zᵀ Z into its output: xx (both strips of
// X), xxp (a of X, b of X'), xpxp (both of X'); xx / xpxp mirrored.
__device__ __forceinline__ void put(float* xx, float* xxp, float* xpxp, int n,
                                    int half, int edge, Tile tl, int r, int c,
                                    float v, int accumulate) {
  const bool ap = tl.a >= half;
  const bool bp = tl.b >= half;
  const int i = (tl.a - (ap ? half : 0)) * edge + r;
  const int j = (tl.b - (bp ? half : 0)) * edge + c;
  if (i >= n || j >= n) return;
  if (ap != bp) {
    store(xxp, static_cast<size_t>(i) * n + j, v, accumulate);
    return;
  }
  if (tl.a == tl.b && r > c) return;  // the diagonal tile's lower half: its mirror
  float* out = ap ? xpxp : xx;
  store(out, static_cast<size_t>(i) * n + j, v, accumulate);
  if (i != j) store(out, static_cast<size_t>(j) * n + i, v, accumulate);
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring

namespace cw {
constexpr int EDGE = 128;               // tile edge: a strip's columns
constexpr int BK = 64;                  // token rows a stage
constexpr int STAGES = 4;
constexpr int ATOM = BK * 64 * 2;       // 8 KB: 64 rows x 64 columns, 128-byte swizzle
constexpr int STAGE_BYTES = 4 * ATOM;   // strip a's two atoms, then strip b's
constexpr int LD = EDGE + 1;            // the staged tile's row pitch (floats)
constexpr int TILE_BYTES = EDGE * LD * 4;
constexpr int THREADS = 3 * 128;        // two consumer warpgroups + a producer one
constexpr int CONSUMERS = 256;
// the 128-byte swizzle repeats every 1024 bytes: stages start 1024-aligned
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + TILE_BYTES + 2 * STAGES * 8;
}  // namespace cw

__device__ __forceinline__ void consumer_sync() {  // the two consumer warpgroups
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// The epilogue of a tile staged in shared memory (s[r·LD + c], fp32):
// written or added into its output with 16-byte accesses, every load of a
// pass in flight before its stores.  dst rows are the tile's rows i0.. (or,
// transposed, its columns j0..); a diagonal tile of xx / xpxp is made
// symmetric from its upper half, an off-diagonal one also stored transposed.
template <bool Transposed>
__device__ __forceinline__ void store_pass(const float* s, float* out, int n,
                                           int row0, int col0, int rows, int cols,
                                           bool sym, int accumulate, int tid) {
  constexpr int Q = cw::EDGE * cw::EDGE / 4 / cw::CONSUMERS;  // float4s a thread
  float4 a[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int q = tid + k * cw::CONSUMERS;
    const int r = q / (cw::EDGE / 4);
    const int c = (q % (cw::EDGE / 4)) * 4;
    a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (accumulate && r < rows && c < cols) {
      a[k] = *reinterpret_cast<const float4*>(out + static_cast<size_t>(row0 + r) * n +
                                              col0 + c);
    }
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int q = tid + k * cw::CONSUMERS;
    const int r = q / (cw::EDGE / 4);
    const int c = (q % (cw::EDGE / 4)) * 4;
    if (r >= rows || c >= cols) continue;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int sr = r, sc = c + e;  // the staged entry that lands at (r, c + e)
      if (Transposed || (sym && sr > sc)) {
        sr = c + e;
        sc = r;
      }
      v[e] = s[sr * cw::LD + sc];
    }
    float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(row0 + r) * n + col0 + c);
    *o = make_float4(a[k].x + v[0], a[k].y + v[1], a[k].z + v[2], a[k].w + v[3]);
  }
}

// A persistent grid of at most one block an SM walks the work items w =
// (bank·splits + z)·tiles + t, tile t of the triangle over token slice z
// (rows [z·rows_per_split, +rows_per_split) ∩ [0, T)) of bank `bank`,
// w += gridDim.x.  The producer's ring runs on into the next item while the
// consumers finish the last one's epilogue.  With part != null an item
// stores its fp32 partial sum to part[w][128][128] for cov_reduce;
// otherwise the epilogue writes (or adds) it into the bank's triple.
__global__ void __launch_bounds__(cw::THREADS, 1)
cov_wgmma(const __grid_constant__ CUtensorMap tma_x,
          const __grid_constant__ CUtensorMap tma_xp, float* __restrict__ xx,
          float* __restrict__ xxp, float* __restrict__ xpxp,
          float* __restrict__ part, int T, int n, int rows_per_split, int tiles,
          int splits, int items, int accumulate) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* staged = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                           cw::STAGES * cw::STAGE_BYTES);
  const uint32_t bars = base + cw::STAGES * cw::STAGE_BYTES + cw::TILE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (cw::STAGES + s); };

  const int half = (n + cw::EDGE - 1) / cw::EDGE;
  const int tid = threadIdx.x;
  const int group = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < cw::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (group == 2) {  // producer warpgroup: one thread issues every load
    if (tid == 2 * 128) {
      int it = 0;  // stages filled so far, over every item
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const Tile tl = tile_at(w % tiles, 2 * half);
        const int bank = w / tiles / splits;
        const int t0 = (w / tiles % splits) * rows_per_split;
        const int nk = (min(T, t0 + rows_per_split) - t0 + cw::BK - 1) / cw::BK;
        const CUtensorMap* ma = tl.a < half ? &tma_x : &tma_xp;
        const CUtensorMap* mb = tl.b < half ? &tma_x : &tma_xp;
        const int ca = (tl.a % half) * cw::EDGE;
        const int cb = (tl.b % half) * cw::EDGE;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % cw::STAGES;
          if (it >= cw::STAGES) mbar_wait(empty(s), ((it / cw::STAGES) - 1) & 1);
          const uint32_t sa = base + s * cw::STAGE_BYTES;
          const int row = t0 + kt * cw::BK;
          // a diagonal tile loads its strip once and reads it as both operands
          mbar_expect_tx(full(s), (tl.a == tl.b ? 2 : 4) * cw::ATOM);
          tma_load_3d(sa, ma, full(s), ca, row, bank);
          tma_load_3d(sa + cw::ATOM, ma, full(s), ca + 64, row, bank);
          if (tl.a != tl.b) {
            tma_load_3d(sa + 2 * cw::ATOM, mb, full(s), cb, row, bank);
            tma_load_3d(sa + 3 * cw::ATOM, mb, full(s), cb + 64, row, bank);
          }
        }
      }
    }
    return;
  }

  int it = 0;  // stages consumed so far, over every item
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int t = w % tiles;
    const Tile tl = tile_at(t, 2 * half);
    const int t0 = (w / tiles % splits) * rows_per_split;
    const int nk = (min(T, t0 + rows_per_split) - t0 + cw::BK - 1) / cw::BK;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % cw::STAGES;
      mbar_wait(full(s), (it / cw::STAGES) & 1);
      const uint32_t stage = base + s * cw::STAGE_BYTES;
      const uint32_t sa = stage + group * cw::ATOM;
      const uint32_t sb = tl.a == tl.b ? stage : stage + 2 * cw::ATOM;
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int j = 0; j < cw::BK / 16; ++j) {
        // both MN-major: 16 token rows = 2048 bytes further; B's second
        // 64-column atom lies ATOM bytes on (LBO), 8-row groups 1024 (SBO);
        // A is one atom (warpgroup g: strip a's columns 64g..), so its LBO
        // is never used
        wgmma_m64n128k16<1>(d, smem_desc(sa + j * 16 * 128, cw::ATOM, 1024),
                            smem_desc(sb + j * 16 * 128, cw::ATOM, 1024), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_acc(d);
      // the previous step's wgmmas are done: hand its stage back
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(d);
      if (kt > 0 && tid % 128 == 0) mbar_arrive(empty((it - 1) % cw::STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    if (nk > 0 && tid % 128 == 0) mbar_arrive(empty((it - 1) % cw::STAGES));

    // stage the tile: d[4j + 2h + e] is row r0 + 8h, column 8j + 2·(lane % 4) + e
    consumer_sync();  // the last item's epilogue is done reading `staged`
    {
      const int lane = tid % 128;
      const int r0 = group * 64 + (lane / 32) * 16 + (lane % 32) / 4;
      const int c0 = (lane % 4) * 2;
#pragma unroll
      for (int j = 0; j < cw::EDGE / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          staged[(r0 + 8 * h) * cw::LD + c0 + 8 * j] = d[4 * j + 2 * h];
          staged[(r0 + 8 * h) * cw::LD + c0 + 8 * j + 1] = d[4 * j + 2 * h + 1];
        }
      }
    }
    consumer_sync();
    if (part != nullptr) {
      float* p = part + static_cast<size_t>(w) * cw::EDGE * cw::EDGE;
      store_pass<false>(staged, p, cw::EDGE, 0, 0, cw::EDGE, cw::EDGE, false, 0, tid);
      continue;
    }
    const bool ap = tl.a >= half;
    const bool bp = tl.b >= half;
    const int i0 = (tl.a - (ap ? half : 0)) * cw::EDGE;
    const int j0 = (tl.b - (bp ? half : 0)) * cw::EDGE;
    const int ni = min(cw::EDGE, n - i0);
    const int nj = min(cw::EDGE, n - j0);
    const size_t at = static_cast<size_t>(w / tiles / splits) * n * n;  // the bank's triple
    if (ap != bp) {
      store_pass<false>(staged, xxp + at, n, i0, j0, ni, nj, false, accumulate, tid);
      continue;
    }
    float* out = (ap ? xpxp : xx) + at;
    store_pass<false>(staged, out, n, i0, j0, ni, nj, tl.a == tl.b, accumulate, tid);
    if (tl.a != tl.b) store_pass<true>(staged, out, n, j0, i0, nj, ni, false, accumulate, tid);
  }
}

// ---------------------------------------------------------------------------
// fp32 on the FMA units

namespace cf {
constexpr int EDGE = 64;      // tile edge
constexpr int BT = 16;        // token rows a step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
}  // namespace cf

// Block (t, z, bank): tile t over token slice z of bank `bank` (cov_wgmma's
// work item (bank·splits + z)·tiles + t), 64 x 64 tiles; token rows past
// the bank's T and columns past n load as zeros.  Split, it stores its
// partial sum to part[bank][z][t][64][64].
__global__ void __launch_bounds__(cf::THREADS)
cov_fma(const float* __restrict__ x, const float* __restrict__ xp,
        float* __restrict__ xx, float* __restrict__ xxp,
        float* __restrict__ xpxp, float* __restrict__ part, int T, int n,
        int rows_per_split, int accumulate) {
  __shared__ __align__(16) float sa[cf::BT][cf::EDGE];
  __shared__ __align__(16) float sb[cf::BT][cf::EDGE];

  const int half = (n + cf::EDGE - 1) / cf::EDGE;
  const Tile tl = tile_at(blockIdx.x, 2 * half);
  const size_t in_at = static_cast<size_t>(blockIdx.z) * T * n;  // the bank's rows
  const size_t out_at = static_cast<size_t>(blockIdx.z) * n * n;
  const float* src_a = (tl.a < half ? x : xp) + in_at;
  const float* src_b = (tl.b < half ? x : xp) + in_at;
  const int ca = (tl.a % half) * cf::EDGE;
  const int cb = (tl.b % half) * cf::EDGE;
  const int t_begin = blockIdx.y * rows_per_split;
  const int t_end = min(T, t_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int t0 = t_begin; t0 < t_end; t0 += cf::BT) {
#pragma unroll
    for (int q = 0; q < (cf::BT * cf::EDGE) / cf::THREADS; ++q) {
      const int idx = tid + q * cf::THREADS;
      const int r = idx / cf::EDGE;
      const int c = idx % cf::EDGE;
      const bool row_ok = t0 + r < t_end;
      const size_t row = static_cast<size_t>(t0 + r) * n;
      sa[r][c] = row_ok && ca + c < n ? src_a[row + ca + c] : 0.f;
      sb[r][c] = row_ok && cb + c < n ? src_b[row + cb + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < cf::BT; ++r) {
      const float4 a4 = *reinterpret_cast<const float4*>(&sa[r][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&sb[r][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* p = part == nullptr
                 ? nullptr
                 : part + ((static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                               gridDim.x + blockIdx.x) * cf::EDGE * cf::EDGE;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty * 4 + i;
      const int c = tx * 4 + j;
      if (p != nullptr) {
        p[r * cf::EDGE + c] = acc[i][j];
      } else {
        put(xx + out_at, xxp + out_at, xpxp + out_at, n, half, cf::EDGE, tl, r, c,
            acc[i][j], accumulate);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// split T: the slices' partial sums added in slice order, then the epilogue
// (block (·, t, bank): tile t of bank `bank`)

template <int EDGE>
__global__ void __launch_bounds__(256)
cov_reduce(const float* __restrict__ part, int splits, int tiles,
           float* __restrict__ xx, float* __restrict__ xxp,
           float* __restrict__ xpxp, int n, int accumulate) {
  const int half = (n + EDGE - 1) / EDGE;
  const Tile tl = tile_at(blockIdx.y, 2 * half);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // grid covers EDGE² exactly
  const size_t plane = static_cast<size_t>(tiles) * EDGE * EDGE;
  const float* p = part + static_cast<size_t>(blockIdx.z) * splits * plane +
                   static_cast<size_t>(blockIdx.y) * EDGE * EDGE + e;
  float s = p[0];
  for (int z = 1; z < splits; ++z) s += p[z * plane];
  const size_t at = static_cast<size_t>(blockIdx.z) * n * n;
  put(xx + at, xxp + at, xpxp + at, n, half, EDGE, tl, e / EDGE, e % EDGE, s, accumulate);
}

// ---------------------------------------------------------------------------
// host side

int set_smem() {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        cov_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, cw::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  return 0;
}

}  // namespace

// One call of the covariance triple of each of `banks` banks under a launch
// plan (kernels/cov_accum.py::plan).  dtype: 0 = fp32 (edge 64), 1 = bf16
// (edge 128).  The work is (banks, tiles, splits) over the upper block
// triangle of each bank's Zᵀ Z, 2·⌈n/edge⌉ strips; with splits > 1, each
// bank's T rows are cut into slices of rows_per_split rows whose partials
// go to `scratch` and cov_reduce adds them in order.  A bank's rows lie at
// bank·rows·n, its triple at bank·n·n.  accumulate: 0 = write, 1 = add into
// the outputs.
extern "C" int cov_accum_launch(const void* x, const void* xp, void* xx,
                                void* xxp, void* xpxp, void* scratch,
                                int banks, int rows, int n, int dtype, int edge,
                                int splits, int rows_per_split, int accumulate,
                                void* stream) {
  const int step = dtype == 1 ? cw::BK : cf::BT;
  const int want_edge = dtype == 1 ? cw::EDGE : cf::EDGE;
  const int align = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || edge != want_edge || banks < 1 ||
      banks > 65535 || rows < 1 || n < 1 ||
      n % align != 0 || splits < 1 || splits > 65535 || rows_per_split < 1 ||
      (accumulate != 0 && accumulate != 1) ||
      static_cast<long long>(splits) * rows_per_split < rows ||
      static_cast<long long>(splits - 1) * rows_per_split >= rows ||
      (splits > 1 && (rows_per_split % step != 0 || scratch == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long strips = 2ll * ((n + edge - 1) / edge);
  const long long tiles = strips * (strips + 1) / 2;
  const long long items = tiles * splits * banks;
  if (items > 0x7fffffffll || (splits > 1 && tiles > 65535)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o0 = static_cast<float*>(xx);
  float* o1 = static_cast<float*>(xxp);
  float* o2 = static_cast<float*>(xpxp);
  float* part = splits > 1 ? static_cast<float*>(scratch) : nullptr;
  if (dtype == 1) {
    int rc = set_smem();
    if (rc != 0) return rc;
    int device = 0, sms = 0;
    rc = static_cast<int>(cudaGetDevice(&device));
    if (rc != 0) return rc;
    rc = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
    if (rc != 0) return rc;
    // (n, rows, banks): a box never reads past its own bank's last row
    CUtensorMap tx, txp;
    rc = tensor_map_3d(&tx, x, banks, rows, n, cw::BK);
    if (rc != 0) return rc;
    rc = tensor_map_3d(&txp, xp, banks, rows, n, cw::BK);
    if (rc != 0) return rc;
    // persistent: one block an SM walks the (bank, slice, tile) items
    const int blocks = static_cast<int>(items < sms ? items : sms);
    cov_wgmma<<<blocks, cw::THREADS, cw::SMEM, s>>>(
        tx, txp, o0, o1, o2, part, rows, n, rows_per_split, static_cast<int>(tiles),
        splits, static_cast<int>(items), accumulate);
  } else {
    const dim3 grid(static_cast<unsigned>(tiles), splits, banks);
    cov_fma<<<grid, cf::THREADS, 0, s>>>(static_cast<const float*>(x),
                                         static_cast<const float*>(xp), o0, o1, o2,
                                         part, rows, n, rows_per_split, accumulate);
  }
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || splits == 1) return rc;
  const dim3 rgrid(edge * edge / 256, static_cast<unsigned>(tiles), banks);
  if (dtype == 1) {
    cov_reduce<cw::EDGE><<<rgrid, 256, 0, s>>>(part, splits, static_cast<int>(tiles),
                                               o0, o1, o2, n, accumulate);
  } else {
    cov_reduce<cf::EDGE><<<rgrid, 256, 0, s>>>(part, splits, static_cast<int>(tiles),
                                               o0, o1, o2, n, accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}
