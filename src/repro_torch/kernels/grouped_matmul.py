"""Launch plan and launcher of the grouped expert GEMM (``csrc/grouped_matmul.cu``).

Replaces the Pallas TPU kernel
``src/repro/kernels/grouped_matmul.py::grouped_matmul`` (its ``pallas_call``
at :135): y[i] = x[i] @ W[g(i)] over rows sorted by expert, with fp32
accumulation.  The TPU kernel visits a row block once per expert it touches
down a sequential grid axis; here every output row is written once, by its
own expert.

Bound on the card: max(2·M·d·f flops / peak, (M·d + E_live·d·f + M·f)·eb
bytes / bandwidth), E_live the experts with rows.  ``plan`` picks the body
and everything it needs:

* ``wgmma`` (bf16): a persistent grid of at most one block an SM over work
  items (g, i, j): expert g's i-th tile of ``bm`` rows, starting at the
  segment's own first row, and column tile j.  The items run expert by
  expert, row tiles in order, column tiles innermost (``tiles``; each block
  scans the group sizes and maps an item index to its item on the device by
  ``Plan.tile_at``'s arithmetic, so nothing of the routing reaches the
  host).  A TMA ring feeds
  wgmma; W is read in place through a 3D tensor map, and dx = dy @ W[g]ᵀ
  (``trans``) reads the same bank as a K-major operand: no transposed copy.
* ``fma32`` (fp32): the FMA units (TF32 stays off), one block per (64-row
  block, 64-column tile), each visiting every segment that overlaps its rows
  with the other rows masked to zero.  It takes W as it lies, so the wrapper
  hands it Wᵀ made contiguous for dx.

Rows past sum(group sizes) belong to no segment and come out zero; segment
ends are clamped to M.  Both bodies sum each output over the contraction in
one fixed order and round once, so a row's bits do not depend on M or on
its segment's offset.  Callers go through ``kernels.ops.grouped_matmul``,
which pads, checks and owns the autograd rule;
``emulate`` repeats a plan's work tile by tile in plain PyTorch for the CPU
tests.

Backward (the TPU kernel has none): dx is this kernel with ``trans``;
dW[e] = x_eᵀ dy_e is one plain ``torch.matmul`` per expert segment, which
reads the group sizes on the host — in backward only.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("fma32", "wgmma")     # index = the launcher's body code
SMS = 132                       # H100 SXM streaming multiprocessors

# d and f must be multiples of this (16-byte rows of bf16, and the TMA
# maps' strides); the wrapper zero-pads to it.  Rows need no padding.
MULTIPLE = 8
# wgmma: 128 x 128 tiles, a 4-stage ring; the two consumer warpgroups take
# 64 rows each, and one whose rows lie wholly past its segment computes
# nothing
WG_BM, WG_BN, WG_STAGES, WG_ROWS = 128, 128, 4, 64
# fma32: 64 x 64 tiles, one block each
F32_TILE = 64
BODY = {torch.bfloat16: "wgmma", torch.float32: "fma32"}
# both bodies scan the group sizes into shared memory (the wgmma body also
# each expert's first tile); the fp32 body's grid has at most 65535 row
# blocks
MAX_EXPERTS = 1024
MAX_ROW_BLOCKS = 65535


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs: y (rows, n) = x (rows, k) @ W[g] for W (experts,
    d, f) as it lies (k = d, n = f) or, with ``trans``, its transpose (k =
    f, n = d).  ``d`` and ``f`` are the padded widths the kernel sees.
    ``ctas`` is the wgmma body's persistent blocks (0: the fp32 body
    launches one block a tile)."""
    rows: int
    d: int
    f: int
    experts: int
    dtype: torch.dtype
    trans: bool
    body: str
    bm: int
    bn: int
    stages: int
    ctas: int

    @property
    def k(self) -> int:
        return self.f if self.trans else self.d

    @property
    def n(self) -> int:
        return self.d if self.trans else self.f

    @property
    def col_tiles(self) -> int:
        return -(-self.n // self.bn)

    @property
    def most_row_tiles(self) -> int:
        """An upper bound of the row tiles whatever the group sizes:
        Σ_g ⌈s_g / bm⌉ < M / bm + E."""
        return -(-self.rows // self.bm) + self.experts

    def segments(self, group_sizes: Sequence[int]) -> List[Tuple[int, int]]:
        """Each expert's rows [lo, hi): the offsets (an exclusive cumsum of
        the sizes) clamped to M, as the kernels clamp them."""
        out, start = [], 0
        for size in group_sizes:
            end = start + int(size)
            out.append((min(start, self.rows), min(end, self.rows)))
            start = end
        return out

    def tile_starts(self, group_sizes: Sequence[int]) -> List[int]:
        """The wgmma body's map: each expert's first row tile (E + 1
        entries, the last all of them), the scan its first warp makes."""
        starts = [0]
        for lo, hi in self.segments(group_sizes):
            starts.append(starts[-1] + (-(-(hi - lo) // self.bm)
                                        if hi > lo else 0))
        return starts

    def computed_rows(self, group_sizes: Sequence[int]) -> int:
        """The wgmma body's rows of MMA work: each tile's 64-row halves that
        hold rows of its segment, Σ_g ⌈s_g / 64⌉·64 (each column tile)."""
        return sum(-(-(hi - lo) // WG_ROWS) * WG_ROWS
                   for lo, hi in self.segments(group_sizes))

    def tile_at(self, group_sizes: Sequence[int], w: int
                ) -> Tuple[int, int, int, int]:
        """wgmma item ``w`` as (g, first row, end row, column tile), by the
        arithmetic of the kernel's ``item_at`` (csrc/grouped_matmul.cu): a
        binary search for the smallest g whose tiles end past w's row
        tile."""
        starts = self.tile_starts(group_sizes)
        if not 0 <= w < starts[-1] * self.col_tiles:
            raise IndexError(f"item {w} past the {starts[-1]} row tiles")
        rt, j = divmod(w, self.col_tiles)
        a, b = 0, self.experts - 1
        while a < b:
            mid = (a + b) // 2
            if starts[mid + 1] > rt:
                b = mid
            else:
                a = mid + 1
        lo, hi = self.segments(group_sizes)[a]
        r0 = lo + (rt - starts[a]) * self.bm
        return a, r0, min(r0 + self.bm, hi), j


@functools.lru_cache(maxsize=4096)
def plan(rows: int, d: int, f: int, experts: int, dtype: torch.dtype,
         trans: bool = False) -> Plan:
    """The launch plan of y = x @ W[g] (``trans``: W[g]ᵀ) for x of ``rows``
    rows and W (experts, d, f) in ``dtype``; d and f are padded to
    ``MULTIPLE``.  bf16 takes the wgmma body with as many persistent blocks
    as an SM each, or as the most items could need; fp32 the FMA body,
    which takes W as it lies."""
    if dtype not in DTYPES:
        raise TypeError(f"grouped_matmul: no kernel for {dtype}")
    if rows < 1 or d < 1 or f < 1 or experts < 1:
        raise ValueError(f"grouped_matmul: no plan for {rows} rows, w "
                         f"({experts}, {d}, {f})")
    if experts > MAX_EXPERTS:
        raise ValueError(f"grouped_matmul: {experts} experts exceed the "
                         f"kernels' {MAX_EXPERTS}")
    d, f = (-(-v // MULTIPLE) * MULTIPLE for v in (d, f))
    body = BODY[dtype]
    if body == "fma32":
        if trans:
            raise ValueError("grouped_matmul: the fp32 body takes W as it "
                             "lies (transpose it first)")
        if -(-rows // F32_TILE) > MAX_ROW_BLOCKS:
            raise ValueError(f"grouped_matmul: {rows} rows exceed the fp32 "
                             "kernel's grid")
        return Plan(rows, d, f, experts, dtype, False, body, F32_TILE,
                    F32_TILE, 0, 0)
    p = Plan(rows, d, f, experts, dtype, trans, body, WG_BM, WG_BN,
             WG_STAGES, 0)
    return dataclasses.replace(p, ctas=min(SMS, p.most_row_tiles
                                           * p.col_tiles))


def tiles(p: Plan, group_sizes: Sequence[int]
          ) -> List[Tuple[int, int, int, int]]:
    """Every tile of a call as (g, first row, end row, column tile).  wgmma:
    the items in launch order, expert by expert, each expert's row tiles
    from its own first row, column tiles innermost.  fma32: each block's
    (64-row block ∩ segment) visits, blocks row by row, segments in
    order."""
    segs = p.segments(group_sizes)
    out = []
    if p.body == "wgmma":
        for g, (lo, hi) in enumerate(segs):
            for r0 in range(lo, hi, p.bm):
                out += [(g, r0, min(r0 + p.bm, hi), j)
                        for j in range(p.col_tiles)]
        return out
    for b0 in range(0, p.rows, p.bm):
        b1 = min(b0 + p.bm, p.rows)
        for j in range(p.col_tiles):
            out += [(g, max(lo, b0), min(hi, b1), j)
                    for g, (lo, hi) in enumerate(segs)
                    if max(lo, b0) < min(hi, b1)]
    return out


def emulate(p: Plan, x, w, group_sizes):
    """Plan ``p``'s work tile by tile in plain PyTorch: x (rows, k) and W
    (experts, d, f) as the kernel sees them (padded), fp32 products of each
    tile's rows with its expert's column tile (the wgmma body computes the
    64-row halves of its box that hold the segment's rows, zero past M, and
    keeps those rows), rows past the segments zero, rounded once to x's
    dtype.  Within a tile the order of the sum is torch's."""
    xf = x.float()
    wf = w.float().transpose(1, 2) if p.trans else w.float()
    y = torch.zeros((p.rows, p.n), dtype=torch.float32)
    for g, r0, r1, j in tiles(p, [int(s) for s in group_sizes]):
        c0, c1 = j * p.bn, min((j + 1) * p.bn, p.n)
        if p.body == "wgmma":
            rows = -(-(r1 - r0) // WG_ROWS) * WG_ROWS
            box = xf[r0:r0 + rows]
            box = torch.nn.functional.pad(box, (0, 0, 0, rows - len(box)))
        else:
            box = xf[r0:r1]
        y[r0:r1, c0:c1] = (box @ wf[g, :, c0:c1])[:r1 - r0]
    return y.to(x.dtype)


def launch(p: Plan, x, w, group_sizes, y) -> None:
    """Run plan ``p``: x (rows, k), w (experts, d, f), y (rows, n), padded
    and checked; ``group_sizes`` (experts,) int32 on the device (the
    kernels scan them into the segment offsets)."""
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.grouped_matmul_launch(
        x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), y.data_ptr(),
        p.rows,
        p.d, p.f, p.experts, DTYPES[p.dtype], int(p.trans),
        BODIES.index(p.body), p.bm, p.bn, p.stages, p.ctas, stream)
    build.check(rc, "grouped_matmul")
