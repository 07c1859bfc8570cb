"""Launch plan and launcher of the factorized linear (``csrc/lowrank_matmul.cu``).

Replaces the Pallas TPU kernel
``src/repro/kernels/lowrank_matmul.py::lowrank_matmul`` (its ``pallas_call``
at :103): y = (x @ V) @ U (+ bias + residual) with fp32 accumulation; the
rank-k intermediate t is rounded once, from its full fp32 sum, to U's dtype,
and the bias and residual are added in fp32 before the one rounding of y.
The TPU kernel keeps t in VMEM; here t round-trips device memory between
two products (2·T·k·eb bytes).

Bound on the card: max(2·T·k·(n + m) flops / peak, (T·n + n·k + k·m + T·m)·eb
bytes / bandwidth).  Decode (T 8) is bound by the factors' bytes,
compression's T 4096 by the tensor cores.  ``plan`` picks one of three
bodies and everything they need:

* ``small_t`` (T ≤ ``SMALL_T_MAX``: 16 in bf16, where it beats the wgmma
  body on the H100, 64 in fp32): bandwidth-designed skinny products, the
  factor streamed through a TMA ring, mma.sync on 16 zero-padded rows (bf16)
  or FMA tiles (fp32).  Each product splits its contraction into
  ``splits_*`` slices of ``depth_*`` rows, as many as one wave of blocks
  holds (two an SM), whose fp32 partials a reduce launch sums in order.
* ``wgmma`` (bf16 above it): one TMA-fed wgmma GEMM per product, block tiles
  of 128 × 128, the depth summed in 512-row slices added in order.  A
  product whose tiles leave most of the card idle gives each block one
  slice (``_gemm_plan``), so a row's result is the same bits at any T
  (chunked prefill equals whole prefill: prefill takes this body at every
  T, ``ops.batch_invariant``).
* ``fma32`` (fp32 above it): the FMA GEMM, 64 × 64 tiles, unsplit.

No body pads T.  n, k and m are zero-padded (exact) only to what a body's
loads need — 16 bytes for ``small_t`` / ``wgmma``, so the main path's 1232,
1792, 4096 and 11008 are never copied; ``fma32`` keeps its 64 / 16 tiles.
Callers go through ``kernels.ops.lowrank_matmul``, which pads, checks and
owns the autograd rule; ``emulate`` repeats a plan's arithmetic in plain
PyTorch for the CPU tests.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("fma32", "small_t", "wgmma")    # index = the launcher's body code
SMS = 132                                 # H100 SXM streaming multiprocessors

# small_t: largest T per dtype (bf16: where it stops beating the wgmma body,
# PERF.md), row tiles (template instances: mma.sync m16 tiles for bf16, FMA
# 8-row tiles for fp32), columns a block, depth rows a ring stage; each
# product takes as many depth slices as one wave of blocks holds (two
# blocks an SM), each a whole number of stages
SMALL_T_MAX = {torch.bfloat16: 16, torch.float32: 64}
# the body above it; its rows' results do not depend on T
LARGE_T_BODY = {torch.bfloat16: "wgmma", torch.float32: "fma32"}
SMALL_ROWS = {torch.bfloat16: (16, 32), torch.float32: (8, 16, 32, 64)}
SMALL_COLS = {torch.bfloat16: 128, torch.float32: 16}
SMALL_STAGE = {torch.bfloat16: 64, torch.float32: 128}
SMALL_WAVE = 2 * SMS
# a split product's fp32 partials go to the scratch and a reduce launch
# sums them in split order
SMALL_MAX_SPLITS = 16

# wgmma: block tiles of 128 rows (two consumer warpgroups) x 128 columns,
# 64-deep steps; the depth is summed in slices of WG_SLICE rows added in
# order, and a split product gives each block one slice, so a row's result
# does not depend on T or on the split
WG_ROWS, WG_COLS, WG_DEPTH = 128, 128, 64
WG_SLICE = 8 * WG_DEPTH

# fma32: rows / columns of a block tile, depth of a step
F32_TILE, F32_DEPTH = 64, 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs.  ``n``/``k``/``m`` are the widths the kernels see
    (padded to ``align``); ``rows`` is T, never padded.  x @ V contracts n
    in ``splits_xv`` slices of ``depth_xv`` rows, t @ U contracts k in
    ``splits_tu`` slices of ``depth_tu``; a product with one slice writes
    its output directly.  Block tiles: ``tile_rows_*`` × ``tile_cols``."""
    body: str
    rows: int
    n: int
    k: int
    m: int
    align: Tuple[int, int, int]
    tile_rows_xv: int
    tile_rows_tu: int
    tile_cols: int
    splits_xv: int
    depth_xv: int
    splits_tu: int
    depth_tu: int

    def grid(self, product: str) -> Tuple[int, int, int]:
        """(column tiles, row tiles, splits) of ``product`` ("xv" or "tu")."""
        cols, splits, tile = ((self.k, self.splits_xv, self.tile_rows_xv)
                              if product == "xv" else
                              (self.m, self.splits_tu, self.tile_rows_tu))
        return (-(-cols // self.tile_cols), -(-self.rows // tile), splits)

    def blocks(self, product: str) -> List[Tuple[int, int, int, int, int,
                                               int]]:
        """Every block of ``product`` as (row0, row1, col0, col1, depth0,
        depth1) half-open ranges, clipped as the kernels clip them."""
        cols, depth, per, tile = (
            (self.k, self.n, self.depth_xv, self.tile_rows_xv)
            if product == "xv" else
            (self.m, self.k, self.depth_tu, self.tile_rows_tu))
        gx, gy, gz = self.grid(product)
        return [(y * tile, min(self.rows, (y + 1) * tile),
                 x * self.tile_cols, min(cols, (x + 1) * self.tile_cols),
                 z * per, min(depth, (z + 1) * per))
                for z in range(gz) for y in range(gy) for x in range(gx)]

    def depth_ranges(self, product: str, depth: int) -> List[Tuple[int, int]]:
        """The contraction slices of ``product`` over its first ``depth``
        rows (the unpadded width), in summation order."""
        splits, per = ((self.splits_xv, self.depth_xv) if product == "xv"
                       else (self.splits_tu, self.depth_tu))
        return [(z * per, min(depth, (z + 1) * per)) for z in range(splits)
                if z * per < depth]

    @property
    def scratch_floats(self) -> int:
        """fp32 elements of the split products' partial sums (0: none)."""
        need = 0
        if self.splits_xv > 1:
            need = self.splits_xv * self.rows * self.k
        if self.splits_tu > 1:
            need = max(need, self.splits_tu * self.rows * self.m)
        return need


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _slices(depth: int, splits: int, step: int) -> Tuple[int, int]:
    """(splits, depth per split) cutting ``depth`` into at most ``splits``
    slices, each a multiple of ``step`` rows."""
    per = _round_up(-(-depth // max(1, splits)), step)
    return -(-depth // per), per


def _gemm_plan(rows: int, cols: int, depth: int) -> Tuple[int, int]:
    """(splits, depth per split) of one wgmma product (rows, depth) @
    (depth, cols): one WG_SLICE slice a block when its tiles would leave
    more than half the SMs idle, the depth holds more than one slice and
    the slices' fp32 partials (written, then read back) come to no more
    than twice the factor's bf16 bytes; else unsplit."""
    tiles = -(-rows // WG_ROWS) * -(-cols // WG_COLS)
    slices = -(-depth // WG_SLICE)
    if (0 < 2 * tiles <= SMS and slices > 1
            and slices * rows * cols * 4 <= 2 * depth * cols * 2):
        return slices, WG_SLICE
    return 1, depth


@functools.lru_cache(maxsize=4096)
def plan(rows: int, n: int, k: int, m: int, dtype: torch.dtype,
         body: Optional[str] = None) -> Plan:
    """The launch plan of (rows, n) @ (n, k) @ (k, m) in ``dtype``; m = 0
    plans x @ V alone (``ops.lowrank_down``), n = 0 t @ U alone on a given
    t (``ops.lowrank_up``: its t @ U is planned as with any n).

    ``body`` forces a body (a harness comparing them); by default
    ``small_t`` for T ≤ ``SMALL_T_MAX[dtype]``, else ``wgmma`` (bf16) or
    ``fma32`` (fp32)."""
    if dtype not in DTYPES:
        raise TypeError(f"lowrank_matmul: no kernel for {dtype}")
    if rows < 1:
        raise ValueError(f"lowrank_matmul: no plan for {rows} rows")
    if body is None:
        body = ("small_t" if rows <= SMALL_T_MAX[dtype]
                else LARGE_T_BODY[dtype])
    if body not in BODIES:
        raise ValueError(f"lowrank_matmul: unknown body {body!r}")
    if body == "small_t":
        if rows > SMALL_ROWS[dtype][-1]:
            raise ValueError(f"lowrank_matmul: small_t takes at most "
                             f"{SMALL_ROWS[dtype][-1]} rows, got {rows}")
        vec = 16 // dtype.itemsize
        align = (vec, vec, vec)
        n, k, m = (_round_up(d, vec) for d in (n, k, m))
        cols = SMALL_COLS[dtype]
        tile_rows = next(r for r in SMALL_ROWS[dtype] if r >= rows)

        def split(out_cols, depth):
            tiles = -(-out_cols // cols)    # 0: x @ V alone, no t @ U
            want = min(SMALL_MAX_SPLITS, max(1, SMALL_WAVE // max(1, tiles)))
            return _slices(depth, want if tiles else 1, SMALL_STAGE[dtype])

        splits_xv, depth_xv = split(k, n) if n else (1, 0)
        splits_tu, depth_tu = split(m, k)
        return Plan(body, rows, n, k, m, align, tile_rows, tile_rows, cols,
                    splits_xv, depth_xv, splits_tu, depth_tu)
    if body == "wgmma":
        if dtype != torch.bfloat16:
            raise ValueError("lowrank_matmul: the wgmma body takes bfloat16")
        align = (8, 8, 8)
        n, k, m = (_round_up(d, 8) for d in (n, k, m))
        splits_xv, depth_xv = _gemm_plan(rows, k, n)
        splits_tu, depth_tu = _gemm_plan(rows, m, k)
        return Plan(body, rows, n, k, m, align, WG_ROWS, WG_ROWS, WG_COLS,
                    splits_xv, depth_xv, splits_tu, depth_tu)
    if dtype != torch.float32:
        raise ValueError("lowrank_matmul: the fma32 body takes float32")
    align = (F32_DEPTH, F32_TILE, F32_TILE)
    n, k, m = (_round_up(d, a) for d, a in zip((n, k, m), align))
    return Plan(body, rows, n, k, m, align, F32_TILE, F32_TILE, F32_TILE, 1,
                n, 1, k)


def emulate(p: Plan, x, v, u, bias=None, residual=None):
    """Plan ``p``'s arithmetic in plain PyTorch on unpadded operands:
    x @ V as fp32 partial sums over the plan's slices of n, added in split
    order; t rounded once to u's dtype; t @ U the same way over k's slices;
    bias and residual added in fp32; one rounding to x's dtype.  The wgmma
    body sums every product in ``WG_SLICE``-row slices added in order,
    split or not, so its splits give the same bits.  Returns (y, t).
    (Within a slice the order of the sum is torch's.)"""
    def split_sum(a, b, ranges):
        out = None
        for d0, d1 in ranges:
            part = torch.matmul(a[:, d0:d1], b[d0:d1])
            out = part if out is None else out + part
        return out

    def ranges(product, depth):
        if p.body == "wgmma":
            return [(d0, min(depth, d0 + WG_SLICE))
                    for d0 in range(0, depth, WG_SLICE)]
        return p.depth_ranges(product, depth)

    t = split_sum(x.float(), v.float(),
                  ranges("xv", x.shape[1])).to(u.dtype)
    y = split_sum(t.float(), u.float(), ranges("tu", t.shape[1]))
    if bias is not None:
        y = y + bias.reshape(-1).float()
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype), t


def launch(p: Plan, x, v, u, t, y, bias, residual, scratch) -> None:
    """Run plan ``p`` on padded, checked operands: ``t`` (T, k) receives the
    rounded intermediate, ``y`` (T, m) the output, ``scratch`` (fp32, at
    least ``p.scratch_floats``) the split products' partial sums.  A plan
    with n = 0 takes ``t`` as its input (x and v None)."""
    lib = build.library()
    stream = torch.cuda.current_stream(t.device).cuda_stream
    rc = lib.lowrank_matmul_launch(
        None if x is None else x.data_ptr(),
        None if v is None else v.data_ptr(), u.data_ptr(), t.data_ptr(),
        y.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        p.rows, p.n, p.k, p.m, DTYPES[t.dtype], BODIES.index(p.body),
        p.tile_rows_xv, p.tile_rows_tu, p.splits_xv, p.depth_xv, p.splits_tu,
        p.depth_tu, stream)
    build.check(rc, "lowrank_matmul")
