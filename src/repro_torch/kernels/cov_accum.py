"""Launch plan and launcher of the covariance triple (``csrc/cov_accum.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/cov_accum.py::cov_accum``
(its ``pallas_call`` at :73): one pass over (T, n) token rows X, X' gives
XᵀX, XᵀX', X'ᵀX' in fp32, ``acc=`` folding into existing accumulators.
With a bank count E it also replaces that kernel's vmap over an expert axis
(``src/repro/kernels/ops.py::_cov_triple_banked``, :182): (E, C, n) inputs
give E triples (E, n, n) in one launch.

The triple is the Gram matrix of Z = [X | X'] (T, 2n): Zᵀ Z = [[xx, xxp],
[xxpᵀ, xpxp]].  Z's columns are cut into strips of ``edge`` columns
(⌈n/edge⌉ from X, then as many from X'), and each block of the kernel
computes one tile (a ≤ b) of the upper block triangle with one fp32
accumulator: the upper halves of xx and xpxp and all of xxp, 4·T·n² flops
(the TPU kernel computes all three products whole, 6·T·n²).  The epilogue
mirrors xx and xpxp, so both are exactly symmetric.

Bound on the card: max(4·T·n² flops / peak, (2·T·n·eb + 3·n²·4·(1 + acc))
bytes / bandwidth); the tensor cores at the main path's (T 4096, n 4096 /
11008), the accumulators' bytes for one expert segment (T ~384).  bf16
inputs take the wgmma body (128-column strips, a TMA ring), fp32 inputs the
FMA body (64-column strips; TF32 stays off).

``plan`` gives everything one call needs: the strips, the tile order (square
super-tiles of ``GROUP`` strips, so blocks in flight share strips in L2),
the work items (bank, slice, tile), the bank slowest, and, when the banks'
tiles leave the card under-filled, a split of T into slices whose fp32
partials a reduce launch adds in slice order (no atomics: two calls give
the same bits, and a bank's bits do not depend on the other banks).  Neither T nor n is padded in
memory beyond n's 16-byte row alignment.  Callers go through
``kernels.ops.cov_accum`` / ``cov_accum_banked``, which check, pad n to
``align`` and own ``acc=``; ``emulate`` repeats a plan's arithmetic in plain PyTorch for the
CPU tests.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132                       # H100 SXM streaming multiprocessors
GROUP = 8                       # strips a side of a super-tile

# per input dtype: tile edge (a strip's columns), token rows a step, n's
# multiple (16-byte rows), blocks one wave holds (wgmma: one persistent
# block an SM; FMA: three, at its 80 registers a thread), and the fewest
# steps a split slice takes
EDGE = {torch.bfloat16: 128, torch.float32: 64}
STEP = {torch.bfloat16: 64, torch.float32: 16}
ALIGN = {torch.bfloat16: 8, torch.float32: 4}
WAVE = {torch.bfloat16: SMS, torch.float32: 3 * SMS}
MIN_STEPS = {torch.bfloat16: 4, torch.float32: 1}
MAX_BANKS = 65535               # a grid axis of the fp32 and reduce launches


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs.  ``n`` is the width the kernel sees (padded to
    ``align``), ``rows`` is T, a bank's rows (never padded).  The work is
    (banks, splits, tiles): item (e, z, t) computes bank e's tile
    ``tile_at(t)`` over token slice z, T cut into slices of
    ``rows_per_split`` rows (``splits`` == 1: all of T); the bf16 body's
    persistent blocks walk the items (e·splits + z)·tiles + t in order
    (``item_at``), the fp32 body launches one block an item."""
    rows: int
    n: int
    dtype: torch.dtype
    align: int
    edge: int
    step: int
    splits: int
    rows_per_split: int
    banks: int = 1

    @property
    def half(self) -> int:
        """Strips of X (and as many of X')."""
        return -(-self.n // self.edge)

    @property
    def strips(self) -> int:
        return 2 * self.half

    @property
    def tiles(self) -> int:
        """Tiles of the upper block triangle of Zᵀ Z."""
        return self.strips * (self.strips + 1) // 2

    def tile_list(self) -> List[Tuple[int, int]]:
        """Every tile (a, b), a ≤ b, in launch order: super-tile rows of
        GROUP strips, each the triangle of its diagonal super-tile row by
        row, then the super-tiles to its right, each row by row."""
        s = self.strips
        out = []
        for a0 in range(0, s, GROUP):
            na = min(GROUP, s - a0)
            out += [(a0 + i, a0 + j) for i in range(na) for j in range(i, na)]
            for b0 in range(a0 + na, s, GROUP):
                nb = min(GROUP, s - b0)
                out += [(a0 + i, b0 + j) for i in range(na)
                        for j in range(nb)]
        return out

    def tile_at(self, t: int) -> Tuple[int, int]:
        """Tile ``t`` of the launch order, by the arithmetic of the kernels'
        ``tile_at`` (csrc/cov_accum.cu)."""
        s = self.strips
        for a0 in range(0, s, GROUP):
            na = min(GROUP, s - a0)
            diag = na * (na + 1) // 2
            row = diag + na * (s - a0 - na)
            if t >= row:
                t -= row
                continue
            if t < diag:
                i = 0
                while t >= na - i:
                    t -= na - i
                    i += 1
                return a0 + i, a0 + i + t
            t -= diag
            right = t // (na * GROUP)
            t -= right * na * GROUP
            b0 = a0 + na + right * GROUP
            nb = min(GROUP, s - b0)
            return a0 + t // nb, b0 + t % nb
        raise IndexError(f"tile {t} past the triangle's {self.tiles}")

    @property
    def items(self) -> int:
        return self.banks * self.splits * self.tiles

    def item_at(self, w: int) -> Tuple[int, int, int]:
        """(bank, slice, tile) of work item ``w``, by the kernels'
        arithmetic."""
        if not 0 <= w < self.items:
            raise IndexError(f"item {w} past the plan's {self.items}")
        return w // self.tiles // self.splits, w // self.tiles % self.splits, \
            w % self.tiles

    def slices(self) -> List[Tuple[int, int]]:
        """The token slices in summation order, half-open."""
        per = self.rows_per_split
        return [(z * per, min(self.rows, (z + 1) * per))
                for z in range(self.splits)]

    @property
    def scratch_floats(self) -> int:
        """fp32 elements of the slices' partial sums (0: no split)."""
        if self.splits == 1:
            return 0
        return self.items * self.edge * self.edge


@functools.lru_cache(maxsize=4096)
def plan(rows: int, n: int, dtype: torch.dtype, banks: int = 1) -> Plan:
    """The launch plan of ``banks`` (rows, n) triples in ``dtype``: T is
    split only when the banks' tiles fill less than a wave of blocks and T
    holds at least two slices of ``MIN_STEPS`` steps; then into as many
    slices as the idle blocks of that wave take, each a whole number of
    steps.  The plan depends on (banks, rows, n, dtype) alone."""
    if dtype not in DTYPES:
        raise TypeError(f"cov_accum: no kernel for {dtype}")
    if rows < 1 or n < 1 or not 1 <= banks <= MAX_BANKS:
        raise ValueError(f"cov_accum: no plan for {banks} x ({rows}, {n})")
    align, edge, step = ALIGN[dtype], EDGE[dtype], STEP[dtype]
    n = -(-n // align) * align
    strips = 2 * -(-n // edge)
    work = banks * strips * (strips + 1) // 2
    steps = -(-rows // step)
    splits, per = 1, rows
    if work < WAVE[dtype] and steps >= 2 * MIN_STEPS[dtype]:
        want = min(WAVE[dtype] // work, steps // MIN_STEPS[dtype])
        if want > 1:
            per = -(-steps // want) * step
            splits = -(-rows // per)
    return Plan(rows, n, dtype, align, edge, step, splits, per, banks)


def _store(out, i0, j0, block, acc):
    """The kernels' store of a block at (i0, j0): written, or added to what
    is there (``acc``)."""
    ni, nj = block.shape
    if acc:
        out[i0:i0 + ni, j0:j0 + nj] += block
    else:
        out[i0:i0 + ni, j0:j0 + nj] = block


def emulate(p: Plan, x, xp, acc=None):
    """Plan ``p``'s arithmetic in plain PyTorch on unpadded (T, n) inputs,
    or (E, C, n) with E == ``p.banks``, bank by bank: for each tile of the
    triangle, the fp32 products of its two strips of Z = [X | X'] over each
    token slice, added in slice order, then the kernels' epilogue (xxp
    stored once; an off-diagonal tile of xx / xpxp also stored transposed;
    a diagonal tile's upper half stored and mirrored), written or added
    into ``acc`` (not modified: the sums come back as new tensors).  Within
    a slice the order of the sum is torch's."""
    if x.ndim == 3:
        if x.shape[0] != p.banks:
            raise ValueError(f"{x.shape[0]} banks under a plan of {p.banks}")
        per_bank = [emulate(dataclasses.replace(p, banks=1), x[e], xp[e],
                            None if acc is None else tuple(a[e] for a in acc))
                    for e in range(p.banks)]
        return tuple(torch.stack(outs) for outs in zip(*per_bank))
    t_rows, n = x.shape
    e, half = p.edge, p.half
    width = half * e

    def strips(a):
        return torch.nn.functional.pad(a.float(), (0, width - n))

    z = torch.cat([strips(x), strips(xp)], dim=1)
    if acc is None:
        outs = [torch.zeros((n, n), dtype=torch.float32) for _ in range(3)]
    else:
        outs = [a.clone() for a in acc]
    xx, xxp, xpxp = outs
    add = acc is not None
    for a, b in p.tile_list():
        total = None
        for r0, r1 in p.slices():
            part = z[r0:r1, a * e:(a + 1) * e].T @ z[r0:r1, b * e:(b + 1) * e]
            total = part if total is None else total + part
        ap, bp = a >= half, b >= half
        i0, j0 = (a % half) * e, (b % half) * e
        block = total[:max(0, min(e, n - i0)), :max(0, min(e, n - j0))]
        if ap != bp:
            _store(xxp, i0, j0, block, add)
            continue
        out = xpxp if ap else xx
        if a == b:
            upper = torch.triu(block)
            block = upper + torch.triu(upper, 1).T
            _store(out, i0, j0, block, add)
        else:
            _store(out, i0, j0, block, add)
            _store(out, j0, i0, block.T, add)
    return tuple(outs)


def launch(p: Plan, x, xp, xx, xxp, xpxp, scratch, *,
           accumulate: bool) -> None:
    """Run plan ``p`` on checked contiguous (p.banks, T, p.n) inputs into
    (p.banks, p.n, p.n) fp32 outputs: a bank's rows lie at bank·T·n, its
    triple at bank·n²; ``accumulate`` adds into them in place, else they
    are overwritten.  ``scratch``: fp32, at least ``p.scratch_floats``."""
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.cov_accum_launch(
        x.data_ptr(), xp.data_ptr(), xx.data_ptr(), xxp.data_ptr(),
        xpxp.data_ptr(), None if scratch is None else scratch.data_ptr(),
        p.banks, p.rows, p.n, DTYPES[p.dtype], p.edge, p.splits,
        p.rows_per_split, int(accumulate), stream)
    build.check(rc, "cov_accum")
