"""Launch plan and launcher of the flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention`` (its
``pallas_call`` at :100) and computes what the JAX model path's
``models/attention.py:31`` computes: blockwise online-softmax attention with
causal, sliding-window and key-padding masks, an optional soft cap, a scalar
or per-slot query offset, and GQA through the head map; masked scores -1e30,
(m, l, acc) in fp32, p rounded to v's dtype before P·V, the output divided
by max(l, 1e-20).

Bound on the card: max(4·B·H·Σ live keys·D flops / peak, (q + k + v + o)
bytes / bandwidth) — operations for prefill, bytes for one-token decode.
``plan`` picks one of five bodies and everything it needs:

* ``wgmma`` (bf16 at D 64 / 96 / 112 / 128 / 192 / 256): one block a
  (batch·head, 128 query rows: two warpgroups of 64), issued longest first;
  a TMA ring of K and V tiles feeds wgmma for S = Q·Kᵀ and for O += P·V
  with P in registers.  Key tiles are 128 wide at D <= 128, 64 at D 192
  and 256.  At D 64 a warpgroup's softmax runs under its own last P·V and
  the other warpgroup's products (the two take turns to issue); the
  arithmetic of each element is unchanged.  D 96 and 112 are read at their
  true width (4D tensor maps whose second 64-column box is zero-filled
  past D) and run the D-128 layout.
* ``split`` (Lq 1 outside ``ops.batch_invariant``, at most
  ``SPLIT_MAX_GROUP`` query heads a KV head, where ``split_mma`` does not
  take the call: fp32, D 16 / 32, one query head a KV head): one block a
  (slot, KV head, key span) over the span's live keys on the FMA units, each
  writing an fp32 partial (m, l, acc); a merge launch adds a row's partials
  in span order, in blocks of 64 columns, each span's weight computed once.
  The span length is picked from (B·KV, Lk) so about ``SPLIT_BLOCKS``
  blocks fill the card.
* ``split_mma`` (the same calls in bf16 at D 64 / 96 / 112 / 128 / 192 /
  256 with 2 to ``SPLIT_MAX_GROUP`` query heads a KV head): ``split``'s
  blocks and partials, the group's heads zero-padded to 16 rows on the
  tensor cores (mma.sync m16n8k16 for S and for P·V), K and V through a
  3-stage ring of ``mma_keys(D)``-key tiles.  Its spans hold at least
  ``MMA_MIN_TILES`` tiles, and the (slot, KV head, span) blocks aim at one
  wave of resident blocks (``mma_wave``, from the block's shared memory).
* ``fma32`` (fp32) and ``wmma`` (bf16 at D 16 / 32): the first version, one
  block a (batch·head, 64 query rows), 64-key tiles (32 at D 256, so that
  the fp32 tiles fit shared memory).

In the three tile bodies key tiles start at absolute key 0 and tiles wholly
outside a block's causal limit or window are skipped (``Plan.key_tiles``),
which is exact: a row's bits do not depend on Lq, on where its block starts
or on B.  Under ``batch_invariant`` no choice depends on Lq, so chunked
prefill equals whole prefill bit for bit.

Callers go through ``kernels.ops.flash_attention``, which checks, pads a
head dim that has no body of its own and owns the autograd rule;
``emulate`` repeats a plan's arithmetic in plain PyTorch for the CPU
tests.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# index = the launcher's body code
BODIES = ("fma32", "wmma", "wgmma", "split", "split_mma")
SPLIT_BODIES = ("split", "split_mma")   # Lq 1: span partials, then a merge
SMS = 132                                      # H100 SXM streaming multiprocessors
NEG_INF = -1e30

# head dims the kernel is compiled for; the wrapper zero-pads any other up
# to one (96: phi-3-vision; 112: kimi-k2 and zamba2's shared block; 192: MLA
# prefill, qk_nope 128 + qk_rope 64; 256: gemma3)
HEAD_DIMS = (16, 32, 64, 96, 112, 128, 192, 256)
# wgmma: query rows a block (two consumer warpgroups of 64), keys a tile by D
WG_BQ = 128
WG_BKEY = {64: 128, 96: 128, 112: 128, 128: 128, 192: 64, 256: 64}
# fma32 / wmma: query rows a block; keys a tile by D (``tile_bkey``)
TILE_BQ = 64
# split: query heads a KV head at most (the block's shared arrays), the
# blocks a launch aims at (8 a streaming multiprocessor), keys a tile (a row
# of at most 256 bytes: 64, else 32)
SPLIT_MAX_GROUP = 16
SPLIT_BLOCKS = 8 * SMS
MAX_GRID_Y = 65535
# split_mma: its head dims, the stages of its K / V ring, the tiles a span
# holds at least (so the ring overlaps loads with math), and the shared
# memory a streaming multiprocessor holds (1 KB of it reserved a block)
MMA_DIMS = (64, 96, 112, 128, 192, 256)
MMA_STAGES = 3
MMA_MIN_TILES = 4
SM_SHARED = 233472


def tile_bkey(d: int) -> int:
    """Keys a tile of the fma32 / wmma bodies: 64, and 32 at D 256, whose
    fp32 tiles would need 272 KB of shared memory at 64."""
    return 32 if d == 256 else 64


def mma_keys(d: int) -> int:
    """Keys a tile of the split_mma body: 64 at D <= 128, else 32."""
    return 64 if d <= 128 else 32


def mma_smem(d: int) -> int:
    """Shared bytes of a split_mma block (``fm::Cfg<D>::SMEM``): the K and
    V rings and Q's 16 rows in bf16 at a pitch of D + 8, and the tile's
    fp32 scores at a pitch of ``mma_keys(d)`` + 4."""
    bk, pitch = mma_keys(d), d + 8
    return 2 * (2 * MMA_STAGES * bk * pitch + 16 * pitch) + 4 * 16 * (bk + 4)


def mma_wave(d: int) -> int:
    """The split_mma blocks the card holds at once (shared memory bounds
    them: 3 a streaming multiprocessor at D 64, 2 at the others)."""
    return SMS * (SM_SHARED // (mma_smem(d) + 1024))


def split_keys(dtype: torch.dtype, d: int) -> int:
    """Keys a shared-memory tile of the split body holds."""
    eb = torch.finfo(dtype).bits // 8
    return 64 if d * eb <= 256 else 32


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs.  ``d`` is the head dim the kernel sees (the
    caller's, or a padded one where the caller's has no body);
    ``bq`` the query rows a block (1 for ``split``), ``bkey`` the keys a
    tile; ``span`` / ``spans`` the split body's key spans (0 otherwise).
    ``offsets`` are the slots' query offsets when the host knows them (the
    block list and ``emulate`` need them; the kernel reads them on the
    device), else None."""
    b: int
    lq: int
    lk: int
    h: int
    kv: int
    d: int
    dtype: torch.dtype
    causal: bool
    window: int
    invariant: bool
    body: str
    bq: int
    bkey: int
    span: int
    spans: int
    offsets: Optional[Tuple[int, ...]]

    @property
    def group(self) -> int:
        return self.h // self.kv

    @property
    def q_blocks(self) -> int:
        return -(-self.lq // self.bq)

    @property
    def grid(self) -> int:
        """Blocks of the (first) launch."""
        if self.body in SPLIT_BODIES:
            return self.spans * self.b * self.kv
        return self.q_blocks * self.b * self.h

    @property
    def scratch_floats(self) -> int:
        """The split bodies' partials: m and l a (slot, head, span), then
        acc (D floats each)."""
        if self.body not in SPLIT_BODIES:
            return 0
        return self.b * self.h * self.spans * (self.d + 2)

    def tile_at(self, w: int) -> Tuple[int, int, int]:
        """Block ``w`` of the launch order as the kernel maps it: (slot,
        head, first query row) for the tile bodies, (slot, KV head, span)
        for the split bodies.  wgmma: heads innermost, the last query block
        first; fma32 / wmma: grid (query blocks, B·H), query blocks
        innermost; split / split_mma: grid (spans, B·KV), spans innermost."""
        if not 0 <= w < self.grid:
            raise IndexError(f"block {w} past the {self.grid} of the launch")
        if self.body in SPLIT_BODIES:
            bkv, sp = divmod(w, self.spans)
            return bkv // self.kv, bkv % self.kv, sp
        if self.body == "wgmma":
            heads = self.b * self.h
            bh = w % heads
            qb = self.q_blocks - 1 - w // heads
        else:
            bh, qb = divmod(w, self.q_blocks)
        return bh // self.h, bh % self.h, qb * self.bq

    def key_tiles(self, q0: int, off: int) -> Tuple[int, int]:
        """The key tiles [begin, end) the block at query row ``q0`` walks
        for a slot at offset ``off``: the kernels' ``key_tiles``."""
        rows = min(self.bq, self.lq - q0)
        first, last = off + q0, off + q0 + rows - 1
        end = -(-self.lk // self.bkey)
        if self.causal:
            end = min(end, last // self.bkey + 1)
        begin = 0
        if self.window > 0 and first - self.window + 1 > 0:
            begin = (first - self.window + 1) // self.bkey
        return begin, max(begin, end)

    def live_keys(self, off: int) -> Tuple[int, int]:
        """The live keys [lo, hi) of a one-row query at offset ``off``."""
        hi = min(self.lk, off + 1) if self.causal else self.lk
        lo = max(0, off - self.window + 1) if self.window > 0 else 0
        return lo, hi

    def span_keys(self, sp: int, off: int) -> Tuple[int, int]:
        """The live keys [begin, end) of span ``sp`` for a slot at offset
        ``off`` (begin >= end: an empty partial)."""
        lo, hi = self.live_keys(off)
        return max(lo, sp * self.span), min(hi, (sp + 1) * self.span)

    def blocks(self) -> List[Tuple[int, int, int, int, int]]:
        """Every block in launch order with its key range: (slot, head,
        first row, first tile, end tile) for the tile bodies, (slot, KV
        head, span, first key, end key) for the split bodies.  Needs
        ``offsets``."""
        if self.offsets is None:
            raise ValueError("flash_attention: the block list needs the "
                             "slots' offsets on the host")
        out = []
        for w in range(self.grid):
            bi, hd, x = self.tile_at(w)
            off = self.offsets[bi]
            rng = (self.span_keys(x, off) if self.body in SPLIT_BODIES
                   else self.key_tiles(x, off))
            out.append((bi, hd, x) + rng)
        return out


Offsets = Union[None, int, Sequence[int]]


def _offsets(b: int, q_offset: Offsets) -> Optional[Tuple[int, ...]]:
    if q_offset is None:
        return None
    if not hasattr(q_offset, "__len__"):
        return (int(q_offset),) * b
    out = tuple(int(o) for o in q_offset)
    if len(out) != b:
        raise ValueError(f"flash_attention: {len(out)} offsets for {b} slots")
    return out


@functools.lru_cache(maxsize=4096)
def _plan(b, lq, lk, h, kv, d, dtype, causal, window, offsets, invariant):
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention: no kernel for {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not one of "
                         f"{HEAD_DIMS} (pad it)")
    if min(b, lq, lk, h, kv) < 1 or h % kv:
        raise ValueError(f"flash_attention: no plan for B {b}, Lq {lq}, Lk "
                         f"{lk}, H {h}, KV {kv}")
    base = dict(b=b, lq=lq, lk=lk, h=h, kv=kv, d=d, dtype=dtype,
                causal=bool(causal), window=int(window),
                invariant=bool(invariant), offsets=offsets, span=0, spans=0)
    if lq == 1 and not invariant and h // kv <= SPLIT_MAX_GROUP:
        if b * kv > MAX_GRID_Y:
            raise ValueError(f"flash_attention: B·KV {b * kv} exceeds the "
                             "split body's grid")
        if dtype == torch.bfloat16 and d in MMA_DIMS and h // kv >= 2:
            bk = mma_keys(d)
            want = -(-mma_wave(d) // (b * kv))
            span = max(MMA_MIN_TILES * bk, -(-(-(-lk // want)) // bk) * bk)
            body = "split_mma"
        else:
            bk = split_keys(dtype, d)
            want = -(-SPLIT_BLOCKS // (b * kv))
            span = -(-(-(-lk // want)) // bk) * bk
            body = "split"
        return Plan(**{**base, "span": span, "spans": -(-lk // span)},
                    body=body, bq=1, bkey=bk)
    if dtype == torch.bfloat16 and d >= 64:
        return Plan(**base, body="wgmma", bq=WG_BQ, bkey=WG_BKEY[d])
    if b * h > MAX_GRID_Y:
        raise ValueError(f"flash_attention: B·H {b * h} exceeds the tile "
                         "body's grid")
    return Plan(**base, body="wmma" if dtype == torch.bfloat16 else "fma32",
                bq=TILE_BQ, bkey=tile_bkey(d))


def plan(b: int, lq: int, lk: int, h: int, kv: int, d: int,
         dtype: torch.dtype, *, causal: bool = True, window: int = 0,
         q_offset: Offsets = None, invariant: bool = False) -> Plan:
    """The launch plan of one call: q (B, Lq, H, d), k / v (B, Lk, KV, d)
    in ``dtype``, d a compiled head dim.  ``q_offset``: the slots' offsets
    when the host knows them (an int or B ints; None when they lie on the
    device), used by ``Plan.blocks`` and ``emulate`` only.  ``invariant``
    (``ops.batch_invariant``): no choice depends on Lq."""
    return _plan(b, lq, lk, h, kv, d, dtype, bool(causal), int(window),
                 _offsets(b, q_offset), bool(invariant))


# ---------------------------------------------------------------------------
# emulation: the plan's arithmetic in plain PyTorch, each element's result a
# function of its own inputs alone (elementwise fp32 products and sums in a
# fixed order; exp and tanh by a fixed fp64 polynomial rounded to fp32, since
# torch's vectorized and scalar exp can differ in the last bit)

_LN2 = math.log(2.0)


def _exp64(x):
    """exp of a float64 tensor by range reduction and a degree-13 Taylor
    polynomial: + and × only, so the result depends on x alone."""
    x = x.clamp(-745.0, 709.0)
    n = torch.round(x / _LN2)
    r = x - n * _LN2
    y = torch.ones_like(r)
    for i in range(13, 0, -1):
        y = 1.0 + y * r / i
    bits = (n.to(torch.int64) + 1023).clamp(1, 2046) << 52
    return y * bits.view(torch.float64)


def _exp(x):
    return _exp64(x.double()).float()


def _tanh(x):
    e = _exp64(-2.0 * x.double().abs())
    return (torch.sign(x.double()) * (1.0 - e) / (1.0 + e)).float()


def _step(p: Plan, qf, kf, vt, pos, k0, m, l, acc, *, scale, softcap):
    """One key tile against rows ``qf`` (rows, d) fp32 at absolute
    positions ``pos``: kf (n, d) fp32 and vt (n, d) in v's dtype, keys
    k0.. (a tile past Lk arrives zero-filled).  Returns the new (m, l,
    acc)."""
    n = kf.shape[0]
    s = torch.zeros((qf.shape[0], n), dtype=torch.float32)
    for i in range(p.d):
        s = s + qf[:, i, None] * kf[None, :, i]
    s = s * scale
    if softcap:
        s = _tanh(s / softcap) * softcap
    kpos = k0 + torch.arange(n)
    ok = (kpos < p.lk)[None, :].expand(s.shape)
    if p.causal:
        ok = ok & (kpos[None, :] <= pos[:, None])
    if p.window > 0:
        ok = ok & (kpos[None, :] > pos[:, None] - p.window)
    s = torch.where(ok, s, torch.tensor(NEG_INF))
    m_new = torch.maximum(m, s.amax(-1))
    e = _exp(s - m_new[:, None])
    corr = _exp(m - m_new)
    total = torch.zeros_like(l)
    for j in range(n):
        total = total + e[:, j]
    l = l * corr + total
    pr = e.to(vt.dtype).float()
    vf = vt.float()
    acc = acc * corr[:, None]
    for j in range(n):
        acc = acc + pr[:, j, None] * vf[None, j]
    return m_new, l, acc


def emulate(p: Plan, q, k, v, *, scale: float, softcap: float = 0.0,
            lse: bool = False):
    """Plan ``p``'s work block by block: q (B, Lq, H, d), k / v (B, Lk, KV,
    d) as the kernel sees them (padded head dim); returns (B, Lq, H, d) in
    q's dtype.  Tile bodies: each block's rows against its key tiles in
    order, keys past Lk zero.  split / split_mma: each span's partial over
    its live keys in tiles of ``bkey`` from the span's first live key, then
    the partials merged in span order, empty ones skipped, each span's
    weight computed once.  Needs ``p.offsets``.  With ``lse`` (tile bodies
    only, as the kernel) it returns (out, lse): each row's m + log(l),
    (B, H, Lq) fp32, what the backward reads."""
    out = torch.zeros((p.b, p.lq, p.h, p.d), dtype=torch.float32)
    stats = torch.zeros((p.b, p.h, p.lq), dtype=torch.float32)
    if lse and p.body in SPLIT_BODIES:
        raise ValueError(f"flash_attention: the {p.body} body writes no "
                         "LSE (a tile body's plan does: invariant=True)")
    if p.body in SPLIT_BODIES:
        parts = {}
        for bi, kvh, sp, k_begin, k_end in p.blocks():
            if k_begin >= k_end:
                continue
            heads = slice(kvh * p.group, (kvh + 1) * p.group)
            qf = q[bi, 0, heads].float()
            pos = torch.full((p.group,), p.offsets[bi])
            m = torch.full((p.group,), NEG_INF)
            l = torch.zeros(p.group)
            acc = torch.zeros((p.group, p.d))
            for k0 in range(k_begin, k_end, p.bkey):
                k1 = min(k0 + p.bkey, k_end)
                m, l, acc = _step(p, qf, k[bi, k0:k1, kvh].float(),
                                  v[bi, k0:k1, kvh], pos, k0, m, l, acc,
                                  scale=scale, softcap=softcap)
            for g in range(p.group):
                parts.setdefault((bi, kvh * p.group + g), []).append(
                    (sp, m[g], l[g], acc[g]))
        for (bi, hd), rows in parts.items():
            rows.sort(key=lambda r: r[0])
            mx = max(r[1] for r in rows)
            lsum = torch.zeros(())
            osum = torch.zeros(p.d)
            for _, m, l, acc in rows:
                w = _exp(m - mx)
                lsum = lsum + l * w
                osum = osum + acc * w
            out[bi, 0, hd] = osum / torch.clamp(lsum, min=1e-20)
        return out.to(q.dtype)
    for bi, hd, q0, t0, t1 in p.blocks():
        rows = min(p.bq, p.lq - q0)
        kvh = hd // p.group
        qf = q[bi, q0:q0 + rows, hd].float()
        pos = p.offsets[bi] + q0 + torch.arange(rows)
        m = torch.full((rows,), NEG_INF)
        l = torch.zeros(rows)
        acc = torch.zeros((rows, p.d))
        for t in range(t0, t1):
            k0 = t * p.bkey
            kf = torch.zeros((p.bkey, p.d))
            vt = torch.zeros((p.bkey, p.d), dtype=v.dtype)
            live = min(p.bkey, p.lk - k0)
            kf[:live] = k[bi, k0:k0 + live, kvh].float()
            vt[:live] = v[bi, k0:k0 + live, kvh]
            m, l, acc = _step(p, qf, kf, vt, pos, k0, m, l, acc,
                              scale=scale, softcap=softcap)
        out[bi, q0:q0 + rows, hd] = acc / torch.clamp(l, min=1e-20)[:, None]
        stats[bi, hd, q0:q0 + rows] = m + torch.log(l)
    if lse:
        return out.to(q.dtype), stats
    return out.to(q.dtype)


def launch(p: Plan, q, k, v, o, q_off, q_off0: int, *, scale: float,
           softcap: float, scratch=None, lse=None) -> None:
    """Run plan ``p``: q, o (B, Lq, H, d); k, v (B, Lk, KV, d), checked
    and padded; ``q_off`` a (B,) int32 tensor or None (every slot at
    ``q_off0``); ``scratch`` ``p.scratch_floats`` fp32 for the split
    bodies; ``lse`` None, or (B, H, Lq) fp32 that a tile body fills with
    each row's m + log(l) (the output's bits do not change)."""
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if q_off is None else q_off.data_ptr(), int(q_off0),
        p.b, p.lq, p.lk, p.h, p.kv, p.d, int(p.causal), int(p.window),
        float(scale), float(softcap), DTYPES[p.dtype], BODIES.index(p.body),
        p.bq, p.bkey, p.span, p.spans,
        None if scratch is None else scratch.data_ptr(),
        None if lse is None else lse.data_ptr(), stream)
    build.check(rc, "flash_attention")


# ---------------------------------------------------------------------------
# backward (``csrc/flash_attention_bwd.cu``): the gradient that XLA takes of
# the JAX model path's scan (``src/repro/models/attention.py:31``; the TPU
# kernel has no backward).  Two passes, no atomics: a pre-pass Δ =
# rowsum(dO ∘ O) in fp32; a dK/dV pass, one block a (key tile, KV head,
# slot) that walks the query heads of its group and, for each, the query
# tiles that can see its keys (``BwdPlan.query_tiles``), recomputing P from
# the forward's LSE; a dQ pass, one block a (query tile, head, slot) over
# the forward's key tiles (``BwdPlan.key_tiles``).  Each gradient is
# written once and every sum runs in a fixed order, so two calls give the
# same bits and a slot's gradients do not depend on the others.

BWD_BODIES = ("fma", "wgmma")   # index = the launcher's body code
# wgmma (bf16 at D 64 / 96 / 112 / 128 / 192 / 256): the dK/dV block's 64
# keys are shared by its two consumer warpgroups, one accumulating dK, the
# other dV; its query rows a step (32 at D 256: the dK warpgroup's
# registers); the dQ block's 128 query rows (64 a warpgroup) and its keys a
# step (32 at D 256)
BWD_WG_KEYS = 64
BWD_WG_QROWS = 128


def bwd_wg_rows(d: int) -> int:
    """Query rows a step of the wgmma dK/dV pass."""
    return 32 if d == 256 else 64


def bwd_wg_keys(d: int) -> int:
    """Keys a step of the wgmma dQ pass."""
    return 32 if d == 256 else 64


# fma (fp32 at every D, bf16 at D 16 / 32): 32 keys and 32 query rows a
# tile in both passes
BWD_TILE = 32


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How one backward call runs.  ``kv_keys`` keys a dK/dV block and
    ``kv_rows`` query rows a step of it; ``q_rows`` query rows a dQ block
    and ``q_keys`` keys a step of it.  ``offsets``: the slots' query
    offsets when the host knows them (``emulate_backward`` needs them)."""
    b: int
    lq: int
    lk: int
    h: int
    kv: int
    d: int
    dtype: torch.dtype
    causal: bool
    window: int
    body: str
    kv_keys: int
    kv_rows: int
    q_rows: int
    q_keys: int
    offsets: Optional[Tuple[int, ...]]

    @property
    def group(self) -> int:
        return self.h // self.kv

    @property
    def kv_grid(self) -> Tuple[int, int]:
        """(key tiles, B·KV) of the dK/dV launch."""
        return -(-self.lk // self.kv_keys), self.b * self.kv

    @property
    def q_grid(self) -> Tuple[int, int]:
        """(query tiles, B·H) of the dQ launch."""
        return -(-self.lq // self.q_rows), self.b * self.h

    def query_tiles(self, k0: int, off: int) -> Tuple[int, int]:
        """The query tiles [begin, end) of ``kv_rows`` rows whose rows (at
        positions off + row) see a key of the tile at ``k0``: the
        kernels' ``query_tiles``."""
        k1 = min(k0 + self.kv_keys, self.lk)
        lo = k0 - off if self.causal else 0
        hi = k1 + self.window - 2 - off if self.window > 0 else self.lq - 1
        lo, hi = max(lo, 0), min(hi, self.lq - 1)
        if lo > hi:
            return 0, 0
        return lo // self.kv_rows, hi // self.kv_rows + 1

    def dead_rows(self, off: int) -> Tuple[int, int]:
        """(x, y): the rows [0, x) and [y, Lq) of a slot at offset ``off``
        that see no key (causal rows before key 0, windowed rows past the
        window of the last key); each adds dO/Lk to every key's dv, the
        plain version's -1e30 semantics.  The kernels' ``dead_rows``."""
        x = min(max(-off, 0), self.lq) if self.causal else 0
        y = (min(max(self.lk + self.window - 1 - off, 0), self.lq)
             if self.window > 0 else self.lq)
        return x, y

    def key_tiles(self, q0: int, off: int) -> Tuple[int, int]:
        """The key tiles [begin, end) of ``q_keys`` keys the dQ block at
        query row ``q0`` walks: the forward's ``key_tiles``."""
        rows = min(self.q_rows, self.lq - q0)
        first, last = off + q0, off + q0 + rows - 1
        end = -(-self.lk // self.q_keys)
        if self.causal:
            end = min(end, last // self.q_keys + 1)
        begin = 0
        if self.window > 0 and first - self.window + 1 > 0:
            begin = (first - self.window + 1) // self.q_keys
        return begin, max(begin, end)


@functools.lru_cache(maxsize=1024)
def _plan_backward(b, lq, lk, h, kv, d, dtype, causal, window, offsets):
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention backward: no kernel for {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention backward: head dim {d} not one "
                         f"of {HEAD_DIMS} (pad it)")
    if min(b, lq, lk, h, kv) < 1 or h % kv:
        raise ValueError(f"flash_attention backward: no plan for B {b}, Lq "
                         f"{lq}, Lk {lk}, H {h}, KV {kv}")
    base = dict(b=b, lq=lq, lk=lk, h=h, kv=kv, d=d, dtype=dtype,
                causal=bool(causal), window=int(window), offsets=offsets)
    if dtype == torch.bfloat16 and d >= 64:
        p = BwdPlan(**base, body="wgmma", kv_keys=BWD_WG_KEYS,
                    kv_rows=bwd_wg_rows(d), q_rows=BWD_WG_QROWS,
                    q_keys=bwd_wg_keys(d))
    else:
        p = BwdPlan(**base, body="fma", kv_keys=BWD_TILE, kv_rows=BWD_TILE,
                    q_rows=BWD_TILE, q_keys=BWD_TILE)
    if max(p.kv_grid[1], p.q_grid[1]) > MAX_GRID_Y:
        raise ValueError(f"flash_attention backward: B·H {b * h} exceeds "
                         "the grid")
    return p


def plan_backward(b: int, lq: int, lk: int, h: int, kv: int, d: int,
                  dtype: torch.dtype, *, causal: bool = True, window: int = 0,
                  q_offset: Offsets = None) -> BwdPlan:
    """The backward's plan: one per (dtype, head dim, masking), nothing
    that varies with B.  q (B, Lq, H, d) and k / v (B, Lk, KV, d) in
    ``dtype``, d a compiled head dim (the wrapper pads the others).
    ``q_offset``: the slots' offsets when the host knows them (for
    ``emulate_backward`` only).  Raises ``ValueError`` for a head dim,
    shape or grid no body takes (``TypeError`` for a dtype)."""
    return _plan_backward(b, lq, lk, h, kv, d, dtype, bool(causal),
                          int(window), _offsets(b, q_offset))


def _dot_rows(a, b):
    """(n, d) x (m, d) -> (n, m) fp32: each element's products summed over
    d in order, so it depends on its own two rows alone."""
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32)
    for i in range(a.shape[1]):
        out = out + a[:, i, None] * b[None, :, i]
    return out


def _scores(p: BwdPlan, qf, kf, qpos, kpos, lse, delta, dof, vf, *, scale,
            softcap):
    """One (query rows x keys) tile of the backward: P = exp(s - LSE) and
    dS = P ∘ (dP - Δ) (times 1 - tanh² under a soft cap) in fp32, masked
    entries 0.  Returns P rounded to the kernel's dtype (dV's operand, as
    the forward rounds it) and dS as the products read it: the wgmma body's
    bf16 (hi, lo) split, the fma body's fp32 (and None)."""
    s = _dot_rows(qf, kf) * scale
    t = None
    if softcap:
        t = _tanh(s / softcap)
        s = t * softcap
    ok = (kpos < p.lk)[None, :].expand(s.shape)
    if p.causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if p.window > 0:
        ok = ok & (kpos[None, :] > qpos[:, None] - p.window)
    pr = torch.where(ok, _exp(s - lse[:, None]), torch.zeros(()))
    dp = _dot_rows(dof, vf)
    ds = pr * (dp - delta[:, None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    if p.body != "wgmma":
        return pr.to(p.dtype).float(), ds, None
    hi = ds.to(p.dtype).float()
    return pr.to(p.dtype).float(), hi, (ds - hi).to(p.dtype).float()


def emulate_backward(p: BwdPlan, q, k, v, out, lse, dout, *, scale: float,
                     softcap: float = 0.0):
    """Plan ``p``'s backward in plain PyTorch, block by block in the
    kernel's order: q, out, dout (B, Lq, H, d), k / v (B, Lk, KV, d) as the
    kernel sees them, ``lse`` (B, H, Lq) from the forward.  Returns (dq, dk,
    dv) in q's dtype.  Needs ``p.offsets``."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if p.offsets is None:
        raise ValueError("flash_attention backward: emulation needs the "
                         "slots' offsets on the host")
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    delta = torch.zeros((b, h, lq), dtype=torch.float32)
    for i in range(d):
        delta = delta + (dof[..., i] * of[..., i]).transpose(1, 2)
    dq = torch.zeros((b, lq, h, d), dtype=torch.float32)
    dk = torch.zeros((b, lk, p.kv, d), dtype=torch.float32)
    dv = torch.zeros((b, lk, p.kv, d), dtype=torch.float32)
    kw = dict(scale=scale, softcap=softcap)
    # dK / dV: a block a (key tile, KV head, slot), the group's heads in
    # order, each head's query tiles in order
    for bi in range(b):
        off = p.offsets[bi]
        for kvh in range(p.kv):
            for k0 in range(0, lk, p.kv_keys):
                k1 = min(k0 + p.kv_keys, lk)
                kpos = torch.arange(k0, k1)
                acc_k = torch.zeros((k1 - k0, d))
                acc_v = torch.zeros((k1 - k0, d))
                t0, t1 = p.query_tiles(k0, off)
                for g in range(p.group):
                    hd = kvh * p.group + g
                    for t in range(t0, t1):
                        r0, r1 = t * p.kv_rows, min((t + 1) * p.kv_rows, lq)
                        qpos = off + torch.arange(r0, r1)
                        pr, ds, lo = _scores(
                            p, qf[bi, r0:r1, hd], kf[bi, k0:k1, kvh], qpos,
                            kpos, lse[bi, hd, r0:r1], delta[bi, hd, r0:r1],
                            dof[bi, r0:r1, hd], vf[bi, k0:k1, kvh], **kw)
                        for r in range(r1 - r0):
                            acc_v = acc_v + pr[r, :, None] * dof[bi, r0 + r,
                                                                 hd][None]
                            acc_k = acc_k + ds[r, :, None] * qf[bi, r0 + r,
                                                                hd][None]
                        for r in range(r1 - r0 if lo is not None else 0):
                            acc_k = acc_k + lo[r, :, None] * qf[bi, r0 + r,
                                                                hd][None]
                # the rows that see no key: P = 1/Lk on every key, dS = 0;
                # their Σ dO/Lk (heads in order, then rows) added at the end
                x, y = p.dead_rows(off)
                dead = torch.zeros(d)
                inv = torch.tensor(1.0 / lk, dtype=torch.float32)
                for g in range(p.group):
                    for r in list(range(x)) + list(range(y, lq)):
                        dead = dead + dof[bi, r, kvh * p.group + g] * inv
                acc_v = acc_v + dead[None]
                dk[bi, k0:k1, kvh] = acc_k * scale
                dv[bi, k0:k1, kvh] = acc_v
    # dQ: a block a (query tile, head, slot) over its key tiles in order
    for bi in range(b):
        off = p.offsets[bi]
        for hd in range(h):
            kvh = hd // p.group
            for q0 in range(0, lq, p.q_rows):
                q1 = min(q0 + p.q_rows, lq)
                qpos = off + torch.arange(q0, q1)
                acc = torch.zeros((q1 - q0, d))
                t0, t1 = p.key_tiles(q0, off)
                for t in range(t0, t1):
                    k0, k1 = t * p.q_keys, min((t + 1) * p.q_keys, lk)
                    _, ds, lo = _scores(
                        p, qf[bi, q0:q1, hd], kf[bi, k0:k1, kvh], qpos,
                        torch.arange(k0, k1), lse[bi, hd, q0:q1],
                        delta[bi, hd, q0:q1], dof[bi, q0:q1, hd],
                        vf[bi, k0:k1, kvh], **kw)
                    for j in range(k1 - k0):
                        acc = acc + ds[:, j, None] * kf[bi, k0 + j, kvh][None]
                    for j in range(k1 - k0 if lo is not None else 0):
                        acc = acc + lo[:, j, None] * kf[bi, k0 + j, kvh][None]
                dq[bi, q0:q1, hd] = acc * scale
    dt = q.dtype
    return dq.to(dt), dk.to(dt), dv.to(dt)


def launch_backward(p: BwdPlan, q, k, v, o, lse, dout, dq, dk, dv, delta,
                    q_off, q_off0: int, *, scale: float,
                    softcap: float) -> None:
    """Run the backward plan ``p``: q, o, dout, dq (B, Lq, H, d); k, v, dk,
    dv (B, Lk, KV, d), all contiguous in ``p.dtype``; ``lse`` (B, H, Lq)
    fp32 from the forward; ``delta`` (B, H, Lq) fp32 scratch.  ``dq`` None
    skips the dQ pass, ``dk`` / ``dv`` None the dK/dV pass (both or
    neither)."""
    if (dk is None) != (dv is None):
        raise ValueError("flash_attention backward: dk and dv come together")
    passes = (1 if dq is not None else 0) | (2 if dk is not None else 0)
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), ptr(dq), ptr(dk), ptr(dv),
        delta.data_ptr(), ptr(q_off), int(q_off0), p.b, p.lq, p.lk, p.h,
        p.kv, p.d, int(p.causal), int(p.window), float(scale),
        float(softcap), DTYPES[p.dtype], BWD_BODIES.index(p.body),
        p.kv_keys, p.kv_rows, p.q_rows, p.q_keys, passes, stream)
    build.check(rc, "flash_attention_bwd")
