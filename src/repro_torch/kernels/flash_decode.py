"""Launch plan, emulation and launcher of the latent-cache decode kernel
(``csrc/flash_decode.cu``).

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_decode.py::flash_decode`` (its ``pallas_call`` at
:120, body ``_kernel`` at :39) and computes what its oracle computes
(``kernels/ref.py::flash_decode_ref``): one decode step against the
factorized latent KV cache, keys up-projected (l_k @ U_k per KV head) and
RoPE'd on chip, values absorbed (the context stays in (H, r_v) latent space
and U_v is applied at the end), all arithmetic in fp32.  U_k and U_v are
read in their stored (r, KV·D) fp32 layout.

Bound on the card: the key up-projection, 2·Σ_b len_b·r_k·KV·D flops
(``bound_flops``), over the bytes of the live latents and the two factors.

The plan cuts every call into key spans of ``SPAN`` keys from absolute key
0, whatever B, L or the lengths: a work item is (slot, KV head, span), and
items at or past their slot's length exit at once (the lengths stay on the
device).  A slot's bits then depend on its own inputs alone.  A call is:

* ``body`` "wgmma" (bf16, D 64 / 96 / 112 / 128, r_k a multiple of
  ``RANK_MULTIPLE``: TMA's 16-byte row stride): U_k split into two bf16
  terms (hi + lo, ``split_factor``), then the keys on wgmma, K = l_k U_hi +
  l_k U_lo (D 112, kimi-k2's, and D 96, phi-3-vision's: U staged as two
  64-column boxes and multiplied as D 128's, the 16 / 32 extra columns
  never read); "fma" (fp32;
  bf16 at D 8 / 16 / 20 / 32 or other ranks): the keys on the FMA units
  from fp32 U_k.  Both write a span's fp32 (m, l, p[SPAN]) per query head;
* the values launch: each live span's latent partial Σ p l_v, one block a
  (ranks, heads, slot·span);
* the merge launch: ctx = Σ e^(m - M) partial / max(Σ l e^(m - M), 1e-20)
  over a slot's spans in order;
* the output launch: out = ctx U_v[:, head], one block a (column block, KV
  head) over all slots, the ranks split over thread groups added in order.

Callers go through ``kernels.ops.flash_decode``, which checks the mixed
dtypes and shapes; ``emulate`` repeats a plan's arithmetic in plain PyTorch
for the CPU tests.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _exp

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("fma", "wgmma")       # index = the launcher's body code

# head dims the kernel is compiled for (8 and 20: granite's and phi3-medium's
# smoke configs, 96 phi-3-vision's, 112 kimi-k2's; RoPE pairs the true dims,
# so none is padded)
HEAD_DIMS = (8, 16, 20, 32, 64, 96, 112, 128)
WGMMA_HEAD_DIMS = (64, 96, 112, 128)
SPAN = 256                      # keys a work item, from absolute key 0
RANK_MULTIPLE = 8               # the wgmma body's r_k: 16-byte bf16 rows
MAX_SMEM = 232448               # bytes of shared memory one block may use
ALIGN_FLOATS = 64               # scratch regions start 256 bytes apart
# wgmma body: ranks a ring stage, stages by D
WG_RANKS = 64
WG_STAGES = {64: 4, 96: 3, 112: 3, 128: 3}
# fma body: keys a tile, ranks a shared-memory chunk
FMA_KEYS = 64
FMA_RANKS = 32


def smem_bytes(body: str, g: int, d: int) -> int:
    """Shared memory of one keys block with ``g`` query heads a KV head
    (mirrors ``kw::Cfg::smem`` / ``kf::smem`` in the .cu).  A stage of the
    wgmma body holds the span's l_k tile and ⌈D/64⌉ 64-column boxes of each
    U term (D 96 and 112: two, the second's last 32 / 16 columns unused)."""
    if body == "wgmma":
        stage = SPAN * 128 + 2 * (-(-d // 64)) * WG_RANKS * 128
        stages = WG_STAGES[d]
        return 1024 + stages * stage + 4 * g * (d + SPAN) + 16 * stages
    return 4 * (FMA_RANKS * d + FMA_RANKS * (FMA_KEYS + 1) + g * d
                + FMA_KEYS * (d + 1) + g * SPAN)


def _round(n: int) -> int:
    return -(-n // ALIGN_FLOATS) * ALIGN_FLOATS


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs: q (B, H, D), lk (B, L, r_k), lv (B, L, r_v) in
    ``dtype``; ``body`` of the keys launch, ``span`` its keys a work
    item."""
    b: int
    l: int
    h: int
    kv: int
    d: int
    rk: int
    rv: int
    dtype: torch.dtype
    body: str
    span: int

    @property
    def group(self) -> int:
        return self.h // self.kv

    @property
    def spans(self) -> int:
        """Spans a slot may have: ⌈L / span⌉."""
        return -(-self.l // self.span)

    @property
    def grid(self) -> int:
        """Blocks of the keys launch, one a work item, live or not."""
        return self.b * self.spans * self.kv

    @property
    def smem(self) -> int:
        return smem_bytes(self.body, self.group, self.d)

    @property
    def offsets(self) -> Dict[str, int]:
        """Scratch regions (fp32 offsets): U_k's two bf16 terms (wgmma),
        then m and l (B·H·spans each), p (B·H·spans·span), the latent
        partials pv (B·H·spans·r_v), ctx (B·H·r_v), and the total
        ("end")."""
        rows = self.b * self.h * self.spans
        u = self.rk * self.kv * self.d if self.body == "wgmma" else 0
        out = {"u": 0, "m": _round(u)}
        out["l"] = out["m"] + _round(rows)
        out["p"] = out["l"] + _round(rows)
        out["pv"] = out["p"] + _round(rows * self.span)
        out["ctx"] = out["pv"] + _round(rows * self.rv)
        out["end"] = out["ctx"] + _round(self.b * self.h * self.rv)
        return out

    @property
    def scratch_floats(self) -> int:
        return self.offsets["end"]

    def item_at(self, w: int) -> Tuple[int, int, int]:
        """Block ``w`` of the keys launch as the kernel maps it: (slot,
        span, KV head), KV head fastest, then span, then slot."""
        if not 0 <= w < self.grid:
            raise IndexError(f"block {w} past the {self.grid} of the launch")
        return w // self.kv // self.spans, (w // self.kv) % self.spans, \
            w % self.kv

    def items(self, lengths: Sequence[int]) -> List[Tuple[int, int, int, int,
                                                          int]]:
        """The work items that run, in launch order: (slot, KV head, span,
        first key, end key), the span's live keys [first, end) of a slot
        whose length (clamped to [0, L]) is ``lengths[slot]``."""
        lens = [min(max(int(n), 0), self.l) for n in lengths]
        out = []
        for w in range(self.grid):
            bi, sp, kvh = self.item_at(w)
            k0 = sp * self.span
            if k0 < lens[bi]:
                out.append((bi, kvh, sp, k0, min(lens[bi], k0 + self.span)))
        return out


@functools.lru_cache(maxsize=1024)
def plan(b: int, l: int, h: int, kv: int, d: int, rk: int, rv: int,
         dtype: torch.dtype) -> Plan:
    """The launch plan of one call.  The span is ``SPAN`` whatever the
    shapes; the body follows from the dtype, D and r_k.  Raises on what no
    body takes."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_decode: no kernel for {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {d} has no kernel (RoPE "
                         f"pairs the true dims, so it is not padded); "
                         f"compiled: {HEAD_DIMS}")
    if min(b, l, h, kv, rk, rv) < 1 or h % kv:
        raise ValueError(f"flash_decode: no plan for B {b}, L {l}, H {h}, "
                         f"KV {kv}, r_k {rk}, r_v {rv}")
    wgmma = (dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS
             and rk % RANK_MULTIPLE == 0)
    p = Plan(b=b, l=l, h=h, kv=kv, d=d, rk=rk, rv=rv, dtype=dtype,
             body="wgmma" if wgmma else "fma", span=SPAN)
    if p.smem > MAX_SMEM:
        raise ValueError(f"flash_decode: the {p.body} body needs {p.smem} "
                         f"bytes of shared memory for {p.group} query heads "
                         f"a KV head at D {d}, over {MAX_SMEM}")
    if p.grid > 2**31 - 1 or b * p.spans > 65535 or kv > 65535:
        raise ValueError(f"flash_decode: B {b} x {p.spans} spans x KV {kv} "
                         "exceeds the grid")
    return p


def bound_flops(lengths: Sequence[int], rk: int, kv: int, d: int) -> int:
    """Flops of the key up-projection (one pass), 2·Σ len·r_k·KV·D."""
    return 2 * sum(lengths) * rk * kv * d


# ---------------------------------------------------------------------------
# emulation: the plan's arithmetic in plain PyTorch, each element's result a
# function of its own inputs alone (elementwise fp32 products and sums in a
# fixed order, exp by flash_attention's fixed polynomial), so a slot's
# emulated bits do not depend on B, L or the other slots


def split_factor(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wgmma body's two bf16 terms of an fp32 factor: hi the nearest
    bf16, lo the nearest bf16 to the rest (``fdec_split_u``)."""
    hi = u.to(torch.bfloat16)
    lo = (u - hi.float()).to(torch.bfloat16)
    return hi, lo


def _keys(p: Plan, lk, terms, cols, k0, k1):
    """(k1 - k0, D) fp32 up-projected keys of rows [k0, k1) of one slot's
    l_k: each term's products added rank by rank, chunk by chunk (the wgmma
    body issues a chunk's hi then lo products)."""
    lkf = lk[k0:k1].float()
    out = torch.zeros((k1 - k0, p.d), dtype=torch.float32)
    chunk = WG_RANKS if p.body == "wgmma" else p.rk
    for r0 in range(0, p.rk, chunk):
        for t in terms:
            for r in range(r0, min(p.rk, r0 + chunk)):
                out = out + lkf[:, r, None] * t[None, r, cols]
    return out


def emulate(p: Plan, q, lk, lv, uk, uv, lengths, cos, sin, *,
            rope: bool = True):
    """Plan ``p``'s work on CPU tensors of the kernel's contract; returns
    (B, H, D) in q's dtype.  The keys launch item by item (the span's live
    keys up-projected, RoPE'd, scored and soft-maxed into (m, l, p)), each
    span's latent partial Σ p l_v, the partials merged in span order, then
    U_v."""
    lens = [min(max(int(n), 0), p.l) for n in lengths.tolist()]
    d, g, half = p.d, p.group, p.d // 2
    uk = uk.float()
    terms = ([t.float() for t in split_factor(uk)] if p.body == "wgmma"
             else [uk])
    m = torch.zeros((p.b, p.h, p.spans))
    lsum = torch.zeros((p.b, p.h, p.spans))
    prob = torch.zeros((p.b, p.h, p.spans, p.span))
    for bi, kvh, sp, k0, k1 in p.items(lens):
        k = _keys(p, lk[bi], terms, slice(kvh * d, (kvh + 1) * d), k0, k1)
        if rope:
            c, s = cos[k0:k1].float(), sin[k0:k1].float()
            x1, x2 = k[:, :half], k[:, half:]
            k = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=1)
        for j in range(g):
            h = kvh * g + j
            qf = q[bi, h].float()
            score = torch.zeros(k1 - k0)
            for i in range(d):
                score = score + qf[i] * k[:, i]
            score = score / math.sqrt(d)
            mx = score.max()
            e = _exp(score - mx)
            total = torch.zeros(())
            for x in e:
                total = total + x
            m[bi, h, sp], lsum[bi, h, sp] = mx, total
            prob[bi, h, sp, :k1 - k0] = e
    ctx = torch.zeros((p.b, p.h, p.rv))
    for bi in range(p.b):
        nsp = -(-lens[bi] // p.span)
        if nsp == 0:
            continue
        mx = m[bi, :, :nsp].amax(-1)                            # (H,)
        den = torch.zeros(p.h)
        for sp in range(nsp):
            den = den + lsum[bi, :, sp] * _exp(m[bi, :, sp] - mx)
        acc = torch.zeros((p.h, p.rv))
        for sp in range(nsp):
            part = torch.zeros((p.h, p.rv))
            k0 = sp * p.span
            for key in range(k0, min(lens[bi], k0 + p.span)):
                part = part + (prob[bi, :, sp, key - k0, None]
                               * lv[bi, key].float()[None])
            acc = acc + part * _exp(m[bi, :, sp] - mx)[:, None]
        ctx[bi] = acc / torch.clamp(den, min=1e-20)[:, None]
    heads = torch.arange(p.h) // g
    uvh = uv.float().reshape(p.rv, p.kv, d)[:, heads]           # (r_v, H, D)
    out = torch.zeros((p.b, p.h, d))
    for r in range(p.rv):
        out = out + ctx[:, :, r, None] * uvh[r][None]
    return out.to(q.dtype)


def launch(p: Plan, q, lk, lv, uk, uv, lengths, cos, sin, out, scratch, *,
           rope: bool) -> None:
    """Run plan ``p``: q, out (B, H, D); lk/lv (B, L, r); uk/uv (r, KV·D)
    fp32; lengths (B,) int32; cos/sin (L, D/2) fp32 — all checked by the
    wrapper; ``scratch`` ``p.scratch_floats`` fp32."""
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_decode_launch(
        q.data_ptr(), lk.data_ptr(), lv.data_ptr(), uk.data_ptr(),
        uv.data_ptr(), lengths.data_ptr(),
        cos.data_ptr() if rope else None, sin.data_ptr() if rope else None,
        out.data_ptr(), scratch.data_ptr(), scratch.numel(), p.b, p.l, p.h,
        p.kv, p.d, p.rk, p.rv, int(rope), DTYPES[p.dtype],
        BODIES.index(p.body), p.span, p.spans, stream)
    build.check(rc, "flash_decode")
