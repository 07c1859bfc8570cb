"""The launch plan of the port's flash attention
(``repro_torch/kernels/flash_attention.py``): which body a call takes, the
blocks of the tile bodies and the key tiles each walks, the split body's key
spans, the launcher's refusals, and a plain-PyTorch emulation of the
kernel's work block by block, held to the port's plain version, to the JAX
package's kernel in Pallas interpret mode and to its model path's
``flash_attention`` (the kernel's oracle).

The CUDA bodies run only on the card; ``chip_smoke.py`` holds each against
the plain version there at the main paths' shapes.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

BF16, F32 = torch.bfloat16, torch.float32

# (name, B, Lq, Lk, H, KV, D, dtype, causal, window, offsets, invariant)
CASES = [
    ("prefill", 1, 300, 300, 2, 2, 128, BF16, True, 0, 0, False),
    ("chunk", 2, 40, 520, 4, 2, 64, BF16, True, 0, [130, 384], False),
    ("mla", 2, 130, 130, 2, 2, 192, BF16, True, 0, 0, False),
    ("window", 1, 333, 333, 2, 1, 64, BF16, True, 100, 0, False),
    ("noncausal_ragged", 1, 77, 200, 2, 2, 128, BF16, False, 0, 0, False),
    ("wmma", 2, 77, 77, 4, 2, 16, BF16, True, 16, 0, False),
    ("fma32", 2, 70, 140, 4, 4, 32, F32, True, 0, [3, 70], False),
    ("decode", 3, 1, 300, 4, 2, 64, BF16, True, 0, [0, 150, 299], False),
    ("decode_window", 3, 1, 300, 4, 4, 128, F32, True, 50, [10, 150, 299],
     False),
    ("decode_invariant", 3, 1, 300, 4, 2, 64, BF16, True, 0, [0, 150, 299],
     True),
    ("decode_fma32_invariant", 2, 1, 90, 2, 2, 16, F32, True, 0, [5, 89],
     True),
    # gemma3's head dim 256: a window, GQA g 4 and per-slot offsets in each
    # body (wgmma with 64-key tiles, fma32 with 32-key tiles, split)
    ("d256_window", 2, 70, 150, 4, 1, 256, BF16, True, 40, [10, 80], False),
    ("d256_fma32", 2, 70, 150, 4, 1, 256, F32, True, 40, [10, 80], False),
    ("d256_decode", 3, 1, 150, 4, 1, 256, BF16, True, 64, [0, 70, 149],
     False),
    ("d256_decode_f32", 3, 1, 150, 4, 1, 256, F32, True, 64, [0, 70, 149],
     False),
    # head dims 112 (kimi-k2 with GQA, zamba2) and 96 (phi-3-vision) at
    # their true width in each body: wgmma (a window, Lk not a multiple of
    # the 128-key tile), the fp32 tile body, and split in both dtypes
    ("d112_gqa", 2, 130, 150, 8, 2, 112, BF16, True, 0, [0, 20], False),
    ("d96_window", 1, 200, 200, 2, 2, 96, BF16, True, 50, 0, False),
    ("d112_fma32", 2, 70, 140, 4, 2, 112, F32, True, 0, [3, 70], False),
    ("d96_decode", 3, 1, 300, 4, 4, 96, BF16, True, 0, [0, 150, 299],
     False),
    ("d112_decode_f32", 3, 1, 300, 8, 2, 112, F32, True, 64, [10, 150, 299],
     False),
    # the tensor-core GQA decode (split_mma): groups of 2, 4, 8 and 16
    # query heads at each of its head dims, per-slot offsets (one slot's
    # first span holds no live key under the window), a window, Lk not a
    # multiple of the tile, a soft cap on the names in SOFTCAP
    ("mma_g2_d128", 3, 1, 300, 4, 2, 128, BF16, True, 0, [0, 150, 299],
     False),
    ("mma_g4_d256_window", 3, 1, 333, 4, 1, 256, BF16, True, 100,
     [5, 200, 332], False),
    ("mma_g8_d112", 2, 1, 300, 16, 2, 112, BF16, True, 0, [77, 299], False),
    ("mma_g16_d64", 2, 1, 290, 16, 1, 64, BF16, True, 0, [0, 289], False),
    ("mma_g4_d96", 2, 1, 300, 8, 2, 96, BF16, False, 0, [0, 0], False),
    ("mma_g2_d192", 2, 1, 150, 4, 2, 192, BF16, True, 40, [149, 60], False),
    ("mma_g8_d256", 1, 1, 200, 8, 1, 256, BF16, True, 0, [199], False),
    # the wgmma body at D 64 (its two warpgroups taking turns) and D 256:
    # whisper's non-causal calls with Lq over one block and Lk 333 (no
    # multiple of a tile), its decoder's causal self-attention with
    # per-slot offsets (the last block's second warpgroup holds 8 rows);
    # gemma3's causal and windowed prefill with Lq under one warpgroup, and
    # rows that end mid-warpgroup
    ("d64_noncausal", 1, 300, 333, 2, 2, 64, BF16, False, 0, 0, False),
    ("d64_causal_offsets", 3, 200, 333, 2, 2, 64, BF16, True, 0,
     [0, 66, 133], False),
    ("d256_short", 2, 40, 77, 4, 1, 256, BF16, True, 0, [0, 37], False),
    ("d256_window_mid", 2, 100, 333, 4, 1, 256, BF16, True, 64, [3, 233],
     False),
]
# cases the emulation runs with a soft cap of 30
SOFTCAP = ("wmma", "decode_window", "mma_g2_d128", "mma_g8_d112",
           "mma_g16_d64", "d256_window_mid")
# the wgmma body's D-64 and D-256 cases
WG_CASES = [c for c in CASES if c[0].startswith(("d64_", "d256_short",
                                                  "d256_window"))]
TILE_CASES = [c for c in CASES if not (c[2] == 1 and not c[11])]
SPLIT_CASES = [c for c in CASES if c[2] == 1 and not c[11]]


def _plan(case):
    _, b, lq, lk, h, kv, d, dtype, causal, window, off, inv = case
    return fa.plan(b, lq, lk, h, kv, d, dtype, causal=causal, window=window,
                   q_offset=off, invariant=inv)


def _live(p, pos, key):
    """Whether ``key`` is live for a query at absolute position ``pos``."""
    ok = key < p.lk
    if p.causal:
        ok = ok and key <= pos
    if p.window > 0:
        ok = ok and key > pos - p.window
    return ok


def _inputs(rng, b, lq, lk, h, kv, d, dtype):
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(dtype) for s in ((b, lq, h, d), (b, lk, kv, d),
                                    (b, lk, kv, d)))
    return q, k, v


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_plan_bodies_and_tiles():
    # the body follows dtype, head dim, Lq and batch_invariant; tile widths
    # are fixed per D, so a row's bits never depend on the call's shape
    assert fa.plan(1, 1024, 1024, 32, 32, 128, BF16).body == "wgmma"
    assert fa.plan(1, 1024, 1024, 32, 32, 128, BF16).bkey == 128
    assert fa.plan(4, 1024, 1024, 16, 16, 192, BF16).bkey == 64
    # head dim 256 (gemma3): wgmma with 64-key tiles in bf16, the fp32 tile
    # body with 32-key tiles (its 64-key tiles would not fit shared memory)
    assert fa.plan(4, 1024, 1024, 4, 1, 256, BF16).body == "wgmma"
    assert fa.plan(4, 1024, 1024, 4, 1, 256, BF16).bkey == 64
    assert fa.plan(4, 1024, 1024, 4, 1, 256, F32).body == "fma32"
    assert fa.plan(4, 1024, 1024, 4, 1, 256, F32).bkey == 32
    # head dims 112 and 96 have bodies of their own: wgmma with 128-key
    # tiles in bf16 (kimi-k2's GQA, zamba2, phi-3-vision), fp32's tile body
    for h, kv, d in ((64, 8, 112), (32, 32, 112), (32, 32, 96)):
        p = fa.plan(4, 1024, 1024, h, kv, d, BF16)
        assert (p.body, p.bkey, p.d) == ("wgmma", 128, d)
        assert fa.plan(4, 1024, 1024, h, kv, d, F32).body == "fma32"
    assert fa.plan(4, 1024, 1024, 4, 1, 128, F32).bkey == 64
    assert fa.plan(1, 8, 2048, 32, 32, 64, BF16).bq == 128
    assert fa.plan(2, 77, 77, 4, 2, 32, BF16).body == "wmma"
    assert fa.plan(2, 77, 77, 4, 2, 128, F32).body == "fma32"
    for dtype in (BF16, F32):
        for d in fa.HEAD_DIMS:
            assert fa.plan(8, 1, 2048, 32, 32, d, dtype).body == "split"
            inv = fa.plan(8, 1, 2048, 32, 32, d, dtype, invariant=True)
            assert inv.body == ("wgmma" if dtype == BF16 and d >= 64
                                else "wmma" if dtype == BF16 else "fma32")
    # more query heads a KV head than the split body holds: a tile body
    assert fa.plan(2, 1, 64, 64, 2, 64, BF16).body == "wgmma"
    with pytest.raises(ValueError):
        fa.plan(1, 1, 64, 4, 4, 100, BF16)       # not a compiled head dim
    with pytest.raises(TypeError):
        fa.plan(1, 1, 64, 4, 4, 64, torch.float16)


@pytest.mark.parametrize("b,kv,lk", [(8, 32, 2048), (1, 1, 77), (2, 2, 300),
                                     (64, 32, 4096), (1, 32, 100000)])
def test_split_spans_fill_the_card(b, kv, lk):
    # spans are whole tiles, as long as the (slot, KV head, span) blocks
    # reach SPLIT_BLOCKS: want = ⌈SPLIT_BLOCKS / (B·KV)⌉ spans a row, each
    # ⌈Lk / want⌉ keys rounded up to a tile
    for dtype, d in ((BF16, 128), (F32, 128), (BF16, 192), (BF16, 16),
                     (BF16, 256), (F32, 256), (BF16, 112), (F32, 96)):
        p = fa.plan(b, 1, lk, kv, kv, d, dtype)
        want = -(-fa.SPLIT_BLOCKS // (b * kv))
        assert p.bkey == fa.split_keys(dtype, d)
        assert p.span == -(-(-(-lk // want)) // p.bkey) * p.bkey
        assert p.spans == -(-lk // p.span) <= want
        assert p.grid == p.spans * b * kv
        assert p.scratch_floats == b * kv * p.spans * (d + 2)
    # llama-7b's dense-cache decode: 5 spans of 448 keys, 1280 blocks
    p = fa.plan(8, 1, 2048, 32, 32, 128, BF16)
    assert (p.span, p.spans, p.grid) == (448, 5, 1280)


@pytest.mark.parametrize("case", TILE_CASES, ids=[c[0] for c in TILE_CASES])
def test_blocks_cover_every_row_once(case):
    p = _plan(case)
    seen = np.zeros((p.b, p.lq, p.h), dtype=np.int64)
    for bi, hd, q0, t0, t1 in p.blocks():
        assert 0 <= q0 < p.lq and q0 % p.bq == 0
        seen[bi, q0:q0 + p.bq, hd] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("case", TILE_CASES, ids=[c[0] for c in TILE_CASES])
def test_skipped_tiles_hold_no_live_key(case):
    # causal, window, Lk padding and per-slot offsets: every key tile a
    # block skips holds no live key for any of its rows, and every live key
    # of its rows lies in the tiles it walks
    p = _plan(case)
    n_tiles = -(-p.lk // p.bkey)
    for bi, hd, q0, t0, t1 in p.blocks():
        assert 0 <= t0 <= t1 <= n_tiles
        for r in range(q0, min(q0 + p.bq, p.lq)):
            pos = p.offsets[bi] + r
            live = [key for key in range(p.lk) if _live(p, pos, key)]
            assert all(t0 * p.bkey <= key < t1 * p.bkey for key in live)


@pytest.mark.parametrize("case", TILE_CASES, ids=[c[0] for c in TILE_CASES])
def test_tile_at_is_the_launch_order(case):
    # wgmma: heads innermost and the last (longest causal) query block
    # first; fma32 / wmma: grid (query blocks, B·H)
    p = _plan(case)
    order = [p.tile_at(w) for w in range(p.grid)]
    assert len(set(order)) == p.grid
    if p.body == "wgmma":
        assert [q0 for _, _, q0 in order] == sorted(
            (q0 for _, _, q0 in order), reverse=True)
        assert order[:p.b * p.h] == [(bi, hd, (p.q_blocks - 1) * p.bq)
                                     for bi in range(p.b)
                                     for hd in range(p.h)]
    else:
        assert order[:p.q_blocks] == [(0, 0, qb * p.bq)
                                      for qb in range(p.q_blocks)]
    with pytest.raises(IndexError):
        p.tile_at(p.grid)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_spans_cover_live_keys_once_in_order(case):
    p = _plan(case)
    assert p.body in fa.SPLIT_BODIES and p.grid == p.spans * p.b * p.kv
    got = {}
    for bi, kvh, sp, k0, k1 in p.blocks():
        assert 0 <= sp < p.spans
        if k0 < k1:
            assert sp * p.span <= k0 < k1 <= (sp + 1) * p.span
            got.setdefault((bi, kvh), []).append((sp, k0, k1))
    for bi in range(p.b):
        live = [key for key in range(p.lk) if _live(p, p.offsets[bi], key)]
        for kvh in range(p.kv):
            spans = got.get((bi, kvh), [])
            assert [s[0] for s in spans] == sorted(s[0] for s in spans)
            keys = [key for _, k0, k1 in spans for key in range(k0, k1)]
            assert keys == live


def _launcher_accepts(p: fa.Plan) -> bool:
    """csrc/flash_attention.cu's flash_attention_launch checks, mirrored."""
    d, h, kv = p.d, p.h, p.kv
    if (min(p.b, p.lq, p.lk, kv) <= 0 or h % kv
            or d not in (16, 32, 64, 96, 112, 128, 192, 256)):
        return False
    heads = p.b * h
    body = fa.BODIES.index(p.body)
    scratch = p.scratch_floats > 0
    if body in (0, 1):
        ok = (p.dtype == F32) if body == 0 else (p.dtype == BF16 and d <= 32)
        return (ok and p.bq == 64 and p.bkey == (32 if d == 256 else 64)
                and p.span == 0
                and p.spans == 0 and not scratch and heads <= 65535)
    if body == 2:
        return (p.dtype == BF16 and d >= 64 and p.bq == 128
                and p.bkey == (128 if d <= 128 else 64) and p.span == 0
                and p.spans == 0 and not scratch
                and -(-p.lq // 128) * heads <= 2**31 - 1)
    if body not in (3, 4):
        return False
    if body == 4:
        bk = 64 if d <= 128 else 32
    else:
        bk = 64 if d * (2 if p.dtype == BF16 else 4) <= 256 else 32
    ok = (p.lq == 1 and h // kv <= 16 and p.bq == 1 and p.bkey == bk
          and p.span > 0 and p.span % bk == 0
          and p.spans == -(-p.lk // p.span) and scratch
          and p.b * kv <= 65535 and heads <= 2**31 - 1)
    if body == 4:
        ok = ok and p.dtype == BF16 and d >= 64 and h // kv >= 2
    return ok


PLANS = [_plan(c) for c in CASES] + [
    fa.plan(8, 1, 2048, 32, 32, 128, BF16),
    fa.plan(8, 1, 2048, 32, 32, 128, F32),
    fa.plan(1, 1024, 1024, 32, 32, 128, BF16),
    fa.plan(4, 1024, 1024, 16, 16, 192, BF16),
    fa.plan(1, 256, 2048, 32, 32, 128, BF16),
    fa.plan(4, 1024, 1024, 16, 16, 192, F32),
    # gemma3 at its published widths: local / global prefill, the Server's
    # prompts, decode over the global layers' dense cache
    fa.plan(4, 1024, 1024, 4, 1, 256, BF16, window=512),
    fa.plan(8, 512, 512, 4, 1, 256, BF16, window=512),
    fa.plan(8, 1, 2048, 4, 1, 256, BF16),
    fa.plan(4, 1024, 1024, 4, 1, 256, F32, window=512),
    # kimi-k2 (D 112, 64 query heads on 8 KV heads), zamba2's shared block
    # (D 112 MHA) and phi-3-vision (D 96 MHA) at their true width: a
    # compression microbatch's prefill and decode over 8 slots' dense
    # cache, in bf16 and fp32
    fa.plan(4, 1024, 1024, 64, 8, 112, BF16),
    fa.plan(8, 1, 2048, 64, 8, 112, BF16),
    fa.plan(8, 1, 2048, 64, 8, 112, F32),
    fa.plan(4, 1024, 1024, 32, 32, 112, BF16),
    fa.plan(4, 1024, 1024, 32, 32, 112, F32),
    fa.plan(8, 1, 2048, 32, 32, 112, BF16),
    fa.plan(8, 1, 2048, 32, 32, 112, F32),
    fa.plan(4, 1024, 1024, 32, 32, 96, BF16),
    fa.plan(4, 1024, 1024, 32, 32, 96, F32),
    fa.plan(8, 1, 2048, 32, 32, 96, BF16),
    fa.plan(8, 1, 2048, 32, 32, 96, F32),
]


@pytest.mark.parametrize("i", range(len(PLANS)))
def test_launcher_accepts_every_plan(i):
    assert _launcher_accepts(PLANS[i])


_WG = fa.plan(1, 300, 300, 4, 2, 128, BF16)
_F32 = fa.plan(1, 300, 300, 4, 2, 128, F32)
# one query head a KV head: the FMA split body (a GQA group takes split_mma)
_SPLIT = fa.plan(2, 1, 300, 2, 2, 64, BF16)
_MMA = fa.plan(2, 1, 300, 4, 2, 64, BF16)
_MMA256 = fa.plan(2, 1, 300, 4, 1, 256, BF16)
_WG64 = fa.plan(4, 1500, 1500, 8, 8, 64, BF16, causal=False)
_WG256 = fa.plan(4, 1024, 1024, 4, 1, 256, BF16)
REFUSED = {
    "wgmma_fp32": dataclasses.replace(_WG, dtype=F32),
    "wgmma_narrow_tile": dataclasses.replace(_WG, bkey=64),
    "wgmma_rows": dataclasses.replace(_WG, bq=64),
    "wgmma_d32": dataclasses.replace(_WG, d=32),
    "wgmma_split_fields": dataclasses.replace(_WG, span=448, spans=1),
    # blocks of two warpgroups, 128-key tiles at D 64 and 64-key at D 256
    "wgmma_d64_rows": dataclasses.replace(_WG64, bq=64),
    "wgmma_d64_tile": dataclasses.replace(_WG64, bkey=64),
    "wgmma_d256_rows": dataclasses.replace(_WG256, bq=64),
    "wgmma_d256_tile": dataclasses.replace(_WG256, bkey=32),
    "wgmma_d256_fp32": dataclasses.replace(_WG256, dtype=F32),
    "fma32_bf16": dataclasses.replace(_F32, dtype=BF16),
    "fma32_tile": dataclasses.replace(_F32, bkey=128),
    # D 256's fp32 tiles are 32 keys wide: 64 would overflow shared memory
    "fma32_d256_tile": dataclasses.replace(
        fa.plan(1, 300, 300, 4, 1, 256, F32), bkey=64),
    "wmma_d128": dataclasses.replace(_F32, dtype=BF16, body="wmma"),
    "head_dim": dataclasses.replace(_WG, d=80),
    "heads": dataclasses.replace(_WG, kv=3),
    "split_span": dataclasses.replace(_SPLIT, span=_SPLIT.span + 1),
    "split_spans": dataclasses.replace(_SPLIT, spans=_SPLIT.spans + 1),
    "split_tile": dataclasses.replace(_SPLIT, bkey=32),
    "split_rows": dataclasses.replace(_SPLIT, lq=2),
    "split_group": dataclasses.replace(_SPLIT, h=68, kv=4),
    # fp32 rows of 512 bytes: the split tile holds 32 keys
    "split_fp32_tile": dataclasses.replace(
        fa.plan(2, 1, 300, 4, 2, 128, F32), bkey=64),
    # split_mma: its tile is 64 keys at D <= 128 and 32 above, bf16 alone,
    # head dims from 64, groups of 2 to 16, one query row
    "split_mma_tile": dataclasses.replace(_MMA, bkey=32),
    "split_mma_d256_tile": dataclasses.replace(_MMA256, bkey=64),
    "split_mma_span": dataclasses.replace(_MMA, span=_MMA.span + 1),
    "split_mma_spans": dataclasses.replace(_MMA, spans=_MMA.spans + 1),
    "split_mma_rows": dataclasses.replace(_MMA, lq=2),
    "split_mma_group_1": dataclasses.replace(_MMA, h=2),
    "split_mma_group_17": dataclasses.replace(_MMA, h=68, kv=4),
    "split_mma_fp32": dataclasses.replace(_MMA, dtype=F32),
    "split_mma_d32": dataclasses.replace(_MMA, d=32),
    "split_mma_scratch": dataclasses.replace(_MMA, spans=0, span=0),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_launcher_refuses_what_the_plan_never_makes(name):
    assert not _launcher_accepts(REFUSED[name])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulate_matches_plain(case):
    # the plan's arithmetic against the plain version: fp32 1e-5, bf16 1e-2
    # relative Frobenius (the chip's limits)
    _, b, lq, lk, h, kv, d, dtype, causal, window, off, _ = case
    p = _plan(case)
    rng = np.random.default_rng(d + lq + lk)
    q, k, v = _inputs(rng, b, lq, lk, h, kv, d, dtype)
    softcap = 30.0 if case[0] in SOFTCAP else 0.0
    got = fa.emulate(p, q, k, v, scale=1.0 / math.sqrt(d), softcap=softcap)
    toff = torch.tensor(off) if isinstance(off, list) else off
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=toff, softcap=softcap)
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel(got, want) <= (1e-5 if dtype == F32 else 1e-2)


@pytest.mark.parametrize("lq,lk,causal,window,d", [
    (64, 64, True, 0, 16), (64, 64, True, 24, 32), (50, 77, False, 0, 16),
    (77, 77, True, 0, 64), (1, 77, True, 0, 16), (64, 64, True, 16, 96),
    (50, 77, False, 0, 112), (1, 77, True, 0, 112),
    (150, 333, False, 0, 64), (140, 140, True, 0, 64),
    (40, 77, True, 0, 256), (100, 150, True, 64, 256)])
def test_emulate_matches_pallas(lq, lk, causal, window, d):
    # the JAX kernel in interpret mode in its (B, H, L, D) layout, fp32, at
    # q_offset 0 and no soft cap (which it lacks): rtol 1e-5, atol 1e-6;
    # from head dim 64 also the bf16 plan's blocks and tiles (the wgmma
    # body's) emulated in fp32
    rng = np.random.default_rng(lq + lk + d)
    b, h, kv = 2, 4, 2
    q, k, v = _inputs(rng, b, lq, lk, h, kv, d, F32)
    tr = (0, 2, 1, 3)
    want = jops.flash_attention(
        jnp.asarray(q.numpy().transpose(tr)),
        jnp.asarray(k.numpy().transpose(tr)),
        jnp.asarray(v.numpy().transpose(tr)), causal=causal, window=window,
        force_pallas=True, interpret=True)
    want = np.asarray(want).transpose(tr)
    p = fa.plan(b, lq, lk, h, kv, d, F32, causal=causal, window=window,
                q_offset=0)
    got = fa.emulate(p, q, k, v, scale=1.0 / math.sqrt(d))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if d >= 64 and lq > 1:
        pw = fa.plan(b, lq, lk, h, kv, d, BF16, causal=causal,
                     window=window, q_offset=0)
        assert pw.body == "wgmma"
        got = fa.emulate(dataclasses.replace(pw, dtype=F32), q, k, v,
                         scale=1.0 / math.sqrt(d))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d,causal,window", [
    (64, True, 0), (112, True, 0), (192, True, 0), (256, True, 0),
    (64, False, 0), (256, True, 100)],
    ids=["64", "112", "192", "256", "64-noncausal", "256-window100"])
def test_invariant_rows_do_not_depend_on_the_chunk(d, causal, window):
    # under batch_invariant a row's emulated bits are the same whether it
    # is computed inside Lq 1, 8, 256 or the whole prompt, at any block
    # start (bf16, the wgmma body; its key tiles start at absolute key 0):
    # causal, whisper's non-causal D 64 and gemma3's windowed D 256
    rng = np.random.default_rng(d)
    b, h, kv, l = 1, 1, 1, 1024 if d == 64 else 300 if d == 192 else 192
    q, k, v = _inputs(rng, b, l, l, h, kv, d, BF16)
    scale = 1.0 / math.sqrt(d)

    def run(q0, n):
        p = fa.plan(b, n, l, h, kv, d, BF16, causal=causal, window=window,
                    q_offset=q0, invariant=True)
        assert p.body == "wgmma"
        return fa.emulate(p, q[:, q0:q0 + n].contiguous(), k, v, scale=scale)

    whole = run(0, l)
    first = 256 if l >= 300 else 128
    for n, starts in ((first, (0, 44, l - first)), (8, (0, 100, l - 8)),
                      (1, (0, 77, 128, l - 1))):
        for q0 in starts:
            assert torch.equal(run(q0, n), whole[:, q0:q0 + n]), (n, q0)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_emulation_repeats_bitwise(case):
    _, b, lq, lk, h, kv, d, dtype, *_ = case
    p = _plan(case)
    rng = np.random.default_rng(7)
    q, k, v = _inputs(rng, b, lq, lk, h, kv, d, dtype)
    first = fa.emulate(p, q, k, v, scale=0.125)
    assert torch.equal(first, fa.emulate(p, q, k, v, scale=0.125))


def test_wrapper_launches_the_plan(monkeypatch):
    # a tensor off the CPU takes the kernel's route (meta: no data): the
    # wrapper hands the launcher the call's plan (batch_invariant chooses
    # by dtype and head dim alone), the head dim (the caller's where it is
    # compiled, else padded) and the split body's scratch, and counts the
    # launch by body
    seen = []
    monkeypatch.setattr(ops, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(ops, "_aligned", lambda a: a)
    monkeypatch.setattr(fa, "launch", lambda p, q, k, v, o, q_off, q_off0,
                        *, scale, softcap, scratch=None: seen.append(
                            (p, tuple(q.shape), tuple(o.shape), q_off, q_off0,
                             scale, None if scratch is None
                             else scratch.numel(), (q, k, v))))
    meta = dict(device="meta")
    ops.reset_launches()

    def call(b, lq, lk, h, kv, d, dtype, **kw):
        q = torch.zeros(b, lq, h, d, dtype=dtype, **meta)
        k = torch.zeros(b, lk, kv, d, dtype=dtype, **meta)
        v = torch.zeros(b, lk, kv, d, dtype=dtype, **meta)
        out = ops._flash_attention_kernel(q, k, v, kw.get("q_offset", 0),
                                          True, 0, 0.0)
        return out, (q, k, v)

    out, _ = call(1, 1024, 1024, 32, 32, 128, BF16)
    assert seen[-1][0] == fa.plan(1, 1024, 1024, 32, 32, 128, BF16)
    assert tuple(out.shape) == (1, 1024, 32, 128) and seen[-1][6] is None
    slots = torch.zeros(8, dtype=torch.int64, **meta)
    out, _ = call(8, 1, 2048, 32, 32, 128, BF16, q_offset=slots)
    p = fa.plan(8, 1, 2048, 32, 32, 128, BF16)
    assert seen[-1][0] == p and p.body == "split"
    assert seen[-1][3].dtype == torch.int32 and seen[-1][6] == p.scratch_floats
    with ops.batch_invariant():
        call(8, 1, 2048, 32, 32, 128, BF16, q_offset=slots)
    assert seen[-1][0].body == "wgmma" and seen[-1][0].invariant
    # head dim 100 has no body: padded to the next compiled one, 112
    out, _ = call(2, 9, 9, 4, 2, 100, F32, q_offset=3)
    assert seen[-1][0] == fa.plan(2, 9, 9, 4, 2, 112, F32)
    assert seen[-1][1] == (2, 9, 4, 112) and tuple(out.shape) == (2, 9, 4, 100)
    assert seen[-1][4] == 3 and seen[-1][5] == pytest.approx(0.1)
    # kimi-k2's D 112 prefill (64 query heads on 8 KV heads) and
    # phi-3-vision's D 96 split decode: the launcher gets the caller's own
    # tensors at their true head dim, no padded copy, and the output is the
    # kernel's (B, Lq, H, D) as it is
    out, qkv = call(4, 1024, 1024, 64, 8, 112, BF16)
    assert seen[-1][0] == fa.plan(4, 1024, 1024, 64, 8, 112, BF16)
    assert seen[-1][0].d == 112 and seen[-1][0].body == "wgmma"
    assert all(a is b for a, b in zip(seen[-1][7], qkv))
    assert tuple(out.shape) == seen[-1][2] == (4, 1024, 64, 112)
    assert seen[-1][5] == pytest.approx(1 / math.sqrt(112))
    out, qkv = call(8, 1, 2048, 32, 32, 96, BF16, q_offset=slots)
    p = fa.plan(8, 1, 2048, 32, 32, 96, BF16)
    assert seen[-1][0] == p and p.body == "split" and p.d == 96
    assert all(a is b for a, b in zip(seen[-1][7], qkv))
    assert seen[-1][6] == p.scratch_floats == 8 * 32 * p.spans * 98
    assert tuple(out.shape) == (8, 1, 32, 96)
    assert ops.LAUNCHES["flash_attention"] == 6
    assert dict(ops.FLASH_BODIES) == {"wgmma": 3, "split": 2, "fma32": 1}
    # gemma3's (4 on 1, D 256) and kimi-k2's (64 on 8, D 112) decode: the
    # tensor-core body with its scratch, counted apart from split
    for h, kv, d in ((4, 1, 256), (64, 8, 112)):
        out, qkv = call(8, 1, 2048, h, kv, d, BF16, q_offset=slots)
        p = fa.plan(8, 1, 2048, h, kv, d, BF16)
        assert seen[-1][0] == p and p.body == "split_mma"
        assert all(a is b for a, b in zip(seen[-1][7], qkv))
        assert seen[-1][6] == p.scratch_floats == 8 * h * p.spans * (d + 2)
        assert tuple(out.shape) == (8, 1, h, d)
    assert ops.LAUNCHES["flash_attention"] == 8
    assert dict(ops.FLASH_BODIES) == {"wgmma": 3, "split": 2, "fma32": 1,
                                      "split_mma": 2}


# ---------------------------------------------------------------------------
# split_mma: the tensor-core body of one-token GQA decode


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_split_mma_takes_bf16_groups_at_its_head_dims(d):
    # Lq 1 outside batch_invariant, bf16, D 64-256, 2 <= H / KV <= 16;
    # fp32, D 16 / 32 and g 1 keep the FMA split body; past 16 a tile body
    for g in range(1, 18):
        for dtype in (BF16, F32):
            p = fa.plan(8, 1, 2048, 2 * g, 2, d, dtype)
            if g > fa.SPLIT_MAX_GROUP:
                assert p.body not in fa.SPLIT_BODIES
            elif dtype == BF16 and d in fa.MMA_DIMS and g >= 2:
                assert (p.body, p.bkey) == ("split_mma", fa.mma_keys(d))
            else:
                assert p.body == "split"
            inv = fa.plan(8, 1, 2048, 2 * g, 2, d, dtype, invariant=True)
            assert inv.body not in fa.SPLIT_BODIES
    assert fa.plan(8, 2, 2048, 8, 2, d, BF16).body not in fa.SPLIT_BODIES


@pytest.mark.parametrize("b,kv,lk", [(8, 1, 2048), (8, 8, 2048), (1, 1, 77),
                                     (3, 2, 300), (64, 8, 4096),
                                     (1, 1, 100000)])
def test_split_mma_spans_aim_at_one_wave(b, kv, lk):
    # spans are whole tiles, at least MMA_MIN_TILES of them, and the
    # (slot, KV head, span) blocks reach about one wave of resident blocks
    for d in fa.MMA_DIMS:
        p = fa.plan(b, 1, lk, 4 * kv, kv, d, BF16)
        bk = fa.mma_keys(d)
        want = -(-fa.mma_wave(d) // (b * kv))
        assert p.body == "split_mma" and p.bkey == bk
        assert p.span == max(fa.MMA_MIN_TILES * bk,
                             -(-(-(-lk // want)) // bk) * bk)
        assert p.spans == -(-lk // p.span) <= max(want, 1)
        assert p.grid == p.spans * b * kv
        assert p.scratch_floats == b * 4 * kv * p.spans * (d + 2)
        # the block's shared memory fits a block, and the wave counts the
        # blocks a streaming multiprocessor holds by it
        assert fa.mma_smem(d) <= 227 * 1024
        assert fa.mma_wave(d) == fa.SMS * (fa.SM_SHARED
                                           // (fa.mma_smem(d) + 1024))


def test_split_mma_published_plans():
    # gemma3's global layer (4 on 1, D 256): 16 spans of 4 32-key tiles,
    # 128 blocks; kimi-k2 (64 on 8, D 112): 5 spans of 7 64-key tiles, 320
    # blocks; qwen3 (16 on 8, D 128): the same spans as kimi
    assert fa.mma_wave(256) == fa.mma_wave(112) == 2 * fa.SMS
    assert fa.mma_wave(64) == 3 * fa.SMS
    for args, want in (((8, 1, 2048, 4, 1, 256), (32, 128, 16, 128)),
                       ((8, 1, 2048, 64, 8, 112), (64, 448, 5, 320)),
                       ((8, 1, 2048, 16, 8, 128), (64, 448, 5, 320))):
        p = fa.plan(*args, BF16)
        assert p.body == "split_mma"
        assert (p.bkey, p.span, p.spans, p.grid) == want
        b, _, _, h, _, d = args
        assert p.scratch_floats == b * h * p.spans * (d + 2)


MMA_CASES = [c for c in CASES if c[0].startswith("mma_")]


@pytest.mark.parametrize("case", MMA_CASES, ids=[c[0] for c in MMA_CASES])
def test_split_mma_blocks_walk_each_live_key_once(case):
    # the launch order is (spans, B·KV), spans innermost; each block's tiles
    # of bkey keys from its first live key cover its span's live keys once
    p = _plan(case)
    assert p.body == "split_mma"
    order = [p.tile_at(w) for w in range(p.grid)]
    assert order == [(bi, kvh, sp) for bi in range(p.b)
                     for kvh in range(p.kv) for sp in range(p.spans)]
    for bi, kvh, sp, k0, k1 in p.blocks():
        tiles = [(t, min(t + p.bkey, k1)) for t in range(k0, k1, p.bkey)]
        keys = [key for t0, t1 in tiles for key in range(t0, t1)]
        assert keys == [key for key in range(sp * p.span, (sp + 1) * p.span)
                        if _live(p, p.offsets[bi], key)]
    if case[0] == "mma_g4_d256_window":
        # the slot at 332 sees keys 233..332 under the window of 100: its
        # first span of 128 holds no live key (an empty partial, l = 0)
        assert p.span == 128 and p.blocks()[2 * p.spans][3:] == (233, 128)


def _np_inputs(seed, b, lk, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, 1, h, d), (b, lk, kv, d), (b, lk, kv, d))]


@pytest.mark.parametrize("case", MMA_CASES, ids=[c[0] for c in MMA_CASES])
def test_split_mma_emulation_matches_the_model_path(case):
    # the JAX package's model-path flash_attention (the kernel's oracle) on
    # the same numpy inputs, per-slot q_offset and a soft cap of 30: fp32
    # through split_mma's spans and tiles (its plan in fp32) at rtol 1e-5,
    # and bf16 within 1e-2 relative Frobenius
    from repro.models import attention as jattn

    name, b, _, lk, h, kv, d, _, causal, window, off, _ = case
    qn, kn, vn = _np_inputs(d + lk + h, b, lk, h, kv, d)
    p = _plan(case)
    kw = dict(causal=causal, window=window, softcap=30.0)
    joff = jnp.asarray(np.asarray(off, dtype=np.int32))
    want = jattn.flash_attention(jnp.asarray(qn), jnp.asarray(kn),
                                 jnp.asarray(vn), q_offset=joff, **kw)
    got = fa.emulate(dataclasses.replace(p, dtype=F32),
                     *(torch.from_numpy(x) for x in (qn, kn, vn)),
                     scale=1.0 / math.sqrt(d), softcap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    want16 = jattn.flash_attention(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (qn, kn, vn)),
        q_offset=joff, **kw)
    got16 = fa.emulate(p, *(torch.from_numpy(x).to(BF16)
                            for x in (qn, kn, vn)),
                       scale=1.0 / math.sqrt(d), softcap=30.0)
    assert got16.dtype == BF16
    want16 = torch.from_numpy(np.array(want16.astype(jnp.float32)))
    assert _rel(got16, want16) <= 1e-2


@pytest.mark.parametrize("d,h,kv", [(64, 4, 2), (112, 16, 2), (256, 4, 1),
                                    (96, 32, 2)])
def test_split_mma_emulation_matches_pallas(d, h, kv):
    # the JAX kernel in interpret mode at Lq 1, non-causal, GQA (fp32 in
    # its (B, H, L, D) layout) against split_mma's spans and tiles in fp32:
    # rtol 1e-5, atol 1e-6
    b, lk = 2, 150
    qn, kn, vn = _np_inputs(d + h, b, lk, h, kv, d)
    tr = (0, 2, 1, 3)
    want = jops.flash_attention(
        *(jnp.asarray(x.transpose(tr)) for x in (qn, kn, vn)), causal=False,
        force_pallas=True, interpret=True)
    p = fa.plan(b, 1, lk, h, kv, d, BF16, causal=False, q_offset=0)
    assert p.body == "split_mma"
    got = fa.emulate(dataclasses.replace(p, dtype=F32),
                     *(torch.from_numpy(x) for x in (qn, kn, vn)),
                     scale=1.0 / math.sqrt(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(tr),
                               rtol=1e-5, atol=1e-6)


def test_chip_smoke_gqa_decodes_take_split_mma():
    # chip_smoke.py holds each flash_attention case to the plan the wrapper
    # launched; by the plan, its bf16 GQA decodes (gemma3's, kimi-k2's and
    # the ragged ones) are split_mma's, at g 2 to 16 and D 64 to 256
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_sizes", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    groups, dims = set(), set()
    for case in (cs.SIZES["flash_attention"]
                 + cs.SIZES["flash_attention_ragged"]):
        name, b, h, kv, lq, lk, d = case[:7]
        if lq != 1:
            continue
        dp = ops._padded_head_dim(d)
        p = fa.plan(b, 1, lk, h, kv, dp, BF16, causal=case[7],
                    window=case[8])
        if h > kv and dp >= 64:
            assert p.body == "split_mma", name
            groups.add(h // kv)
            dims.add(dp)
        else:
            assert p.body == "split", name
    assert {"gemma_decode", "kimi_decode"} <= set(
        cs.SIZES["flash_attention_profiled"])
    assert {2, 4, 8, 16} <= groups and set(fa.MMA_DIMS) <= dims


# ---------------------------------------------------------------------------
# wgmma at D 64 and D 256


def test_wgmma_tiles_by_head_dim():
    # query rows a block and keys a tile by head dim: two warpgroups of 64
    # rows; 128-key tiles to D 128, 64-key tiles at D 192 and 256; the
    # choice follows dtype and D alone (Lq, masks and batch_invariant never
    # change it)
    want = {64: 128, 96: 128, 112: 128, 128: 128, 192: 64, 256: 64}
    assert {d: fa.WG_BKEY[d] for d in fa.MMA_DIMS} == want
    for d, bkey in want.items():
        for lq, causal, window, inv in ((1024, True, 0, False),
                                        (77, False, 0, False),
                                        (300, True, 100, False),
                                        (1, True, 0, True)):
            p = fa.plan(2, lq, 1024, 4, 1, d, BF16, causal=causal,
                        window=window, invariant=inv)
            assert (p.body, p.bq, p.bkey) == ("wgmma", fa.WG_BQ, bkey)
            assert p.grid == -(-lq // 128) * 2 * 4
            assert _launcher_accepts(p)


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_sizes", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_wgmma_published_plans():
    # chip_smoke.py's whisper-base rows (D 64) and gemma3-1b prefill rows
    # (D 256, 4 query heads on 1) at their published widths: the blocks
    # they launch, one wave of the card's 132 multiprocessors or more
    cs = _chip_smoke()
    cases = {c[0]: c for c in cs.SIZES["flash_attention"]}
    want = {"whisper_encoder": (128, 128, 12 * 32),
            "whisper_cross": (128, 128, 4 * 32),
            "whisper_decoder": (128, 128, 4 * 32),
            "gemma_global": (128, 64, 8 * 16),
            "gemma_local": (128, 64, 8 * 16),
            "gemma_server": (128, 64, 4 * 32)}
    for name, (bq, bkey, grid) in want.items():
        _, b, h, kv, lq, lk, d, causal, window, _, _ = cases[name]
        p = fa.plan(b, lq, lk, h, kv, d, BF16, causal=causal, window=window)
        assert (p.body, p.bq, p.bkey, p.grid) == ("wgmma", bq, bkey, grid)
        assert _launcher_accepts(p)
    assert not cases["whisper_encoder"][7] and cases["whisper_decoder"][7]
    # the chunk-row check and the profiled calls take one row of each
    rows_cases = cs.SIZES["flash_attention_rows_cases"]
    assert {"whisper_encoder", "gemma_global"} <= set(rows_cases)
    assert {"whisper_encoder", "gemma_global"} <= set(
        cs.SIZES["flash_attention_profiled"])
    ragged = {c[0] for c in cs.SIZES["flash_attention_ragged"]}
    assert {"ragged_d64_noncausal", "ragged_d64_offsets", "ragged_d256_short",
            "ragged_d256_mid"} <= ragged


@pytest.mark.parametrize("case", WG_CASES, ids=[c[0] for c in WG_CASES])
def test_wgmma_emulation_matches_the_model_path(case):
    # the JAX package's model-path flash_attention (the kernel's oracle) on
    # the same numpy inputs with the case's per-slot offsets and masks:
    # fp32 through the wgmma plan's blocks and tiles at rtol 1e-5 (atol
    # 1e-6; 5e-6 under a soft cap, whose tanh differs in the last bit
    # between jnp.tanh and the emulation's polynomial, which moves outputs
    # near 0 by about 1.5e-6), and bf16 within 1e-2 relative Frobenius
    from repro.models import attention as jattn

    name, b, lq, lk, h, kv, d, _, causal, window, off, _ = case
    p = _plan(case)
    assert p.body == "wgmma"
    softcap = 30.0 if name in SOFTCAP else 0.0
    rng = np.random.default_rng(d + lq + lk)
    qn, kn, vn = (rng.standard_normal(s, dtype=np.float32)
                  for s in ((b, lq, h, d), (b, lk, kv, d), (b, lk, kv, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    joff = jnp.asarray(np.broadcast_to(np.asarray(off, dtype=np.int32), (b,)))
    want = jattn.flash_attention(jnp.asarray(qn), jnp.asarray(kn),
                                 jnp.asarray(vn), q_offset=joff, **kw)
    got = fa.emulate(dataclasses.replace(p, dtype=F32),
                     *(torch.from_numpy(x) for x in (qn, kn, vn)),
                     scale=1.0 / math.sqrt(d), softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=5e-6 if softcap else 1e-6)
    want16 = jattn.flash_attention(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (qn, kn, vn)),
        q_offset=joff, **kw)
    got16 = fa.emulate(p, *(torch.from_numpy(x).to(BF16)
                            for x in (qn, kn, vn)),
                       scale=1.0 / math.sqrt(d), softcap=softcap)
    assert got16.dtype == BF16
    want16 = torch.from_numpy(np.array(want16.astype(jnp.float32)))
    assert _rel(got16, want16) <= 1e-2
