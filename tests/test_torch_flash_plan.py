"""The launch plan of the port's flash attention
(``repro_torch/kernels/flash_attention.py``): which body a call takes, the
blocks of the tile bodies and the key tiles each walks, the split body's key
spans, the launcher's refusals, and a plain-PyTorch emulation of the
kernel's work block by block, held to the port's plain version and to the
JAX package's kernel in Pallas interpret mode.

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
]
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
    assert p.body == "split" and p.grid == p.spans * p.b * p.kv
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
    bk = 64 if d * (2 if p.dtype == BF16 else 4) <= 256 else 32
    return (p.lq == 1 and h // kv <= 16 and p.bq == 1 and p.bkey == bk
            and p.span > 0 and p.span % bk == 0
            and p.spans == -(-p.lk // p.span) and scratch
            and p.b * kv <= 65535 and heads <= 2**31 - 1)


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
_SPLIT = fa.plan(2, 1, 300, 4, 2, 64, BF16)
REFUSED = {
    "wgmma_fp32": dataclasses.replace(_WG, dtype=F32),
    "wgmma_narrow_tile": dataclasses.replace(_WG, bkey=64),
    "wgmma_rows": dataclasses.replace(_WG, bq=64),
    "wgmma_d32": dataclasses.replace(_WG, d=32),
    "wgmma_split_fields": dataclasses.replace(_WG, span=448, spans=1),
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
    softcap = 30.0 if case[0] in ("wmma", "decode_window") else 0.0
    got = fa.emulate(p, q, k, v, scale=1.0 / math.sqrt(d), softcap=softcap)
    toff = torch.tensor(off) if isinstance(off, list) else off
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=toff, softcap=softcap)
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel(got, want) <= (1e-5 if dtype == F32 else 1e-2)


@pytest.mark.parametrize("lq,lk,causal,window,d", [
    (64, 64, True, 0, 16), (64, 64, True, 24, 32), (50, 77, False, 0, 16),
    (77, 77, True, 0, 64), (1, 77, True, 0, 16), (64, 64, True, 16, 96),
    (50, 77, False, 0, 112), (1, 77, True, 0, 112)])
def test_emulate_matches_pallas(lq, lk, causal, window, d):
    # the JAX kernel in interpret mode in its (B, H, L, D) layout, fp32, at
    # q_offset 0 and no soft cap (which it lacks): rtol 1e-5, atol 1e-6
    rng = np.random.default_rng(lq + lk + d)
    b, h, kv = 2, 4, 2
    q, k, v = _inputs(rng, b, lq, lk, h, kv, d, F32)
    tr = (0, 2, 1, 3)
    want = jops.flash_attention(
        jnp.asarray(q.numpy().transpose(tr)),
        jnp.asarray(k.numpy().transpose(tr)),
        jnp.asarray(v.numpy().transpose(tr)), causal=causal, window=window,
        force_pallas=True, interpret=True)
    p = fa.plan(b, lq, lk, h, kv, d, F32, causal=causal, window=window,
                q_offset=0)
    got = fa.emulate(p, q, k, v, scale=1.0 / math.sqrt(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(tr),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [64, 112, 192, 256])
def test_invariant_rows_do_not_depend_on_the_chunk(d):
    # under batch_invariant a row's emulated bits are the same whether it
    # is computed inside Lq 1, 8, 256 or the whole prompt, at any block
    # start (bf16, the wgmma body; its key tiles start at absolute key 0)
    rng = np.random.default_rng(d)
    b, h, kv, l = 1, 1, 1, 1024 if d == 64 else 300 if d == 192 else 192
    q, k, v = _inputs(rng, b, l, l, h, kv, d, BF16)
    scale = 1.0 / math.sqrt(d)

    def run(q0, n):
        p = fa.plan(b, n, l, h, kv, d, BF16, q_offset=q0, invariant=True)
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
