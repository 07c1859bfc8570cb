"""The launch plan of the port's latent-cache decode
(``repro_torch/kernels/flash_decode.py``): which keys body a call takes, the
key spans and work items (fixed 256-key spans from absolute key 0), the
scratch layout, the launcher's and the wrapper's refusals, and a
plain-PyTorch emulation of the kernel's span and merge arithmetic, held to
the port's plain version and to the JAX package's kernel in Pallas
interpret mode, and bit for bit the same for a slot alone or inside a batch.

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
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL

BF16, F32 = torch.bfloat16, torch.float32

# (name, B, H, KV, D, r_k, r_v, L, lengths, dtype): ragged lengths, length
# 1, L not a multiple of the span, g > 1, both bodies
CASES = [
    ("wgmma_d128", 3, 2, 2, 128, 16, 8, 520, [520, 1, 257], BF16),
    ("wgmma_g4_d64", 3, 8, 2, 64, 24, 20, 300, [1, 256, 300], BF16),
    ("fma_fp32_d16", 3, 4, 2, 16, 19, 24, 77, [1, 40, 77], F32),
    ("fma_fp32_g2_d128", 2, 2, 1, 128, 16, 12, 260, [260, 256], F32),
    ("fma_bf16_odd_rank", 2, 4, 4, 64, 19, 24, 300, [300, 77], BF16),
    ("fma_bf16_d32_g4", 2, 4, 1, 32, 16, 16, 100, [100, 3], BF16),
    # granite's and phi3-medium's smoke head dims (RoPE pairs 4 and 10 dims)
    ("fma_fp32_d8_g4", 2, 8, 2, 8, 24, 20, 300, [300, 5], F32),
    ("fma_bf16_d8_g4", 2, 8, 2, 8, 24, 20, 300, [1, 257], BF16),
    ("fma_fp32_d20_g2", 2, 4, 2, 20, 32, 19, 90, [90, 1], F32),
    ("fma_bf16_d20_g2", 3, 4, 2, 20, 32, 24, 260, [260, 40, 256], BF16),
    # kimi-k2's head dim 112 (RoPE pairs 56 dims; U staged as 64 + 48
    # columns by the wgmma body) with its 8 query heads a KV head
    ("wgmma_d112_g8", 2, 16, 2, 112, 24, 16, 300, [300, 41], BF16),
    ("fma_fp32_d112_g8", 2, 16, 2, 112, 20, 16, 260, [260, 1], F32),
    ("fma_bf16_d112_odd_rank", 2, 8, 1, 112, 19, 16, 100, [100, 3], BF16),
    # phi-3-vision's head dim 96 (RoPE pairs 48 dims; U staged as 64 + 32
    # columns by the wgmma body), one query head a KV head as it has
    ("wgmma_d96_g1", 3, 3, 3, 96, 24, 16, 300, [300, 41, 256], BF16),
    ("fma_fp32_d96_g1", 2, 2, 2, 96, 20, 16, 260, [260, 1], F32),
    ("fma_bf16_d96_odd_rank", 2, 4, 2, 96, 19, 16, 100, [100, 3], BF16),
    # whisper's decoder: head dim 64, one query head a KV head (its calls
    # take rope=False; every case runs both ways below)
    ("wgmma_d64_g1", 2, 4, 4, 64, 16, 24, 280, [280, 17], BF16),
]
IDS = [c[0] for c in CASES]


def _plan(case):
    _, b, h, kv, d, rk, rv, l, _, dtype = case
    return fd.plan(b, l, h, kv, d, rk, rv, dtype)


def _inputs(case, seed=0):
    """(q, lk, lv, uk, uv, lengths, cos, sin) of a case, numpy-made."""
    _, b, h, kv, d, rk, rv, l, lens, dtype = case
    rng = np.random.default_rng(seed + b + d + rk + l)

    def rand(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    q = rand(b, h, d).to(dtype)
    lk = rand(b, l, rk).to(dtype)
    lv = rand(b, l, rv).to(dtype)
    uk = rand(rk, kv * d, scale=1 / math.sqrt(rk))
    uv = rand(rv, kv * d, scale=1 / math.sqrt(rv))
    cos, sin = TL.rope_table(torch.arange(l), d, 10000.0)
    return q, lk, lv, uk, uv, torch.tensor(lens, dtype=torch.int32), cos, sin


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_plan_bodies():
    # bf16 at D 64 / 128 with ranks a multiple of 8 takes wgmma; fp32, the
    # small head dims and other ranks the FMA body
    assert fd.plan(8, 2048, 32, 32, 128, 1232, 1232, BF16).body == "wgmma"
    assert fd.plan(8, 2048, 32, 32, 128, 1232, 1232, F32).body == "fma"
    assert fd.plan(5, 700, 8, 2, 64, 200, 77, BF16).body == "wgmma"
    assert fd.plan(3, 77, 4, 2, 16, 24, 24, BF16).body == "fma"
    assert fd.plan(3, 77, 4, 2, 32, 24, 24, BF16).body == "fma"
    assert fd.plan(3, 77, 4, 2, 128, 19, 24, BF16).body == "fma"
    # granite's (D 8) and phi3-medium's (D 20) smoke head dims: the FMA body
    # in both dtypes, also at ranks a multiple of 8
    for d, h, kv in ((8, 8, 2), (20, 4, 2)):
        for dtype in (F32, BF16):
            p = fd.plan(4, 64, h, kv, d, 32, 32, dtype)
            assert p.body == "fma" and p.smem <= fd.MAX_SMEM
    # kimi-k2's head dim 112: wgmma for bf16 at ranks a multiple of 8
    # (its serving case: 64 query heads on 8 KV heads, r_k 480), else FMA
    kimi = fd.plan(8, 2048, 64, 8, 112, 480, 480, BF16)
    assert kimi.body == "wgmma" and kimi.smem <= fd.MAX_SMEM
    assert fd.plan(8, 2048, 64, 8, 112, 480, 480, F32).body == "fma"
    assert fd.plan(3, 77, 16, 2, 112, 19, 24, BF16).body == "fma"
    # phi-3-vision's head dim 96: the same rule
    vision = fd.plan(8, 2048, 32, 32, 96, 928, 928, BF16)
    assert vision.body == "wgmma" and vision.smem <= fd.MAX_SMEM
    assert fd.plan(8, 2048, 32, 32, 96, 928, 928, F32).body == "fma"
    assert fd.plan(3, 77, 4, 4, 96, 19, 24, BF16).body == "fma"
    with pytest.raises(ValueError, match="head dim"):
        fd.plan(1, 64, 4, 4, 48, 16, 16, BF16)
    with pytest.raises(TypeError):
        fd.plan(1, 64, 4, 4, 64, 16, 16, torch.float16)
    with pytest.raises(ValueError):
        fd.plan(1, 64, 4, 3, 64, 16, 16, BF16)


@pytest.mark.parametrize("b,l,h,kv,d,dtype", [
    (8, 2048, 32, 32, 128, BF16), (1, 1, 1, 1, 16, F32),
    (64, 4096, 32, 8, 128, BF16), (2, 300, 8, 2, 64, BF16),
    (3, 77, 4, 2, 16, F32)])
def test_span_is_fixed(b, l, h, kv, d, dtype):
    # the span never depends on B, L or the heads: a slot's work items are
    # the same whatever it is batched with
    p = fd.plan(b, l, h, kv, d, 64, 64, dtype)
    assert p.span == fd.SPAN == 256
    assert p.spans == -(-l // 256) and p.grid == b * p.spans * kv


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_items_cover_live_keys_once_in_order(case):
    p = _plan(case)
    lens = case[8]
    got = {}
    for bi, kvh, sp, k0, k1 in p.items(lens):
        assert k0 == sp * p.span and k0 < k1 <= min(k0 + p.span, lens[bi])
        got.setdefault((bi, kvh), []).append((sp, k0, k1))
    for bi, n in enumerate(lens):
        for kvh in range(p.kv):
            spans = got[(bi, kvh)]
            assert [s[0] for s in spans] == list(range(-(-n // p.span)))
            assert [k for _, k0, k1 in spans for k in range(k0, k1)] == \
                list(range(n))


def test_items_of_dead_and_overlong_slots():
    # length 0 has no work item; a length past L is clamped to L
    p = fd.plan(3, 300, 2, 2, 64, 16, 16, BF16)
    items = p.items([0, 1, 5000])
    assert not [i for i in items if i[0] == 0]
    assert [i[2:] for i in items if i[0] == 1] == [(0, 0, 1)] * 2
    assert [i[2:] for i in items if i[0] == 2 and i[1] == 0] == \
        [(0, 0, 256), (1, 256, 300)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_item_at_is_the_launch_order(case):
    p = _plan(case)
    order = [(bi, sp, kvh) for bi in range(p.b) for sp in range(p.spans)
             for kvh in range(p.kv)]
    assert [p.item_at(w) for w in range(p.grid)] == order
    with pytest.raises(IndexError):
        p.item_at(p.grid)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scratch_layout(case):
    # regions 256-byte aligned, in order, each as large as its contents;
    # U_k's two bf16 terms only for the wgmma body
    p = _plan(case)
    off = p.offsets
    keys = ["u", "m", "l", "p", "pv", "ctx", "end"]
    assert [off[k] for k in keys] == sorted(off[k] for k in keys)
    assert all(off[k] % 64 == 0 for k in keys)
    rows = p.b * p.h * p.spans
    u = p.rk * p.kv * p.d if p.body == "wgmma" else 0
    assert off["m"] - off["u"] >= u and off["l"] - off["m"] >= rows
    assert off["p"] - off["l"] >= rows
    assert off["pv"] - off["p"] >= rows * p.span
    assert off["ctx"] - off["pv"] >= rows * p.rv
    assert off["end"] - off["ctx"] >= p.b * p.h * p.rv
    assert p.scratch_floats == off["end"]


def _launcher_accepts(p: fd.Plan, scratch_floats=None) -> bool:
    """csrc/flash_decode.cu's flash_decode_launch checks, mirrored."""
    if (min(p.b, p.l, p.kv, p.h, p.rk, p.rv) <= 0 or p.h % p.kv
            or p.d not in (8, 16, 20, 32, 64, 96, 112, 128)
            or p.dtype not in (F32, BF16)
            or p.body not in ("fma", "wgmma") or p.span != 256
            or p.spans != -(-p.l // 256)):
        return False
    wgmma = p.body == "wgmma"
    if wgmma and (p.dtype != BF16 or p.d not in (64, 96, 112, 128)
                  or p.rk % 8):
        return False
    g = p.h // p.kv
    if (fd.smem_bytes(p.body, g, p.d) > 232448
            or p.b * p.spans * p.kv > 2**31 - 1 or p.b * p.spans > 65535
            or -(-p.h // 32) > 65535 or p.b * p.h > 2**31 - 1
            or -(-p.rv // 128) > 65535 or p.kv > 65535):
        return False

    def r(n):
        return -(-n // 64) * 64

    rows = p.b * p.h * p.spans
    need = ((r(p.rk * p.kv * p.d) if wgmma else 0) + 2 * r(rows)
            + r(rows * 256) + r(rows * p.rv) + r(p.b * p.h * p.rv))
    have = p.scratch_floats if scratch_floats is None else scratch_floats
    return have >= need


PLANS = [_plan(c) for c in CASES] + [
    fd.plan(8, 2048, 32, 32, 128, 1232, 1232, BF16),
    fd.plan(8, 2048, 32, 32, 128, 1232, 1232, F32),
    fd.plan(5, 700, 8, 2, 64, 200, 77, BF16),
    fd.plan(3, 77, 4, 2, 16, 19, 24, BF16),
    fd.plan(1, 1, 1, 1, 32, 1, 1, F32),
    fd.plan(8, 64, 8, 2, 8, 56, 56, F32),
    fd.plan(8, 64, 4, 2, 20, 48, 48, BF16),
    fd.plan(8, 2048, 64, 8, 112, 480, 480, BF16),
    fd.plan(8, 2048, 64, 8, 112, 480, 480, F32),
    fd.plan(8, 2048, 32, 32, 96, 928, 928, BF16),
    fd.plan(8, 2048, 32, 32, 96, 928, 928, F32),
    fd.plan(8, 448, 8, 8, 64, 160, 160, BF16),
]


@pytest.mark.parametrize("i", range(len(PLANS)))
def test_launcher_accepts_every_plan(i):
    assert _launcher_accepts(PLANS[i])


_WG = fd.plan(2, 300, 4, 2, 128, 16, 16, BF16)
_FMA = fd.plan(2, 300, 4, 2, 128, 16, 16, F32)
REFUSED = {
    "wgmma_fp32": dataclasses.replace(_WG, dtype=F32),
    "wgmma_d32": dataclasses.replace(_WG, d=32),
    "wgmma_d8": dataclasses.replace(_WG, d=8),
    "wgmma_rank": dataclasses.replace(_WG, rk=19),
    "wgmma_group": dataclasses.replace(_WG, h=64, kv=2),
    "fma_group": dataclasses.replace(_FMA, h=512, kv=2),
    "span": dataclasses.replace(_FMA, span=128),
    "head_dim": dataclasses.replace(_FMA, d=48),
    "heads": dataclasses.replace(_FMA, kv=3),
    "dtype": dataclasses.replace(_FMA, dtype=torch.float16),
    "body": dataclasses.replace(_FMA, body="split"),
    "slots_by_spans": dataclasses.replace(_FMA, b=300, l=60000),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_launcher_refuses_what_the_plan_never_makes(name):
    assert not _launcher_accepts(REFUSED[name])


def test_launcher_refuses_a_short_scratch():
    p = PLANS[0]
    assert not _launcher_accepts(p, p.scratch_floats - 1)


def test_wrapper_refusals():
    # what no body takes is refused before any launch: head dims, dtypes,
    # and a group of query heads no block's shared memory holds
    case = CASES[0]
    q, lk, lv, uk, uv, lengths, cos, sin = _inputs(case)
    args = [q, lk, lv, uk, uv, lengths, cos, sin, True]
    assert ops._decode_plan(*args) == _plan(case)

    def refused(exc, match, **swap):
        names = ["q", "lk", "lv", "uk", "uv", "lengths", "cos", "sin"]
        call = list(args)
        for k, v in swap.items():
            call[names.index(k)] = v
        with pytest.raises(exc, match=match):
            ops._decode_plan(*call)

    refused(TypeError, "float32 or bfloat16", q=q.half(), lk=lk.half(),
            lv=lv.half())
    refused(TypeError, "share one dtype", lk=lk.float())
    refused(TypeError, "uk must be float32", uk=uk.to(BF16))
    refused(TypeError, "cos must be float32", cos=cos.double())
    refused(TypeError, "lengths must be int32", lengths=lengths.long())
    refused(ValueError, "head dim 48", q=q[..., :48], cos=cos[:, :24],
            sin=sin[:, :24])
    refused(ValueError, "do not fit", uv=uv[:, :100])
    # 64 query heads on one KV head at D 128: no body's block holds them
    b, l = 1, 64
    big = [torch.zeros(b, 64, 128, dtype=BF16),
           torch.zeros(b, l, 16, dtype=BF16), torch.zeros(b, l, 8, dtype=BF16),
           torch.zeros(16, 128), torch.zeros(8, 128),
           torch.ones(b, dtype=torch.int32), torch.zeros(l, 64),
           torch.zeros(l, 64), True]
    with pytest.raises(ValueError, match="shared memory"):
        ops._decode_plan(*big)


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulate_matches_plain(case, rope):
    # the plan's arithmetic against the plain version at the chip's limits:
    # fp32 1e-5, bf16 5e-3 relative Frobenius
    p = _plan(case)
    args = _inputs(case)
    got = fd.emulate(p, *args, rope=rope)
    want = ref.flash_decode_ref(*args, rope=rope)
    assert got.dtype == case[9] and got.shape == want.shape
    assert _rel(got, want) <= (1e-5 if case[9] == F32 else 5e-3)


def _pallas(args, rope):
    arrays = [jnp.asarray(t.float().numpy()) if t.is_floating_point()
              else jnp.asarray(t.numpy()) for t in args]
    return np.array(jops.flash_decode(*arrays, rope=rope, force_pallas=True,
                                      interpret=True))


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("name", ["fma_fp32_d16", "fma_fp32_g2_d128",
                                  "fma_fp32_d8_g4", "fma_fp32_d20_g2",
                                  "fma_fp32_d112_g8", "fma_fp32_d96_g1"])
def test_emulate_matches_pallas(name, rope):
    # the FMA body's plan against the JAX kernel in interpret mode, all
    # fp32, U in the stored layout on both sides: rtol 1e-5, atol 1e-6
    case = next(c for c in CASES if c[0] == name)
    args = _inputs(case, seed=1)
    got = fd.emulate(_plan(case), *args, rope=rope)
    np.testing.assert_allclose(got.numpy(), _pallas(args, rope), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("name", ["wgmma_d128", "wgmma_g4_d64",
                                  "wgmma_d112_g8", "wgmma_d96_g1",
                                  "wgmma_d64_g1"])
def test_wgmma_emulation_matches_pallas(name, rope):
    # the wgmma body's plan (U_k as two bf16 terms) against the JAX kernel
    # on the same bf16 values taken to fp32: the output rounds to bf16
    # (2^-8): 5e-3 relative Frobenius, as on the card
    case = next(c for c in CASES if c[0] == name)
    args = _inputs(case, seed=2)
    got = fd.emulate(_plan(case), *args, rope=rope)
    want = torch.from_numpy(_pallas(args, rope))
    assert _rel(got, want) <= 5e-3


@pytest.mark.parametrize("name,rope", [("fma_fp32_d96_g1", True),
                                       ("wgmma_d96_g1", True),
                                       ("wgmma_d64_g1", False)])
def test_wrapper_matches_pallas_at_the_multimodal_dims(name, rope):
    # the port's wrapper (its plain version on the CPU) at phi-3-vision's
    # head dim 96 and at whisper's D 64 without RoPE, against the JAX
    # package's kernel in interpret mode: fp32 1e-5, bf16 inputs taken to
    # fp32 on both sides 5e-3 (the output rounds to bf16)
    case = next(c for c in CASES if c[0] == name)
    args = _inputs(case, seed=4)
    got = ops.flash_decode(*args, rope=rope)
    want = torch.from_numpy(_pallas(args, rope))
    assert got.dtype == case[9]
    assert _rel(got, want) <= (1e-5 if case[9] == F32 else 5e-3)


def test_split_factor_keeps_fp32_quality():
    # hi + lo holds an fp32 factor to ~2^-16 of each value: the keys the
    # wgmma body makes are not rounded to bf16
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    hi, lo = fd.split_factor(u)
    assert hi.dtype == lo.dtype == BF16
    err = (hi.float() + lo.float() - u).abs()
    assert float((err / u.abs()).max()) <= 2.0 ** -15
    assert float((hi.float() - u).abs().max()) > float(err.max()) * 100


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_slot_alone_equals_slot_in_batch(case):
    # a slot's emulated output bits are the same computed alone (B 1, its
    # cache cut to its own length) as inside the batch of other lengths
    p = _plan(case)
    q, lk, lv, uk, uv, lengths, cos, sin = _inputs(case)
    whole = fd.emulate(p, q, lk, lv, uk, uv, lengths, cos, sin)
    for bi, n in enumerate(lengths.tolist()):
        alone = fd.plan(1, n, p.h, p.kv, p.d, p.rk, p.rv, p.dtype)
        got = fd.emulate(alone, q[bi:bi + 1], lk[bi:bi + 1, :n].contiguous(),
                         lv[bi:bi + 1, :n].contiguous(), uk, uv,
                         lengths[bi:bi + 1], cos[:n], sin[:n])
        assert torch.equal(got[0], whole[bi]), (bi, n)


@pytest.mark.parametrize("g", [1, 8, 16])
def test_smem_counts_every_box_of_a_u_row(g):
    # a wgmma stage holds the span's l_k tile (256 keys x 64 ranks) and
    # ⌈D/64⌉ 64-column boxes of each U term: D 112 stages two boxes, as D
    # 128 does, so its shared memory is D 128's less the 16 query and
    # score columns it does not hold (4·g·16 bytes); counting D // 64 = 1
    # box would undercount it by 3 x 16 KB
    stage = 256 * 128 + 2 * 2 * 64 * 128
    want = 1024 + 3 * stage + 4 * g * (112 + 256) + 16 * 3
    assert fd.smem_bytes("wgmma", g, 112) == want
    assert fd.smem_bytes("wgmma", g, 128) - want == 4 * g * 16
    # the FMA body at D 112: a 32-rank chunk of U_k, the rank-major l_k
    # chunk, q, the 64-key tile and the span's scores, in floats
    assert fd.smem_bytes("fma", g, 112) == 4 * (
        32 * 112 + 32 * 65 + g * 112 + 64 * 113 + g * 256)


@pytest.mark.parametrize("g", [1, 4])
def test_smem_of_head_dim_96(g):
    # D 96 stages two 64-column boxes of each U term, the second's last 32
    # columns unused: D 128's stages, less 32 query and score columns
    stage = 256 * 128 + 2 * 2 * 64 * 128
    want = 1024 + 3 * stage + 4 * g * (96 + 256) + 16 * 3
    assert fd.smem_bytes("wgmma", g, 96) == want
    assert fd.smem_bytes("wgmma", g, 128) - want == 4 * g * 32
    assert fd.smem_bytes("fma", g, 96) == 4 * (
        32 * 96 + 32 * 65 + g * 96 + 64 * 97 + g * 256)


def test_kimi_decode_fits_one_block():
    # kimi-k2's 8 query heads a KV head at D 112 fit one block in either
    # body; the plan refuses a group no block holds
    for dtype in (BF16, F32):
        p = fd.plan(8, 2048, 64, 8, 112, 480, 480, dtype)
        assert p.group == 8 and p.smem <= fd.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        fd.plan(1, 64, 64, 1, 112, 480, 480, BF16)


def test_bound_flops():
    # the chip case's key up-projection: 93.0 GFLOP a pass
    lens = np.linspace(256, 2048, 8).astype(np.int64).tolist()
    assert fd.bound_flops(lens, 1232, 32, 128) == \
        2 * sum(lens) * 1232 * 32 * 128
    assert abs(fd.bound_flops(lens, 1232, 32, 128) / 1e9 - 93.0) < 0.1


def test_wrapper_launches_the_plan(monkeypatch):
    # a tensor off the CPU takes the kernel's route (meta: no data): the
    # wrapper hands the launcher the call's plan and a scratch of its size,
    # and counts the launch by body
    seen = []
    monkeypatch.setattr(ops, "_check_decode", ops._decode_plan)
    monkeypatch.setattr(ops, "_aligned", lambda a: a)
    monkeypatch.setattr(fd, "launch", lambda p, *args, rope: seen.append(
        (p, args[-1].numel(), tuple(args[-2].shape), rope)))
    meta = dict(device="meta")
    ops.reset_launches()

    def call(b, l, h, kv, d, rk, rv, dtype, rope=True):
        t = [torch.zeros(b, h, d, dtype=dtype, **meta),
             torch.zeros(b, l, rk, dtype=dtype, **meta),
             torch.zeros(b, l, rv, dtype=dtype, **meta),
             torch.zeros(rk, kv * d, **meta), torch.zeros(rv, kv * d, **meta),
             torch.zeros(b, dtype=torch.int32, **meta),
             torch.zeros(l, d // 2, **meta), torch.zeros(l, d // 2, **meta)]
        return ops.flash_decode(*t, rope=rope)

    out = call(8, 2048, 32, 32, 128, 1232, 1232, BF16)
    p = fd.plan(8, 2048, 32, 32, 128, 1232, 1232, BF16)
    assert seen[-1] == (p, p.scratch_floats, (8, 32, 128), True)
    assert tuple(out.shape) == (8, 32, 128) and out.dtype == BF16
    call(3, 77, 4, 2, 16, 19, 24, F32, rope=False)
    assert seen[-1][0].body == "fma" and seen[-1][3] is False
    assert ops.LAUNCHES["flash_decode"] == 2
    assert dict(ops.DECODE_BODIES) == {"wgmma": 1, "fma": 1}
