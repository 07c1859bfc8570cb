"""The backward of ``flash_attention`` on the CPU: the plain backward
(``ref.flash_attention_bwd_ref``, and ``ops.flash_attention``'s autograd rule
on CPU tensors) and the backward kernel's emulation
(``kernels.flash_attention.emulate_backward`` under ``plan_backward``'s
plan) against ``jax.vjp`` of the JAX model path's scan
(``repro.models.attention.flash_attention``) on the same numpy-made inputs;
the forward's LSE, the plan's tile walks, its refusals, and the wrapper's
launch.

The CUDA kernel itself (``csrc/flash_attention_bwd.cu``) runs only on the
card; ``chip_smoke.py`` holds it against the plain backward there.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

F32, BF16 = torch.float32, torch.bfloat16

# (b, lq, lk, h, kv, d, causal, window, softcap, q_offset): every head dim
# the kernel is compiled for at and above 64, and D 16 / 32; causal,
# windowed and non-causal masks with Lq != Lk; 1 to 16 query heads a KV
# head; soft caps; scalar and per-slot offsets; Lk no multiple of any tile
CASES = {
    "d16_window_softcap_gqa": (2, 77, 77, 4, 2, 16, True, 16, 30.0, 0),
    "d32_gqa16": (1, 24, 30, 16, 1, 32, True, 0, 0.0, 6),
    "d64_per_slot_window": (2, 40, 70, 4, 2, 64, True, 24, 30.0, [30, 5]),
    "d96_noncausal_cross": (1, 20, 45, 2, 2, 96, False, 0, 0.0, 0),
    "d112_gqa4": (1, 40, 40, 4, 1, 112, True, 0, 0.0, 0),
    "d128_offset": (1, 50, 70, 2, 1, 128, True, 0, 0.0, 20),
    "d192_softcap": (1, 33, 33, 2, 2, 192, True, 0, 30.0, 0),
    "d256_window": (1, 35, 35, 2, 1, 256, True, 20, 0.0, 0),
}
DTYPES = {"float32": F32, "bfloat16": BF16}
PAIRS = [(c, dt) for c in sorted(CASES) for dt in sorted(DTYPES)]
# the cases held to the JAX package's bf16 vjp (it compiles in ~3 s, an
# fp32 one in ~1 s); the other bf16 cases are held to its fp32 vjp on the
# same numpy inputs, of which the bf16 ones are the rounding
JAX_BF16 = ("d16_window_softcap_gqa", "d64_per_slot_window", "d256_window")


def _rel(a, b):
    a, b = (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _arrays(case):
    b, lq, lk, h, kv, d = CASES[case][:6]
    rng = np.random.default_rng(sum(map(ord, case)))
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, lq, h, d), (b, lk, kv, d), (b, lk, kv, d),
                      (b, lq, h, d))]


def _opts(case, per_slot_tensor=True):
    causal, window, softcap, off = CASES[case][6:]
    if isinstance(off, list) and per_slot_tensor:
        off = torch.tensor(off, dtype=torch.int32)
    return dict(causal=causal, window=window, softcap=softcap, q_offset=off)


def _torch(case, dtype):
    return [torch.from_numpy(a).to(dtype) for a in _arrays(case)]


@pytest.fixture(scope="module")
def jax_grads():
    """jax.vjp of the JAX model path's scan, one per (case, dtype), made
    on first use and shared by the tests below; for a bf16 case outside
    ``JAX_BF16``, the fp32 vjp's grads."""
    cache = {}

    def get(case, dtype_name):
        key = (case, dtype_name)
        if key not in cache and dtype_name == "bfloat16" \
                and case not in JAX_BF16:
            cache[key] = get(case, "float32")
        if key not in cache:
            jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
            q, k, v, dout = (jnp.asarray(a).astype(jdt)
                             for a in _arrays(case))
            causal, window, softcap, off = CASES[case][6:]
            joff = jnp.asarray(off, jnp.int32) if isinstance(off, list) \
                else off

            def f(q_, k_, v_):
                return JA.flash_attention(q_, k_, v_, causal=causal,
                                          window=window, q_offset=joff,
                                          softcap=softcap)

            _, vjp = jax.vjp(f, q, k, v)
            cache[key] = [np.asarray(g.astype(jnp.float32))
                          for g in vjp(dout)]
        return cache[key]

    return get


def _lim(dtype_name, fp32, bf16):
    return fp32 if dtype_name == "float32" else bf16


@pytest.mark.parametrize("case,dtype", PAIRS)
def test_plain_backward_matches_jax(case, dtype, jax_grads):
    # the plain backward: the fp32 einsum scan recomputed and differentiated
    # (fp32: the same function in another order, 1e-5; bf16: every operand
    # and gradient rounded to bf16 in both, 1e-2)
    q, k, v, dout = _torch(case, DTYPES[dtype])
    got = ref.flash_attention_bwd_ref(q, k, v, dout, **_opts(case))
    for g, w in zip(got, jax_grads(case, dtype)):
        assert g.dtype == DTYPES[dtype]
        assert _rel(g, w) <= _lim(dtype, 1e-5, 1e-2)


@pytest.mark.parametrize("case,dtype", PAIRS)
def test_cpu_autograd_rule_is_the_plain_backward(case, dtype, jax_grads):
    # ops.flash_attention's backward on CPU tensors, a gradient of each
    q, k, v, dout = _torch(case, DTYPES[dtype])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*leaves, **_opts(case)).backward(dout)
    plain = ref.flash_attention_bwd_ref(q, k, v, dout, **_opts(case))
    for t, p, w in zip(leaves, plain, jax_grads(case, dtype)):
        assert torch.equal(t.grad, p)
        assert _rel(t.grad, w) <= _lim(dtype, 1e-5, 1e-2)


def _emulated(case, dtype, q=None, k=None, v=None, dout=None, offsets=None):
    b, lq, lk, h, kv, d, causal, window, softcap, off = CASES[case]
    if q is None:
        q, k, v, dout = _torch(case, dtype)
        offsets = off
    b = q.shape[0]
    offs = (tuple(offsets) if isinstance(offsets, (list, tuple))
            else (offsets,) * b)
    scale = 1.0 / math.sqrt(d)
    fwd = fa.plan(b, lq, lk, h, kv, d, dtype, causal=causal, window=window,
                  q_offset=offs, invariant=True)
    out, lse = fa.emulate(fwd, q, k, v, scale=scale, softcap=softcap,
                          lse=True)
    p = fa.plan_backward(b, lq, lk, h, kv, d, dtype, causal=causal,
                         window=window, q_offset=offs)
    return fa.emulate_backward(p, q, k, v, out, lse, dout, scale=scale,
                               softcap=softcap), p


@pytest.mark.parametrize("case,dtype", PAIRS)
def test_emulated_backward_matches_jax(case, dtype, jax_grads):
    # the kernel's tile order and rounding: P rounded to bf16 before dV, dS
    # split into bf16 hi and lo before dK and dQ (bf16 2e-2), fp32 otherwise
    # (1e-5)
    got, p = _emulated(case, DTYPES[dtype])
    want_body = "wgmma" if (dtype == "bfloat16"
                            and CASES[case][5] >= 64) else "fma"
    assert p.body == want_body
    for g, w in zip(got, jax_grads(case, dtype)):
        assert g.dtype == DTYPES[dtype] and g.shape == w.shape
        assert _rel(g, w) <= _lim(dtype, 1e-5, 2e-2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_lse_matches_the_plain_statistics(case):
    # each row's m + log(l) from the tile bodies' emulation, against the
    # plain version's running statistics (fp32: 1e-5 absolute)
    b, lq, lk, h, kv, d, causal, window, softcap, off = CASES[case]
    q, k, v, _ = _torch(case, F32)
    offs = tuple(off) if isinstance(off, list) else (off,) * b
    p = fa.plan(b, lq, lk, h, kv, d, F32, causal=causal, window=window,
                q_offset=offs, invariant=True)
    out, lse = fa.emulate(p, q, k, v, scale=1.0 / math.sqrt(d),
                          softcap=softcap, lse=True)
    want, want_lse = ref.flash_attention_ref(q, k, v, with_lse=True,
                                             **_opts(case))
    assert lse.shape == (b, h, lq) and lse.dtype == F32
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    # the plain version's LSE is the log of the softmax's denominator
    s = torch.einsum("bqhd,bkhd->bhqk", q,
                     k.repeat_interleave(h // kv, dim=2)) / math.sqrt(d)
    if not softcap and not window and causal and off == 0 and lq == lk:
        s = s.masked_fill(torch.ones(lq, lk).triu(1).bool(), -math.inf)
        torch.testing.assert_close(want_lse, torch.logsumexp(s, -1),
                                   rtol=0, atol=1e-5)


def test_split_bodies_write_no_lse():
    p = fa.plan(2, 1, 64, 4, 2, 64, BF16, q_offset=(10, 63))
    assert p.body in fa.SPLIT_BODIES
    q = torch.zeros(2, 1, 4, 64, dtype=BF16)
    k = torch.zeros(2, 64, 2, 64, dtype=BF16)
    with pytest.raises(ValueError, match="LSE"):
        fa.emulate(p, q, k, k, scale=0.125, lse=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_slot_alone_equals_it_inside_a_batch(dtype):
    # no atomics and fixed sums: slot 1 of three gives the same bits as that
    # slot alone (its own offset), in every gradient
    case = "d64_per_slot_window"
    dt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    b, lq, lk, h, kv, d = 3, 40, 70, 4, 2, 64
    arrs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
            for s in ((b, lq, h, d), (b, lk, kv, d), (b, lk, kv, d),
                      (b, lq, h, d))]
    offs = [30, 5, 17]
    whole, _ = _emulated(case, dt, *arrs, offsets=offs)
    alone, _ = _emulated(case, dt, *(a[1:2].contiguous() for a in arrs),
                         offsets=[offs[1]])
    for w, a in zip(whole, alone):
        assert torch.equal(w[1:2], a)


def test_plan_backward_bodies_and_tiles():
    # one plan per (dtype, head dim, masking): nothing depends on B
    for d in (64, 96, 112, 128, 192, 256):
        p = fa.plan_backward(8, 512, 512, 16, 8, d, BF16)
        assert p.body == "wgmma" and p.kv_keys == fa.BWD_WG_KEYS
        assert p.q_rows == fa.BWD_WG_QROWS
        assert (p.kv_rows, p.q_keys) == ((32, 32) if d == 256 else (64, 64))
        one = fa.plan_backward(1, 512, 512, 16, 8, d, BF16)
        assert dataclasses.replace(one, b=8) == p
    for dt, d in ((F32, 16), (F32, 128), (F32, 256), (BF16, 16), (BF16, 32)):
        p = fa.plan_backward(2, 77, 77, 4, 2, d, dt, window=16)
        assert p.body == "fma" and {p.kv_keys, p.kv_rows, p.q_rows,
                                    p.q_keys} == {fa.BWD_TILE}
    p = fa.plan_backward(8, 512, 512, 16, 8, 128, BF16)
    assert p.kv_grid == (8, 64) and p.q_grid == (4, 128)


@pytest.mark.parametrize("args,err", [
    ((1, 8, 8, 2, 1, 80, F32), ValueError),      # no body: pad it
    ((1, 8, 8, 3, 2, 64, F32), ValueError),      # H not a multiple of KV
    ((1, 0, 8, 2, 1, 64, F32), ValueError),      # no rows
    ((70000, 8, 8, 1, 1, 64, F32), ValueError),  # B·H past the grid
    ((1, 8, 8, 2, 1, 64, torch.float16), TypeError),
])
def test_plan_backward_refuses(args, err):
    with pytest.raises(err):
        fa.plan_backward(*args)


@pytest.mark.parametrize("causal,window,off", [(True, 0, 0), (True, 24, 0),
                                               (False, 0, 0), (True, 7, 13),
                                               (False, 30, 5),
                                               (True, 100, 200)])
@pytest.mark.parametrize("dtype,d", [(BF16, 128), (BF16, 256), (F32, 64)])
def test_tile_walks_cover_every_live_pair(causal, window, off, dtype, d):
    # the dK/dV pass's query tiles hold every row that sees a key of the
    # block, the dQ pass's key tiles every key its rows see
    lq, lk = 150, 170
    p = fa.plan_backward(1, lq, lk, 2, 1, d, dtype, causal=causal,
                         window=window)

    def live(row, key):
        qp = off + row
        return ((not causal or key <= qp) and (not window or key > qp - window)
                and key < lk)

    for k0 in range(0, lk, p.kv_keys):
        t0, t1 = p.query_tiles(k0, off)
        for row in range(lq):
            if any(live(row, key) for key in range(k0, min(k0 + p.kv_keys,
                                                           lk))):
                assert t0 * p.kv_rows <= row < t1 * p.kv_rows
    for q0 in range(0, lq, p.q_rows):
        t0, t1 = p.key_tiles(q0, off)
        for row in range(q0, min(q0 + p.q_rows, lq)):
            for key in range(lk):
                if live(row, key):
                    assert t0 * p.q_keys <= key < t1 * p.q_keys


def test_wrapper_launches_the_backward_plan(monkeypatch):
    # a tensor off the CPU takes the kernel's route (meta: no data): the
    # wrapper pads the head dim as the forward, hands the launcher the
    # backward's plan, runs only the passes the gradients need, slices back,
    # counts one launch; without the forward's LSE it raises
    seen = []
    monkeypatch.setattr(ops, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(ops, "_aligned", lambda a: a)
    monkeypatch.setattr(fa, "launch_backward", lambda p, q, k, v, o, lse,
                        dout, dq, dk, dv, delta, q_off, q_off0, *, scale,
                        softcap: seen.append((p, tuple(q.shape), dq is None,
                                              dk is None, scale)))
    meta = dict(device="meta")
    ops.reset_launches()

    def call(d, needs, lse=True):
        q = torch.zeros(2, 9, 4, d, dtype=BF16, **meta)
        k = torch.zeros(2, 11, 2, d, dtype=BF16, **meta)
        stats = torch.zeros(2, 4, 9, **meta) if lse else None
        return ops._flash_attention_bwd_kernel(q, k, k, q, stats, q, 0, True,
                                               0, 0.0, needs)

    grads = call(128, (True, True, True))
    assert seen[-1][0] == fa.plan_backward(2, 9, 11, 4, 2, 128, BF16)
    assert seen[-1][2:4] == (False, False)
    assert [tuple(g.shape) for g in grads] == [(2, 9, 4, 128),
                                               (2, 11, 2, 128),
                                               (2, 11, 2, 128)]
    grads = call(100, (False, True, False))
    assert seen[-1][0].d == 112 and seen[-1][1] == (2, 9, 4, 112)
    assert seen[-1][2:4] == (True, False)
    assert seen[-1][4] == pytest.approx(1.0 / math.sqrt(100))
    assert grads[0] is None and grads[2] is None
    assert tuple(grads[1].shape) == (2, 11, 2, 100)
    call(64, (True, False, False))
    assert seen[-1][2:4] == (False, True)
    assert ops.LAUNCHES["flash_attention_bwd"] == 3
    with pytest.raises(ValueError, match="LSE"):
        call(64, (True, True, True), lse=False)
    assert ops.LAUNCHES["flash_attention_bwd"] == 3


def test_cuda_forward_asks_for_lse_only_under_grad(monkeypatch):
    # the autograd Function tells the CUDA forward to write the LSE exactly
    # when autograd will want a gradient of q, k or v
    asked = []

    def fake(q, k, v, q_offset, causal, window, softcap, lse=False):
        asked.append(lse)
        out = torch.zeros_like(q)
        return (out, torch.zeros(q.shape[0], q.shape[2], q.shape[1])) \
            if lse else out

    monkeypatch.setattr(ops, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(ops, "_flash_attention_kernel", fake)
    q = torch.zeros(1, 4, 2, 16)
    ops.flash_attention(q, q, q)
    ops.flash_attention(q.requires_grad_(), q, q)
    with torch.no_grad():
        ops.flash_attention(q, q, q)
    assert asked == [False, True, False]


# (b, lq, lk, h, kv, d, causal, window, offsets, dtype): slots with rows that
# see no key: causal rows before key 0 (a negative offset, a whole slot of
# them), windowed rows past the window of the last key, under each body
DEAD = [
    (2, 40, 50, 4, 2, 64, True, 12, (-9, 45), BF16),     # wgmma
    (2, 40, 50, 4, 2, 64, True, 12, (-9, 45), F32),      # fma
    (1, 30, 20, 2, 1, 16, False, 8, (10,), BF16),        # fma, bf16
    (2, 70, 90, 2, 2, 32, True, 0, (-70, 5), F32),       # slot 0 all dead
]


@pytest.mark.parametrize("case", DEAD)
def test_rows_that_see_no_key_follow_the_plain_version(case):
    # the plain version scores such a row -1e30 on every key: P = 1/Lk on
    # all of them, and the mask stops dS, so the row adds dO/Lk to every
    # key's dv and nothing to dq or dk; the emulated kernel does the same
    # (fp32 1e-5, bf16 2e-2 against the plain backward)
    b, lq, lk, h, kv, d, causal, window, offs, dtype = case
    rng = np.random.default_rng(lq + lk + d)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s)
                                      .astype(np.float32)).to(dtype)
                     for s in ((b, lq, h, d), (b, lk, kv, d), (b, lk, kv, d),
                               (b, lq, h, d)))
    opts = dict(causal=causal, window=window,
                q_offset=torch.tensor(offs) if b > 1 else offs[0])
    p = fa.plan_backward(b, lq, lk, h, kv, d, dtype, causal=causal,
                         window=window, q_offset=offs)
    dead = [p.dead_rows(o) for o in offs]
    assert any(x > 0 or y < lq for x, y in dead)
    out, lse = ref.flash_attention_ref(q, k, v, with_lse=True, **opts)
    got = fa.emulate_backward(p, q, k, v, out, lse, dout,
                              scale=1.0 / math.sqrt(d))
    want = ref.flash_attention_bwd_ref(q, k, v, dout, **opts)
    for g, w in zip(got, want):
        assert _rel(g, w) <= (1e-5 if dtype == F32 else 2e-2)
    for bi, (x, y) in enumerate(dead):
        rows = list(range(x)) + list(range(y, lq))
        assert not got[0][bi, rows].float().abs().sum() > 0
    if offs[0] == -lq:    # a slot of dead rows alone: dv = Σ dO / Lk
        mean = dout[0].float().reshape(lq, kv, h // kv, d).sum((0, 2)) / lk
        torch.testing.assert_close(got[2][0].float(),
                                   mean.expand(lk, kv, d), rtol=1e-5,
                                   atol=1e-6)
        assert not got[1][0].float().abs().sum() > 0


@pytest.mark.parametrize("d", [64, 128])
def test_split_ds_is_no_further_from_the_exact_gradient_than_plain(d):
    # in bf16 the kernel reads dS as bf16 hi + lo, so its dq and dk are no
    # further from the fp64 gradient of the same bf16 inputs than the plain
    # backward's fp32 scan (which rounds dP to bf16); its dv reads P in
    # bf16, as the forward does, and stays within the plain's 2x
    b, l, h, kv = 1, 192, 2, 1
    rng = np.random.default_rng(d)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s)
                                      .astype(np.float32)).to(BF16)
                     for s in ((b, l, h, d), (b, l, kv, d), (b, l, kv, d),
                               (b, l, h, d)))
    q = (q.float() * 2).to(BF16)      # peaked rows: P far from uniform
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", leaves[0],
                     leaves[1].repeat_interleave(h // kv, 2)) / math.sqrt(d)
    s = s.masked_fill(torch.ones(l, l).triu(1).bool(), -math.inf)
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1),
                     leaves[2].repeat_interleave(h // kv, 2))
    exact = torch.autograd.grad(o, leaves, dout.double())
    out, lse = ref.flash_attention_ref(q, k, v, with_lse=True)
    p = fa.plan_backward(b, l, l, h, kv, d, BF16, q_offset=0)
    got = fa.emulate_backward(p, q, k, v, out, lse, dout,
                              scale=1.0 / math.sqrt(d))
    plain = ref.flash_attention_bwd_ref(q, k, v, dout)
    errs = [_rel(g.double(), e) for g, e in zip(got, exact)]
    plain_errs = [_rel(g.double(), e) for g, e in zip(plain, exact)]
    assert errs[0] <= plain_errs[0] and errs[1] <= plain_errs[1]
    assert errs[2] <= 2 * plain_errs[2]
