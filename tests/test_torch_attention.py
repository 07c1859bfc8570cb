"""Attention on the CPU: the port's ``flash_attention`` / ``flash_decode``
plain versions against the JAX package's model path and its Pallas kernels
in interpret mode, the autograd rule, and the wrappers' padding.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each against its plain version there.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as JA
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# (b, lq, lk, h, kv, d, causal, window, softcap, q_offset)
MODEL_PATH_CASES = {
    "causal": (2, 24, 24, 4, 4, 16, True, 0, 0.0, 0),
    "scalar_offset": (2, 8, 40, 4, 4, 16, True, 0, 0.0, 17),
    "per_slot_offset": (3, 1, 40, 4, 4, 16, True, 0, 0.0, [0, 13, 39]),
    "per_slot_chunk": (3, 6, 40, 4, 2, 16, True, 0, 0.0, [0, 5, 30]),
    "window": (2, 30, 30, 4, 4, 16, True, 7, 0.0, 0),
    "softcap": (2, 20, 20, 4, 4, 16, True, 0, 30.0, 0),
    "gqa": (2, 20, 20, 4, 2, 16, True, 0, 0.0, 0),
    "ragged_noncausal": (1, 13, 77, 4, 2, 32, False, 0, 0.0, 0),
    "window_softcap_gqa": (2, 77, 77, 4, 2, 16, True, 16, 30.0, 0),
}


@pytest.mark.parametrize("case", sorted(MODEL_PATH_CASES))
def test_flash_attention_ref_matches_model_path(case):
    # fp32, the same online-softmax recurrence with chunk 16 (several
    # chunks, a ragged last one): rtol 1e-5, atol 1e-6 for entries near 0
    b, lq, lk, h, kv, d, causal, window, softcap, off = MODEL_PATH_CASES[case]
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, b, lq, h, d), _rand(rng, b, lk, kv, d), \
        _rand(rng, b, lk, kv, d)
    per_slot = isinstance(off, list)
    joff = jnp.asarray(off, jnp.int32) if per_slot else off
    toff = torch.tensor(off, dtype=torch.int32) if per_slot else off
    want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, q_offset=joff,
                              chunk=16, softcap=softcap)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                  window=window, q_offset=toff, chunk=16,
                                  softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the wrapper (autograd Function) takes the plain version on the CPU
    wrapped = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                  window=window, q_offset=toff, chunk=16,
                                  softcap=softcap)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("lq,lk,causal,window", [(64, 64, True, 0),
                                                 (64, 64, True, 24),
                                                 (50, 77, False, 0),
                                                 (77, 77, True, 0)])
def test_flash_attention_ref_matches_pallas(lq, lk, causal, window):
    # the Pallas kernel (interpret mode) in its (B, H, L, D) layout, with
    # padded Lq / Lk where they are ragged; it multiplies in fp32 with q
    # pre-scaled: rtol 1e-5, atol 1e-6
    rng = np.random.default_rng(1)
    b, h, kv, d = 2, 4, 2, 16
    q, k, v = _rand(rng, b, lq, h, d), _rand(rng, b, lk, kv, d), \
        _rand(rng, b, lk, kv, d)
    tr = (0, 2, 1, 3)
    want = jops.flash_attention(
        jnp.asarray(q.transpose(tr)), jnp.asarray(k.transpose(tr)),
        jnp.asarray(v.transpose(tr)), causal=causal, window=window,
        force_pallas=True, interpret=True)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                  window=window)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(tr), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("rk,rv,h,kv", [(19, 24, 4, 2), (24, 19, 4, 4)])
def test_flash_decode_ref_matches_pallas(rope, rk, rv, h, kv):
    # per-slot lengths, odd ranks, g = 2 and g = 1; U in the stored
    # (r, KV·D) layout on both sides; all fp32: rtol 1e-5, atol 1e-6
    rng = np.random.default_rng(2)
    b, l, d = 3, 77, 16
    q = _rand(rng, b, h, d)
    lk, lv = _rand(rng, b, l, rk), _rand(rng, b, l, rv)
    uk = _rand(rng, rk, kv * d) / np.sqrt(rk)
    uv = _rand(rng, rv, kv * d) / np.sqrt(rv)
    lengths = np.array([1, 40, 77], np.int32)
    cos, sin = TL.rope_table(torch.arange(l), d, 10000.0)
    args = (q, lk, lv, uk, uv, lengths, cos.numpy(), sin.numpy())
    want = jops.flash_decode(*map(jnp.asarray, args), rope=rope,
                             force_pallas=True, interpret=True)
    got = ops.flash_decode(*map(_t, args), rope=rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_flash_decode_equals_attention_over_upprojected_cache():
    # the latent decode is attention of q over keys l_k U_k (RoPE'd) and
    # values l_v U_v with per-slot lengths: one function, two routes
    rng = np.random.default_rng(3)
    b, l, h, kv, d, rk, rv = 3, 40, 4, 2, 16, 19, 24
    q = _t(_rand(rng, b, h, d))
    lk, lv = _t(_rand(rng, b, l, rk)), _t(_rand(rng, b, l, rv))
    uk, uv = _t(_rand(rng, rk, kv * d)), _t(_rand(rng, rv, kv * d))
    pos = torch.tensor([0, 17, 39], dtype=torch.int32)
    cos, sin = TL.rope_table(torch.arange(l), d, 10000.0)
    got = ops.flash_decode(q, lk, lv, uk, uv, pos + 1, cos, sin)
    k = TL.apply_rope((lk @ uk).reshape(b, l, kv, d), cos, sin)
    v = (lv @ uv).reshape(b, l, kv, d)
    want = ref.flash_attention_ref(q[:, None], k, v, q_offset=pos)[:, 0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("per_slot", [False, True])
def test_flash_attention_backward_matches_autograd(per_slot):
    # the autograd Function's backward (recomputed plain version) against
    # autograd through the plain version: fp32, rtol 1e-5 / atol 1e-6
    rng = np.random.default_rng(4)
    b, lq, lk, h, kv, d = 2, 5, 21, 4, 2, 16
    arrays = [_rand(rng, b, lq, h, d), _rand(rng, b, lk, kv, d),
              _rand(rng, b, lk, kv, d)]
    dout = _t(_rand(rng, b, lq, h, d))
    off = torch.tensor([3, 16], dtype=torch.int32) if per_slot else 16
    kw = dict(window=9, softcap=20.0, q_offset=off, chunk=8)

    def leaves():
        return [torch.tensor(a, requires_grad=True) for a in arrays]

    a = leaves()
    ops.flash_attention(*a, **kw).backward(dout)
    p = leaves()
    ref.flash_attention_ref(*p, **kw).backward(dout)
    for ga, gp in zip(a, p):
        torch.testing.assert_close(ga.grad, gp.grad, rtol=1e-5, atol=1e-6)
    # a gradient asked for q only
    qa = torch.tensor(arrays[0], requires_grad=True)
    ops.flash_attention(qa, _t(arrays[1]), _t(arrays[2]), **kw).backward(dout)
    torch.testing.assert_close(qa.grad, p[0].grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [8, 16, 24, 96, 100, 112])
def test_head_dim_padding_is_exact(d):
    # the wrapper zero-pads D up to a compiled head dim and passes the scale
    # of the true D: the padded plain version, sliced back, is the same
    # function (fp32 sums with zero terms added: rtol 1e-6).  A compiled D
    # (96: phi-3-vision, 112: kimi-k2 and zamba2) is not padded: the
    # caller's tensor goes through as it is
    rng = np.random.default_rng(5)
    q, k, v = (_t(_rand(rng, 2, 9, 4, d)), _t(_rand(rng, 2, 9, 2, d)),
               _t(_rand(rng, 2, 9, 2, d)))
    dp = ops._padded_head_dim(d)
    assert dp == {8: 16, 16: 16, 24: 32, 96: 96, 100: 112, 112: 112}[d]
    if dp == d:
        assert all(ops.pad_dim(t, 3, dp) is t for t in (q, k, v))
    padded = ref.flash_attention_ref(
        *(ops.pad_dim(t, 3, dp) for t in (q, k, v)),
        scale=1.0 / math.sqrt(d))[..., :d]
    torch.testing.assert_close(padded, ref.flash_attention_ref(q, k, v),
                               rtol=1e-6, atol=1e-6)


def test_decode_shared_memory_plan():
    # the llama-7b latent decode (g 1, D 128) fits one keys block's shared
    # memory in either body (no block holds a rank-sized array); a group of
    # query heads no block can hold is refused before launch
    assert tfd.smem_bytes("wgmma", 1, 128) < tfd.MAX_SMEM
    assert tfd.smem_bytes("fma", 1, 128) < tfd.MAX_SMEM
    assert tfd.smem_bytes("wgmma", 32, 128) > tfd.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        tfd.plan(1, 64, 64, 2, 128, 64, 64, torch.bfloat16)


def test_attention_wrappers_refuse_tensors_they_cannot_run():
    meta = dict(device="meta")
    q = torch.zeros(1, 4, 2, 16, **meta)
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_decode(torch.zeros(1, 2, 16, **meta),
                         torch.zeros(1, 8, 3, **meta),
                         torch.zeros(1, 8, 3, **meta),
                         torch.zeros(3, 32, **meta),
                         torch.zeros(3, 32, **meta),
                         torch.zeros(1, dtype=torch.int32, **meta),
                         torch.zeros(8, 8, **meta),
                         torch.zeros(8, 8, **meta))
