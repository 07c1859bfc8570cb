"""Serving deepseek-v2-lite on the CPU: MLA's compressed {"c", "kr"} cache
paths, the model's prefill / chunked prefill / decode, ``Server`` and the
continuous-batching engine of the port against the JAX package, under the
config's own capacity MoE dispatch and under drop-free.

deepseek smoke in fp32 at 3 layers (one ``mla_dense_first`` unit, then a
stacked ``mla_moe`` stage of 2, whose cache leaves carry a leading layer
axis).  The compressed params come from one JAX ``compress_model`` per
dispatch on 8 x 32 numpy tokens (ratio 0.6, fused, one refine epoch: every
linear factorized, ``wk_b`` / ``wv_b`` included) and are bridged, so both
packages serve the same weights.  The JAX servers get an Auto-axis mesh:
its default mesh is Explicit on jax 0.9, which its sharding constraints
reject.  Under capacity the outputs depend on the tokens routed together,
so the gates there are equality with the reference at the same slots and
the same chunking; chunked against whole prefill runs under drop-free.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_smoke_config as j_smoke
from repro.core import CompressConfig as JCompressConfig
from repro.core import compress_model as j_compress_model
from repro.launch import serve as JS
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.launch import serve as TS
from repro_torch.models import attention as TA
from repro_torch.models import model as TM

ARCH = "deepseek-v2-lite-16b"
LAYERS = 3


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cfgs(dispatch, num_layers=LAYERS, dtype="float32"):
    """(JAX cfg, port cfg): deepseek smoke under ``dispatch``."""
    jc = j_smoke(ARCH).replace(dtype=dtype, num_layers=num_layers)
    tc = TC.get_smoke_config(ARCH).replace(dtype=dtype,
                                           num_layers=num_layers)
    return (jc.replace(moe=dataclasses.replace(jc.moe, dispatch=dispatch)),
            tc.replace(moe=dataclasses.replace(tc.moe, dispatch=dispatch)))


def _pair(tree):
    tree = jax.tree.map(np.asarray, tree)
    return jax.tree.map(jnp.asarray, tree), bridge.to_torch(tree)


@pytest.fixture(scope="module")
def models():
    """{dispatch: (jcfg, tcfg, {"dense": (jax, torch), "compressed":
    (jax, torch)})}: one JAX compression per dispatch."""
    out = {}
    for dispatch in ("capacity", "dropfree"):
        jcfg, tcfg = _cfgs(dispatch)
        dense = JM.init_params(jcfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        calib = {"tokens": jnp.asarray(
            rng.integers(0, jcfg.vocab_size, (8, 32)), jnp.int32)}
        comp, _ = j_compress_model(dense, jcfg, calib, JCompressConfig(
            ratio=0.6, rank_multiple=1, microbatch=4, calib_mode="fused",
            refine_epochs=1))
        out[dispatch] = (jcfg, tcfg, {"dense": _pair(dense),
                                      "compressed": _pair(comp)})
    return out


@functools.lru_cache(maxsize=None)
def _dense_params(num_layers):
    jcfg, _ = _cfgs("capacity", num_layers)
    return _pair(JM.init_params(jcfg, jax.random.PRNGKey(0)))


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _assert_trees_close(got, want, rtol, atol):
    got = bridge.to_numpy(got)
    want = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# caches


@pytest.mark.parametrize("num_layers", [2, 3])
@pytest.mark.parametrize("with_params", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(num_layers, with_params, dtype):
    # {"c", "kr"} for every MLA sub-block, with or without params (MLA
    # never takes the latent {"lk", "lv"} layout); a stacked leading layer
    # axis on the mla_moe stage at 3 layers; shapes and dtypes exactly
    jcfg, tcfg = _cfgs("capacity", num_layers, dtype)
    jp, tp = _dense_params(num_layers) if with_params else (None, None)
    want = JM.init_cache(jcfg, 3, 40, params=jp)
    got = TM.init_cache(tcfg, 3, 40, params=tp, device="cpu")
    assert jax.tree.structure(bridge.to_numpy(got)) \
        == jax.tree.structure(jax.tree.map(np.asarray, want))
    for g, w in zip(jax.tree.leaves(bridge.to_numpy(got)),
                    jax.tree.leaves(want)):
        assert g.shape == w.shape and str(g.dtype) == str(w.dtype)
        assert not np.asarray(g, np.float32).any()
    assert [sorted(c) for per_kind in got for c in per_kind] \
        == [["c", "kr"]] * len(got)
    lead = () if num_layers == 2 else (2,)
    assert tuple(got[1][0]["c"].shape) == lead + (3, 40, 32)


def test_cache_slot_take_put_round_trip():
    # the stacked mla_moe stage (layer axis 0, batch axis 1) and the
    # unstacked dense-first one (batch axis 0)
    _, tcfg = _cfgs("capacity")
    cache = TM.init_cache(tcfg, 3, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    leaves = [t for per_kind in cache for c in per_kind for t in c.values()]
    for leaf in leaves:
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    before = [t.clone() for t in leaves]
    slot = TM.cache_slot_take(tcfg, cache, 1)
    assert tuple(slot[0][0]["c"].shape) == (1, 16, 32)
    assert tuple(slot[1][0]["c"].shape) == (2, 1, 16, 32)
    assert tuple(slot[1][0]["kr"].shape) == (2, 1, 16, 8)
    assert torch.equal(slot[1][0]["c"][:, 0], cache[1][0]["c"][:, 1])
    assert torch.equal(slot[0][0]["kr"][0], cache[0][0]["kr"][1])
    for per_kind in slot:
        for c in per_kind:
            for t in c.values():
                t.fill_(7.0)             # a copy: the cache is intact
    assert all(torch.equal(a, b) for a, b in zip(leaves, before))
    assert TM.cache_slot_put(tcfg, cache, slot, 1) is cache
    for leaf, old in zip(leaves, before):
        axis = leaf.dim() - 3            # the batch axis
        for b in range(3):
            got, prev = leaf.select(axis, b), old.select(axis, b)
            if b == 1:
                assert bool((got == 7.0).all())
            else:
                assert torch.equal(got, prev)


# ---------------------------------------------------------------------------
# MLA's cache paths against the JAX functions


def _attn_params(factorized):
    """MLA attention params (the JAX package's init); ``factorized`` swaps
    wk_b / wv_b for rank-5 {v, u} pairs, as compression leaves them."""
    jcfg, tcfg = _cfgs("capacity")
    p = jax.tree.map(np.asarray, JA.mla_init(jax.random.PRNGKey(3), jcfg))
    if factorized:
        rng = np.random.default_rng(4)
        for name in ("wk_b", "wv_b"):
            n, m = p[name]["w"].shape
            p[name] = {"v": _rand(rng, n, 5) / np.sqrt(n),
                       "u": _rand(rng, 5, m) / np.sqrt(5)}
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), bridge.to_torch(p)


def _ctx(jcfg, tcfg, positions):
    jctx = JM.make_ctx(jcfg, jnp.asarray(positions))
    tctx = TM.make_ctx(tcfg, torch.from_numpy(positions))
    return (jctx["cos"], jctx["sin"]), (tctx["cos"], tctx["sin"])


def _caches(rng, b, lmax, cfg):
    m = cfg.mla
    return (_rand(rng, b, lmax, m.kv_lora_rank),
            _rand(rng, b, lmax, m.qk_rope_head_dim))


def _close(got, want):
    # the same fp32 einsums, summed in another order: rtol 1e-5, atol 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("factorized", [False, True])
@pytest.mark.parametrize("q_pos", ["one", "slots", "chunk"])
def test_absorbed_attend_matches_reference(factorized, q_pos):
    # q_pos (1, 1), (B, 1) and (1, Lq): keys past each query masked
    jcfg, tcfg, jp, tp = _attn_params(factorized)
    m, h = jcfg.mla, jcfg.num_heads
    rng = np.random.default_rng(5)
    b, lq, lmax = 3, (4 if q_pos == "chunk" else 1), 12
    qn = _rand(rng, b, lq, h, m.qk_nope_head_dim)
    qr = _rand(rng, b, lq, h, m.qk_rope_head_dim)
    cc, kr = _caches(rng, b, lmax, jcfg)
    pos = {"one": np.array([[7]]), "slots": np.array([[0], [11], [5]]),
           "chunk": np.array([[3, 4, 5, 6]])}[q_pos].astype(np.int32)
    want = JA._mla_absorbed_attend(jp, *map(jnp.asarray, (qn, qr, cc, kr,
                                                          pos)), jcfg)
    got = TA._mla_absorbed_attend(tp, *map(torch.from_numpy, (qn, qr, cc, kr,
                                                              pos)), tcfg)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (b, lq, h, m.v_head_dim)
    _close(got, want)


@pytest.mark.parametrize("factorized", [False, True])
@pytest.mark.parametrize("per_slot", [False, True])
def test_mla_decode_matches_reference(factorized, per_slot):
    # output and both caches, written in place at one position or at each
    # slot's own
    jcfg, tcfg, jp, tp = _attn_params(factorized)
    rng = np.random.default_rng(6)
    b, lmax = 3, 12
    x = _rand(rng, b, 1, jcfg.d_model) * 0.5
    cc, kr = _caches(rng, b, lmax, jcfg)
    if per_slot:
        pos = np.array([9, 0, 11], np.int32)
        (jcos, jsin), (tcos, tsin) = _ctx(jcfg, tcfg, pos[:, None])
        jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    else:
        (jcos, jsin), (tcos, tsin) = _ctx(jcfg, tcfg, np.array([6]))
        jpos = tpos = 6
    want = JA.mla_decode(jp, jnp.asarray(x), jnp.asarray(cc),
                         jnp.asarray(kr), jpos, jcfg, jcos, jsin)
    tc, tkr = torch.from_numpy(cc.copy()), torch.from_numpy(kr.copy())
    got = TA.mla_decode(tp, torch.from_numpy(x), tc, tkr, tpos, tcfg, tcos,
                        tsin)
    assert got[1] is tc and got[2] is tkr
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("factorized", [False, True])
def test_mla_prefill_cached_matches_reference(factorized):
    # a 5-row chunk written at 4 into a 12-position cache, attending
    # against all of it
    jcfg, tcfg, jp, tp = _attn_params(factorized)
    rng = np.random.default_rng(7)
    x = _rand(rng, 2, 5, jcfg.d_model) * 0.5
    cc, kr = _caches(rng, 2, 12, jcfg)
    (jcos, jsin), (tcos, tsin) = _ctx(jcfg, tcfg, np.arange(4, 9))
    want = JA.mla_prefill_cached(jp, jnp.asarray(x), jnp.asarray(cc),
                                 jnp.asarray(kr), 4, jcfg, jcos, jsin)
    got = TA.mla_prefill_cached(tp, torch.from_numpy(x),
                                torch.from_numpy(cc.copy()),
                                torch.from_numpy(kr.copy()), 4, tcfg, tcos,
                                tsin)
    for g, w in zip(got, want):
        _close(g, w)


def test_mla_prefill_returns_the_cache():
    jcfg, tcfg, jp, tp = _attn_params(True)
    x = _rand(np.random.default_rng(8), 2, 6, jcfg.d_model) * 0.5
    (jcos, jsin), (tcos, tsin) = _ctx(jcfg, tcfg, np.arange(6))
    jy, (jc, jkr) = JA.mla_prefill(jp, jnp.asarray(x), jcfg, jcos, jsin,
                                   return_cache=True)
    ty, (tc, tkr) = TA.mla_prefill(tp, torch.from_numpy(x), tcfg, tcos,
                                   tsin, return_cache=True)
    for g, w in ((ty, jy), (tc, jc), (tkr, jkr)):
        _close(g, w)


# ---------------------------------------------------------------------------
# the model's serving calls


@pytest.mark.parametrize("dispatch", ["capacity", "dropfree"])
@pytest.mark.parametrize("which", ["dense", "compressed"])
def test_prefill_and_decode_match_reference(models, dispatch, which):
    # whole prefill (expanded), a chunk (absorbed), then decode at a scalar
    # and at a per-slot (B,) position: logits and caches against the JAX
    # package, fp32: rtol 1e-4, atol 1e-5
    jcfg, tcfg, m = models[dispatch]
    jp, tp = m[which]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jc = JM.init_cache(jcfg, 2, 32)
    tc = TM.init_cache(tcfg, 2, 32, device="cpu")

    def check(got, want):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        _assert_trees_close(got[1], want[1], 1e-4, 1e-5)

    want = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :8])}, jc)
    got = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :8])},
                     tc)
    check(got, want)
    want = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, 8:])},
                      want[1], pos=8, chunked=True, last_idx=2)
    got = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, 8:])},
                     got[1], pos=8, chunked=True, last_idx=2)
    check(got, want)
    step = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    want = JM.decode_step(jp, jcfg, want[1], jnp.asarray(step), 12)
    got = TM.decode_step(tp, tcfg, got[1], torch.from_numpy(step), 12)
    check(got, want)
    pos = np.array([13, 5], np.int32)
    want = JM.decode_step(jp, jcfg, want[1], jnp.asarray(step),
                          jnp.asarray(pos))
    got = TM.decode_step(tp, tcfg, got[1], torch.from_numpy(step),
                         torch.from_numpy(pos))
    check(got, want)


@pytest.mark.parametrize("which", ["dense", "compressed"])
def test_chunked_prefill_matches_whole_prefill(models, which):
    # the port alone, drop-free: chunks of 4 (absorbed) against one whole
    # prefill (expanded) — different arithmetic, held to the reference's
    # own prefill / decode tolerance: rtol 2e-3, atol 2e-3 on the logits
    # and the cache
    _, tcfg, m = models["dropfree"]
    _, tp = m[which]
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 12)).astype(np.int32))
    whole = TM.prefill(tp, tcfg, {"tokens": toks},
                       TM.init_cache(tcfg, 2, 24, device="cpu"))
    cache = TM.init_cache(tcfg, 2, 24, device="cpu")
    for c0 in range(0, 12, 4):
        logits, cache = TM.prefill(tp, tcfg, {"tokens": toks[:, c0:c0 + 4]},
                                   cache, pos=c0, chunked=True)
    torch.testing.assert_close(logits, whole[0], rtol=2e-3, atol=2e-3)
    for got, want in zip(jax.tree.leaves(bridge.to_numpy(cache)),
                         jax.tree.leaves(bridge.to_numpy(whole[1]))):
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("which", ["dense", "compressed"])
def test_decode_after_prefill_matches_forward(models, which):
    # the port alone, drop-free: prefill of all but the last token, then
    # one decode step, against the full forward's last row (rtol 2e-3,
    # atol 2e-3, as the reference holds itself)
    _, tcfg, m = models["dropfree"]
    _, tp = m[which]
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (2, 14)).astype(np.int32))
    with torch.no_grad():
        hidden, _ = TM.forward_hidden(tp, tcfg, {"tokens": toks})
        full = TM.logits_from_hidden(tp, tcfg, hidden[:, -1:])[:, 0]
    cache = TM.init_cache(tcfg, 2, 18, device="cpu")
    TM.prefill(tp, tcfg, {"tokens": toks[:, :-1]}, cache)
    dec, _ = TM.decode_step(tp, tcfg, cache, toks[:, -1:], 13)
    torch.testing.assert_close(dec, full, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the servers


@pytest.mark.parametrize("dispatch", ["capacity", "dropfree"])
def test_server_tokens_match_reference(models, dispatch):
    # 3 prompts on 4 slots: under capacity the zero row _pad_batch adds
    # takes capacity slots in both packages
    jcfg, tcfg, m = models[dispatch]
    jp, tp = m["compressed"]
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    want = JS.Server(jcfg, jp, max_len=32, batch=4, mesh=_auto_mesh()
                     ).generate(jnp.asarray(prompts), steps=8)
    got = TS.Server(tcfg, tp, max_len=32, batch=4, device="cpu"
                    ).generate(prompts, steps=8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _requests(module, rng, vocab):
    lens, steps = (5, 13, 9), (6, 4, 7)
    return [module.Request(rid=i, prompt=rng.integers(0, vocab, (n,))
                           .astype(np.int32), steps=s)
            for i, (n, s) in enumerate(zip(lens, steps))]


@pytest.mark.parametrize("dispatch", ["capacity", "dropfree"])
@pytest.mark.parametrize("chunk", [8, 0])
def test_engine_tokens_match_reference(models, dispatch, chunk):
    # 3 requests on 2 slots (the third refills a freed slot): chunked
    # (absorbed) or whole padded-bucket (expanded) prefill, parked slots
    # riding along at position 0; tokens and prefill routes equal the JAX
    # engine's
    jcfg, tcfg, m = models[dispatch]
    jp, tp = m["compressed"]
    seed = 3 + chunk
    jeng = JS.ContinuousBatchingServer(jcfg, jp, max_len=40, slots=2,
                                       prefill_chunk=chunk,
                                       mesh=_auto_mesh())
    want = jeng.run(_requests(JS, np.random.default_rng(seed),
                              jcfg.vocab_size))
    teng = TS.ContinuousBatchingServer(tcfg, tp, max_len=40, slots=2,
                                       prefill_chunk=chunk, device="cpu")
    got = teng.run(_requests(TS, np.random.default_rng(seed),
                             jcfg.vocab_size))
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid]["tokens"],
                                      want[rid]["tokens"])
    assert teng.prefill_routes == jeng.prefill_routes
    assert set(teng.prefill_routes.values()) == {
        "chunked" if chunk else "whole_padded"}
    assert len(teng.decode_step_times) == len(jeng.decode_step_times)
