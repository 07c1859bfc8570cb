"""Serving on the CPU: caches, prefill / decode logits and greedy tokens of
the port against the JAX package, on llama smoke (dense and compressed).

The compressed params come from the JAX package's ``compress_model`` on 8 x
32 numpy tokens (ratio 0.6, rank 19 everywhere) and are bridged, so both
packages serve the same weights.  The JAX servers get an Auto-axis mesh:
its default mesh is Explicit on jax 0.9, which its sharding constraints
reject (ROADMAP hazard 3a).
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.core import CompressConfig as JCompressConfig
from repro.core import compress_model as j_compress_model
from repro.core import zoo
from repro.launch import serve as JS
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.launch import serve as TS
from repro_torch.models import model as TM


@pytest.fixture(scope="module")
def models():
    cfg = zoo.smoke_cfg("llama-7b")
    tcfg = TC.get_smoke_config("llama-7b").replace(dtype="float32")
    dense = JM.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    calib = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (8, 32)),
                                   jnp.int32)}
    comp, _ = j_compress_model(dense, cfg, calib, JCompressConfig(
        ratio=0.6, rank_multiple=1, microbatch=4, calib_mode="fused",
        refine_epochs=1))
    out = {}
    for name, p in (("dense", dense), ("compressed", comp)):
        tree = jax.tree.map(np.asarray, p)
        out[name] = (jax.tree.map(jnp.asarray, tree), bridge.to_torch(tree))
    return cfg, tcfg, out


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _np(tree):
    return jax.tree.map(np.asarray, bridge.to_numpy(tree))


def _assert_trees_close(got, want, rtol, atol):
    got, want = _np(got), jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("which", ["dense", "compressed"])
@pytest.mark.parametrize("with_params", [False, True])
def test_init_cache_matches_reference(models, which, with_params):
    # leaf for leaf: the latent {"lk", "lv"} layout exactly when params
    # with factorized k/v are given
    cfg, tcfg, m = models
    jp, tp = m[which]
    want = JM.init_cache(cfg, 3, 40, params=jp if with_params else None)
    got = TM.init_cache(tcfg, 3, 40, params=tp if with_params else None,
                        device="cpu")
    _assert_trees_close(got, want, 0, 0)
    kind = set(got[0][0])
    assert kind == ({"lk", "lv"} if which == "compressed" and with_params
                    else {"k", "v"})


@pytest.mark.parametrize("which,layout", [("dense", "dense"),
                                          ("compressed", "dense"),
                                          ("compressed", "latent")])
def test_prefill_and_decode_match_reference(models, which, layout):
    # whole prefill, chunked prefill, then decode at a scalar and at a
    # per-slot (B,) position: logits and caches against the JAX package,
    # fp32: rtol 1e-4, atol 1e-5
    cfg, tcfg, m = models
    jp, tp = m[which]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    cp = (jp, tp) if layout == "latent" else (None, None)
    jc = JM.init_cache(cfg, 2, 32, params=cp[0])
    tc = TM.init_cache(tcfg, 2, 32, params=cp[1], device="cpu")

    def check(got, want):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        _assert_trees_close(got[1], want[1], 1e-4, 1e-5)

    want = JM.prefill(jp, cfg, {"tokens": jnp.asarray(toks[:, :8])}, jc)
    got = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :8])}, tc)
    check(got, want)
    # the next 4 prompt tokens as a chunk against the whole cache, logits
    # of row 2
    want = JM.prefill(jp, cfg, {"tokens": jnp.asarray(toks[:, 8:])},
                      want[1], pos=8, chunked=True, last_idx=2)
    got = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, 8:])},
                     got[1], pos=8, chunked=True, last_idx=2)
    check(got, want)
    step = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    want = JM.decode_step(jp, cfg, want[1], jnp.asarray(step), 12)
    got = TM.decode_step(tp, tcfg, got[1], torch.from_numpy(step), 12)
    check(got, want)
    pos = np.array([13, 5], np.int32)
    want = JM.decode_step(jp, cfg, want[1], jnp.asarray(step),
                          jnp.asarray(pos))
    got = TM.decode_step(tp, tcfg, got[1], torch.from_numpy(step),
                         torch.from_numpy(pos))
    check(got, want)


@pytest.mark.parametrize("which", ["dense", "compressed"])
def test_server_tokens_match_reference(models, which):
    cfg, tcfg, m = models
    jp, tp = m[which]
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    want = JS.Server(cfg, jp, max_len=32, batch=4, mesh=_auto_mesh()
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


@pytest.mark.parametrize("which,chunk,layout", [
    ("compressed", 8, "auto"), ("compressed", 0, "auto"),
    ("compressed", 8, "dense"), ("compressed", 0, "dense"),
    ("dense", 8, "auto")])
def test_engine_tokens_match_reference(models, which, chunk, layout):
    # 3 requests on 2 slots (the third refills a freed slot); tokens and
    # prefill routes equal the JAX engine's
    cfg, tcfg, m = models
    jp, tp = m[which]
    seed = 3 + chunk
    jeng = JS.ContinuousBatchingServer(cfg, jp, max_len=40, slots=2,
                                       prefill_chunk=chunk, mesh=_auto_mesh(),
                                       cache_layout=layout)
    want = jeng.run(_requests(JS, np.random.default_rng(seed),
                              cfg.vocab_size))
    teng = TS.ContinuousBatchingServer(tcfg, tp, max_len=40, slots=2,
                                       prefill_chunk=chunk,
                                       cache_layout=layout, device="cpu")
    got = teng.run(_requests(TS, np.random.default_rng(seed),
                             cfg.vocab_size))
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid]["tokens"],
                                      want[rid]["tokens"])
    assert teng.prefill_routes == jeng.prefill_routes
    assert len(teng.decode_step_times) == len(jeng.decode_step_times)


def test_cache_slot_take_put_round_trip(models):
    cfg, tcfg, m = models
    _, tp = m["compressed"]
    cache = TM.init_cache(tcfg, 3, 16, params=tp, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for leaf in (cache[0][0]["lk"], cache[0][0]["lv"]):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    before = [t.clone() for t in cache[0][0].values()]
    slot = TM.cache_slot_take(tcfg, cache, 1)
    assert tuple(slot[0][0]["lk"].shape) == (2, 1, 16, 19)   # layers, 1, L, r
    assert torch.equal(slot[0][0]["lk"][:, 0], cache[0][0]["lk"][:, 1])
    slot[0][0]["lk"].fill_(7.0)                 # a copy: the cache is intact
    assert torch.equal(cache[0][0]["lk"], before[0])
    out = TM.cache_slot_put(tcfg, cache, slot, 1)
    assert out is cache
    assert torch.equal(cache[0][0]["lk"][:, 1], torch.full((2, 16, 19), 7.0))
    assert torch.equal(cache[0][0]["lk"][:, 0], before[0][:, 0])
    assert torch.equal(cache[0][0]["lk"][:, 2], before[0][:, 2])
    assert torch.equal(cache[0][0]["lv"], before[1])


@pytest.mark.parametrize("layout", ["dense", "latent"])
def test_chunked_prefill_equals_whole_prefill(models, layout):
    # the port alone: chunks of 4 against the whole cache give the logits
    # and cache of one whole prefill (fp32, sums in another order: rtol
    # 1e-5, atol 1e-6 on the logits and 1e-5 on the O(1) cache entries)
    _, tcfg, m = models
    _, tp = m["compressed"]
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 12)).astype(np.int32))
    cp = tp if layout == "latent" else None
    whole = TM.prefill(tp, tcfg, {"tokens": toks},
                       TM.init_cache(tcfg, 2, 24, params=cp, device="cpu"))
    cache = TM.init_cache(tcfg, 2, 24, params=cp, device="cpu")
    for c0 in range(0, 12, 4):
        logits, cache = TM.prefill(tp, tcfg, {"tokens": toks[:, c0:c0 + 4]},
                                   cache, pos=c0, chunked=True)
    torch.testing.assert_close(logits, whole[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(bridge.to_numpy(cache[0][0]).values(),
                    bridge.to_numpy(whole[1][0][0]).values()):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_latent_decode_equals_dense_decode(models):
    # one compressed model, two caches: latent (flash_decode) and dense
    # (flash_attention over up-projected k/v); teacher-forced tokens at
    # per-slot positions, fp32: rtol 1e-4, atol 1e-5
    _, tcfg, m = models
    _, tp = m["compressed"]
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 16))
                            .astype(np.int32))
    caches = {name: TM.init_cache(tcfg, 2, 24, params=p, device="cpu")
              for name, p in (("latent", tp), ("dense", None))}
    logits = {}
    for name, cache in caches.items():
        TM.prefill(tp, tcfg, {"tokens": toks[:, :6]}, cache)
        rows = []
        for i in range(6, 16):
            pos = torch.tensor([i, i - 3], dtype=torch.int32)
            step = toks[:, i:i + 1]
            rows.append(TM.decode_step(tp, tcfg, cache, step, pos)[0])
        logits[name] = torch.stack(rows)
    assert set(caches["latent"][0][0]) == {"lk", "lv"}
    torch.testing.assert_close(logits["latent"], logits["dense"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("arch,ratio", [("llama-7b", "0.6"),
                                        ("deepseek-v2-lite-16b", None)])
@pytest.mark.parametrize("engine", [False, True])
def test_serve_main_on_cpu(engine, arch, ratio, capsys):
    # llama compressed before serving; deepseek served dense under its own
    # capacity dispatch over MLA's {"c", "kr"} cache
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8",
            "--steps", "4", "--device", "cpu"]
    argv += ["--ratio", ratio] if ratio else []
    toks = TS.main(argv + (["--engine"] if engine else []))
    assert toks.shape == (2, 4)
    assert ((0 <= toks) & (toks < 256)).all()
    out = capsys.readouterr().out
    assert ("compressed to ratio 0.6" in out) == (ratio is not None)
