"""phi-3-vision-4.2b (patch embeddings spliced before the tokens) through
the port against the JAX package on the CPU.

Smoke config in fp32: 2 ``attn`` layers, d_model 64, 4 heads of 16
(RoPE), SwiGLU, 8 patches.  Function by function on bridged params and
numpy-made inputs: ``_embed_inputs`` (the patches before the tokens),
``forward_hidden`` and the loss (labels over patches + tokens, zeros under
the patches, as the JAX package's data makes them: 1e-5), ``prefill`` and
``decode_step`` (scalar and per-slot positions, decode starting past the
patches) over the dense and the latent cache (1e-5), ``init_cache``.

``compress_model`` is shared a mode through a module-scoped fixture
(fused, sequential, hybrid, adaptive), one JAX and one port run from the
same bridged params and the same 16 x 32 uniform tokens with 16 x 8
patches at the embeddings' 0.02 scale (ratio 0.6, ``rank_multiple=1``,
one refine epoch, microbatch 2).  Held exactly: unit names, ranks, tapped
forwards; to 1e-3 relative Frobenius: every composed map, compared as it
acts on the shifted stream the solve saw in sequential mode (its later
groups are collected after the earlier ones are solved, as in
``tests/test_torch_hybrid.py``); ppl to 0.5 %.  Serving: ``Server`` and
the engine (latent and dense caches, every request ``whole_extras``) give
the JAX servers' tokens (its servers on an Auto-axis mesh, ROADMAP hazard
3a), and the JAX package's two vision decode-position regressions
(``tests/test_serving.py:32``, ``:71``) hold for the port.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_smoke_config as j_smoke
from repro.core import pipeline as JP
from repro.core.factorized import factorize_params as j_factorize
from repro.launch import serve as JS
from repro.models import blocks as JB
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.core import pipeline as TP
from repro_torch.core.factorized import factorize_params
from repro_torch.launch import serve as TS
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM

ARCH = "phi-3-vision-4.2b"
RECIPE = dict(ratio=0.6, rank_multiple=1, microbatch=2, refine_epochs=1,
              debug_covs=True)
CALIB = (16, 32)
MAP_TOL = 1e-3


def _cfgs(**kw):
    return (j_smoke(ARCH).replace(dtype="float32", **kw),
            TC.get_smoke_config(ARCH).replace(dtype="float32", **kw))


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _dense(cfg, seed=0):
    return jax.tree.map(np.asarray, JM.init_params(cfg,
                                                   jax.random.PRNGKey(seed)))


def _patches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal(
        (n, cfg.num_patches, cfg.d_model))).astype(np.float32)


def _batches(cfg, n=2, seed=4):
    """Eval batches with patches; labels over patches + tokens, zeros under
    the patches (the JAX package's ``_add_frontend_inputs``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = rng.integers(0, cfg.vocab_size, (4, 25)).astype(np.int32)
        labels = np.concatenate([np.zeros((4, cfg.num_patches), np.int32),
                                 t[:, 1:]], axis=1)
        out.append({"tokens": t[:, :-1], "labels": labels,
                    "patches": _patches(cfg, 4, seed + 10 * i)})
    return out


def _ppl(loss, params, cfg, batches, to):
    tot = sum(float(loss(params, cfg, {k: to(v) for k, v in b.items()})[0])
              for b in batches)
    return float(np.exp(tot / len(batches)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    if tree is None:
        return None
    return tuple(tree.shape)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# ---------------------------------------------------------------------------
# programs, inputs, forward


def test_stage_program_params_and_units_match_reference():
    jcfg, tcfg = _cfgs()
    assert [(s.kinds, s.n, s.scan) for s in TB.stage_program(tcfg)] == \
        [(s.kinds, s.n, s.scan) for s in JB.stage_program(jcfg)]
    assert TB.encoder_stages(tcfg) == []
    dense = _dense(jcfg)
    tparams = TM.init_params(tcfg, 0, device="cpu")
    assert _structure(tparams) == _structure(dense)
    assert [(u.name, u.kind, u.where)
            for u in TP.unit_iterator(tparams, tcfg)] == \
        [(u.name, u.kind, u.where) for u in JP.unit_iterator(dense, jcfg)]
    want = jax.eval_shape(lambda: j_factorize(
        JM.init_params(jcfg, jax.random.PRNGKey(0)), jcfg, ratio=0.6))
    got = factorize_params(tparams, tcfg, ratio=0.6, device="cpu")
    assert _structure(got) == jax.tree.map(lambda a: tuple(a.shape), want)


def test_embed_inputs_put_the_patches_before_the_tokens():
    jcfg, tcfg = _cfgs()
    dense = _dense(jcfg, seed=1)
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    patches = _patches(jcfg, 3, 3)
    want = np.asarray(JM._embed_inputs(
        jax.tree.map(jnp.asarray, dense), jcfg,
        {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)}))
    got = TM._embed_inputs(bridge.to_torch(dense), tcfg, {
        "tokens": torch.from_numpy(toks),
        "patches": torch.from_numpy(patches)}).numpy()
    assert got.shape == want.shape == (3, 8 + 10, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :8], patches)


def test_forward_hidden_and_loss_match_reference():
    jcfg, tcfg = _cfgs()
    dense = _dense(jcfg, seed=3)
    batch = _batches(jcfg, n=1)[0]
    jp = jax.tree.map(jnp.asarray, dense)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jh, _ = JM.forward_hidden(jp, jcfg, jb, train=False)
    jl, _ = JM.loss_fn(jp, jcfg, jb)
    tp = bridge.to_torch(dense)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        th, _ = TM.forward_hidden(tp, tcfg, tb)
        tl, _ = TM.loss_fn(tp, tcfg, tb)
    assert tuple(th.shape) == (4, 8 + 24, 64)
    assert _rel(_np(th), jh) <= 1e-5
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)


@pytest.mark.parametrize("layout", ["dense", "latent"])
def test_init_cache_keys_and_shapes(layout):
    jcfg, tcfg = _cfgs()
    params = None if layout == "dense" else _compressed("fused")["jc"]
    jc = JM.init_cache(jcfg, 3, 24, params=None if params is None
                       else jax.tree.map(jnp.asarray, params))
    tc = TM.init_cache(tcfg, 3, 24, params=None if params is None
                       else bridge.to_torch(params), device="cpu")
    assert _structure(tc) == jax.tree.map(lambda a: tuple(a.shape), jc)
    assert set(tc[0][0]) == ({"lk", "lv"} if layout == "latent"
                             else {"k", "v"})


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("layout", ["dense", "latent"])
def test_prefill_and_decode_match_reference(layout, per_slot):
    # prefill writes the patches' 8 positions and the prompt's; decode
    # starts past them
    jcfg, tcfg = _cfgs()
    params = (_dense(jcfg, seed=5) if layout == "dense"
              else _compressed("fused")["jc"])
    jp, tp = jax.tree.map(jnp.asarray, params), bridge.to_torch(params)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (3, 12)).astype(np.int32)
    patches = _patches(jcfg, 3, 7)
    cp = None if layout == "dense" else jp
    jcache = JM.init_cache(jcfg, 3, 32, params=cp)
    tcache = TM.init_cache(tcfg, 3, 32, params=None if cp is None else tp,
                           device="cpu")
    jl, jcache = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :8]),
                                       "patches": jnp.asarray(patches)},
                            jcache)
    with torch.inference_mode():
        tl, tcache = TM.prefill(tp, tcfg, {
            "tokens": torch.from_numpy(toks[:, :8]),
            "patches": torch.from_numpy(patches)}, tcache)
    assert _rel(_np(tl), jl) <= 1e-5
    for key in tcache[0][0]:
        assert _rel(_np(tcache[0][0][key]), jcache[0][0][key]) <= 1e-5, key
    for i in range(8, 12):
        p0 = 8 + i
        if per_slot:
            pos = np.array([p0, p0 - 3, p0 - 5], np.int32)
            jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
        else:
            jpos, tpos = p0, p0
        jl, jcache = JM.decode_step(jp, jcfg, jcache,
                                    jnp.asarray(toks[:, i:i + 1]), jpos)
        with torch.inference_mode():
            tl, tcache = TM.decode_step(tp, tcfg, tcache,
                                        torch.from_numpy(toks[:, i:i + 1]),
                                        tpos)
        assert _rel(_np(tl), jl) <= 1e-5, i


# ---------------------------------------------------------------------------
# compression


@functools.lru_cache(maxsize=None)
def _compressed(mode):
    """One JAX and one port compression of the smoke model under ``mode``
    (fused, sequential, hybrid or adaptive), shared by the module's
    tests."""
    jcfg, tcfg = _cfgs()
    dense = _dense(jcfg)
    rng = np.random.default_rng(0)
    calib = {"tokens": rng.integers(0, jcfg.vocab_size,
                                    CALIB).astype(np.int32),
             "patches": _patches(jcfg, CALIB[0], 1)}
    recipe = dict(RECIPE, calib_mode=mode)
    if mode == "adaptive":
        recipe.update(calib_mode="fused", rank_mode="adaptive")
    jc, jrep = JP.compress_model(jax.tree.map(jnp.asarray, dense), jcfg,
                                 {k: jnp.asarray(v) for k, v in calib.items()},
                                 JP.CompressConfig(**recipe))
    tc, trep = TP.compress_model(bridge.to_torch(dense), tcfg, calib,
                                 TP.CompressConfig(**recipe), device="cpu")
    return dict(mode=mode, jcfg=jcfg, tcfg=tcfg,
                jc=jax.tree.map(np.asarray, jc), jrep=jrep, tc=tc, trep=trep)


@pytest.fixture(scope="module",
                params=["fused", "sequential", "hybrid", "adaptive"])
def run(request):
    return _compressed(request.param)


def test_report_units_and_ranks_match(run):
    jrep, trep = run["jrep"], run["trep"]
    assert [u["name"] for u in trep["units"]] == ["dec.0.attn", "dec.1.attn"]
    assert [u["name"] for u in trep["units"]] == \
        [u["name"] for u in jrep["units"]]
    for ju, tu in zip(jrep["units"], trep["units"]):
        for key in ("kind", "calib_mode", "tapped_forwards",
                    "replayed_groups"):
            assert tu.get(key) == ju.get(key), (tu["name"], key)
        assert [(lin["path"], lin["rank"], lin["shape"])
                for lin in tu["linears"]] == \
            [(lin["path"], lin["rank"], lin["shape"])
             for lin in ju["linears"]]
    assert _structure(run["tc"]) == _structure(run["jc"])
    if run["mode"] == "adaptive":
        assert len({lin["rank"] for u in trep["units"]
                    for lin in u["linears"]}) > 1


def test_composed_maps_match(run):
    tcfg = run["tcfg"]
    covs = {u["name"]: u["covs"] for u in run["trep"]["units"]}
    sequential = run["mode"] == "sequential"
    want = TP.unit_iterator(bridge.to_torch(run["jc"]), tcfg)
    checked = 0
    for wu, gu in zip(want, TP.unit_iterator(run["tc"], tcfg)):
        specs = TP.linear_specs(gu.kind, tcfg)
        for spec in specs:
            g, w = (TP.get_path(u.params, spec.path) for u in (gu, wu))
            gm = (g["v"].double() @ g["u"].double()).numpy()
            wm = (w["v"].double() @ w["u"].double()).numpy()
            if sequential and spec.tap != specs[0].tap:
                # collected after the unit's earlier groups were solved:
                # the map as it acts on that shifted stream
                cov = covs[gu.name][spec.tap]["xpxp"].numpy().astype(
                    np.float64)
                lam, q = np.linalg.eigh(cov)
                half = q * np.sqrt(np.clip(lam, 0.0, None))
                err = (np.linalg.norm(half.T @ (gm - wm))
                       / np.linalg.norm(half.T @ wm))
            else:
                err = np.linalg.norm(gm - wm) / np.linalg.norm(wm)
            assert err <= MAP_TOL, (gu.name, spec.path, err)
            checked += 1
    assert checked == 2 * 7


def test_ppl_matches_reference(run):
    batches = _batches(run["jcfg"])
    want = _ppl(JM.loss_fn, jax.tree.map(jnp.asarray, run["jc"]),
                run["jcfg"], batches, jnp.asarray)
    with torch.no_grad():
        got = _ppl(TM.loss_fn, run["tc"], run["tcfg"], batches,
                   torch.from_numpy)
    assert got == pytest.approx(want, rel=5e-3)


# ---------------------------------------------------------------------------
# serving


def _requests(module, cfg):
    rng = np.random.default_rng(3)
    patches = _patches(cfg, 4, 9)
    return [module.Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, (n,)).astype(np.int32), steps=s,
        extras={"patches": patches[i:i + 1]})
        for i, (n, s) in enumerate(zip((5, 13, 9, 2), (6, 4, 7, 5)))]


def test_serving_matches_reference():
    # the JAX package's compressed weights (fused), bridged: Server (3
    # prompts of 10 tokens with their patches on 4 slots, 8 steps) and the
    # engine (4 requests on 2 slots, over the latent and the dense cache)
    # give the JAX servers' tokens
    run = _compressed("fused")
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    jp, tp = jax.tree.map(jnp.asarray, run["jc"]), bridge.to_torch(run["jc"])
    prompts = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    patches = _patches(jcfg, 3, 8)
    want = JS.Server(jcfg, jp, max_len=40, batch=4, mesh=_auto_mesh()
                     ).generate(jnp.asarray(prompts), steps=8,
                                extras={"patches": jnp.asarray(patches)})
    got = TS.Server(tcfg, tp, max_len=40, batch=4, device="cpu"
                    ).generate(prompts, steps=8, extras={"patches": patches})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for layout in ("auto", "dense"):
        jeng = JS.ContinuousBatchingServer(jcfg, jp, max_len=48, slots=2,
                                           cache_layout=layout,
                                           mesh=_auto_mesh())
        want = jeng.run(_requests(JS, jcfg))
        teng = TS.ContinuousBatchingServer(tcfg, tp, max_len=48, slots=2,
                                           prefill_chunk=8,
                                           cache_layout=layout,
                                           device="cpu")
        got = teng.run(_requests(TS, tcfg))
        assert sorted(got) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got[rid]["tokens"],
                                          want[rid]["tokens"])
        assert set(teng.prefill_routes.values()) == {"whole_extras"}
        assert teng.prefill_routes == jeng.prefill_routes


def _greedy_reference(cfg, params, prompt, steps, extras, max_len):
    """The JAX package's teacher-forced oracle (``tests/test_serving.py``):
    re-prefill prompt + generated-so-far each step."""
    toks = [int(t) for t in np.asarray(prompt)]
    out = []
    for _ in range(steps):
        cache = JM.init_cache(cfg, 1, max_len)
        batch = {"tokens": jnp.asarray([toks], jnp.int32), **extras}
        logits, _ = JM.prefill(params, cfg, batch, cache)
        nxt = int(jnp.argmax(logits[0]))
        out.append(nxt)
        toks.append(nxt)
    return np.asarray(out, np.int32)


def test_vision_decode_position_matches_reference():
    # the JAX package's regression (tests/test_serving.py:32): prefill
    # writes num_patches positions before the tokens, so decode starts at
    # plen + num_patches; the port's Server and engine give the oracle's
    # tokens, and the JAX Server's
    jcfg, tcfg = _cfgs()
    params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab_size, (10,)).astype(np.int32)
    patches = _patches(jcfg, 1, 2)
    jp, tp = jax.tree.map(jnp.asarray, params), bridge.to_torch(params)
    want = _greedy_reference(jcfg, jp, prompt, 6,
                             {"patches": jnp.asarray(patches)}, max_len=64)
    got = TS.Server(tcfg, tp, max_len=64, batch=1, device="cpu").generate(
        prompt[None], steps=6, extras={"patches": patches})
    np.testing.assert_array_equal(got.numpy()[0], want)
    eng = TS.ContinuousBatchingServer(tcfg, tp, max_len=64, slots=2,
                                      device="cpu")
    res = eng.run([TS.Request(rid=0, prompt=prompt, steps=6,
                              extras={"patches": patches})])
    np.testing.assert_array_equal(res[0]["tokens"], want)
    jsrv = JS.Server(jcfg, jp, max_len=64, batch=1, mesh=_auto_mesh())
    np.testing.assert_array_equal(
        np.asarray(jsrv.generate(jnp.asarray(prompt[None]), steps=6,
                                 extras={"patches": jnp.asarray(patches)}))[0],
        want)


def test_vision_capacity_guard_counts_patches():
    # the JAX package's regression (tests/test_serving.py:71): plen + steps
    # fits max_len but patches + plen + steps does not, in both servers
    jcfg, tcfg = _cfgs()
    params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0)))
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (1, 10)).astype(np.int32)
    patches = _patches(jcfg, 1, 2)
    assert tcfg.num_patches + 10 + 13 > 30 >= 10 + 13
    srv = TS.Server(tcfg, bridge.to_torch(params), max_len=30, batch=1,
                    device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        srv.generate(prompts, steps=13, extras={"patches": patches})
    eng = TS.ContinuousBatchingServer(tcfg, bridge.to_torch(params),
                                      max_len=30, slots=1, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.run([TS.Request(rid=0, prompt=prompts[0], steps=13,
                            extras={"patches": patches})])
    jsrv = JS.Server(jcfg, jax.tree.map(jnp.asarray, params), max_len=30,
                     batch=1, mesh=_auto_mesh())
    with pytest.raises(ValueError, match="max_len"):
        jsrv.generate(jnp.asarray(prompts), steps=13,
                      extras={"patches": jnp.asarray(patches)})


def test_serve_cli_takes_the_arch(capsys):
    toks = TS.main(["--arch", ARCH, "--smoke", "--ratio", "0.6", "--engine",
                    "--batch", "2", "--prompt-len", "6", "--steps", "4",
                    "--device", "cpu"])
    assert toks.shape == (2, 4)
    out = capsys.readouterr().out
    assert "compressed to ratio 0.6; 2 blocks" in out
    assert "generated (2, 4)" in out
