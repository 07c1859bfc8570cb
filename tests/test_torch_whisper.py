"""whisper-base (an encoder over audio frames, a decoder with
cross-attention) through the port against the JAX package on the CPU.

Smoke config in fp32: 2 ``enc_attn`` layers over 32 frames, 2 ``dec_attn``
layers, d_model 64, 4 heads of 16, gelu, LayerNorm, tied embeddings.
Function by function on bridged params and numpy-made inputs:
``sinusoid_positions`` and ``_run_encoder`` (1e-6), ``cross_attention_kv``
/ ``cross_attention`` and their taps (1e-5), ``forward_hidden`` and the
loss (1e-5), ``prefill`` and ``decode_step`` (scalar and per-slot
positions) over the dense and the latent cache, with the cross-attention
cache {"xk", "xv"} (1e-5), ``init_cache`` keys and shapes,
``cache_slot_take`` / ``cache_slot_put``; non-causal ``flash_attention``
at Lk 1500 through the port's wrapper against the JAX package's.

``compress_model`` is shared a mode through a module-scoped fixture
(fused, sequential, hybrid, adaptive), one JAX and one port run from the
same bridged params and the same 16 x 32 uniform tokens with 16 x 32
frames (ratio 0.6, ``rank_multiple=1``, one refine epoch, microbatch 2).
The units run ``enc.*`` then ``dec.*``.  The calibration set is made well
conditioned (ROADMAP hazard 3d): whisper's embeddings (0.02·N(0, 1)) and
frames at the JAX data's 0.02 scale are dwarfed by the sinusoid positions
every sequence shares, so the taps' covariances reach condition numbers of
1e6–1e9 and the two packages' solves differed by up to 2.6e-1 on equal
covariances (1e-7); so the frames here are N(0, 1) and the embedding
table is scaled by 50, and tokens move the stream as positions do.  Every
composed map is compared as it acts on the stream its solve saw,
||X′(W_port − W_jax)|| / ||X′ W_jax|| from the port's X′ᵀX′: a
LayerNorm's output has zero feature mean, so the ones vector lies in every
tap's null space and a map along it is set by fp32 rounding alone
(ROADMAP hazard 3k); plain Frobenius gaps there reach 1.5e-2 at unit 0.
Held exactly: unit names and order, ranks, tapped forwards; to 1e-3: the
maps on their stream; ppl to 0.5 %.  Serving: ``Server`` and the engine
(latent and dense caches, every request ``whole_extras``) give the JAX
servers' tokens (its servers on an Auto-axis mesh, ROADMAP hazard 3a); the
JAX package's decode-position regression for whisper
(``tests/test_serving.py:52``) holds for the port; a format-3 checkpoint
of the compressed model moves between the packages bit for bit and is
served by ``from_checkpoint``.
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

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_smoke_config as j_smoke
from repro.core import pipeline as JP
from repro.core.factorized import factorize_params as j_factorize
from repro.launch import serve as JS
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten_with_paths
from repro_torch.core import pipeline as TP
from repro_torch.core.factorized import factorize_params
from repro_torch.kernels import ops
from repro_torch.launch import serve as TS
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

ARCH = "whisper-base"
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


def _dense(cfg, seed=0, table_scale=1.0):
    p = jax.tree.map(np.asarray, JM.init_params(cfg,
                                                jax.random.PRNGKey(seed)))
    if table_scale != 1.0:
        p["embed"]["table"] = (p["embed"]["table"]
                               * table_scale).astype(np.float32)
    return p


def _frames(cfg, n, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(
        (n, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)


def _batches(cfg, n=2, seed=4, scale=0.02):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:],
                    "frames": _frames(cfg, 4, seed + 10 * i, scale)})
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
# stage programs, params, units


def test_stage_programs_params_and_units_match_reference():
    jcfg, tcfg = _cfgs()
    for jst, tst in ((JB.stage_program(jcfg), TB.stage_program(tcfg)),
                     (JB.encoder_stages(jcfg), TB.encoder_stages(tcfg))):
        assert [(s.kinds, s.n, s.scan) for s in tst] == \
            [(s.kinds, s.n, s.scan) for s in jst]
    assert [s.kinds for s in TB.encoder_stages(tcfg)] == [("enc_attn",)]
    dense = _dense(jcfg)
    tparams = TM.init_params(tcfg, 0, device="cpu")
    assert _structure(tparams) == _structure(dense)
    assert set(tparams["encoder"]) == {"stages", "final_norm"}
    assert {"ln_x", "xattn"} <= set(tparams["stages"][0][0])
    junits = list(JP.unit_iterator(dense, jcfg))
    tunits = list(TP.unit_iterator(tparams, tcfg))
    assert [(u.name, u.kind, u.where) for u in tunits] == \
        [(u.name, u.kind, u.where) for u in junits]
    assert [u.name for u in tunits] == ["enc.0.enc_attn", "enc.1.enc_attn",
                                        "dec.0.dec_attn", "dec.1.dec_attn"]
    assert [s.path for s in TP.linear_specs("dec_attn", tcfg)] == \
        [s.path for s in JP.linear_specs("dec_attn", jcfg)]


def test_sinusoid_positions_match_reference():
    pos = np.arange(1500)
    want = np.asarray(JM.sinusoid_positions(jnp.asarray(pos), 512))
    got = TM.sinusoid_positions(torch.from_numpy(pos), 512).numpy()
    assert got.shape == want.shape == (1500, 512)
    assert _rel(got, want) <= 1e-6
    # per-slot decode positions
    want = np.asarray(JM.sinusoid_positions(jnp.asarray([3, 40, 7]), 64))
    got = TM.sinusoid_positions(torch.tensor([3, 40, 7]), 64).numpy()
    assert _rel(got, want) <= 1e-6


def test_run_encoder_matches_reference():
    jcfg, tcfg = _cfgs()
    dense = _dense(jcfg, seed=1)
    frames = _frames(jcfg, 3, 0)
    want = np.asarray(JM._run_encoder(jax.tree.map(jnp.asarray, dense), jcfg,
                                      jnp.asarray(frames), False))
    with torch.no_grad():
        got = TM._run_encoder(bridge.to_torch(dense), tcfg,
                              torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (3, 32, 64)
    assert _rel(got, want) <= 1e-6


def test_cross_attention_matches_reference():
    jcfg, tcfg = _cfgs()
    dense = _dense(jcfg, seed=2)
    p = dense["stages"][0][0]["xattn"]
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]), p)      # layer 1
    tp = bridge.to_torch(jax.tree.map(lambda a: a[1], p))
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, 32, 64)).astype(np.float32)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    jstore, tstore = {}, {}
    with JL.sowing(jstore):
        jk, jv = JA.cross_attention_kv(jp, jnp.asarray(enc), jcfg)
        jout = JA.cross_attention(jp, jnp.asarray(x), jk, jv, jcfg)
    with torch.no_grad(), TL.sowing(tstore):
        tk, tv = TA.cross_attention_kv(tp, torch.from_numpy(enc), tcfg)
        tout = TA.cross_attention(tp, torch.from_numpy(x), tk, tv, tcfg)
    assert tuple(tk.shape) == tuple(jk.shape) == (2, 32, 4, 16)
    for g, w in ((tk, jk), (tv, jv), (tout, jout)):
        assert _rel(_np(g), w) <= 1e-5
    assert sorted(tstore) == sorted(jstore) == ["kv_in", "o_in", "q_in"]
    for tap in tstore:
        assert _rel(_np(tstore[tap]), jstore[tap]) <= 1e-5, tap


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
    assert _rel(_np(th), jh) <= 1e-5
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)


# ---------------------------------------------------------------------------
# caches, prefill and decode


def _compressed_tree(jcfg):
    """The JAX package's fused compression of the smoke model (numpy)."""
    return _compressed("fused")["jc"]


@pytest.mark.parametrize("layout", ["dense", "latent"])
def test_init_cache_keys_and_shapes(layout):
    jcfg, tcfg = _cfgs()
    params = None if layout == "dense" else _compressed_tree(jcfg)
    jc = JM.init_cache(jcfg, 3, 24, params=None if params is None
                       else jax.tree.map(jnp.asarray, params))
    tc = TM.init_cache(tcfg, 3, 24, params=None if params is None
                       else bridge.to_torch(params), device="cpu")
    assert _structure(tc) == jax.tree.map(lambda a: tuple(a.shape), jc,
                                          is_leaf=lambda a: hasattr(
                                              a, "shape"))
    c = tc[0][0]
    self_keys = {"lk", "lv"} if layout == "latent" else {"k", "v"}
    assert set(c) == self_keys | {"xk", "xv"}
    assert tuple(c["xk"].shape) == tuple(c["xv"].shape) == (2, 3, 32, 4, 16)


def test_cache_slot_take_and_put_carry_the_cross_kv():
    _, tcfg = _cfgs()
    cache = TM.init_cache(tcfg, 3, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for c in cache[0]:
        for t in c.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    slot = TM.cache_slot_take(tcfg, cache, 1)
    xk = slot[0][0]["xk"]
    assert tuple(xk.shape) == (2, 1, 32, 4, 16)
    assert torch.equal(xk[:, 0], cache[0][0]["xk"][:, 1])
    slot[0][0]["xk"].add_(1.0)
    slot[0][0]["xv"].mul_(2.0)
    before = [t.clone() for t in cache[0][0].values()]
    TM.cache_slot_put(tcfg, cache, slot, 1)
    for (key, t), b in zip(cache[0][0].items(), before):
        assert torch.equal(t[:, 0], b[:, 0]) and torch.equal(t[:, 2],
                                                             b[:, 2]), key
    assert torch.equal(cache[0][0]["xk"][:, 1], xk[:, 0])
    assert torch.equal(cache[0][0]["xv"][:, 1], slot[0][0]["xv"][:, 0])


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("layout", ["dense", "latent"])
def test_prefill_and_decode_match_reference(layout, per_slot):
    jcfg, tcfg = _cfgs()
    params = (_dense(jcfg, seed=5) if layout == "dense"
              else _compressed_tree(jcfg))
    jp, tp = jax.tree.map(jnp.asarray, params), bridge.to_torch(params)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (3, 12)).astype(np.int32)
    frames = _frames(jcfg, 3, 7)
    cp = None if layout == "dense" else jp
    jcache = JM.init_cache(jcfg, 3, 24, params=cp)
    tcache = TM.init_cache(tcfg, 3, 24, params=None if cp is None else tp,
                           device="cpu")
    jl, jcache = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :8]),
                                       "frames": jnp.asarray(frames)}, jcache)
    with torch.inference_mode():
        tl, tcache = TM.prefill(tp, tcfg, {
            "tokens": torch.from_numpy(toks[:, :8]),
            "frames": torch.from_numpy(frames)}, tcache)
    assert _rel(_np(tl), jl) <= 1e-5
    for key in tcache[0][0]:
        assert _rel(_np(tcache[0][0][key]), jcache[0][0][key]) <= 1e-5, key
    for i in range(8, 12):
        if per_slot:
            pos = np.array([i, i - 3, i - 5], np.int32)
            jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
        else:
            jpos, tpos = i, i
        jl, jcache = JM.decode_step(jp, jcfg, jcache,
                                    jnp.asarray(toks[:, i:i + 1]), jpos)
        with torch.inference_mode():
            tl, tcache = TM.decode_step(tp, tcfg, tcache,
                                        torch.from_numpy(toks[:, i:i + 1]),
                                        tpos)
        assert _rel(_np(tl), jl) <= 1e-5, i


@pytest.mark.parametrize("lk", [1500, 77])
def test_noncausal_flash_attention_matches_reference(lk):
    # whisper's cross-attention shape at full width (Lk 1500 frames, head
    # dim 64, 8 heads) and a ragged one, through the port's wrapper (its
    # plain version on the CPU) against the JAX package's attention with
    # causal=False; Lq 1 is the decode row
    rng = np.random.default_rng(lk)
    for lq in (1, 40):
        q = rng.standard_normal((2, lq, 8, 64)).astype(np.float32)
        k = rng.standard_normal((2, lk, 8, 64)).astype(np.float32)
        v = rng.standard_normal((2, lk, 8, 64)).astype(np.float32)
        want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False)
        got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False)
        assert _rel(_np(got), want) <= 1e-5, lq


# ---------------------------------------------------------------------------
# compression


@functools.lru_cache(maxsize=None)
def _compressed(mode):
    """One JAX and one port compression of the smoke model under ``mode``
    (fused, sequential, hybrid or adaptive), shared by the module's
    tests."""
    jcfg, tcfg = _cfgs()
    dense = _dense(jcfg, table_scale=50.0)
    rng = np.random.default_rng(0)
    calib = {"tokens": rng.integers(0, jcfg.vocab_size,
                                    CALIB).astype(np.int32),
             "frames": _frames(jcfg, CALIB[0], 1, scale=1.0)}
    recipe = dict(RECIPE, calib_mode=mode)
    if mode == "adaptive":
        recipe.update(calib_mode="fused", rank_mode="adaptive")
    jc, jrep = JP.compress_model(jax.tree.map(jnp.asarray, dense), jcfg,
                                 {k: jnp.asarray(v) for k, v in calib.items()},
                                 JP.CompressConfig(**recipe))
    tparams = bridge.to_torch(dense)
    tc, trep = TP.compress_model(tparams, tcfg, calib,
                                 TP.CompressConfig(**recipe), device="cpu")
    return dict(mode=mode, jcfg=jcfg, tcfg=tcfg, dense=dense,
                tparams=tparams, jc=jax.tree.map(np.asarray, jc), jrep=jrep,
                tc=tc, trep=trep)


@pytest.fixture(scope="module",
                params=["fused", "sequential", "hybrid", "adaptive"])
def run(request):
    return _compressed(request.param)


def test_report_units_and_ranks_match(run):
    jrep, trep = run["jrep"], run["trep"]
    names = [u["name"] for u in trep["units"]]
    assert names == [u["name"] for u in jrep["units"]]
    assert names == ["enc.0.enc_attn", "enc.1.enc_attn", "dec.0.dec_attn",
                     "dec.1.dec_attn"]
    for ju, tu in zip(jrep["units"], trep["units"]):
        for key in ("kind", "calib_mode", "tapped_forwards",
                    "replayed_groups"):
            assert tu.get(key) == ju.get(key), (tu["name"], key)
        assert [(lin["path"], lin["rank"], lin["shape"])
                for lin in tu["linears"]] == \
            [(lin["path"], lin["rank"], lin["shape"])
             for lin in ju["linears"]]
    for key in ("mode", "tapped_forwards", "replayed_groups"):
        assert trep["calibration"][key] == jrep["calibration"][key], key
    if run["mode"] == "adaptive":
        ja, ta = (r["calibration"]["rank_mode"] for r in (jrep, trep))
        assert {k: v for k, v in ta.items() if not isinstance(v, float)} \
            == {k: v for k, v in ja.items() if not isinstance(v, float)}
        assert len({lin["rank"] for u in trep["units"]
                    for lin in u["linears"]}) > 1


def test_param_tree_matches_reference(run):
    assert _structure(run["tc"]) == _structure(run["jc"])
    assert "u" in run["tc"]["encoder"]["stages"][0][0]["attn"]["wq"]
    assert "u" in run["tc"]["stages"][0][0]["xattn"]["wk"]
    # the caller's params are untouched
    before = bridge.to_torch(run["dense"])
    for (name, a), (_, b) in zip(_flatten_with_paths(run["tparams"]),
                                 _flatten_with_paths(before)):
        assert torch.equal(a, b), name


def test_composed_maps_match_on_their_stream(run):
    tcfg = run["tcfg"]
    covs = {u["name"]: u["covs"] for u in run["trep"]["units"]}
    want = TP.unit_iterator(bridge.to_torch(run["jc"]), tcfg)
    checked = 0
    for wu, gu in zip(want, TP.unit_iterator(run["tc"], tcfg)):
        assert (gu.name, gu.kind) == (wu.name, wu.kind)
        for spec in TP.linear_specs(gu.kind, tcfg):
            g, w = (TP.get_path(u.params, spec.path) for u in (gu, wu))
            gm = (g["v"].double() @ g["u"].double()).numpy()
            wm = (w["v"].double() @ w["u"].double()).numpy()
            cov = covs[gu.name][spec.tap]["xpxp"].numpy().astype(np.float64)
            lam, q = np.linalg.eigh(cov)
            half = q * np.sqrt(np.clip(lam, 0.0, None))
            err = (np.linalg.norm(half.T @ (gm - wm))
                   / np.linalg.norm(half.T @ wm))
            assert err <= MAP_TOL, (gu.name, spec.path, err)
            checked += 1
    assert checked == 2 * 6 + 2 * 10


def test_ppl_matches_reference(run):
    batches = _batches(run["jcfg"], scale=1.0)
    want = _ppl(JM.loss_fn, jax.tree.map(jnp.asarray, run["jc"]),
                run["jcfg"], batches, jnp.asarray)
    with torch.no_grad():
        got = _ppl(TM.loss_fn, run["tc"], run["tcfg"], batches,
                   torch.from_numpy)
    assert got == pytest.approx(want, rel=5e-3)


def test_factorize_params_matches_reference_with_encoder():
    jcfg, tcfg = _cfgs()
    want = jax.eval_shape(lambda: j_factorize(
        JM.init_params(jcfg, jax.random.PRNGKey(0)), jcfg, ratio=0.6))
    got = factorize_params(TM.init_params(tcfg, 0, device="cpu"), tcfg,
                           ratio=0.6, device="cpu")
    assert _structure(got) == jax.tree.map(lambda a: tuple(a.shape), want)
    assert all("u" in got["encoder"]["stages"][0][0]["attn"][w]
               for w in ("wq", "wk", "wv", "wo"))
    assert all("u" in got["stages"][0][0]["xattn"][w]
               for w in ("wq", "wk", "wv", "wo"))


# ---------------------------------------------------------------------------
# serving and checkpoints


def _requests(module, cfg):
    rng = np.random.default_rng(3)
    frames = _frames(cfg, 4, 9)
    return [module.Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, (n,)).astype(np.int32), steps=s,
        extras={"frames": frames[i:i + 1]})
        for i, (n, s) in enumerate(zip((5, 13, 9, 2), (6, 4, 7, 5)))]


def test_serving_matches_reference():
    # the JAX package's compressed weights (fused), bridged: Server (3
    # prompts of 10 tokens with their frames on 4 slots, 8 steps) and the
    # engine (4 requests on 2 slots, over the latent and the dense cache)
    # give the JAX servers' tokens
    run = _compressed("fused")
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    jp, tp = jax.tree.map(jnp.asarray, run["jc"]), bridge.to_torch(run["jc"])
    prompts = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    frames = _frames(jcfg, 3, 8)
    want = JS.Server(jcfg, jp, max_len=32, batch=4, mesh=_auto_mesh()
                     ).generate(jnp.asarray(prompts), steps=8,
                                extras={"frames": jnp.asarray(frames)})
    got = TS.Server(tcfg, tp, max_len=32, batch=4, device="cpu"
                    ).generate(prompts, steps=8, extras={"frames": frames})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for layout in ("auto", "dense"):
        jeng = JS.ContinuousBatchingServer(jcfg, jp, max_len=40, slots=2,
                                           cache_layout=layout,
                                           mesh=_auto_mesh())
        want = jeng.run(_requests(JS, jcfg))
        teng = TS.ContinuousBatchingServer(tcfg, tp, max_len=40, slots=2,
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


def test_whisper_decode_position_matches_reference():
    # the JAX package's regression (tests/test_serving.py:52): frames fill
    # only the cross-attention cache, so decode starts at the prompt's
    # length; the port's Server gives the oracle's tokens, and the JAX
    # Server's
    jcfg, tcfg = _cfgs()
    params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab_size, (8,)).astype(np.int32)
    frames = _frames(jcfg, 1, 2)
    jp = jax.tree.map(jnp.asarray, params)
    want = _greedy_reference(jcfg, jp, prompt, 5,
                             {"frames": jnp.asarray(frames)}, max_len=48)
    got = TS.Server(tcfg, bridge.to_torch(params), max_len=48, batch=1,
                    device="cpu").generate(prompt[None], steps=5,
                                           extras={"frames": frames})
    np.testing.assert_array_equal(got.numpy()[0], want)
    jsrv = JS.Server(jcfg, jp, max_len=48, batch=1, mesh=_auto_mesh())
    np.testing.assert_array_equal(
        np.asarray(jsrv.generate(jnp.asarray(prompt[None]), steps=5,
                                 extras={"frames": jnp.asarray(frames)}))[0],
        want)


def _bits(x):
    return (x.numpy().tobytes() if torch.is_tensor(x)
            else np.ascontiguousarray(x).tobytes())


def _assert_same(got, want):
    assert _structure(got) == _structure(want)
    fg, fw = _flatten_with_paths(got), _flatten_with_paths(want)
    assert [n for n, _ in fg] == [n for n, _ in fw]
    for (name, g), (_, w) in zip(fg, fw):
        assert _bits(g) == _bits(w), name


def test_checkpoint_moves_between_packages_bitwise(tmp_path):
    run = _compressed("fused")
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(
        0, run["tc"], meta={"arch": ARCH})
    _, got, meta = JManager(str(tmp_path / "t"), async_save=False
                            ).restore_tree(0)
    assert meta == {"arch": ARCH}
    _assert_same(got, bridge.to_numpy(run["tc"]))
    assert "u" in got["encoder"]["stages"][0][0]["attn"]["wq"]
    JManager(str(tmp_path / "j"), async_save=False).save(0, run["jc"])
    _, back, _ = CheckpointManager(str(tmp_path / "j")).restore_tree(
        0, device="cpu")
    _assert_same(back, bridge.to_torch(run["jc"]))
    # from_checkpoint serves what the JAX Server serves from the same tree
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    prompts = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    frames = _frames(tcfg, 2, 11)
    want = JS.Server(jcfg, jax.tree.map(jnp.asarray, run["jc"]), max_len=24,
                     batch=2, mesh=_auto_mesh()).generate(
        jnp.asarray(prompts), steps=6, extras={"frames": jnp.asarray(frames)})
    srv = TS.Server.from_checkpoint(tcfg, str(tmp_path / "j"), max_len=24,
                                    batch=2, device="cpu")
    np.testing.assert_array_equal(
        srv.generate(prompts, steps=6, extras={"frames": frames}).numpy(),
        np.asarray(want))


def test_serve_cli_takes_the_arch(capsys):
    toks = TS.main(["--arch", ARCH, "--smoke", "--ratio", "0.6", "--engine",
                    "--batch", "2", "--prompt-len", "6", "--steps", "4",
                    "--device", "cpu"])
    assert toks.shape == (2, 4)
    out = capsys.readouterr().out
    assert "compressed to ratio 0.6; 4 blocks" in out
    assert "generated (2, 4)" in out
