"""kimi-k2 on the CPU: GQA attention over a mixture of experts
(``attn_dense_first`` / ``attn_moe``), the port against the JAX package.

kimi-k2 smoke in fp32: 2 layers (one ``attn_dense_first`` unit, then one
``attn_moe``), d_model 64, 8 query heads on 2 KV heads of dim 8, 8 routed
experts top-2 and one shared expert.  The module shares one JAX and one
port ``compress_model`` per dispatch (the config's own capacity at factor
1.25, and drop-free), both from the same bridged params and the same 16 x
32 uniform numpy tokens (ratio 0.6, ``rank_multiple=1``, fused, one refine
epoch, microbatch 8): about 128 routed rows an expert against n = 64.
Ranks, tapped forwards, drop rates and routed expert ids are held exactly
equal, composed maps to 1e-3 relative Frobenius (per expert for a bank),
ppl to 0.5 %.

Under the capacity dispatch an expert's shifted-stream rows are the ones
its C slots a microbatch kept (C 80 here), so its X′ᵀX′ can be ill
conditioned or singular: expert 1's has condition 7.6e4 in this run, and
at 16 x 64 tokens in microbatches of 2 it has rank < 64.  The whitening
then leaves the map's weak directions to fp32 rounding in either package
(ROADMAP hazard 3d): its plain gap is 1.24e-3 here and 2.9e-2 at 16 x 64,
while ||X′(W_port − W_jax)||_F / ||X′ W_jax||_F, the solve's own metric,
is 2.4e-4 and 3.2e-5.  So the capacity banks' maps are compared on the
shifted stream the solve saw, from the port's accumulated X′ᵀX′, as
``tests/test_torch_deepseek.py`` compares its sequential maps; every other
map (drop-free banks included) is compared plainly.

The serving tests bridge the JAX package's compressed params, so both
packages serve the same weights: prefill (whole and chunked) and
``decode_step`` over the dense {"k", "v"} and the latent {"lk", "lv"}
caches (fp32: rtol 1e-4, atol 1e-5), ``Server`` and engine tokens exactly
equal.  The JAX servers get an Auto-axis mesh (its default mesh is
Explicit on jax 0.9, which its sharding constraints reject; ROADMAP hazard
3a).
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as JCONF
from repro.core import pipeline as JP
from repro.launch import serve as JS
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import pipeline as TP
from repro_torch.launch import serve as TS
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from test_torch_adaptive import map_errors

ARCH = "kimi-k2-1t-a32b"
RECIPE = dict(ratio=0.6, rank_multiple=1, microbatch=8, refine_epochs=1,
              calib_mode="fused", debug_covs=True)
DISPATCHES = ("capacity", "dropfree")


def _cfgs(dispatch="capacity"):
    """(JAX cfg, port cfg): kimi-k2 smoke in fp32 under ``dispatch``."""
    out = []
    for get in (JCONF.get_smoke_config, TC.get_smoke_config):
        c = get(ARCH).replace(dtype="float32")
        out.append(c.replace(moe=dataclasses.replace(c.moe,
                                                     dispatch=dispatch)))
    return tuple(out)


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _pair(tree):
    tree = jax.tree.map(np.asarray, tree)
    return jax.tree.map(jnp.asarray, tree), bridge.to_torch(tree)


def _batch(rng, vocab, b, l):
    t = rng.integers(0, vocab, (b, l + 1)).astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


@pytest.fixture(scope="module")
def dense():
    """The dense params, (JAX, port), from ``PRNGKey(0)``."""
    jcfg, _ = _cfgs()
    return _pair(JM.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module", params=DISPATCHES)
def run(request, dense):
    """One JAX and one port compression under the dispatch."""
    jcfg, tcfg = _cfgs(request.param)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (16, 32)).astype(np.int32)
    evals = [_batch(rng, jcfg.vocab_size, 4, 32) for _ in range(2)]
    jc, jrep = JP.compress_model(dense[0], jcfg, {"tokens": jnp.asarray(toks)},
                                 JP.CompressConfig(**RECIPE))
    tc, trep = TP.compress_model(dense[1], tcfg, {"tokens": toks},
                                 TP.CompressConfig(**RECIPE), device="cpu")
    return dict(dispatch=request.param, jcfg=jcfg, tcfg=tcfg, jc=jc,
                jrep=jrep, tc=tc, trep=trep, evals=evals,
                served=_pair(jc))


# ---------------------------------------------------------------------------
# config, stage program, units


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_field_equal(getter):
    jc = getattr(JCONF, getter)(ARCH)
    tc = getattr(TC, getter)(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.head_dim, tc.attention, tc.moe.num_shared_experts) == \
        (jc.head_dim, "full", 1)


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_stage_program_and_linear_specs_match(getter):
    # one unscanned attn_dense_first stage, then the attn_moe stage; each
    # kind's specs (path, tap, bank, replay) and tap groups the JAX
    # package's: a GQA attention, then a dense FFN or the expert banks
    # (replayed by hybrid calibration) and the one shared expert
    jcfg, tcfg = JCONF.get_config(ARCH), TC.get_config(ARCH)
    if getter == "get_smoke_config":
        jcfg, tcfg = _cfgs()
    want = [(st.kinds, st.n, st.scan) for st in JB.stage_program(jcfg)]
    got = [(st.kinds, st.n, st.scan) for st in TB.stage_program(tcfg)]
    assert got == want
    assert got[0] == (("attn_dense_first",), 1, False)
    assert got[1][0] == ("attn_moe",)
    for kind in ("attn_dense_first", "attn_moe"):
        js = [tuple(s) for s in JP.linear_specs(kind, jcfg)]
        ts = [tuple(s) for s in TP.linear_specs(kind, tcfg)]
        assert ts == js
        assert [(tap, [s.path for s in grp])
                for tap, grp in TP.tap_groups(TP.linear_specs(kind, tcfg))] \
            == [(tap, [s.path for s in grp])
                for tap, grp in JP.tap_groups(JP.linear_specs(kind, jcfg))]
    taps = [s.tap for s in TP.linear_specs("attn_moe", tcfg)]
    assert sorted(set(taps)) == sorted(
        ["attn/qkv_in", "attn/o_in", "ffn/experts_in", "ffn/experts_down_in",
         "ffn/shared/in", "ffn/shared/down_in"])


def test_unit_keys_match(dense):
    jcfg, tcfg = _cfgs()
    want = [(u.name, u.kind) for u in JP.unit_iterator(dense[0], jcfg)]
    got = [(u.name, u.kind) for u in TP.unit_iterator(dense[1], tcfg)]
    assert got == want == [("dec.0.attn_dense_first", "attn_dense_first"),
                           ("dec.1.attn_moe", "attn_moe")]


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_forward_loss_and_aux_match(dense, dispatch):
    # the loss, its cross-entropy and the router's aux loss on 4 x 32
    # numpy tokens: rtol 1e-5; the aux loss is > 0 (the MoE layer ran)
    jcfg, tcfg = _cfgs(dispatch)
    b = _batch(np.random.default_rng(5), jcfg.vocab_size, 4, 32)
    jl, jm = JM.loss_fn(dense[0], jcfg, {k: jnp.asarray(v)
                                         for k, v in b.items()})
    with torch.no_grad():
        tl, tm = TM.loss_fn(dense[1], tcfg, {k: torch.from_numpy(v)
                                             for k, v in b.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5)
    assert float(tm["aux"]) > 0


# ---------------------------------------------------------------------------
# compression


def _maps(block):
    """{path: (..., n, m) composed map v @ u} of every factorized linear of
    a block (numpy leaves), float64; a bank keeps its expert axis."""
    out = {}
    for part in ("attn", "ffn"):
        for name, lin in block[part].items():
            subs = (lin.items() if name in ("experts", "shared")
                    else [(None, lin)])
            for sub, sl in subs:
                if "u" in sl:
                    key = f"{part}.{name}" + ("" if sub is None
                                              else f".{sub}")
                    out[key] = np.einsum(
                        "...nk,...km->...nm", np.asarray(sl["v"], np.float64),
                        np.asarray(sl["u"], np.float64))
    return out


def _map_error(got, want, xpxp=None):
    """Relative Frobenius gap of two (n, m) maps, plainly or as they act on
    the shifted stream whose X′ᵀX′ is ``xpxp`` (its null eigenvalues come
    out of the fp32 sums at ±1e-7·λmax: clipped to 0)."""
    dw = got - want
    if xpxp is None:
        return np.linalg.norm(dw) / np.linalg.norm(want)
    lam, q = np.linalg.eigh(xpxp.astype(np.float64))
    half = q * np.sqrt(np.clip(lam, 0.0, None))
    return np.linalg.norm(half.T @ dw) / np.linalg.norm(half.T @ want)


def test_compress_matches_reference(run):
    # ranks, shapes, tapped forwards and report keys exactly; every composed
    # map (each expert of a bank; the capacity banks on their shifted
    # stream) within 1e-3; refine MSEs rtol 1e-3
    jrep, trep = run["jrep"], run["trep"]
    assert [u["name"] for u in trep["units"]] == \
        [u["name"] for u in jrep["units"]]
    for ju, tu in zip(jrep["units"], trep["units"]):
        assert set(tu) == set(ju)
        assert [(lin["path"], lin["rank"], lin["shape"])
                for lin in tu["linears"]] == \
            [(lin["path"], lin["rank"], lin["shape"]) for lin in ju["linears"]]
        assert tu["tapped_forwards"] == ju["tapped_forwards"]
        for key in ("pre_refine_mse", "post_refine_mse"):
            np.testing.assert_allclose(tu[key], ju[key], rtol=1e-3)
    assert trep["calibration"]["tapped_forwards"] == \
        jrep["calibration"]["tapped_forwards"]
    checked = 0
    for jst, tst, unit in zip(run["jc"]["stages"], run["tc"]["stages"],
                              trep["units"]):
        jm = _maps(jax.tree.map(np.asarray, jst[0]))
        tm = _maps(bridge.to_numpy(tst[0]))
        assert sorted(tm) == sorted(jm)
        taps = {sp.path: sp for sp in TP.linear_specs(unit["kind"],
                                                      run["tcfg"])}
        for path, want in jm.items():
            got = tm[path]
            assert got.shape == want.shape, path
            want = want.reshape(-1, *want.shape[-2:])
            got = got.reshape(-1, *got.shape[-2:])
            shifted = taps[path].bank and run["dispatch"] == "capacity"
            xpxp = unit["covs"][taps[path].tap]["xpxp"].numpy()
            for i in range(want.shape[0]):
                err = _map_error(got[i], want[i],
                                 xpxp[i] if shifted else None)
                assert err <= 1e-3, (run["dispatch"], path, i, err)
                checked += 1
    # dense-first: 4 attention + 3 FFN; MoE: 4 attention + 3 shared + 3
    # banks x 8 experts
    assert checked == 7 + 4 + 3 + 3 * 8


def test_drop_rates_and_routed_ids_match(run):
    # the report's drop rate exactly (0 under drop-free); the compressed
    # models' routed expert ids on held-out tokens exactly (sown by the
    # drop-free dispatch: the router does not depend on the dispatch, and
    # the MoE layer is the last one); ppl within 0.5 %
    rates = run["trep"]["calibration"]["moe_drop_rate"]
    assert rates == run["jrep"]["calibration"]["moe_drop_rate"]
    assert list(rates) == ["dec.1.attn_moe"]
    if run["dispatch"] == "dropfree":
        assert rates["dec.1.attn_moe"] == 0.0
    else:
        assert 0.0 <= rates["dec.1.attn_moe"] < 1.0
    jfree, tfree = _cfgs("dropfree")
    b = run["evals"][0]
    jstore, tstore = {}, {}
    with JL.sowing(jstore):
        JM.loss_fn(run["jc"], jfree, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad(), TL.sowing(tstore):
        TM.loss_fn(run["tc"], tfree, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
    want = np.asarray(jstore["ffn/experts_ids"])
    got = tstore["ffn/experts_ids"].numpy()
    assert got.shape == want.shape == (2 * 4 * 32,)
    np.testing.assert_array_equal(got, want)
    jl = [float(JM.loss_fn(run["jc"], run["jcfg"], {
        k: jnp.asarray(v) for k, v in e.items()})[1]["ce"])
        for e in run["evals"]]
    with torch.no_grad():
        tl = [float(TM.loss_fn(run["tc"], run["tcfg"], {
            k: torch.from_numpy(v) for k, v in e.items()})[1]["ce"])
            for e in run["evals"]]
    assert abs(np.exp(np.mean(tl)) / np.exp(np.mean(jl)) - 1) <= 5e-3


def test_adaptive_rank_per_expert_matches_reference(dense):
    # one adaptive run under drop-free (each expert its own item;
    # rank_multiple 1; no refinement, whose Adam steps move a small
    # expert's map by about lr, test_torch_adaptive.py): ranks and
    # rank_per_expert tuples integer-equal
    jcfg, tcfg = _cfgs()
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (16, 32),
                                             dtype=np.int32)
    recipe = dict(RECIPE, rank_mode="adaptive", moe_dispatch="dropfree",
                  refine=False)
    _, jrep = JP.compress_model(dense[0], jcfg, {"tokens": jnp.asarray(toks)},
                                JP.CompressConfig(**recipe))
    _, trep = TP.compress_model(dense[1], tcfg, {"tokens": toks},
                                TP.CompressConfig(**recipe), device="cpu")
    for ju, tu in zip(jrep["units"], trep["units"]):
        assert [(lin["path"], lin["rank"], lin.get("rank_per_expert"))
                for lin in tu["linears"]] == \
            [(lin["path"], lin["rank"], lin.get("rank_per_expert"))
             for lin in ju["linears"]]
    per_expert = [lin["rank_per_expert"] for lin in trep["units"][1]["linears"]
                  if "rank_per_expert" in lin]
    assert len(per_expert) == 3 and all(len(r) == 8 for r in per_expert)


def test_hybrid_replays_the_banks_as_the_reference(dense):
    # hybrid calibration under capacity: the MoE unit replays its two bank
    # taps (2·B + 2·2·B tapped forwards), as the JAX package does; maps
    # within 1e-3, the replayed banks on their shifted stream
    # (test_torch_adaptive.map_errors)
    jcfg, tcfg = _cfgs()
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (16, 32),
                                             dtype=np.int32)
    recipe = dict(RECIPE, calib_mode="hybrid")
    jc, jrep = JP.compress_model(dense[0], jcfg, {"tokens": jnp.asarray(toks)},
                                 JP.CompressConfig(**recipe))
    tc, trep = TP.compress_model(dense[1], tcfg, {"tokens": toks},
                                 TP.CompressConfig(**recipe), device="cpu")
    b = toks.shape[0] // RECIPE["microbatch"]
    assert [(u["replay_taps"], u["tapped_forwards"]) for u in trep["units"]] \
        == [(u["replay_taps"], u["tapped_forwards"]) for u in jrep["units"]] \
        == [([], 2 * b), (["ffn/experts_in", "ffn/experts_down_in"], 6 * b)]
    for key in ("tapped_forwards", "replayed_groups", "moe_drop_rate"):
        assert trep["calibration"][key] == jrep["calibration"][key], key
    errs, _ = map_errors(jc, tc, tcfg, trep)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])


# ---------------------------------------------------------------------------
# serving the JAX package's compressed weights


def _assert_trees_close(got, want, rtol, atol):
    got = bridge.to_numpy(got)
    want = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("layout", ["dense_params", "dense_cache",
                                    "latent_cache"])
def test_prefill_and_decode_match_reference(run, dense, layout):
    # whole prefill, a chunk, then decode at a scalar and at a per-slot
    # (B,) position over the dense {k, v} cache (dense or compressed
    # params) or the latent {lk, lv} one (compressed params): logits and
    # caches against the JAX package, fp32: rtol 1e-4, atol 1e-5
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    jp, tp = dense if layout == "dense_params" else run["served"]
    latent = layout == "latent_cache"
    jcache = JM.init_cache(jcfg, 2, 32, params=jp if latent else None)
    tcache = TM.init_cache(tcfg, 2, 32, params=tp if latent else None,
                           device="cpu")
    assert all(("lk" in c) == latent for per_kind in tcache for c in per_kind)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)

    def check(got, want):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        _assert_trees_close(got[1], want[1], 1e-4, 1e-5)

    want = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :8])}, jcache)
    got = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :8])},
                     tcache)
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


def test_server_tokens_match_reference(run):
    # 3 prompts on 4 slots over the dense cache: under capacity the zero row
    # _pad_batch adds takes capacity slots in both packages
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    jp, tp = run["served"]
    prompts = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    want = JS.Server(jcfg, jp, max_len=32, batch=4, mesh=_auto_mesh()
                     ).generate(jnp.asarray(prompts), steps=8)
    got = TS.Server(tcfg, tp, max_len=32, batch=4, device="cpu"
                    ).generate(prompts, steps=8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _requests(module, seed, vocab):
    rng = np.random.default_rng(seed)
    return [module.Request(rid=i, prompt=rng.integers(0, vocab, (n,))
                           .astype(np.int32), steps=s)
            for i, (n, s) in enumerate(zip((5, 13, 9), (6, 4, 7)))]


@pytest.mark.parametrize("chunk", [8, 0])
def test_engine_tokens_match_reference(run, chunk):
    # 3 requests on 2 slots over the latent cache (compressed wk and wv),
    # chunked or whole padded-bucket prefill: tokens and routes equal the
    # JAX engine's
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    jp, tp = run["served"]
    jeng = JS.ContinuousBatchingServer(jcfg, jp, max_len=40, slots=2,
                                       prefill_chunk=chunk,
                                       mesh=_auto_mesh())
    want = jeng.run(_requests(JS, 3 + chunk, jcfg.vocab_size))
    teng = TS.ContinuousBatchingServer(tcfg, tp, max_len=40, slots=2,
                                       prefill_chunk=chunk, device="cpu")
    layout = TM.init_cache(tcfg, 1, 8, params=teng._cache_params,
                           device="meta")
    assert all("lk" in c for per_kind in layout for c in per_kind)
    got = teng.run(_requests(TS, 3 + chunk, jcfg.vocab_size))
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid]["tokens"], want[rid]["tokens"])
    assert teng.prefill_routes == jeng.prefill_routes
    assert set(teng.prefill_routes.values()) == {
        "chunked" if chunk else "whole_padded"}


def test_checkpoint_round_trip_serves_the_same_tokens(run, tmp_path):
    # the port's compressed kimi saved as a format-3 checkpoint, restored by
    # Server.from_checkpoint (the port's and the JAX package's): tokens
    # equal the in-memory model's
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    d = str(tmp_path)
    CheckpointManager(d, async_save=False).save(0, run["tc"], meta={"r": 0.6})
    prompts = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (3, 12)).astype(np.int32)
    want = TS.Server(tcfg, run["tc"], max_len=32, batch=4, device="cpu"
                     ).generate(prompts, steps=6).numpy()
    tsrv = TS.Server.from_checkpoint(tcfg, d, max_len=32, batch=4,
                                     device="cpu")
    assert tsrv.checkpoint_meta == {"r": 0.6}
    np.testing.assert_array_equal(tsrv.generate(prompts, steps=6).numpy(),
                                  want)
    jsrv = JS.Server.from_checkpoint(jcfg, d, max_len=32, batch=4,
                                     mesh=_auto_mesh())
    np.testing.assert_array_equal(
        np.asarray(jsrv.generate(jnp.asarray(prompts), steps=6)), want)
