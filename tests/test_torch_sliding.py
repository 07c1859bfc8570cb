"""gemma3's sliding-window family on the CPU: the 5:1 local / global stage
program, the global RoPE tables, the ring cache (``_write_ring``,
``ring_decode``), the model's forward / prefill / decode, ``compress_model``,
``Server`` and the engine of the port against the JAX package.

gemma3 smoke in fp32 (d_model 64, 4 heads, KV 1, head dim 16,
sliding_window 8).  Its own 6 layers are one 6-kind group (5
``attn_local`` + 1 ``attn_global``); at 8 layers a 2-layer ``attn_local``
remainder stage follows, stacked; at 14 the group stage is stacked too.

Compression runs on 8 x 32 uniform numpy tokens (ratio 0.6, fused, one
refine epoch, microbatch 2). Against the JAX package it runs at the smoke
config's own 6 layers: the composed maps' gap grows with depth, about 2x
a unit, from 3.1e-5 at unit 0 (4.0e-6 on the stream its solve saw; the unit
MSEs equal to 6 digits) to 8.7e-4 at unit 5, and reaches 1.1e-3 at unit 7
of an 8-layer model, past the 1e-3 the maps are held to: rounding amplified
by depth, as between 1 and 8 CPU threads of the port (ROADMAP hazard 3j,
``tests/refine_off_sweep.py``). The port's 8-layer compression (both
stages) is checked for its structure, and serves: bridged to the JAX
package, both packages serve the same compressed weights. The JAX servers
get an Auto-axis mesh (its default mesh is Explicit on jax 0.9, which its
sharding constraints reject). Prompts run past the window so that every
ring wraps.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
from refine_off_sweep import unit_gaps
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.core import CompressConfig as JCompressConfig
from repro.core import compress_model as j_compress_model
from repro.core import pipeline as JP
from repro.launch import serve as JS
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.core import pipeline as TP
from repro_torch.launch import serve as TS
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM

ARCH = "gemma3-1b"
RECIPE = dict(ratio=0.6, rank_multiple=1, microbatch=2, calib_mode="fused",
              refine_epochs=1)


def _cfgs(num_layers=8, dtype="float32"):
    return (j_smoke(ARCH).replace(dtype=dtype, num_layers=num_layers),
            TC.get_smoke_config(ARCH).replace(dtype=dtype,
                                              num_layers=num_layers))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(tree):
    tree = jax.tree.map(np.asarray, tree)
    return jax.tree.map(jnp.asarray, tree), bridge.to_torch(tree)


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


def _ppl(loss, params, cfg, batches, to):
    tot = sum(float(loss(params, cfg, {k: to(v) for k, v in b.items()})[0])
              for b in batches)
    return float(np.exp(tot / len(batches)))


def _calib(vocab):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, (8, 32)).astype(np.int32)
    evals = []
    for _ in range(2):
        t = rng.integers(0, vocab, (4, 33)).astype(np.int32)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return toks, evals


@pytest.fixture(scope="module")
def parity():
    """One JAX and one port compression of gemma3 smoke (6 layers) on the
    same dense params and 8 x 32 numpy tokens, each unit's covariances kept
    in the reports."""
    jcfg, tcfg = _cfgs(6)
    jdense, tdense = _pair(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    toks, evals = _calib(jcfg.vocab_size)
    jc, jrep = j_compress_model(jdense, jcfg, {"tokens": jnp.asarray(toks)},
                                JCompressConfig(**RECIPE, debug_covs=True))
    tc, trep = TP.compress_model(tdense, tcfg, {"tokens": toks},
                                 TP.CompressConfig(**RECIPE, debug_covs=True),
                                 device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jc=jc, jrep=jrep, tc=tc, trep=trep,
                evals=evals)


@pytest.fixture(scope="module")
def run():
    """The port's compression of gemma3 smoke at 8 layers (a group stage
    and a stacked remainder stage), as a (JAX, port) param pair."""
    jcfg, tcfg = _cfgs()
    _, tdense = _pair(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    toks, _ = _calib(jcfg.vocab_size)
    tc, trep = TP.compress_model(tdense, tcfg, {"tokens": toks},
                                 TP.CompressConfig(**RECIPE), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, trep=trep,
                pair=_pair(bridge.to_numpy(tc)))


# ---------------------------------------------------------------------------
# the stage program and the tables


@pytest.mark.parametrize("layers", [None, 6, 8, 14])
def test_stage_program_matches_reference(layers):
    # 26 published layers: 4 groups of 6 kinds + a 2-layer local stage;
    # smoke 6: one group; 8: one group + 2 local; 14: 2 groups + 2 local
    jcfg = j_config(ARCH) if layers is None else _cfgs(layers)[0]
    tcfg = TC.get_config(ARCH) if layers is None else _cfgs(layers)[1]
    got = [(st.kinds, st.n, st.scan) for st in TB.stage_program(tcfg)]
    want = [(st.kinds, st.n, st.scan) for st in JB.stage_program(jcfg)]
    assert got == want
    assert got[0][0] == ("attn_local",) * 5 + ("attn_global",)
    if layers is None:
        assert [n for _, n, _ in got] == [4, 2]


def test_make_ctx_global_tables_match_reference():
    # the global layers' tables at rope_theta_global (1e6), the local ones
    # at rope_theta (1e4), at a scalar and a per-slot position layout
    jcfg, tcfg = _cfgs()
    for positions in (np.arange(11), np.array([[3], [17]])):
        want = JM.make_ctx(jcfg, jnp.asarray(positions))
        got = TM.make_ctx(tcfg, torch.from_numpy(positions))
        assert set(got) == {"cos", "sin", "cos_global", "sin_global"}
        for key in got:
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), rtol=1e-6,
                                       atol=1e-6)
        assert not np.allclose(got["cos"].numpy(),
                               got["cos_global"].numpy())
    ctx = TM.make_ctx(TC.get_smoke_config("llama-7b"), torch.arange(4))
    assert set(ctx) == {"cos", "sin"}


@pytest.mark.parametrize("start,length", [(0, 5), (6, 5), (0, 8), (3, 13)])
def test_write_ring_matches_reference(start, length):
    # L < W (with and without wrapping past slot W - 1) and L >= W (only
    # the last W keys kept): the same slots as the JAX function, in place
    rng = np.random.default_rng(start + length)
    cache = _rand(rng, 2, 8, 1, 4)
    new = _rand(rng, 2, length, 1, 4)
    want = JB._write_ring(jnp.asarray(cache), jnp.asarray(new), start)
    buf = torch.from_numpy(cache.copy())
    got = TB._write_ring(buf, torch.from_numpy(new), start)
    assert got is buf
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _attn_params(jcfg):
    p = jax.tree.map(np.asarray, JA.gqa_init(jax.random.PRNGKey(3), jcfg))
    return jax.tree.map(jnp.asarray, p), bridge.to_torch(p)


@pytest.mark.parametrize("pos", ["early", "wrapped", "slots"])
def test_ring_decode_matches_reference(pos):
    # one step into an 8-slot ring: at 5 (slots past 5 not yet written), at
    # 21 (wrapped: slot i holds key 21 - ((21 - i) mod 8)), and per slot at
    # (2, 30, 8); output and both caches, fp32
    jcfg, tcfg = _cfgs()
    jp, tp = _attn_params(jcfg)
    rng = np.random.default_rng(11)
    b = 3
    x = _rand(rng, b, 1, jcfg.d_model) * 0.5
    ck = _rand(rng, b, 8, 1, jcfg.head_dim)
    cv = _rand(rng, b, 8, 1, jcfg.head_dim)
    if pos == "slots":
        p = np.array([2, 30, 8], np.int32)
        positions = p[:, None]
        jpos, tpos = jnp.asarray(p), torch.from_numpy(p)
    else:
        jpos = tpos = 5 if pos == "early" else 21
        positions = np.array([jpos])
    jctx = JM.make_ctx(jcfg, jnp.asarray(positions))
    tctx = TM.make_ctx(tcfg, torch.from_numpy(positions))
    want = JA.ring_decode(jp, jnp.asarray(x), jnp.asarray(ck),
                          jnp.asarray(cv), jpos, jcfg, jctx["cos"],
                          jctx["sin"], window=8)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = TA.ring_decode(tp, torch.from_numpy(x), tk, tv, tpos, tcfg,
                         tctx["cos"], tctx["sin"], window=8)
    assert got[1] is tk and got[2] is tv
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the model


def test_loss_matches_reference():
    jcfg, tcfg = _cfgs(14)
    jp, tp = _pair(JM.init_params(jcfg, jax.random.PRNGKey(1)))
    t = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 25))
    batch = {"tokens": t[:, :-1].astype(np.int32),
             "labels": t[:, 1:].astype(np.int32)}
    want = JM.loss_fn(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = TM.loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)


def test_init_cache_and_slots():
    # ring caches of min(window, max_len) slots in the 5 local sub-blocks
    # and the remainder stage, a full-length dense cache in the global one,
    # with or without params (no latent layout: qk_norm); slot take / put
    # on the stacked stages
    jcfg, tcfg = _cfgs(14)
    jp, tp = _pair(JM.init_params(jcfg, jax.random.PRNGKey(1)))
    for params in ((None, None), (jp, tp)):
        want = JM.init_cache(jcfg, 3, 20, params=params[0])
        got = TM.init_cache(tcfg, 3, 20, params=params[1], device="cpu")
        _assert_trees_close(got, want, 0, 0)
    assert tuple(got[0][0]["k"].shape) == (2, 3, 8, 1, 16)
    assert tuple(got[0][5]["k"].shape) == (2, 3, 20, 1, 16)
    assert tuple(got[1][0]["v"].shape) == (2, 3, 8, 1, 16)
    short = TM.init_cache(tcfg, 1, 5, device="cpu")
    assert tuple(short[0][0]["k"].shape) == (2, 1, 5, 1, 16)
    gen = torch.Generator().manual_seed(0)
    leaves = [t for pk in got for c in pk for t in c.values()]
    for leaf in leaves:
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    slot = TM.cache_slot_take(tcfg, got, 2)
    assert tuple(slot[0][3]["k"].shape) == (2, 1, 8, 1, 16)
    assert torch.equal(slot[0][3]["k"][:, 0], got[0][3]["k"][:, 2])
    for pk in slot:
        for c in pk:
            for t in c.values():
                t.fill_(5.0)
    TM.cache_slot_put(tcfg, got, slot, 2)
    assert all(bool((t[:, 2] == 5.0).all()) for t in leaves)
    assert not any(bool((t[:, :2] == 5.0).any()) for t in leaves)


@pytest.mark.parametrize("which", ["dense", "compressed"])
def test_prefill_and_decode_match_reference(run, which):
    # whole prefill of 13 tokens (past the window: the L >= W ring write),
    # decode at scalar positions through a wrap, then per slot: logits and
    # caches, fp32 through 8 layers: rtol 1e-4, atol 5e-5 (the entries are
    # O(1)).  Chunked prefill raises for ring caches, in both packages
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    if which == "dense":
        jp, tp = _pair(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    else:
        jp, tp = run["pair"]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 18)).astype(np.int32)
    jc = JM.init_cache(jcfg, 2, 32)
    tc = TM.init_cache(tcfg, 2, 32, device="cpu")

    def check(got, want):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=5e-5)
        _assert_trees_close(got[1], want[1], 1e-4, 5e-5)

    want = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :13])}, jc)
    got = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :13])},
                     tc)
    check(got, want)
    for pos in range(13, 17):
        step = toks[:, pos:pos + 1]
        want = JM.decode_step(jp, jcfg, want[1], jnp.asarray(step), pos)
        got = TM.decode_step(tp, tcfg, got[1], torch.from_numpy(step), pos)
        check(got, want)
    pos = np.array([17, 9], np.int32)
    step = toks[:, 17:18]
    want = JM.decode_step(jp, jcfg, want[1], jnp.asarray(step),
                          jnp.asarray(pos))
    got = TM.decode_step(tp, tcfg, got[1], torch.from_numpy(step),
                         torch.from_numpy(pos))
    check(got, want)
    with pytest.raises(ValueError, match="ring"):
        TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :4])},
                   got[1], pos=4, chunked=True)


def test_decode_matches_forward(run):
    # the port alone: prefill 5 tokens (a ring not yet full), then decode
    # 15 more one by one (wrapping every local ring), each step's logits
    # against the forward over the same tokens (rtol 2e-3, atol 2e-3, the
    # reference's own decode tolerance)
    tcfg = run["tcfg"]
    _, tp = run["pair"]
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (2, 20)).astype(np.int32))
    with torch.no_grad():
        hidden, _ = TM.forward_hidden(tp, tcfg, {"tokens": toks})
        full = TM.logits_from_hidden(tp, tcfg, hidden)
    cache = TM.init_cache(tcfg, 2, 24, device="cpu")
    TM.prefill(tp, tcfg, {"tokens": toks[:, :5]}, cache)
    for pos in range(5, 20):
        dec, _ = TM.decode_step(tp, tcfg, cache, toks[:, pos:pos + 1], pos)
        torch.testing.assert_close(dec, full[:, pos], rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# compression


def test_compress_matches_reference(parity):
    # ranks integer-equal, composed maps within 1e-3 relative Frobenius on
    # every linear of every layer, report keys, and the compressed model's
    # ppl within 0.5 % of the reference's
    run = parity
    jrep, trep = run["jrep"], run["trep"]
    assert [u["name"] for u in trep["units"]] \
        == [u["name"] for u in jrep["units"]] \
        == [f"dec.{i}.attn_local" for i in range(5)] + ["dec.5.attn_global"]
    for ju, tu in zip(jrep["units"], trep["units"]):
        assert set(tu) == set(ju)
        assert [lin["rank"] for lin in tu["linears"]] \
            == [lin["rank"] for lin in ju["linears"]]
    for js_, ts_ in zip(jax.tree.leaves(run["jc"]["stages"],
                                        is_leaf=lambda x: isinstance(x, dict)
                                        and "u" in x),
                        jax.tree.leaves(run["tc"]["stages"],
                                        is_leaf=lambda x: isinstance(x, dict)
                                        and "u" in x)):
        if not (isinstance(js_, dict) and "u" in js_):
            continue
        want = np.einsum("...nk,...km->...nm", np.asarray(js_["v"]),
                         np.asarray(js_["u"]))
        got = torch.einsum("...nk,...km->...nm", ts_["v"], ts_["u"]).numpy()
        want = want.reshape(-1, *want.shape[-2:])
        got = got.reshape(-1, *got.shape[-2:])
        for layer in range(want.shape[0]):
            err = (np.linalg.norm(got[layer] - want[layer])
                   / np.linalg.norm(want[layer]))
            assert err <= 1e-3, err
    jppl = _ppl(JM.loss_fn, run["jc"], run["jcfg"], run["evals"],
                jnp.asarray)
    with torch.no_grad():
        tppl = _ppl(TM.loss_fn, run["tc"], run["tcfg"], run["evals"],
                    torch.from_numpy)
    assert abs(tppl / jppl - 1.0) <= 5e-3, (tppl, jppl)


def test_map_gap_starts_at_rounding_and_stays_in_limit(parity):
    # ROADMAP hazard 3j: the maps' gap to the JAX package starts at rounding
    # (unit 0: 3e-5 plainly, 4e-6 on the stream its solve saw; held to 1e-4
    # and to 1e-5, the fp32 limit of the port's kernel checks) and grows
    # with depth, about 2x a unit, as 1 against 8 CPU threads of the port
    # and the card against the CPU grow (tests/refine_off_sweep.py); on the
    # stream each solve saw it stays within the 1e-3 the maps are held to
    # at every unit
    tcfg = parity["tcfg"]
    jc = bridge.to_torch(jax.tree.map(np.asarray, parity["jc"]))
    gaps = unit_gaps(tcfg, parity["tc"], jc, parity["trep"])
    assert list(gaps) == [u["name"] for u in parity["trep"]["units"]]
    (plain0, shifted0, _), *_ = gaps.values()
    assert plain0 <= 1e-4 and shifted0 <= 1e-5, gaps
    for unit, (plain, shifted, cond) in gaps.items():
        assert shifted <= 1e-3, (unit, plain, shifted, cond)


def test_compress_walks_both_stages(parity, run):
    # 8 layers: the units in the JAX package's order (the 6-kind group,
    # then the remainder stage's 2 layers), the ranks of the 6-layer
    # reference run, every linear factorized and the remainder stage
    # restacked on its layer axis
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    want = [u.name for u in JP.unit_iterator(
        JM.init_params(jcfg, jax.random.PRNGKey(0)), jcfg)]
    assert [u["name"] for u in run["trep"]["units"]] == want
    assert want[6:] == ["dec.6.attn_local", "dec.7.attn_local"]
    ranks = [lin["rank"] for lin in parity["jrep"]["units"][0]["linears"]]
    for unit in run["trep"]["units"]:
        assert [lin["rank"] for lin in unit["linears"]] == ranks
    _, tc = run["pair"]
    rem = tc["stages"][1][0]
    assert tuple(rem["attn"]["wq"]["v"].shape) == (2, tcfg.d_model, ranks[0])
    assert "w" not in rem["ffn"]["down"]


# ---------------------------------------------------------------------------
# the servers


def test_server_tokens_match_reference(run):
    # 3 prompts of 12 tokens (past the window of 8) on 4 slots, 10 steps
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    jp, tp = run["pair"]
    prompts = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (3, 12)).astype(np.int32)
    want = JS.Server(jcfg, jp, max_len=32, batch=4, mesh=_auto_mesh()
                     ).generate(jnp.asarray(prompts), steps=10)
    got = TS.Server(tcfg, tp, max_len=32, batch=4, device="cpu"
                    ).generate(prompts, steps=10)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_tokens_match_reference(run):
    # 4 requests on 2 slots, prompts of 5 (L < W), 8 (L = W) and 13 / 11
    # (L > W): every request takes whole_exact prefill; the decode steps
    # wrap the rings
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    jp, tp = run["pair"]

    def requests(module):
        rng = np.random.default_rng(3)
        return [module.Request(rid=i, prompt=rng.integers(
            0, jcfg.vocab_size, (n,)).astype(np.int32), steps=s)
            for i, (n, s) in enumerate(zip((5, 13, 8, 11), (9, 6, 12, 7)))]

    jeng = JS.ContinuousBatchingServer(jcfg, jp, max_len=40, slots=2,
                                       mesh=_auto_mesh())
    want = jeng.run(requests(JS))
    teng = TS.ContinuousBatchingServer(tcfg, tp, max_len=40, slots=2,
                                       device="cpu")
    got = teng.run(requests(TS))
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid]["tokens"],
                                      want[rid]["tokens"])
    assert teng.prefill_routes == jeng.prefill_routes
    assert set(teng.prefill_routes.values()) == {"whole_exact"}
