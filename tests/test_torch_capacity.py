"""The port's capacity MoE dispatch on the CPU against the JAX package:
``moe_apply(dispatch="capacity")`` (forward, taps, drop stat, backward),
the banked covariance triple ``ops.cov_accum_banked``, the calibration
engine's capacity bank taps, and ``compress_model`` on deepseek smoke with
the config's own capacity dispatch.

Inputs come from ``np.random.default_rng`` and go to both packages as the
same arrays.  The CUDA kernel behind ``cov_accum_banked`` runs only on the
card; ``chip_smoke.py`` holds it against its plain version there.

The compression runs deepseek smoke at 2 layers (one ``mla_dense_first``
unit, one ``mla_moe``), fused calibration, 16 × 64 uniform numpy tokens in
microbatches of 2: 128 tokens a microbatch, top-2 of 8 experts at capacity
factor 1.25, so C = 40 slots an expert and 320 buffer rows an expert over
the calibration set against n = 64: every expert's covariances have full
rank.  Tolerances: composed maps per linear and per expert to 1e-3
relative Frobenius; ranks, tapped forwards and drop rates exactly; refine
MSEs to rtol 1e-3 and ppl to 0.5 %, as ``test_torch_deepseek.py`` holds
the drop-free dispatch.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import calibration as JCal
from repro.core import streaming as JS
from repro.core.pipeline import CompressConfig as JCompressConfig
from repro.core.pipeline import compress_model as j_compress
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import mlp as jmlp
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.core import calibration as TCal
from repro_torch.core import pipeline as TP
from repro_torch.core import streaming as TS
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import mlp as tmlp
from repro_torch.models import model as TM

ARCH = "deepseek-v2-lite-16b"


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cfgs(**moe_over):
    """(JAX cfg, port cfg): deepseek smoke in fp32, the config's own
    capacity dispatch (``moe_over`` replaces fields of ``cfg.moe``)."""
    jc = j_smoke(ARCH).replace(dtype="float32")
    tc = TC.get_smoke_config(ARCH).replace(dtype="float32")
    assert jc.moe.dispatch == tc.moe.dispatch == "capacity"
    return (jc.replace(moe=dataclasses.replace(jc.moe, **moe_over)),
            tc.replace(moe=dataclasses.replace(tc.moe, **moe_over)))


def _moe_params(jcfg, seed=0, factorized=False):
    p = jmlp.moe_init(jax.random.PRNGKey(seed), jcfg)
    if factorized:
        rng = np.random.default_rng(seed + 10)
        for name, lin in p["experts"].items():
            e, n, m = lin["w"].shape
            k = 5
            p["experts"][name] = {
                "v": jnp.asarray(_rand(rng, e, n, k) / np.sqrt(n)),
                "u": jnp.asarray(_rand(rng, e, k, m) / np.sqrt(k))}
    return p, bridge.to_torch(jax.tree.map(np.asarray, p))


def _triples_close(got, want):
    # fp32 sums of outer products in another order: rtol 1e-5 plus an atol
    # of 1e-6 of the accumulator's largest entry (ROADMAP hazard 3b)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())


# ---------------------------------------------------------------------------
# moe_apply (capacity)


def _run_jax(p, x, cfg, factor):
    store = {}
    with JL.sowing(store):
        y, aux = jmlp.moe_apply(p, jnp.asarray(x), cfg,
                                capacity_factor=factor)
    return np.asarray(y), float(aux), {k: np.asarray(v)
                                       for k, v in store.items()}


def _run_port(p, x, cfg, factor):
    store = {}
    with torch.no_grad(), TL.sowing(store):
        y, aux = tmlp.moe_apply(p, torch.from_numpy(x), cfg,
                                capacity_factor=factor)
    return y.numpy(), float(aux), {k: v.numpy() for k, v in store.items()}


@pytest.mark.parametrize("factor", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("factorized", [False, True])
def test_moe_apply_capacity_matches_reference(factorized, factor):
    # y, the aux loss and the (E, C, n) buffers to fp32 rounding (rtol 1e-5,
    # atol 1e-5 on O(1) values); the [dropped, total] stat EXACTLY.  Factor
    # 0.5 drops many choices, 4.0 none
    jcfg, tcfg = _cfgs()
    jp, tp = _moe_params(jcfg, factorized=factorized)
    x = _rand(np.random.default_rng(4), 3, 16, jcfg.d_model) * 0.5
    jy, jaux, jtaps = _run_jax(jp, x, jcfg, factor)
    ty, taux, ttaps = _run_port(tp, x, tcfg, factor)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-5)
    assert set(ttaps) == set(jtaps)
    np.testing.assert_array_equal(ttaps["experts_dropped"],
                                  jtaps["experts_dropped"])
    dropped, total = ttaps["experts_dropped"]
    assert total == 48 * jcfg.moe.top_k
    assert (dropped > 0) == (factor < 1.0)
    cap = int(np.ceil(48 * jcfg.moe.top_k / jcfg.moe.num_experts * factor))
    for name in ("experts_in", "experts_down_in", "shared/in",
                 "shared/down_in"):
        np.testing.assert_allclose(ttaps[name], jtaps[name], rtol=1e-5,
                                   atol=1e-5)
    assert ttaps["experts_in"].shape == (jcfg.moe.num_experts, cap,
                                         jcfg.d_model)


def test_moe_apply_capacity_floor_of_k_slots():
    # one token: T·k/E · factor < k, so C is floored at k slots an expert
    jcfg, tcfg = _cfgs()
    jp, tp = _moe_params(jcfg, seed=1)
    x = _rand(np.random.default_rng(5), 1, 1, jcfg.d_model)
    jy, jaux, jtaps = _run_jax(jp, x, jcfg, 1.25)
    ty, taux, ttaps = _run_port(tp, x, tcfg, 1.25)
    k = jcfg.moe.top_k
    assert ttaps["experts_in"].shape == (jcfg.moe.num_experts, k,
                                         jcfg.d_model)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-5)
    np.testing.assert_array_equal(ttaps["experts_dropped"], [0.0, k])
    np.testing.assert_allclose(ttaps["experts_in"], jtaps["experts_in"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("factorized", [False, True])
def test_moe_apply_capacity_backward_matches_reference(factorized):
    # gradients of a scalar of the output (with drops: factor 0.75) through
    # x, the router, the gates and the three batched expert products against
    # jax.grad: rtol 1e-4, atol 1e-5 (fp32 sums in another order through
    # softmax and the expert products)
    jcfg, tcfg = _cfgs()
    jp, tp = _moe_params(jcfg, seed=2, factorized=factorized)
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, 8, jcfg.d_model) * 0.5
    cot = _rand(rng, 2, 8, jcfg.d_model)

    def jloss(p, xj):
        y, aux = jmlp.moe_apply(p, xj, jcfg, capacity_factor=0.75)
        return jnp.sum(y * jnp.asarray(cot)) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaf = "v" if factorized else "w"
    leaves = {"router": tp["router"]["w"],
              "gate": tp["experts"]["gate"][leaf],
              "up": tp["experts"]["up"][leaf],
              "down": tp["experts"]["down"][leaf]}
    want = {"router": jg["router"]["w"],
            "gate": jg["experts"]["gate"][leaf],
            "up": jg["experts"]["up"][leaf],
            "down": jg["experts"]["down"][leaf]}
    xt = torch.from_numpy(x).requires_grad_(True)
    for t in leaves.values():
        t.requires_grad_(True)
    y, aux = tmlp.moe_apply(tp, xt, tcfg, capacity_factor=0.75)
    loss = torch.sum(y * torch.from_numpy(cot)) + aux
    grads = torch.autograd.grad(loss, [xt] + list(leaves.values()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)
    for name, g in zip(leaves, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# banked covariance triple


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("e,c,n", [(3, 37, 100), (2, 130, 192)])
def test_cov_accum_banked_matches_pallas(e, c, n, with_acc):
    # the port's plain route against the JAX package's vmapped kernel in
    # Pallas interpret mode; acc= is added into in place
    rng = np.random.default_rng(e + c + n)
    x = _rand(rng, e, c, n)
    xp = x + 0.1 * _rand(rng, e, c, n)
    x[:, c - 5:] = 0.0            # empty capacity slots, as routing leaves
    xp[:, c - 5:] = 0.0
    acc = None
    if with_acc:
        acc = tuple(_rand(rng, e, n, n) for _ in range(3))
    want = jops.cov_accum_banked(
        jnp.asarray(x), jnp.asarray(xp), force_pallas=True, interpret=True,
        acc=None if acc is None else tuple(jnp.asarray(a) for a in acc))
    tacc = None if acc is None else tuple(torch.from_numpy(a.copy())
                                          for a in acc)
    got = ops.cov_accum_banked(torch.from_numpy(x), torch.from_numpy(xp),
                               acc=tacc)
    if tacc is not None:
        assert all(g is a for g, a in zip(got, tacc))
    assert all(tuple(g.shape) == (e, n, n) and g.dtype == torch.float32
               for g in got)
    _triples_close([g.numpy() for g in got], want)


def test_cov_accum_banked_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="not one"):
        ops.cov_accum_banked(torch.zeros(2, 4, 8), torch.zeros(2, 5, 8))
    with pytest.raises(ValueError, match="not one"):
        ops.cov_accum_banked(torch.zeros(4, 8), torch.zeros(4, 8))


def test_update_covs_and_engine_take_capacity_banks():
    # update_covs routes (E, C, n) buffers into the (E, n, n) accumulator
    # and counts C a call, as the JAX package does; the engine sizes a 3-D
    # bank tap from its E and n (not its C) and feeds it the same way
    e, c, n = 4, 24, 16
    rng = np.random.default_rng(6)
    xs = [_rand(rng, e, c, n) for _ in range(2)]
    xps = [_rand(rng, e, c, n) for _ in range(2)]
    covs = TCal.init_covs(n, e)
    jcovs = JCal.init_covs(n, e)
    for x, xp in zip(xs, xps):
        TCal.update_covs(covs, torch.from_numpy(x), torch.from_numpy(xp))
        jcovs = JCal.update_covs(jcovs, jnp.asarray(x), jnp.asarray(xp))
    keys = ("xx", "xxp", "xpxp")
    _triples_close([covs[k].numpy() for k in keys], [jcovs[k] for k in keys])
    assert covs["count"] == float(jcovs["count"]) == 2 * c

    group = [("ffn.experts.gate", "ffn/experts_in", True)]
    # sized from a forward of another token count: C 7
    engine = TS.CalibrationEngine([("ffn/experts_in", group)],
                                  {"ffn/experts_in": torch.Size([e, 7, n])})
    jengine = JS.CalibrationEngine(
        [("ffn/experts_in", group)],
        {"ffn/experts_in": jax.ShapeDtypeStruct((e, 7, n), jnp.float32)})
    for x, xp in zip(xs, xps):
        engine.consume({"ffn/experts_in": torch.from_numpy(x)},
                       {"ffn/experts_in": torch.from_numpy(xp)})
        jengine.consume({"ffn/experts_in": jnp.asarray(x)},
                        {"ffn/experts_in": jnp.asarray(xp)})
    got = engine.covs_for("ffn/experts_in")
    want = jengine.covs_for("ffn/experts_in")
    assert got["xx"].shape == (e, n, n)
    _triples_close([got[k].numpy() for k in keys], [want[k] for k in keys])
    assert got["count"] == float(want["count"]) == 2 * c


# ---------------------------------------------------------------------------
# compress_model with the config's own capacity dispatch


RECIPE = dict(ratio=0.6, rank_multiple=1, microbatch=2, refine_epochs=1,
              calib_mode="fused")


@pytest.fixture(scope="module")
def run():
    cfg = j_smoke(ARCH).replace(dtype="float32", num_layers=2)
    tcfg = TC.get_smoke_config(ARCH).replace(dtype="float32", num_layers=2)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(16, 64), dtype=np.int32)
    evals = []
    for _ in range(2):
        t = rng.integers(0, cfg.vocab_size, size=(8, 65), dtype=np.int32)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    jc, jrep = j_compress(params, cfg, {"tokens": jnp.asarray(toks)},
                          JCompressConfig(**RECIPE))
    tc, trep = TP.compress_model(tparams, tcfg, {"tokens": toks},
                                 TP.CompressConfig(**RECIPE), device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, jc=jc, jrep=jrep, tc=tc, trep=trep,
                evals=evals)


def _maps(block):
    """{path: composed map v @ u} of every factorized linear of a block,
    one map per expert for a bank."""
    out = {}
    for part in ("attn", "ffn"):
        for name, lin in block[part].items():
            subs = (lin.items() if name in ("experts", "shared")
                    else [(None, lin)])
            for sub, sl in subs:
                if "u" in sl:
                    key = f"{part}.{name}" + ("" if sub is None
                                              else f".{sub}")
                    out[key] = np.einsum("...nk,...km->...nm",
                                         np.asarray(sl["v"]),
                                         np.asarray(sl["u"]))
    return out


def test_capacity_compress_composed_maps_match(run):
    checked = 0
    for jst, tst in zip(run["jc"]["stages"], run["tc"]["stages"]):
        jm = _maps(jst[0])
        tm = _maps(jax.tree.map(np.asarray, bridge.to_numpy(tst[0])))
        assert sorted(jm) == sorted(tm)
        for path, want in jm.items():
            got = tm[path]
            assert got.shape == want.shape, path
            want = want.reshape(-1, *want.shape[-2:]).astype(np.float64)
            got = got.reshape(-1, *got.shape[-2:]).astype(np.float64)
            for i in range(want.shape[0]):
                err = (np.linalg.norm(got[i] - want[i])
                       / np.linalg.norm(want[i]))
                assert err <= 1e-3, (path, i, err)
                checked += 1
    # 8 dense-first + (5 attention + 3 shared + 3 banks x 8 experts)
    assert checked == 8 + 5 + 3 + 3 * 8


def test_capacity_compress_ranks_forwards_and_mses_match(run):
    assert len(run["trep"]["units"]) == len(run["jrep"]["units"]) == 2
    for ju, tu in zip(run["jrep"]["units"], run["trep"]["units"]):
        assert set(tu) == set(ju)
        for key in ("pre_refine_mse", "post_refine_mse"):
            np.testing.assert_allclose(tu[key], ju[key], rtol=1e-3)
        assert tu["refine_steps"] == ju["refine_steps"]
        assert tu["tapped_forwards"] == ju["tapped_forwards"]
        assert [(lin["path"], lin["rank"], lin["shape"])
                for lin in tu["linears"]] == \
            [(lin["path"], lin["rank"], lin["shape"]) for lin in ju["linears"]]
    assert run["trep"]["calibration"]["tapped_forwards"] == \
        run["jrep"]["calibration"]["tapped_forwards"]


def test_capacity_compress_drop_rates_match(run):
    jrep, trep = run["jrep"], run["trep"]
    assert trep["calibration"]["moe_dispatch"] == "capacity"
    rates = trep["calibration"]["moe_drop_rate"]
    assert rates == jrep["calibration"]["moe_drop_rate"]
    assert list(rates) == ["dec.1.mla_moe"]
    assert 0.0 <= rates["dec.1.mla_moe"] < 1.0


def test_capacity_compress_ppl_matches_reference(run):
    jl = [float(JM.loss_fn(run["jc"], run["cfg"], {
        k: jnp.asarray(v) for k, v in b.items()})[1]["ce"])
        for b in run["evals"]]
    with torch.no_grad():
        tl = [float(TM.loss_fn(run["tc"], run["tcfg"], {
            k: torch.from_numpy(v) for k, v in b.items()})[1]["ce"])
            for b in run["evals"]]
    want, got = np.exp(np.mean(jl)), np.exp(np.mean(tl))
    assert abs(got / want - 1) <= 5e-3, (got, want)
