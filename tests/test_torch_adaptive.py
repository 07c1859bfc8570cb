"""``rank_mode="adaptive"``: the port's allocator, spectrum solves and two
sweeps against the JAX package's.

* ``allocate_by_loss`` and the lattice helpers are a verbatim copy: exact
  list equality with ``repro.core.ranks`` over a seeded sweep of shapes,
  losses, copies, floors, ceilings and ``remap``.
* ``solve_*_with_spectrum``: the factors equal the plain solve's bit for
  bit and the spectrum equals ``whitened_spectrum`` / ``weight_spectrum``
  to 1e-5.
* ``compress_model(rank_mode="adaptive")`` against the JAX package on
  llama smoke (hybrid calibration with ``replay_taps="auto"``), deepseek
  smoke under the drop-free dispatch (per-expert rank tuples) and under
  its own capacity dispatch (one rank a bank), 2 layers each, on
  well-conditioned uniform numpy tokens (8 × 32 llama, 16 × 64 deepseek);
  the deepseek runs without refinement, whose parity
  ``test_torch_deepseek.py`` / ``test_torch_capacity.py`` hold.
  Ranks, ``rank_per_expert``, replay taps and the allocation summary's
  integers are equal; ``trunc_loss_est`` agrees to 1e-3 relative (the
  estimates feed the water-fill, so a looser match would flip ranks),
  composed maps to 1e-3, eval ppl to 0.5 %.
* The masked tails: ``_mask_expert_tails`` multiplies by the mask as the
  reference does, so on the same factors it gives the same bits, -0.0
  included, and both packages' ``rank_per_expert`` by bits reads kmax.
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

from repro.configs import get_smoke_config as j_smoke
from repro.core import lowrank as JLR
from repro.core import pipeline as JP
from repro.core import ranks as JR
from repro.checkpoint import manager as JCK
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.checkpoint import manager as TCK
from repro_torch.core import lowrank as TLR
from repro_torch.core import pipeline as TP
from repro_torch.core import ranks as TR
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM

LLAMA, DEEPSEEK = "llama-7b", "deepseek-v2-lite-16b"
RECIPE = dict(ratio=0.6, rank_multiple=8, microbatch=4, refine_epochs=1,
              rank_mode="adaptive", debug_covs=True)
RUNS = {
    "llama": (LLAMA, dict(calib_mode="hybrid", replay_taps="auto")),
    # rank_multiple 1: at 8 every expert of these small banks lands on 8.
    # No refinement: one Adam epoch moves every coordinate by about lr
    # whatever the sign noise of its gradient, which is 1.06e-3 of expert
    # 7's rank-7 down map here (4.9e-4 at most elsewhere); the solves alone
    # agree to 1.4e-4.  test_refined_masked_tails_stay_zero refines them.
    "deepseek_dropfree": (DEEPSEEK, dict(calib_mode="fused",
                                         moe_dispatch="dropfree",
                                         rank_multiple=1, refine=False)),
    "deepseek_capacity": (DEEPSEEK, dict(calib_mode="hybrid",
                                         refine=False)),
}


def _tokens(rng, cfg, arch):
    return rng.integers(0, cfg.vocab_size, (8, 32) if arch == LLAMA
                        else (16, 64), dtype=np.int32)


def _factor_maps(tree, path=""):
    """{path: (..., n, m) composed map v @ u} of a param tree (numpy or
    torch leaves), float64."""
    out = {}
    if isinstance(tree, dict):
        if "u" in tree and "v" in tree:
            v, u = (np.asarray(t.numpy() if torch.is_tensor(t) else t,
                               np.float64) for t in (tree["v"], tree["u"]))
            return {path: np.einsum("...nk,...km->...nm", v, u)}
        for k, v in tree.items():
            out.update(_factor_maps(v, f"{path}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_factor_maps(v, f"{path}/[{i}]"))
    return out


def _ppl(loss_fn, params, cfg, evals, to):
    """exp of the mean cross-entropy over ``evals``."""
    tot = sum(float(loss_fn(params, cfg, {k: to(v) for k, v in b.items()}
                            )[1]["ce"]) for b in evals)
    return math.exp(tot / len(evals))


# one compiled JAX loss a config: the eager one dispatches op by op
_jax_loss = jax.jit(JM.loss_fn, static_argnums=1)


@pytest.fixture(scope="module", params=list(RUNS))
def run(request):
    arch, extra = RUNS[request.param]
    cfg = j_smoke(arch).replace(dtype="float32", num_layers=2)
    tcfg = TC.get_smoke_config(arch).replace(dtype="float32", num_layers=2)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = _tokens(rng, cfg, arch)
    evals = []
    for _ in range(2):
        t = rng.integers(0, cfg.vocab_size, (8, 65), dtype=np.int32)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    recipe = dict(RECIPE, **extra)
    jc, jrep = JP.compress_model(params, cfg, {"tokens": jnp.asarray(toks)},
                                 JP.CompressConfig(**recipe))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params))
    solve_forwards = []
    merge = TP._merge_adaptive_report

    def spy(report, rep1, est, alloc):
        # the solve sweep's own count, before the estimate sweep's is
        # merged in
        solve_forwards.append(report["calibration"]["tapped_forwards"])
        merge(report, rep1, est, alloc)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "_merge_adaptive_report", spy)
        tc, trep = TP.compress_model(tparams, tcfg, {"tokens": toks},
                                     TP.CompressConfig(**recipe),
                                     device="cpu")
    if recipe.get("moe_dispatch") == "dropfree":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch="dropfree"))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, dispatch="dropfree"))
    return dict(name=request.param, cfg=cfg, tcfg=tcfg, jc=jc, jrep=jrep,
                tc=tc, trep=trep, evals=evals, recipe=recipe,
                solve_forwards=solve_forwards)


def test_ranks_and_allocation_integers_equal(run):
    jrep, trep = run["jrep"], run["trep"]
    for ju, tu in zip(jrep["units"], trep["units"]):
        assert [lin["rank"] for lin in tu["linears"]] == \
            [lin["rank"] for lin in ju["linears"]], tu["name"]
        assert [lin.get("rank_per_expert") for lin in tu["linears"]] == \
            [lin.get("rank_per_expert") for lin in ju["linears"]]
        assert [lin.get("uniform_rank") for lin in tu["linears"]] == \
            [lin.get("uniform_rank") for lin in ju["linears"]]
        assert tu["replay_taps"] == ju["replay_taps"], tu["name"]
        assert tu["tapped_forwards"] == ju["tapped_forwards"], tu["name"]
    ja, ta = (r["calibration"]["rank_mode"] for r in (jrep, trep))
    assert set(ta) == set(ja)
    for key, want in ja.items():
        if isinstance(want, float):
            assert ta[key] == pytest.approx(want, rel=1e-12), key
        else:
            assert ta[key] == want, key
    if run["name"] == "deepseek_dropfree":
        assert any(lin.get("rank_per_expert") for u in trep["units"]
                   for lin in u["linears"])
        assert ta["padded_params"] > ta["allocated_params"]


def test_loss_estimates_match(run):
    for ju, tu in zip(run["jrep"]["units"], run["trep"]["units"]):
        for jl, tl in zip(ju["linears"], tu["linears"]):
            assert tl["trunc_loss_est"] == pytest.approx(
                jl["trunc_loss_est"], rel=1e-3), (tu["name"], tl["path"])
            assert tl["shift_drift"] == pytest.approx(
                jl["shift_drift"], rel=1e-3, abs=1e-6)


def _units_by_slot(tcfg):
    """{(stage, kind slot): [unit index of each iteration]}, solve order."""
    out, idx = {}, 0
    for si, st in enumerate(TB.stage_program(tcfg)):
        iters = st.n if (st.scan and st.n > 1) else 1
        for ki in range(len(st.kinds)):
            out[si, ki] = [idx + it * len(st.kinds) + ki
                           for it in range(iters)]
        idx += iters * len(st.kinds)
    return out


def map_errors(jc, tc, tcfg, trep):
    """({(path, unit, expert): relative error of the port's composed map},
    {same key: condition number of the port's X′ᵀX′ there}).
    A tap group the unit replayed was collected sequentially, and its
    shifted stream is rank-deficient by construction (``attn/o_in`` mixes
    the compressed ``wv``'s values): there the maps are compared as they
    act on that stream, ||X′(W_port − W_jax)||_F / ||X′ W_jax||_F from the
    port's accumulated X′ᵀX′ (null directions are fixed by fp32 rounding
    alone, hazard 3d, as in ``tests/test_torch_deepseek.py``)."""
    want, got = _factor_maps(jc), _factor_maps(tc)
    assert sorted(got) == sorted(want)
    units = _units_by_slot(tcfg)
    errs, conds = {}, {}
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        slot = tuple(int(part[1:-1]) for part in path.split("/")[2:4])
        lin = ".".join(path.split("/")[4:])
        n, m = w.shape[-2:]
        g = g.reshape(len(units[slot]), -1, n, m)
        w = w.reshape(len(units[slot]), -1, n, m)
        for layer, ui in enumerate(units[slot]):
            unit = trep["units"][ui]
            tap = next(sp.tap for sp in TP.linear_specs(unit["kind"], tcfg)
                       if sp.path == lin)
            cov = unit["covs"][tap]["xpxp"].numpy().reshape(-1, n, n)
            for e in range(w.shape[1]):
                key = (lin, ui, e)
                dw, we = g[layer, e] - w[layer, e], w[layer, e]
                lam, q = np.linalg.eigh(cov[e].astype(np.float64))
                conds[key] = lam[-1] / max(lam[0], 1e-300)
                if tap not in unit["replay_taps"]:
                    errs[key] = np.linalg.norm(dw) / np.linalg.norm(we)
                else:
                    half = q * np.sqrt(np.clip(lam, 0.0, None))
                    errs[key] = (np.linalg.norm(half.T @ dw)
                                 / np.linalg.norm(half.T @ we))
    return errs, conds


def test_composed_maps_match(run):
    errs, _ = map_errors(run["jc"], run["tc"], run["tcfg"], run["trep"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])


def test_ppl_matches_reference(run):
    want = _ppl(_jax_loss, run["jc"], run["cfg"], run["evals"], jnp.asarray)
    with torch.no_grad():
        got = _ppl(TM.loss_fn, run["tc"], run["tcfg"], run["evals"],
                   torch.from_numpy)
    assert abs(got / want - 1) <= 5e-3, (got, want)


def test_solve_sweep_issues_no_tapped_forwards(run):
    assert run["solve_forwards"] == [0]
    cal = run["trep"]["calibration"]
    assert cal["rank_mode"]["estimate_forwards"] == cal["tapped_forwards"] > 0


def test_budget_met_within_one_lane_step(run):
    alloc = run["trep"]["calibration"]["rank_mode"]
    steps = [(lin["shape"][0] if len(lin["shape"]) == 3
              and "rank_per_expert" not in lin else 1)
             * TR.rank_cost(lin["shape"][-1], lin["shape"][-2])
             * run["recipe"]["rank_multiple"]
             for u in run["trep"]["units"] for lin in u["linears"]]
    assert alloc["allocated_params"] <= alloc["budget_params"]
    assert alloc["budget_params"] - alloc["allocated_params"] <= max(steps)


@pytest.mark.parametrize("run", ["deepseek_dropfree"], indirect=True)
def test_masked_tails_carry_the_reference_bits(run):
    checked = 0
    for jst, tst in zip(run["jc"]["stages"], run["tc"]["stages"]):
        for proj in ("gate", "up", "down"):
            if "experts" not in tst[0]["ffn"]:
                continue
            tb = tst[0]["ffn"]["experts"][proj]
            jb = jst[0]["ffn"]["experts"][proj]
            # the same factors through both masks: the same bits
            ks = [max(1, k // 2) for k in range(1, tb["u"].shape[-2] + 1)
                  ][:tb["u"].shape[0]]
            ks = (ks * tb["u"].shape[0])[:tb["u"].shape[0]]
            t_in = {"v": tb["v"], "u": tb["u"]}
            j_in = {k: jnp.asarray(v.numpy()) for k, v in t_in.items()}
            tm = TP._mask_expert_tails(t_in, ks)
            jm = JP._mask_expert_tails(j_in, ks)
            for key in ("v", "u"):
                assert tm[key].numpy().tobytes() == \
                    np.asarray(jm[key]).tobytes(), (proj, key)
            # both packages' manifests count bits: a masked tail with a
            # negative factor entry reads kmax in each
            for key, axis in (("v", -1), ("u", -2)):
                t_store = tb[key].numpy()
                j_store = np.asarray(jb[key])
                assert TCK._logical_ranks(t_store, axis) == \
                    JCK._logical_ranks(j_store, axis)
            checked += 1
    assert checked == 3


# ---------------------------------------------------------------------------
# the allocator and the lattice


def _alloc_cases():
    rng = np.random.default_rng(0)
    cases = []
    for i in range(60):
        n_items = int(rng.integers(1, 9))
        shapes = [(int(rng.integers(4, 300)), int(rng.integers(4, 300)))
                  for _ in range(n_items)]
        if i % 7 == 0:   # identical items: the tie-breaks decide
            shapes = [shapes[0]] * n_items
        losses = [float(x) for x in rng.lognormal(0.0, 2.0, n_items)]
        if i % 5 == 0:
            losses = [losses[0]] * n_items
        copies = ([int(rng.integers(1, 65)) for _ in range(n_items)]
                  if i % 3 == 0 else None)
        cases.append(dict(
            shapes=shapes, losses=losses,
            budget_ratio=float(rng.choice([0.05, 0.2, 0.4, 0.6, 0.8, 1.2])),
            remap=bool(i % 2), floor_ratio=float(rng.choice([0.0, 0.25, 1.0])),
            ceil_ratio=float(rng.choice([0.0, 1.0, 1.5])),
            multiple=int(rng.choice([1, 8, 128])), copies=copies))
    return cases


def test_allocate_by_loss_matches_reference():
    for case in _alloc_cases():
        kw = dict(case)
        shapes, losses, ratio = (kw.pop(k) for k in
                                 ("shapes", "losses", "budget_ratio"))
        assert TR.allocate_by_loss(shapes, losses, ratio, **kw) == \
            JR.allocate_by_loss(shapes, losses, ratio, **kw), case


def test_lattice_and_cost_helpers_match_reference():
    rng = np.random.default_rng(1)
    for _ in range(200):
        m, n = int(rng.integers(1, 5000)), int(rng.integers(1, 5000))
        k = int(rng.integers(1, 3000))
        mult = int(rng.choice([1, 8, 128]))
        remap = bool(rng.integers(2))
        kmax = TR.rank_cap(m, n, remap=remap)
        for name, args, kw in (
                ("rank_cap", (m, n), {"remap": remap}),
                ("rank_cost", (m, n), {"remap": remap}),
                ("params_saved", (m, n, k), {"remap": remap}),
                ("_lattice_bottom", (kmax, mult), {}),
                ("_lattice_floor", (k * 1.37, kmax, mult), {}),
                ("_lattice_next", (min(k, kmax), kmax, mult), {}),
                ("_real_rank", (m, n, 0.37), {"remap": remap}),
                ("bank_padded_cost", (m, n, [k, k // 2 + 1, 1]),
                 {"remap": remap})):
            assert getattr(TR, name)(*args, **kw) == \
                getattr(JR, name)(*args, **kw), (name, args)


# ---------------------------------------------------------------------------
# spectrum solves


def test_spectrum_solves_match_standalone_estimators():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((12, 10)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((64, 12)).astype(np.float32))
    cov = x.T @ x
    f1 = TLR.solve_anchored(w, cov, cov, 4)
    f2, s = TLR.solve_anchored_with_spectrum(w, cov, cov, 4)
    for key in ("v", "u"):
        assert torch.equal(f1[key], f2[key])
    torch.testing.assert_close(s, TLR.whitened_spectrum(w, cov, cov),
                               rtol=1e-5, atol=1e-5)
    fa, sa = TLR.solve_agnostic_with_spectrum(w, 4)
    for key in ("v", "u"):
        assert torch.equal(TLR.solve_agnostic(w, 4)[key], fa[key])
    torch.testing.assert_close(sa, TLR.weight_spectrum(w), rtol=1e-5,
                               atol=1e-5)
    # against the JAX package's spectra on the same inputs
    want = JLR.whitened_spectrum(jnp.asarray(w.numpy()),
                                 jnp.asarray(cov.numpy()),
                                 jnp.asarray(cov.numpy()))
    np.testing.assert_allclose(s.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        sa.numpy(), np.asarray(JLR.weight_spectrum(jnp.asarray(w.numpy()))),
        rtol=1e-5, atol=1e-5)


def test_tail_energy_is_the_reference_expression():
    s = np.random.default_rng(4).random((3, 17)).astype(np.float32)
    for k in (0, 1, 5, 17):
        assert TLR.spectrum_tail_energy(torch.from_numpy(s), k) == \
            JLR.spectrum_tail_energy(jnp.asarray(s), k)
        assert TLR.spectrum_tail_energy(s[1], k) == \
            JLR.spectrum_tail_energy(s[1], k)


# ---------------------------------------------------------------------------
# port-only contracts


def _llama_port():
    tcfg = TC.get_smoke_config(LLAMA).replace(dtype="float32")
    params = TM.init_params(tcfg, 0, device="cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (8, 32))
    return tcfg, params, {"tokens": toks}


def test_pinned_allocation_reproduces_uniform_bitwise():
    tcfg, params, calib = _llama_port()
    base = dict(ratio=0.4, refine=False, rank_multiple=1, microbatch=4,
                calib_mode="fused")
    out_u, rep_u = TP.compress_model(params, tcfg, calib,
                                     TP.CompressConfig(**base), device="cpu")
    out_p, rep_p = TP.compress_model(
        params, tcfg, calib,
        TP.CompressConfig(rank_mode="adaptive", rank_floor_ratio=1.0,
                          rank_ceil_ratio=1.0, **base), device="cpu")
    ranks = [[lin["rank"] for lin in u["linears"]] for u in rep_u["units"]]
    assert ranks == [[lin["rank"] for lin in u["linears"]]
                     for u in rep_p["units"]]
    for a, b in zip(TCK._flatten_with_paths(out_u),
                    TCK._flatten_with_paths(out_p)):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]


def test_refined_masked_tails_stay_zero():
    """Refinement leaves a masked tail at zero: its factor column and row
    are both zero, so neither gets a gradient."""
    tcfg = TC.get_smoke_config(DEEPSEEK).replace(dtype="float32",
                                                 num_layers=2)
    params = TM.init_params(tcfg, 0, device="cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (16, 64))
    comp, rep = TP.compress_model(
        params, tcfg, {"tokens": toks},
        TP.CompressConfig(**{**RECIPE, **RUNS["deepseek_dropfree"][1],
                             "refine": True, "debug_covs": False}),
        device="cpu")
    assert rep["refinement"]["steps"] > 0
    banks = {lin["path"].split(".")[-1]: lin["rank_per_expert"]
             for lin in rep["units"][1]["linears"]
             if "rank_per_expert" in lin}
    assert len(banks) == 3
    for proj, ks in banks.items():
        f = comp["stages"][1][0]["ffn"]["experts"][proj]
        assert len(set(ks)) > 1
        for e, k in enumerate(ks):
            assert not f["v"][e, :, k:].any() and not f["u"][e, k:].any()
            assert f["v"][e, :, k - 1].any() and f["u"][e, k - 1].any()


def test_ranks_tied_across_a_stacked_stage():
    tcfg, params, calib = _llama_port()
    _, rep = TP.compress_model(
        params, tcfg, calib,
        TP.CompressConfig(ratio=0.4, refine=False, microbatch=4,
                          calib_mode="fused", rank_mode="adaptive"),
        device="cpu")
    per_unit = [{lin["path"]: lin["rank"] for lin in u["linears"]}
                for u in rep["units"]]
    assert len(per_unit) == 2 and per_unit[0] == per_unit[1]
    assert len(set(per_unit[0].values())) > 1   # not uniform
    assert rep["calibration"]["rank_mode"]["rank_groups"] == len(per_unit[0])
