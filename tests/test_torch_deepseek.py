"""Algorithm 2 on deepseek-v2-lite smoke with drop-free MoE dispatch: the
port's ``compress_model`` against the JAX package's, fused and sequential.

The config runs at 3 layers, so the ``mla_moe`` stage stacks (n = 2) beside
the unstacked ``mla_dense_first`` one.  Calibration is 16 × 64 tokens drawn
with numpy, uniform over the vocabulary: about 256 routed rows an expert
(top-2 of 8) against n = 64, so every expert's covariances have full rank
and the solve is well conditioned (ROADMAP hazard 3d).  The recipe is the
zoo's (ratio 0.6, ``rank_multiple=1``, microbatch 2, one refine epoch) with
``moe_dispatch="dropfree"``.

Tolerances: composed maps — per linear and, for the expert banks, per
expert — to 1e-3 relative Frobenius; refine MSEs to rtol 1e-3; ppl to
0.5 %; ranks, tapped forwards, report keys and the drop rates exactly.

Sequential calibration re-collects each tap group after the groups before
it are solved, so two of MLA's shifted-stream inputs are rank-deficient by
construction: ``attn/kvb_in`` is the kv-normed latent of the compressed
``wkv_a`` (rank 14 of 32 here) and ``attn/o_in`` mixes values of the
compressed ``wv_b`` (rank 12 of 64).  The whitening floors the null
eigenvalues at 1e-6·λmax, so the composed maps' null-space parts are fixed
by fp32 rounding alone in either package (hazard 3d again); the plain
Frobenius gaps of ``wk_b`` / ``wv_b`` / ``wo`` measure 0.17 / 0.17 / 0.06
in the first unit.  In sequential mode the maps are therefore compared as
they act on the shifted stream the solve saw, ||X′(W_port − W_jax)||_F /
||X′ W_jax||_F from the accumulated X′ᵀX′.  That gap is 2.4e-5 at most in
the first unit; refinement then moves each unit's rounding-set directions
into the next unit's shifted stream, and the gap grows with depth to
1.6e-4 (second unit) and 1.5e-3 (third unit, an expert's ``down``), so
sequential mode is held to 5e-3.  Refine MSEs (1e-3) and ppl (0.5 %) hold
in both modes.
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
from repro.core.pipeline import CompressConfig as JCompressConfig
from repro.core.pipeline import compress_model as j_compress
from repro.core.pipeline import compress_ratio_report as j_ratio
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.core import pipeline as TP
from repro_torch.models import model as TM

ARCH = "deepseek-v2-lite-16b"
RECIPE = dict(ratio=0.6, rank_multiple=1, microbatch=2, refine_epochs=1,
              moe_dispatch="dropfree")


def _dropfree(cfg):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="dropfree"))


@pytest.fixture(scope="module", params=["fused", "sequential"])
def run(request):
    cfg = j_smoke(ARCH).replace(dtype="float32", num_layers=3)
    tcfg = TC.get_smoke_config(ARCH).replace(dtype="float32", num_layers=3)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params))
    before = bridge.to_numpy(tparams)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(16, 64), dtype=np.int32)
    evals = []
    for _ in range(2):
        t = rng.integers(0, cfg.vocab_size, size=(8, 65), dtype=np.int32)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    recipe = dict(RECIPE, calib_mode=request.param, debug_covs=True)
    jc, jrep = j_compress(params, cfg, {"tokens": jnp.asarray(toks)},
                          JCompressConfig(**recipe))
    tc, trep = TP.compress_model(tparams, tcfg, {"tokens": toks},
                                 TP.CompressConfig(**recipe), device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                before=before, jc=jc, jrep=jrep, tc=tc, trep=trep,
                evals=evals)


def _linears(block):
    """(path, {"u", "v"}) of every factorized linear of a block, expert
    banks and shared experts included."""
    out = []
    for part in ("attn", "ffn"):
        for name, lin in block[part].items():
            if name in ("experts", "shared"):
                out += [(f"{part}.{name}.{sub}", sl)
                        for sub, sl in lin.items()]
            elif "u" in lin:
                out.append((f"{part}.{name}", lin))
    return out


def _shifted_cov(run, si, layer, path):
    """The port's accumulated X′ᵀX′ at the tap feeding ``path`` in the unit
    of stage ``si``, layer ``layer`` (one (n, n) or (E, n, n) per unit)."""
    unit = run["trep"]["units"][0 if si == 0 else 1 + layer]
    tap = next(spec.tap for spec in TP.linear_specs(unit["kind"], run["tcfg"])
               if spec.path == path)
    return unit["covs"][tap]["xpxp"].numpy()


def test_composed_maps_match(run):
    sequential = run["trep"]["calibration"]["mode"] == "sequential"
    checked = 0
    for si, (jst, tst) in enumerate(zip(run["jc"]["stages"],
                                        run["tc"]["stages"])):
        jl, tl = dict(_linears(jst[0])), dict(_linears(tst[0]))
        assert sorted(jl) == sorted(tl)
        for path, lin in jl.items():
            want = np.einsum("...nk,...km->...nm", np.asarray(lin["v"]),
                             np.asarray(lin["u"]))
            got = torch.einsum("...nk,...km->...nm", tl[path]["v"],
                               tl[path]["u"]).numpy()
            assert got.shape == want.shape, path
            n, m = want.shape[-2:]
            layers = want.shape[0] if want.ndim == 4 or (
                want.ndim == 3 and si == 1 and "experts" not in path) else 1
            want = want.reshape(layers, -1, n, m)
            got = got.reshape(layers, -1, n, m)
            for layer in range(layers):
                cov = (_shifted_cov(run, si, layer, path).reshape(-1, n, n)
                       if sequential else None)
                for e in range(want.shape[1]):
                    dw = (got[layer, e] - want[layer, e]).astype(np.float64)
                    w = want[layer, e].astype(np.float64)
                    if cov is None:
                        err = np.linalg.norm(dw) / np.linalg.norm(w)
                    else:
                        # X′ᵀX′ as a PSD form: its null eigenvalues come out
                        # of the fp32 sums at ±1e-7·λmax, clipped to 0
                        lam, q = np.linalg.eigh(cov[e].astype(np.float64))
                        half = q * np.sqrt(np.clip(lam, 0.0, None))
                        err = (np.linalg.norm(half.T @ dw)
                               / np.linalg.norm(half.T @ w))
                    assert err <= (5e-3 if sequential else 1e-3), \
                        (si, path, layer, e, err)
                    checked += 1
    # 8 dense-first + 2 layers x (5 attention + 3 shared + 3 banks x 8)
    assert checked == 8 + 2 * (5 + 3 + 3 * 8)


def test_refine_mse_ranks_and_forwards_match(run):
    for ju, tu in zip(run["jrep"]["units"], run["trep"]["units"]):
        for key in ("pre_refine_mse", "post_refine_mse"):
            np.testing.assert_allclose(tu[key], ju[key], rtol=1e-3)
        assert tu["refine_steps"] == ju["refine_steps"]
        assert tu["tapped_forwards"] == ju["tapped_forwards"]
        assert [(lin["path"], lin["rank"], lin["shape"])
                for lin in tu["linears"]] == \
            [(lin["path"], lin["rank"], lin["shape"]) for lin in ju["linears"]]


def test_report_keys_and_drop_rates(run):
    jrep, trep = run["jrep"], run["trep"]
    assert set(trep) == set(jrep)
    for key in ("calibration", "refinement", "config"):
        assert set(trep[key]) == set(jrep[key]), key
    for ju, tu in zip(jrep["units"], trep["units"]):
        assert set(tu) == set(ju)
        for jl, tl in zip(ju["linears"], tu["linears"]):
            assert set(tl) == set(jl)
    assert trep["calibration"]["moe_dispatch"] == "dropfree"
    assert trep["calibration"]["moe_drop_rate"] == \
        jrep["calibration"]["moe_drop_rate"] == {"dec.1.mla_moe": 0.0,
                                                 "dec.2.mla_moe": 0.0}
    assert trep["calibration"]["tapped_forwards"] == \
        jrep["calibration"]["tapped_forwards"]


def test_ppl_matches_reference(run):
    cfg, tcfg = _dropfree(run["cfg"]), _dropfree(run["tcfg"])
    jl = [float(JM.loss_fn(run["jc"], cfg, {k: jnp.asarray(v)
                                            for k, v in b.items()})[1]["ce"])
          for b in run["evals"]]
    with torch.no_grad():
        tl = [float(TM.loss_fn(run["tc"], tcfg, {k: torch.from_numpy(v)
                                                 for k, v in b.items()})
                    [1]["ce"]) for b in run["evals"]]
    want, got = np.exp(np.mean(jl)), np.exp(np.mean(tl))
    assert abs(got / want - 1) <= 5e-3, (got, want)


def test_params_untouched_and_ratio_report(run):
    after = bridge.to_numpy(run["tparams"])
    for a, b in zip(jax.tree.leaves(after), jax.tree.leaves(run["before"])):
        assert a.tobytes() == b.tobytes()
    want = j_ratio(run["params"], run["jc"])
    got = TP.compress_ratio_report(run["tparams"], run["tc"])
    assert got == want


def test_refinement_steps_the_expert_banks(run):
    # one refine epoch moves every leaf of the MoE unit — the factorized
    # expert banks and the router included — away from the closed-form
    # solve: the same recipe without refinement leaves them where they were
    recipe = dict(RECIPE, calib_mode=run["trep"]["calibration"]["mode"],
                  refine=False)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, run["cfg"].vocab_size, size=(16, 64),
                        dtype=np.int32)
    plain, rep = TP.compress_model(run["tparams"], run["tcfg"],
                                   {"tokens": toks},
                                   TP.CompressConfig(**recipe), device="cpu")
    assert all("refine_steps" not in u for u in rep["units"])
    refined = run["tc"]["stages"][1][0]["ffn"]
    solved = plain["stages"][1][0]["ffn"]
    for name in ("gate", "up", "down"):
        for leaf in ("u", "v"):
            moved = (refined["experts"][name][leaf]
                     - solved["experts"][name][leaf]).abs().amax(dim=(-2, -1))
            assert bool((moved > 0).all()), (name, leaf)
    assert not torch.equal(refined["router"]["w"], solved["router"]["w"])
    assert run["trep"]["refinement"]["steps"] > 0
