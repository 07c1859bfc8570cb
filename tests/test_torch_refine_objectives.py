"""Knobs of ``compress_model`` the earlier parity tests left out, against
the JAX package on llama smoke (2 layers, 8 × 32 uniform numpy tokens,
fused calibration, ratio 0.6, ``rank_multiple=1``, microbatch 2):

* ``refine_target_mse``: refinement stops after the first epoch whose mean
  loss reaches the target.  At 0.08 the first unit (0.090 before
  refinement) stops early and the second (0.275) runs all 6 epochs: the
  same ``refine_steps`` as the reference's, post-refine MSEs to 1e-3
  relative.
* ``objective="input_aware"`` (A = B = X) and ``"shift_aware"``
  (A = B = X′): composed maps to 1e-3, ranks and forwards equal, eval ppl
  to 0.5 %.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zoo
from repro.core.pipeline import CompressConfig as JCompressConfig
from repro.core.pipeline import compress_model as j_compress
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.core import pipeline as TP
from repro_torch.models import model as TM
from test_torch_adaptive import map_errors

BASE = dict(ratio=0.6, rank_multiple=1, microbatch=2, calib_mode="fused",
            refine_epochs=1, debug_covs=True)


def _compress(**kw):
    cfg = zoo.smoke_cfg("llama-7b")
    tcfg = TC.get_smoke_config("llama-7b").replace(dtype="float32")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (8, 32), dtype=np.int32)
    recipe = dict(BASE, **kw)
    jc, jrep = j_compress(params, cfg, {"tokens": jnp.asarray(toks)},
                          JCompressConfig(**recipe))
    tc, trep = TP.compress_model(
        bridge.to_torch(jax.tree.map(np.asarray, params)), tcfg,
        {"tokens": toks}, TP.CompressConfig(**recipe), device="cpu")
    evals = []
    for _ in range(2):
        t = rng.integers(0, cfg.vocab_size, (8, 65), dtype=np.int32)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return cfg, tcfg, jc, jrep, tc, trep, evals


def test_refine_target_mse_stops_where_the_reference_does():
    _, _, _, jrep, _, trep, _ = _compress(refine_epochs=6,
                                          refine_target_mse=0.08)
    steps = [u["refine_steps"] for u in trep["units"]]
    assert steps == [u["refine_steps"] for u in jrep["units"]]
    assert steps[0] < 6 * 4 == steps[1]
    for ju, tu in zip(jrep["units"], trep["units"]):
        for key in ("pre_refine_mse", "post_refine_mse"):
            np.testing.assert_allclose(tu[key], ju[key], rtol=1e-3)
    assert trep["units"][0]["post_refine_mse"] <= 0.08


@pytest.mark.parametrize("objective", ["input_aware", "shift_aware"])
def test_objective_matches_reference(objective):
    cfg, tcfg, jc, jrep, tc, trep, evals = _compress(objective=objective)
    errs, _ = map_errors(jc, tc, tcfg, trep)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])
    for ju, tu in zip(jrep["units"], trep["units"]):
        assert [lin["rank"] for lin in tu["linears"]] == \
            [lin["rank"] for lin in ju["linears"]]
        assert tu["tapped_forwards"] == ju["tapped_forwards"]
    loss = jax.jit(JM.loss_fn, static_argnums=1)
    want = math.exp(np.mean([float(loss(
        jc, cfg, {k: jnp.asarray(v) for k, v in b.items()})[0])
        for b in evals]))
    with torch.no_grad():
        got = math.exp(np.mean([float(TM.loss_fn(
            tc, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})[0])
            for b in evals]))
    assert abs(got / want - 1) <= 5e-3, (got, want)
