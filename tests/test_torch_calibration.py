"""Per-tap covariance triples of a llama unit: the port's engine against the
JAX ``CalibrationEngine``, fused and sequential.

Tolerance: rtol 1e-5 plus atol 1e-6·max|acc|.  The sums run in another
order, and a relative-only check is flaky on near-zero entries.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.core import streaming as JS
from repro.core import zoo
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.core import pipeline as TP
from repro_torch.core import streaming as TS


def _close(got, want):
    for key in ("xx", "xxp", "xpxp"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("mode", ["fused", "sequential"])
def test_unit_triples_match_reference(mode):
    cfg = zoo.smoke_cfg("llama-7b")
    tcfg = TC.get_smoke_config("llama-7b").replace(dtype="float32")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    xs = [(rng.standard_normal((2, 32, 64)) * 0.5).astype(np.float32)
          for _ in range(3)]
    # the shifted stream drifts from the original, as after a compressed unit
    xps = [x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
           for x in xs]
    groups = JP.tap_groups(JP.linear_specs("attn", cfg))
    j_orig = jax.tree.map(lambda a: a[0], params["stages"][0][0])
    j_cur = jax.tree.map(lambda a: a, j_orig)
    jfwd = JP.make_unit_apply("attn", cfg, 32, True)
    t_orig = bridge.to_torch(jax.tree.map(np.asarray, j_orig))
    t_cur = TP._clone(t_orig)
    tfwd = TP.make_unit_apply("attn", tcfg, 32, True)
    jxs, jxps = [jnp.asarray(x) for x in xs], [jnp.asarray(x) for x in xps]
    txs, txps = [torch.from_numpy(x) for x in xs], [torch.from_numpy(x)
                                                    for x in xps]
    je = JS.CalibrationEngine.for_unit(groups, jfwd, j_orig, jxs[0], None)
    te = TS.CalibrationEngine.for_unit(TP.tap_groups(
        TP.linear_specs("attn", tcfg)), tfwd, t_orig, txs[0], None)
    if mode == "fused":
        jy = je.collect_fused(jfwd, j_orig, j_cur, jxs, jxps, None, None)
        ty = te.collect_fused(tfwd, t_orig, t_cur, txs, txps, None, None)
        for a, b in zip(ty, jy):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    for tap, group in groups:
        if mode == "sequential":
            je.collect_group(tap, jfwd, j_orig, j_cur, jxs, jxps, None, None)
            te.collect_group(tap, tfwd, t_orig, t_cur, txs, txps, None, None)
        _close(te.covs_for(tap), je.covs_for(tap))
        if mode == "sequential":
            # solve the group on the JAX side and hand both engines the same
            # factors, so later groups see the same compressed unit
            covs = je.covs_for(tap)
            for spec in group:
                w = JP.get_path(j_cur, spec.path)["w"]
                fac = JP._solve_weight(w, covs, 19,
                                       JP.CompressConfig(ratio=0.6))
                JP.set_path(j_cur, spec.path, dict(fac))
                TP.set_path(t_cur, spec.path, bridge.to_torch(
                    jax.tree.map(np.asarray, dict(fac))))
    assert te.stats["tapped_forwards"] == je.stats["tapped_forwards"]
