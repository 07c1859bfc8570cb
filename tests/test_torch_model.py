"""llama smoke forward: the port against the JAX package on bridged params."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import pipeline as JP
from repro.core import zoo
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.core import pipeline as TP
from repro_torch.models import model as TM


def _setup():
    cfg = zoo.smoke_cfg("llama-7b")
    tcfg = TC.get_smoke_config("llama-7b").replace(dtype="float32")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, bridge.to_torch(jax.tree.map(np.asarray,
                                                           params))


def test_loss_matches_reference():
    # fp32 end to end; reductions in another order: rtol 1e-5
    cfg, tcfg, params, tparams = _setup()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(4, 65), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want = float(JM.loss_fn(params, cfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()})[0])
    got = float(TM.loss_fn(tparams, tcfg, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})[0])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_factorized_loss_matches_reference():
    # the same with every block linear factorized (odd rank 19), so the
    # lowrank_matmul wrapper is on the path: rtol 1e-5
    cfg, tcfg, params, _ = _setup()
    rng = np.random.default_rng(1)
    tree = jax.tree.map(np.asarray, params)
    block = tree["stages"][0][0]
    for part in ("attn", "ffn"):
        for name, lin in block[part].items():
            lyr, n, m = lin["w"].shape
            block[part][name] = {
                "u": (rng.standard_normal((lyr, 19, m)) / np.sqrt(19)
                      ).astype(np.float32),
                "v": (rng.standard_normal((lyr, n, 19)) / np.sqrt(n)
                      ).astype(np.float32)}
    toks = rng.integers(0, cfg.vocab_size, size=(2, 33), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want = float(JM.loss_fn(jax.tree.map(jnp.asarray, tree), cfg,
                            {k: jnp.asarray(v) for k, v in batch.items()})[0])
    got = float(TM.loss_fn(bridge.to_torch(tree), tcfg,
                           {k: torch.from_numpy(v)
                            for k, v in batch.items()})[0])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_unit_taps_match_reference():
    # one unit's tapped forward: same tap names, values to rtol 1e-5 / atol
    # 1e-6 (fp32, different kernels)
    cfg, tcfg, params, tparams = _setup()
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 32, cfg.d_model)) * 0.5).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["stages"][0][0])
    tp = {k: v for k, v in TP.unit_iterator(tparams, tcfg).__next__()
          .params.items()}
    jy, jtaps = JP.make_unit_apply("attn", cfg, 32, True)(jp, jnp.asarray(x),
                                                           None)
    ty, ttaps = TP.make_unit_apply("attn", tcfg, 32, True)(
        tp, torch.from_numpy(x), None)
    assert sorted(ttaps) == sorted(jtaps)
    for name in jtaps:
        np.testing.assert_allclose(ttaps[name].numpy(),
                                   np.asarray(jtaps[name]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)


def test_init_params_layout_matches_reference():
    cfg, tcfg, params, _ = _setup()
    want = jax.tree.map(np.asarray, params)
    got = bridge.to_numpy(TM.init_params(tcfg, 0, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
        # same distribution family: equal spread to within sampling noise
        if b.std() > 0:
            assert abs(a.std() / b.std() - 1) < 0.2
