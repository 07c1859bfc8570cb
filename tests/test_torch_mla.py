"""deepseek's MLA attention and block kinds in the port against the JAX
package on the CPU: ``mla_prefill`` with its taps, the rope tables over
``qk_rope_head_dim``, the ``mla_dense_first`` / ``mla_moe`` units, the
model loss with its aux term, the param layout (an unstacked n = 1 stage and
a stacked one), and ``flash_attention`` at MLA's head dim.

Inputs come from ``np.random.default_rng``; params are the JAX package's,
bridged.  The CUDA ``flash_attention`` kernel at head dim 192 runs only on
the card; ``chip_smoke.py`` holds it against its plain version there.
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
from repro.core import pipeline as JP
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.core import pipeline as TP
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

ARCH = "deepseek-v2-lite-16b"


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cfgs(num_layers=2):
    jc = j_smoke(ARCH).replace(dtype="float32", num_layers=num_layers)
    tc = TC.get_smoke_config(ARCH).replace(dtype="float32",
                                           num_layers=num_layers)
    return (jc.replace(moe=dataclasses.replace(jc.moe, dispatch="dropfree")),
            tc.replace(moe=dataclasses.replace(tc.moe, dispatch="dropfree")))


def _params(jcfg, seed=0):
    p = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return p, bridge.to_torch(jax.tree.map(np.asarray, p))


def test_rope_tables_span_the_rope_dims():
    jcfg, tcfg = _cfgs()
    pos = np.arange(9)
    jctx = JM.make_ctx(jcfg, jnp.asarray(pos))
    tctx = TM.make_ctx(tcfg, torch.from_numpy(pos))
    assert tuple(tctx["cos"].shape) == (9, tcfg.mla.qk_rope_head_dim // 2)
    for key in ("cos", "sin"):
        np.testing.assert_allclose(tctx[key].numpy(), np.asarray(jctx[key]),
                                   rtol=1e-6, atol=1e-6)


def test_mla_prefill_matches_reference():
    # output and the three taps (qkv_in, kvb_in, o_in) to fp32 rounding:
    # rtol 1e-5, atol 1e-6
    jcfg, tcfg = _cfgs()
    jp = JA.mla_init(jax.random.PRNGKey(3), jcfg)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp))
    x = _rand(np.random.default_rng(1), 2, 24, jcfg.d_model) * 0.5
    pos = np.arange(24)
    jctx = JM.make_ctx(jcfg, jnp.asarray(pos))
    tctx = TM.make_ctx(tcfg, torch.from_numpy(pos))
    jstore, tstore = {}, {}
    with JL.sowing(jstore):
        jy = JA.mla_prefill(jp, jnp.asarray(x), jcfg, jctx["cos"],
                            jctx["sin"])
    with torch.no_grad(), TL.sowing(tstore):
        ty = TA.mla_prefill(tp, torch.from_numpy(x), tcfg, tctx["cos"],
                            tctx["sin"])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    assert sorted(tstore) == sorted(jstore) == ["kvb_in", "o_in", "qkv_in"]
    for name in jstore:
        np.testing.assert_allclose(tstore[name].numpy(),
                                   np.asarray(jstore[name]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["mla_dense_first", "mla_moe"])
def test_unit_taps_match_reference(kind):
    # one unit's tapped forward: same tap names; activations to rtol 1e-5 /
    # atol 1e-6 and the routed expert ids exactly
    jcfg, tcfg = _cfgs()
    params, tparams = _params(jcfg)
    si = 0 if kind == "mla_dense_first" else 1
    jp = params["stages"][si][0]
    tp = tparams["stages"][si][0]
    x = _rand(np.random.default_rng(2), 2, 32, jcfg.d_model) * 0.5
    jy, jtaps = JP.make_unit_apply(kind, jcfg, 32, True)(jp, jnp.asarray(x),
                                                          None)
    with torch.no_grad():
        ty, ttaps = TP.make_unit_apply(kind, tcfg, 32, True)(
            tp, torch.from_numpy(x), None)
    assert sorted(ttaps) == sorted(jtaps)
    for name in jtaps:
        if name.endswith("experts_ids"):
            np.testing.assert_array_equal(ttaps[name].numpy(),
                                          np.asarray(jtaps[name]))
            continue
        np.testing.assert_allclose(ttaps[name].numpy(),
                                   np.asarray(jtaps[name]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("num_layers", [2, 3])
def test_loss_matches_reference(num_layers):
    # CE and the MoE aux loss; 3 layers stack the MoE stage (n = 2): rtol 1e-5
    jcfg, tcfg = _cfgs(num_layers)
    params, tparams = _params(jcfg)
    t = np.random.default_rng(4).integers(0, jcfg.vocab_size, (4, 33),
                                          dtype=np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    jl, jm = JM.loss_fn(params, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    with torch.no_grad():
        tl, tm = TM.loss_fn(tparams, tcfg, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5)
    assert float(tm["aux"]) > 0.0


@pytest.mark.parametrize("num_layers", [2, 3])
def test_init_params_layout_matches_reference(num_layers):
    # the n = 1 stages unstacked, a stacked MoE stage at 3 layers; same
    # leaves, shapes, dtypes and spread (within sampling noise)
    jcfg, tcfg = _cfgs(num_layers)
    want = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    got = bridge.to_numpy(TM.init_params(tcfg, 0, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
        if b.std() > 0:
            assert abs(a.std() / b.std() - 1) < 0.2
    bank = got["stages"][1][0]["ffn"]["experts"]["gate"]["w"]
    lead = () if num_layers == 2 else (2,)
    assert bank.shape == lead + (8, 64, 32)


def test_stage_program_matches_reference():
    for num_layers in (2, 3, 27):
        jcfg, tcfg = _cfgs(num_layers)
        want = [(s.kinds, s.n, s.scan) for s in JB.stage_program(jcfg)]
        assert [(s.kinds, s.n, s.scan) for s in TB.stage_program(tcfg)] \
            == want


@pytest.mark.parametrize("d", [150, 192])
def test_head_dim_192_is_compiled(d):
    # MLA prefill's head dim (qk_nope 128 + qk_rope 64) has its own kernel
    # instance; a head dim between 128 and 192 pads to it exactly (zero
    # dims with the scale of the true D: rtol 1e-6)
    assert ops._padded_head_dim(d) == 192
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 5, 2, d)) for _ in range(3))
    padded = ref.flash_attention_ref(
        *(ops.pad_dim(t, 3, 192) for t in (q, k, v)),
        scale=1.0 / math.sqrt(d))[..., :d]
    torch.testing.assert_close(padded, ref.flash_attention_ref(q, k, v),
                               rtol=1e-6, atol=1e-6)
    assert ops._padded_head_dim(193) == 256
    with pytest.raises(ValueError, match="no kernel"):
        ops._padded_head_dim(257)
