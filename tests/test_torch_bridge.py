"""numpy -> torch -> numpy is bit-exact for llama and deepseek smoke trees."""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import zoo
from repro.models import model as JM
from repro_torch import bridge


def _factorize(tree, rng):
    """Replace every stacked block linear {"w": (L, n, m)} with random
    {"u": (L, k, m), "v": (L, n, k)} at an odd rank (a compressed layout)."""
    block = tree["stages"][0][0]
    for part in ("attn", "ffn"):
        for name, lin in block[part].items():
            lyr, n, m = lin["w"].shape
            k = 19
            block[part][name] = {
                "u": rng.standard_normal((lyr, k, m)).astype(np.float32),
                "v": rng.standard_normal((lyr, n, k)).astype(np.float32)}
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["dense", "compressed"])
def test_roundtrip_bit_exact(layout, dtype):
    cfg = zoo.smoke_cfg("llama-7b")
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    if layout == "compressed":
        tree = _factorize(tree, np.random.default_rng(0))
    if dtype == "bfloat16":
        tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
    tt = bridge.to_torch(tree)
    assert tt["stages"][0][0]["attn"]["wq"][
        "w" if layout == "dense" else "v"].dtype == getattr(torch, dtype)
    back = bridge.to_numpy(tt)
    leaves_a, tree_a = jax.tree.flatten(tree)
    leaves_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(leaves_a, leaves_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_stacked_leaf_layout():
    cfg = zoo.smoke_cfg("llama-7b")
    tree = _factorize(jax.tree.map(
        np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0))),
        np.random.default_rng(1))
    tt = bridge.to_torch(tree)
    assert tuple(tt["stages"][0][0]["attn"]["wq"]["v"].shape) == (2, 64, 19)
    assert tuple(tt["stages"][0][0]["ffn"]["down"]["u"].shape) == (2, 19, 64)


def _factorize_banks(tree, rng, k=5):
    """Replace every expert bank {"w": (..., E, n, m)} of the MoE stage with
    random {"u": (..., E, k, m), "v": (..., E, n, k)} factors."""
    for lin in tree["stages"][1][0]["ffn"]["experts"].values():
        *lead, n, m = lin["w"].shape
        del lin["w"]
        lin["u"] = rng.standard_normal((*lead, k, m)).astype(np.float32)
        lin["v"] = rng.standard_normal((*lead, n, k)).astype(np.float32)
    return tree


@pytest.mark.parametrize("num_layers", [2, 3])
@pytest.mark.parametrize("layout", ["dense", "compressed"])
def test_deepseek_roundtrip_bit_exact(layout, num_layers):
    # 3-D expert banks, the unstacked n = 1 stages (2 layers) and a stacked
    # MoE stage (3 layers), dense or factorized banks
    cfg = get_smoke_config("deepseek-v2-lite-16b").replace(
        dtype="float32", num_layers=num_layers)
    tree = jax.tree.map(np.asarray,
                        JM.init_params(cfg, jax.random.PRNGKey(0)))
    if layout == "compressed":
        tree = _factorize_banks(tree, np.random.default_rng(2))
    tt = bridge.to_torch(tree)
    lead = () if num_layers == 2 else (2,)
    bank = tt["stages"][1][0]["ffn"]["experts"]
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    if layout == "dense":
        assert tuple(bank["gate"]["w"].shape) == lead + (e, d, f)
        assert tuple(bank["down"]["w"].shape) == lead + (e, f, d)
    else:
        assert tuple(bank["gate"]["u"].shape) == lead + (e, 5, f)
        assert tuple(bank["gate"]["v"].shape) == lead + (e, d, 5)
    assert tuple(tt["stages"][0][0]["attn"]["wkv_a"]["w"].shape) == (
        d, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)
    back = bridge.to_numpy(tt)
    leaves_a, tree_a = jax.tree.flatten(tree)
    leaves_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(leaves_a, leaves_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
