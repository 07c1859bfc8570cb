"""The port's llama config equals the JAX package's field by field."""

from __future__ import annotations

import dataclasses

import pytest

from repro import configs as JC
from repro_torch import configs as TC


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_llama_config_field_equal(getter):
    jc = getattr(JC, getter)("llama-7b")
    tc = getattr(TC, getter)("llama-7b")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.head_dim == jc.head_dim


def test_head_dim_default_rule():
    cfg = TC.get_config("llama-7b")
    assert cfg.head_dim == cfg.d_model // cfg.num_heads == 128
    assert cfg.replace(head_dim=0).head_dim == 128


def test_unported_arch_raises():
    with pytest.raises(KeyError, match="not ported"):
        TC.get_config("qwen3-0.6b")
