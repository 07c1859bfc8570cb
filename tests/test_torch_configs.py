"""The port's configs equal the JAX package's field by field."""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
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


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_deepseek_config_field_equal(getter):
    # MoEConfig and MLAConfig sub-configs included
    jc = getattr(JC, getter)("deepseek-v2-lite-16b")
    tc = getattr(TC, getter)("deepseek-v2-lite-16b")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.head_dim == jc.head_dim == (tc.mla.qk_nope_head_dim
                                          + tc.mla.qk_rope_head_dim)


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-3-8b",
                                  "phi3-medium-14b", "gemma3-1b"])
def test_dense_attention_config_field_equal(arch, getter):
    jc = getattr(JC, getter)(arch)
    tc = getattr(TC, getter)(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.head_dim == jc.head_dim


def test_head_dim_default_rule():
    cfg = TC.get_config("llama-7b")
    assert cfg.head_dim == cfg.d_model // cfg.num_heads == 128
    assert cfg.replace(head_dim=0).head_dim == 128


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_ssm_hybrid_config_field_equal(arch, getter):
    # SSMConfig sub-config included; falcon-mamba's dt_rank default
    # (ceil(d_model / 16)) is filled in by both packages alike
    jc = getattr(JC, getter)(arch)
    tc = getattr(TC, getter)(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.ssm.dt_rank == jc.ssm.dt_rank


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", ["whisper-base", "phi-3-vision-4.2b"])
def test_multimodal_config_field_equal(arch, getter):
    # the encoder / frontend fields (num_encoder_layers, encoder_seq_len,
    # frontend, num_patches) included; phi-3-vision's head dim is 96
    jc = getattr(JC, getter)(arch)
    tc = getattr(TC, getter)(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.head_dim == jc.head_dim


def test_every_arch_of_the_reference_is_registered():
    assert sorted(TC._REGISTRY) == sorted(JC.ALL_ARCHS)
    assert TC.get_config("phi-3-vision-4.2b").head_dim == 96


def test_unported_arch_raises():
    # every arch of the JAX package is registered: a name outside the
    # registry raises with the list of ported archs
    with pytest.raises(KeyError, match="not ported"):
        TC.get_config("no-such-arch")
