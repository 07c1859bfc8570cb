"""Architecture config registry of the port.

``get_config(arch_id)`` / ``get_smoke_config(arch_id)`` mirror
``repro.configs``.  Ported so far: llama-7b (the paper's own model),
deepseek-v2-lite-16b (MLA attention, MoE under either dispatch), the other
dense-attention archs qwen3-0.6b (qk_norm, tied embeddings), granite-3-8b
and phi3-medium-14b (GQA), and gemma3-1b (5 sliding-window local layers to
1 global, ring caches, a second RoPE theta), kimi-k2-1t-a32b (GQA
attention over a MoE under either dispatch, one shared expert, head dim
112), falcon-mamba-7b (Mamba1, attention-free), zamba2-7b (a Mamba2
backbone with one weight-shared attention block), and the multimodal archs:
whisper-base (an encoder over audio frames, a decoder with
cross-attention) and phi-3-vision-4.2b (patch embeddings spliced before
the tokens).  Every arch of the JAX package is ported.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
)

_REGISTRY: Dict[str, str] = {
    "llama-7b": "llama_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-3-8b": "granite_3_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma3-1b": "gemma3_1b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "zamba2-7b": "zamba2_7b",
    "whisper-base": "whisper_base",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}
ALL_ARCHS: List[str] = list(_REGISTRY)


def _module(arch: str):
    if arch not in _REGISTRY:
        raise KeyError(f"arch {arch!r} is not ported yet; ported: "
                       f"{sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG
