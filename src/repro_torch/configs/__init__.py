"""Architecture config registry of the port.

``get_config(arch_id)`` / ``get_smoke_config(arch_id)`` mirror
``repro.configs``.  Only llama-7b (the paper's own model) is ported in this
slice; the other registered archs of the JAX package come with later slices.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
)

_REGISTRY: Dict[str, str] = {
    "llama-7b": "llama_7b",
}


def _module(arch: str):
    if arch not in _REGISTRY:
        raise KeyError(f"arch {arch!r} is not ported yet; ported: "
                       f"{sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG
