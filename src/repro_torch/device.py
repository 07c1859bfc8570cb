"""Where the port's entry points run: the card, unless the caller asks for
the CPU.  Asking for CUDA on a machine without it raises — nothing carries
on quietly on the CPU."""

from __future__ import annotations

import repro_torch._fp32  # noqa: F401  (TF32 off before any torch work)
import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
