"""Plain PyTorch versions of the hand-written kernels.

They define what each kernel computes.  The wrappers in ``kernels.ops`` use
them for tensors on the CPU, and ``chip_smoke.py`` holds each kernel against
them on the card.  Counterpart of ``src/repro/kernels/ref.py``.
"""

from __future__ import annotations

import torch


def lowrank_matmul_ref(x, v, u):
    """y = (x @ v) @ u with fp32 accumulation; the rank-k intermediate is
    rounded to ``u.dtype`` before the second product."""
    t = torch.matmul(x.float(), v.float()).to(u.dtype)
    return torch.matmul(t.float(), u.float()).to(x.dtype)


def cov_accum_ref(x, xp):
    """x, xp: (T, n) -> (xᵀx, xᵀxp, xpᵀxp), each (n, n) fp32."""
    xf = x.float()
    xpf = xp.float()
    return xf.T @ xf, xf.T @ xpf, xpf.T @ xpf
