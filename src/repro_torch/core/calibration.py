"""Streaming covariance accumulation for calibration (App. B.1).

Counterpart of ``src/repro/core/calibration.py`` (:50-144).  Covariances
accumulate in fp32 over token batches:

    xx   += Xᵀ X      (original ⊗ original)
    xxp  += Xᵀ X'     (original ⊗ shifted — the anchored cross term)
    xpxp += X'ᵀ X'    (shifted ⊗ shifted)

with X given as rows (tokens, n).  Every product goes through
``kernels.ops.cov_accum`` — the hand-written CUDA kernel on the card, which
adds into the accumulators in place.  Expert-bank layouts (capacity banks,
grouped drop-free rows) come with the MoE slice.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ops


def init_covs(n: int, experts: int = 0, *, device="cpu") -> Dict:
    if experts:
        raise NotImplementedError(
            "expert-bank covariances are not ported to repro_torch yet "
            "(comes with the MoE slice)")
    return {
        "xx": torch.zeros((n, n), dtype=torch.float32, device=device),
        "xxp": torch.zeros((n, n), dtype=torch.float32, device=device),
        "xpxp": torch.zeros((n, n), dtype=torch.float32, device=device),
        "count": 0.0,
    }


def update_covs(covs: Dict, x: torch.Tensor, xp: torch.Tensor,
                ids=None) -> Dict:
    """x, xp: (..., tokens, n) activations (original / shifted), flattened
    to token rows.  The triple is updated IN PLACE (the kernel adds into the
    accumulators) and the dict is returned."""
    if ids is not None or covs["xx"].ndim == 3:
        raise NotImplementedError(
            "expert-bank covariance updates are not ported to repro_torch "
            "yet (comes with the MoE slice)")
    x = x.reshape(-1, x.shape[-1])
    xp = xp.reshape(-1, xp.shape[-1])
    ops.cov_accum(x, xp, acc=(covs["xx"], covs["xxp"], covs["xpxp"]))
    covs["count"] += x.shape[0]
    return covs


def shift_drift(covs: Dict) -> float:
    """||XᵀX − X′ᵀX′||_F / ||XᵀX||_F — how far the shifted stream's
    second-order statistics have drifted from the original's at a tap."""
    xx = covs["xx"].float()
    xpxp = covs["xpxp"].float()
    num = torch.linalg.norm((xx - xpxp).reshape(-1))
    den = torch.clamp(torch.linalg.norm(xx.reshape(-1)), min=1e-30)
    return float(num / den)


def objective_covs(covs: Dict, objective: str):
    """Map accumulated covariances to the (cov_ab, cov_bb) of Thm 3.2.

    objective ∈ {input_aware (A=B=X), shift_aware (A=B=X'),
                 anchored (A=X, B=X')}.
    """
    if objective == "input_aware":
        return covs["xx"], covs["xx"]
    if objective == "shift_aware":
        return covs["xpxp"], covs["xpxp"]
    if objective == "anchored":
        return covs["xxp"], covs["xpxp"]
    raise ValueError(f"unknown objective {objective!r} "
                     "(agnostic is handled by solve_agnostic)")
