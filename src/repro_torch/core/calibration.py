"""Streaming covariance accumulation for calibration (App. B.1).

Counterpart of ``src/repro/core/calibration.py`` (:50-144).  Covariances
accumulate in fp32 over token batches:

    xx   += Xᵀ X      (original ⊗ original)
    xxp  += Xᵀ X'     (original ⊗ shifted — the anchored cross term)
    xpxp += X'ᵀ X'    (shifted ⊗ shifted)

with X given as rows (tokens, n).  Every product goes through
``kernels.ops.cov_accum`` — the hand-written CUDA kernel on the card, which
adds into the accumulators in place.

Expert banks accumulate per-expert triples ((E, n, n)) in one of two
layouts, as in the JAX package:

- capacity dispatch: the routed (E, C, n) capacity buffers of both streams
  (``kernels.ops.cov_accum_banked``: one launch of the kernel over all E
  banks; zero-padded slots add nothing).  ``count`` grows by C a microbatch,
  as the JAX package counts it;
- drop-free dispatch: the (R, n) choice-major routed rows of both streams
  plus the (R,) expert ids of the ORIGINAL stream
  (``kernels.ops.cov_accum_grouped``: the rows sorted by id, one
  ``cov_accum`` per expert segment).  The rows are exactly the T·k routed
  choices, so the triple is batch-size invariant.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ops


def init_covs(n: int, experts: int = 0, *, device="cpu") -> Dict:
    shape = (experts, n, n) if experts else (n, n)
    return {
        "xx": torch.zeros(shape, dtype=torch.float32, device=device),
        "xxp": torch.zeros(shape, dtype=torch.float32, device=device),
        "xpxp": torch.zeros(shape, dtype=torch.float32, device=device),
        "count": 0.0,
    }


def ids_tap_name(tap: str) -> str:
    """Tap carrying the expert ids paired with a grouped activation tap: the
    sibling ``experts_ids`` in the same scope (``ffn/experts_in`` ->
    ``ffn/experts_ids``).  Both grouped MoE taps of a unit share it."""
    return tap.rsplit("/", 1)[0] + "/experts_ids"


def update_covs(covs: Dict, x: torch.Tensor, xp: torch.Tensor,
                ids=None) -> Dict:
    """x, xp: activations (original / shifted).  With ``ids`` (the grouped
    drop-free layout) they are routed rows binned by expert into an
    (E, n, n) accumulator; without, an (E, n, n) accumulator takes
    (..., E, C, n) capacity buffers and an (n, n) one (..., tokens, n)
    activations flattened to token rows.  The triple is updated IN PLACE
    (the kernel adds into the accumulators) and the dict is returned."""
    acc = (covs["xx"], covs["xxp"], covs["xpxp"])
    if ids is not None:
        if covs["xx"].ndim != 3:
            raise ValueError("expert ids given for a dense (n, n) "
                             "accumulator")
        x = x.reshape(-1, x.shape[-1])
        xp = xp.reshape(-1, xp.shape[-1])
        ops.cov_accum_grouped(x, xp, ids, covs["xx"].shape[0], acc=acc)
        covs["count"] += x.shape[0]
    elif covs["xx"].ndim == 3:   # capacity banks: (E, C, n)
        x = x.reshape((-1,) + x.shape[-2:])
        xp = xp.reshape((-1,) + xp.shape[-2:])
        ops.cov_accum_banked(x, xp, acc=acc)
        covs["count"] += x.shape[-2]
    else:
        x = x.reshape(-1, x.shape[-1])
        xp = xp.reshape(-1, xp.shape[-1])
        ops.cov_accum(x, xp, acc=acc)
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
