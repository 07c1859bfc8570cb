"""Compression-ratio → truncation-rank math (App. B.3/B.4).

``rank_for_ratio`` and ``achieved_ratio`` copied verbatim from
``src/repro/core/ranks.py`` (pure Python), kept here so the port imports
nothing of the JAX package.

Standard storage: a rank-k factorization of an (m, n) weight stores
k(m+n) parameters, so ratio ρ = k(m+n)/(mn) and k = ρ·mn/(m+n).  The
valid range is k ≤ mn/(m+n) at ρ=1 — high-rank approximations are not
representable.

Dobi-SVD remapping: store the smaller factor plus the top min(m,n)
rows/cols of the larger factor at half precision; effective storage is
max(m,n)·k full-precision-equivalents, so ρ = k/min(m,n) and every
ρ ∈ [0,1] maps to k = ρ·min(m,n) — the full rank range.  (``AA-SVD^q``
rows in the paper's tables.)

Only the uniform-ratio math is ported; non-uniform allocation
(``allocate_by_loss``, ``rank_mode="adaptive"``) comes with the slice that
ports that mode.
"""

from __future__ import annotations

import math


def rank_for_ratio(m: int, n: int, ratio: float, *, remap: bool = False,
                   multiple: int = 8) -> int:
    """Truncation rank for a target compression ratio of an (m, n) weight.

    ``multiple``: round up to a lane-friendly multiple (TPU: last-dim tiles
    of 128 are ideal; 8 is the minimum sublane quantum) — never above the
    valid maximum.
    """
    if ratio >= 1.0:
        k_max = min(m, n) if remap else (m * n) // (m + n)
        return max(1, k_max)
    k = ratio * min(m, n) if remap else ratio * m * n / (m + n)
    k = max(1, int(math.floor(k)))
    if multiple > 1:
        k = min(-(-k // multiple) * multiple,
                min(m, n) if remap else max(1, (m * n) // (m + n)))
    return max(1, k)


def achieved_ratio(m: int, n: int, k: int, *, remap: bool = False) -> float:
    if remap:
        return k * max(m, n) / (m * n)
    return k * (m + n) / (m * n)
