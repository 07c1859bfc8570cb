"""Compression-ratio → truncation-rank math (App. B.3/B.4).

Copied verbatim from ``src/repro/core/ranks.py`` (pure Python), kept here
so the port imports nothing of the JAX package: the integer accounting,
the heap order and the tie-breaks of ``allocate_by_loss`` are the
reference's own, so both packages allocate the same ranks from the same
losses.

Standard storage: a rank-k factorization of an (m, n) weight stores
k(m+n) parameters, so ratio ρ = k(m+n)/(mn) and k = ρ·mn/(m+n).  The
valid range is k ≤ mn/(m+n) at ρ=1 — high-rank approximations are not
representable.

Dobi-SVD remapping: store the smaller factor plus the top min(m,n)
rows/cols of the larger factor at half precision; effective storage is
max(m,n)·k full-precision-equivalents, so ρ = k/min(m,n) and every
ρ ∈ [0,1] maps to k = ρ·min(m,n) — the full rank range.  (``AA-SVD^q``
rows in the paper's tables.)

Also: non-uniform allocation (``allocate_by_loss``, the engine behind
``CompressConfig.rank_mode="adaptive"``) — beyond-paper; §Limitations notes
uniform ratio as the paper's choice, AdaSVD / SVD-LLM-V2 motivate the
error-driven reallocation.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple


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


def params_saved(m: int, n: int, k: int, *, remap: bool = False) -> int:
    stored = k * max(m, n) if remap else k * (m + n)
    return m * n - stored


def rank_cap(m: int, n: int, *, remap: bool = False) -> int:
    """Largest representable rank for an (m, n) weight (ρ = 1)."""
    return min(m, n) if remap else max(1, (m * n) // (m + n))


def rank_cost(m: int, n: int, *, remap: bool = False) -> int:
    """Stored parameters per unit of rank (per bank copy)."""
    return max(m, n) if remap else (m + n)


def bank_padded_cost(m: int, n: int, ranks: Sequence[int], *,
                     remap: bool = False) -> Tuple[int, int]:
    """(logical, padded) stored parameter counts of an expert bank with
    per-expert ranks (drop-free adaptive allocation).

    Logical = Σ_e cost·k_e — the budget the water-filler met, counting
    each expert at its own rank.  Padded = E·cost·max(k_e) — the stacked
    (E, n, kmax) / (E, kmax, m) factor buffers actually materialized: the
    bank solves once (vmapped) at the max allocated rank and each expert's
    factor tail is zero-masked in place, trading the logical/padded gap
    for static shapes, one solve, and one grouped GEMM per bank.  The gap
    is recoverable by per-expert re-slicing at export time; both counts
    appear in the adaptive allocation report so the trade stays visible.
    """
    cost = rank_cost(m, n, remap=remap)
    ranks = list(ranks)
    return cost * sum(ranks), cost * len(ranks) * max(ranks)


def _lattice_bottom(kmax: int, multiple: int) -> int:
    """Smallest allocatable rank.  Rank 1 stays on the lattice so a tight
    budget can always be respected; everything above the bottom is a lane
    multiple (or the cap)."""
    del kmax, multiple
    return 1


def _lattice_floor(k: float, kmax: int, multiple: int) -> int:
    """Largest lattice point ≤ k.  The lattice is the multiples of
    ``multiple`` in [bottom, kmax] plus ``kmax`` itself (the cap is a valid
    rank even when it is not lane-aligned — there is nothing above it)."""
    bottom = _lattice_bottom(kmax, multiple)
    k = min(int(k), kmax)
    if k <= bottom:
        return bottom
    if k == kmax:
        return kmax
    if multiple > 1:
        k = (k // multiple) * multiple
    return max(k, bottom)


def _lattice_next(k: int, kmax: int, multiple: int) -> Optional[int]:
    """Smallest lattice point > k, or None at the cap."""
    if k >= kmax:
        return None
    if multiple <= 1:
        return k + 1
    return min((k // multiple + 1) * multiple, kmax)


def _real_rank(m: int, n: int, ratio: float, *, remap: bool) -> float:
    return ratio * min(m, n) if remap else ratio * m * n / (m + n)


def allocate_by_loss(shapes: Sequence[Tuple[int, int]],
                     losses: Sequence[float], budget_ratio: float,
                     *, remap: bool = False, floor_ratio: float = 0.25,
                     ceil_ratio: float = 0.0, multiple: int = 8,
                     copies: Optional[Sequence[int]] = None) -> List[int]:
    """Beyond-paper: AdaSVD / SVD-LLM-V2-style reallocation.  Given per-layer
    truncation losses (e.g. whitened-spectrum tail energies from a uniform
    first pass), shift rank from low-loss to high-loss layers under one
    global parameter budget.

    Water-filling on the per-item compression ratio r_i ∝ loss_i^{1/2},
    realized as an exact greedy fill over the quantized rank lattice:
    starting from the floors, the item whose next lattice point is reached
    at the lowest water level λ (λ = ratio-at-next-rank / weight) is bumped
    first, and an item whose next step no longer fits the remaining budget
    is frozen.  All accounting is integer, so the invariants hold exactly:

    * the summed allocation NEVER exceeds the budget (floors included —
      they are re-normalized against the budget, down to one lane quantum
      per item, fixing the old over-budget floor behaviour), except in the
      degenerate case where even one lane quantum per item does not fit;
    * the budget is met to within one lane-multiple step
      (``max_i copies_i·rank_cost_i·multiple``) unless every item is at its
      representable cap;
    * every rank is a lattice point: a multiple of ``multiple`` (or the
      cap) inside [1, rank_cap];
    * the allocation is a function of the item *contents* plus the global
      budget, so it is permutation-equivariant in the item order (ties
      between items identical in shape, copies AND loss fall back to input
      order), and monotone: among equal-shape items, higher loss never
      gets a lower rank.

    ``floor_ratio`` / ``ceil_ratio`` bound each item's ratio relative to
    the budget — a trust region around the uniform allocation.  The floor
    (``floor_ratio·budget_ratio``) protects low-loss items from being
    starved; the ceiling (``ceil_ratio·budget_ratio``, 0 = uncapped) stops
    a few high-loss items from draining the pool, which bounds the
    worst-case damage of a mis-calibrated loss signal.  ``copies``
    multiplies an item's dense size and per-rank storage (expert banks:
    E experts share one rank, E× the parameters).
    """
    n_items = len(shapes)
    if n_items == 0:
        return []
    if copies is None:
        copies = [1] * n_items
    weights = [max(float(l), 1e-12) ** 0.5 for l in losses]
    kmaxs = [rank_cap(m, n, remap=remap) for m, n in shapes]
    costs = [c * rank_cost(m, n, remap=remap)
             for c, (m, n) in zip(copies, shapes)]
    bottoms = [_lattice_bottom(km, multiple) for km in kmaxs]
    total = sum(c * m * n for c, (m, n) in zip(copies, shapes))
    budget = int(budget_ratio * total)

    def spent(ks: Sequence[int]) -> int:
        return sum(c * k for c, k in zip(costs, ks))

    # floors at floor_ratio·budget_ratio, re-normalized against the budget:
    # when the quantized floors overflow (near-uniform losses, aggressive
    # rounding, tiny shapes), bisect a scale γ ∈ [0, 1] on the floor target
    # until they fit — never below one lane quantum per item
    def floors_for(gamma: float) -> List[int]:
        rf = gamma * floor_ratio * budget_ratio
        return [max(b, _lattice_floor(_real_rank(m, n, rf, remap=remap),
                                      km, multiple))
                for (m, n), km, b in zip(shapes, kmaxs, bottoms)]

    floors = floors_for(1.0)
    if spent(floors) > budget:
        if spent(bottoms) > budget:
            # even one lane quantum per item overflows: the minimal valid
            # allocation is the only answer (documented overshoot)
            return bottoms
        lo, hi = 0.0, 1.0
        for _ in range(50):
            mid = 0.5 * (lo + hi)
            if spent(floors_for(mid)) > budget:
                hi = mid
            else:
                lo = mid
        floors = floors_for(lo)
        if spent(floors) > budget:  # guard the bisection edge
            floors = bottoms

    # ceilings: the largest lattice point inside ceil_ratio·budget_ratio
    # (never below the floor — the floor wins a conflict)
    kcaps = list(kmaxs)
    if ceil_ratio > 0:
        rc = ceil_ratio * budget_ratio
        kcaps = [max(f, _lattice_floor(_real_rank(m, n, rc, remap=remap),
                                       km, multiple))
                 for (m, n), km, f in zip(shapes, kmaxs, floors)]

    ks = list(floors)
    remaining = budget - spent(ks)

    def entry(i: int, next_k: int):
        # water level at which item i's continuous ratio target reaches
        # next_k; ties broken on content (heavier loss first, then shape)
        # before input order, so the fill is permutation-equivariant for
        # content-distinct items
        lam = achieved_ratio(*shapes[i], next_k, remap=remap) / weights[i]
        return (lam, -weights[i], shapes[i], copies[i], i, next_k)

    heap = []
    for i in range(n_items):
        nk = _lattice_next(ks[i], kcaps[i], multiple)
        if nk is not None:
            heapq.heappush(heap, entry(i, nk))
    while heap:
        _, _, _, _, i, nk = heapq.heappop(heap)
        step_cost = costs[i] * (nk - ks[i])
        if step_cost > remaining:
            continue  # frozen: lattice steps are sequential
        ks[i] = nk
        remaining -= step_cost
        nk2 = _lattice_next(nk, kcaps[i], multiple)
        if nk2 is not None:
            heapq.heappush(heap, entry(i, nk2))
    return ks
