"""Streaming calibration engine (App. B.1 at driver scale).

Counterpart of ``src/repro/core/streaming.py`` (``TapAccumulator`` :187,
``CalibrationEngine`` :207).  Per unit, every tap group's covariance triple
is accumulated from tapped block forwards on both streams:

- ``collect_fused`` — ONE tapped forward per microbatch per stream; every
  sown tap feeds its accumulator from the same pass, and the original-stream
  outputs come back as the refinement anchors.  Shifted taps of later groups
  see the unit pre-solve (the documented approximation).
- ``collect_group`` — replays both streams for one tap group, so its
  shifted taps see every group solved so far (sequential semantics).

The port collects in a Python loop over microbatches, the JAX package's
loop path (:328).  Its ``lax.scan`` sweep (:360) is a JAX dispatch device
and has no counterpart here; eager PyTorch already issues one forward per
microbatch.  ``stats["tapped_forwards"]`` counts the tapped block forwards
issued, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.core import calibration as C

Spec = Tuple[str, str, bool]
Groups = Sequence[Tuple[str, Sequence[Spec]]]


@dataclasses.dataclass
class TapAccumulator:
    """Streaming covariance state for one dense tap: (B, L, n) activations
    flatten to token rows; memory is 3·n² fp32 whatever the token count."""

    tap: str
    is_bank: bool
    covs: Dict

    def update(self, a_act: torch.Tensor, b_act: torch.Tensor) -> None:
        self.covs = C.update_covs(self.covs, a_act, b_act)


class CalibrationEngine:
    """Per-unit registry of tap accumulators + stream collection.

    ``fwd_taps(params, x, aux) -> (y, {tap: activation})`` is the unit's
    tapped apply fn; ``aux`` is the per-microbatch auxiliary input (None for
    decoder-only models).
    """

    def __init__(self, groups: Groups, shapes: Dict[str, torch.Size],
                 device="cpu"):
        self.groups = list(groups)
        self.device = device
        self._spec: Dict[str, Tuple[bool, int]] = {}
        for tap, group in self.groups:
            if group[0][2]:
                raise NotImplementedError(
                    "expert-bank taps are not ported to repro_torch yet "
                    "(comes with the MoE slice)")
            self._spec[tap] = (False, shapes[tap][-1])
        self.accumulators: Dict[str, TapAccumulator] = {}
        self._released: Set[str] = set()
        self.stats: Dict[str, int] = {"tapped_forwards": 0, "tap_updates": 0}

    @classmethod
    def for_unit(cls, groups: Groups, fwd_taps: Callable, params, x0,
                 aux0) -> "CalibrationEngine":
        """Size the registry from the taps of one forward on a single
        sequence of the first microbatch (the JAX package uses a shape-only
        evaluation; eager PyTorch has none, so one short forward stands in
        and is not counted)."""
        with torch.no_grad():
            _, store = fwd_taps(params, x0[:1],
                                None if aux0 is None else aux0[:1])
        shapes = {t: a.shape for t, a in store.items()}
        return cls(groups, shapes, device=x0.device)

    def _acc(self, tap: str) -> TapAccumulator:
        if tap in self._released:
            raise RuntimeError(f"tap {tap!r} already solved and released")
        acc = self.accumulators.get(tap)
        if acc is None:
            is_bank, n = self._spec[tap]
            acc = TapAccumulator(tap, is_bank,
                                 C.init_covs(n, device=self.device))
            self.accumulators[tap] = acc
        return acc

    # -- accumulation -------------------------------------------------------

    def consume(self, taps_orig: Dict[str, torch.Tensor],
                taps_shift: Dict[str, torch.Tensor], *,
                only: Optional[Set[str]] = None) -> None:
        """Route one microbatch of sown taps into the accumulators (``only``
        restricts the update to a subset of taps)."""
        for tap in self._spec:
            if only is not None and tap not in only:
                continue
            self._acc(tap).update(taps_orig[tap], taps_shift[tap])
            self.stats["tap_updates"] += 1

    def _tapped(self, fwd_taps, p, x, aux):
        self.stats["tapped_forwards"] += 1
        return fwd_taps(p, x, aux)  # (y, {tap: activation})

    def _collect(self, fwd_taps: Callable, orig_p, cur_p,
                 xs: Sequence, xps: Sequence,
                 aux_o: Optional[Sequence], aux_c: Optional[Sequence], *,
                 only: Optional[Set[str]] = None,
                 keep_orig_outputs: bool = False) -> Optional[List]:
        ys = [] if keep_orig_outputs else None
        with torch.no_grad():
            for i in range(len(xs)):
                y, taps_o = self._tapped(fwd_taps, orig_p, xs[i],
                                         None if aux_o is None else aux_o[i])
                _, taps_c = self._tapped(fwd_taps, cur_p, xps[i],
                                         None if aux_c is None else aux_c[i])
                if ys is not None:
                    ys.append(y)
                self.consume(taps_o, taps_c, only=only)
        return ys

    def collect_fused(self, fwd_taps: Callable, orig_p, cur_p,
                      xs: Sequence, xps: Sequence,
                      aux_o: Optional[Sequence],
                      aux_c: Optional[Sequence]) -> List:
        """Every sown tap feeds its accumulator from the same pass.  Returns
        the original-stream unit outputs (the refinement anchors)."""
        return self._collect(fwd_taps, orig_p, cur_p, xs, xps, aux_o, aux_c,
                             keep_orig_outputs=True)

    def collect_group(self, tap: str, fwd_taps: Callable, orig_p, cur_p,
                      xs: Sequence, xps: Sequence,
                      aux_o: Optional[Sequence],
                      aux_c: Optional[Sequence]) -> None:
        """Replay both streams for ONE tap group, so its shifted taps
        reflect every previously solved group (sequential semantics)."""
        self._collect(fwd_taps, orig_p, cur_p, xs, xps, aux_o, aux_c,
                      only={tap})

    # -- access -------------------------------------------------------------

    def covs_for(self, tap: str) -> Dict:
        return self._acc(tap).covs

    def drift(self, tap: str) -> float:
        return C.shift_drift(self._acc(tap).covs)

    def reset(self, tap: str) -> None:
        self.accumulators.pop(tap, None)

    def release(self, tap: str) -> None:
        """Drop a solved tap's 3·n² state; later access raises."""
        self.reset(tap)
        self._released.add(tap)
