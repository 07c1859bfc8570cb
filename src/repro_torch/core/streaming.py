"""Streaming calibration engine (App. B.1 at driver scale).

Counterpart of ``src/repro/core/streaming.py`` (``TapAccumulator`` :187,
``CalibrationEngine`` :207).  Per unit, every tap group's covariance triple
is accumulated from tapped block forwards on both streams (per expert for
the MoE's bank taps: the capacity dispatch's (E, C, n) buffers, or the
drop-free dispatch's grouped rows binned by the original stream's expert
ids):

- ``collect_fused`` — ONE tapped forward per microbatch per stream; every
  sown tap feeds its accumulator from the same pass, and the original-stream
  outputs come back as the refinement anchors.  Shifted taps of later groups
  see the unit pre-solve (the documented approximation).
  ``skip`` leaves hybrid mode's replay taps out of that pass.
- ``collect_group`` — replays both streams for one tap group, so its
  shifted taps see every group solved so far (sequential semantics, and
  hybrid mode's replays).

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
    """Streaming covariance state for one tap.  Dense taps: (B, L, n)
    activations flatten to token rows, 3·n² fp32 whatever the token count.
    Bank taps fill an (E, n, n) triple from (E, C, n) routed capacity
    buffers (zero-padded slots add nothing) or, under the drop-free
    dispatch, from (T·k, n) choice-major routed rows plus the original
    stream's (T·k,) expert ids."""

    tap: str
    is_bank: bool
    covs: Dict

    def update(self, a_act: torch.Tensor, b_act: torch.Tensor,
               ids: Optional[torch.Tensor] = None) -> None:
        self.covs = C.update_covs(self.covs, a_act, b_act, ids=ids)


class CalibrationEngine:
    """Per-unit registry of tap accumulators + stream collection.

    ``fwd_taps(params, x, aux) -> (y, {tap: activation})`` is the unit's
    tapped apply fn; ``aux`` is the per-microbatch auxiliary input (None for
    decoder-only models).
    """

    def __init__(self, groups: Groups, shapes: Dict[str, torch.Size],
                 device="cpu", num_experts: int = 0):
        self.groups = list(groups)
        self.device = device
        # tap -> (is_bank, n, experts).  A bank tap sown as 2-D rows is the
        # grouped (drop-free) layout: it carries no expert axis, so E comes
        # from ``num_experts``; a 3-D bank tap is an (E, C, n) capacity
        # buffer, E its first axis (C depends on the token count, so only E
        # and n are read from the sizing forward).  Without a mesh there is
        # no microbatch folding to turn off for capacity banks.
        self._spec: Dict[str, Tuple[bool, int, int]] = {}
        for tap, group in self.groups:
            is_bank = group[0][2]
            shape = shapes[tap]
            grouped = is_bank and len(shape) == 2
            if grouped and num_experts <= 0:
                raise ValueError(
                    f"grouped bank tap {tap!r} needs num_experts > 0")
            experts = (num_experts if grouped
                       else shape[0] if is_bank else 0)
            self._spec[tap] = (is_bank, shape[-1], experts)
        self.accumulators: Dict[str, TapAccumulator] = {}
        self._released: Set[str] = set()
        self.stats: Dict[str, int] = {"tapped_forwards": 0, "tap_updates": 0}

    @classmethod
    def for_unit(cls, groups: Groups, fwd_taps: Callable, params, x0,
                 aux0, num_experts: int = 0) -> "CalibrationEngine":
        """Size the registry from the taps of one forward on a single
        sequence of the first microbatch (the JAX package uses a shape-only
        evaluation; eager PyTorch has none, so one short forward stands in
        and is not counted).  ``num_experts`` sizes grouped bank taps; a
        capacity bank tap takes E and n from this forward, never C."""
        with torch.no_grad():
            _, store = fwd_taps(params, x0[:1],
                                None if aux0 is None else aux0[:1])
        shapes = {t: a.shape for t, a in store.items()}
        return cls(groups, shapes, device=x0.device, num_experts=num_experts)

    def _acc(self, tap: str) -> TapAccumulator:
        if tap in self._released:
            raise RuntimeError(f"tap {tap!r} already solved and released")
        acc = self.accumulators.get(tap)
        if acc is None:
            is_bank, n, experts = self._spec[tap]
            acc = TapAccumulator(tap, is_bank,
                                 C.init_covs(n, experts, device=self.device))
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
            # grouped bank taps carry the ORIGINAL stream's expert ids
            self._acc(tap).update(taps_orig[tap], taps_shift[tap],
                                  ids=taps_orig.get(C.ids_tap_name(tap)))
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
                      aux_c: Optional[Sequence], *,
                      skip: Optional[Set[str]] = None) -> List:
        """Every sown tap feeds its accumulator from the same pass.  Returns
        the original-stream unit outputs (the refinement anchors).

        ``skip`` excludes taps from the joint collection (hybrid mode:
        replay groups must not mix pre-solve statistics into the
        accumulators they later fill sequentially)."""
        only = None
        if skip:
            only = {t for t in self._spec if t not in skip}
        return self._collect(fwd_taps, orig_p, cur_p, xs, xps, aux_o, aux_c,
                             only=only, keep_orig_outputs=True)

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
