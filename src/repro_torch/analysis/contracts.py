"""Kernel-contract pass: check every autotune candidate on the host.

Counterpart of ``src/repro/analysis/contracts.py``.  Drives
``kernels.contracts.CONTRACTS`` on the CPU — no card, no compiler:

* ``contract-registry``  — ``ops.REGISTERED_KERNELS``, ``CONTRACTS``,
  ``autotune._LATTICES`` and ``autotune._ANCHORS`` agree: every registered
  wrapper exists and resolves to a contract, every contract has a lattice
  and an anchor, nothing is orphaned, no probe's lattice is empty.
* ``contract-alignment`` — every candidate's widths, slices and spans are
  multiples of what its body loads (the contract's ``align``), and its
  tiles, slices and spans the values its body is compiled for (``exact``).
* ``contract-smem``      — the counterpart of ``contract-vmem``: every
  candidate's modeled shared bytes fit the tuner's budget, and its grid
  fits 2³¹−1 × 65535 × 65535 (a launch's resources).
* ``contract-waste``     — no candidate's modeled split partials exceed
  max(``MAX_WASTE``, the anchor's), unless it is the sole candidate.
* ``contract-eval``      — the counterpart of ``contract-abstract-eval``:
  each candidate's emulation runs, agrees with ``kernels.ref`` within the
  contract's tolerance, and gives the output shapes the wrapper slices;
  each of ``refused`` is refused (``ValueError``) — reported as refused,
  not as a finding.

Findings anchor to ``kernels/contracts.py``.  This module imports torch
only inside its functions, so ``repro_torch.analysis`` stays torch-free
until the pass runs.
"""

from __future__ import annotations

import traceback
from typing import Dict, List, Optional

from repro_torch.analysis.findings import Finding

_PATH = "src/repro_torch/kernels/contracts.py"


def _fmt_probe(probe: Dict) -> str:
    return "(" + ", ".join(f"{k}={v}" for k, v in sorted(probe.items())) \
        + ")"


def _fmt_plan(plan) -> str:
    import dataclasses
    keep = ("body", "splits", "rows_per_split", "splits_xv", "depth_xv",
            "splits_tu", "depth_tu", "span", "spans", "ctas")
    fields = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
              if f.name in keep}
    return "{" + ", ".join(f"{k}:{v}" for k, v in fields.items()) + "}"


def _check_registry(out: List[Finding]) -> None:
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels.contracts import CONTRACTS
    lattices, anchors = set(autotune._LATTICES), set(autotune._ANCHORS)
    contracts = set(CONTRACTS)
    for name in sorted(lattices - contracts):
        out.append(Finding(
            "contract-registry", _PATH, 0,
            f"autotune lattice {name!r} has no KernelContract — declare "
            "one in kernels/contracts.py"))
    for name in sorted(contracts - lattices):
        out.append(Finding(
            "contract-registry", _PATH, 0,
            f"contract {name!r} has no autotune lattice"))
    for name in sorted(lattices ^ anchors):
        out.append(Finding(
            "contract-registry", _PATH, 0,
            f"kernel {name!r} present in only one of _LATTICES/_ANCHORS"))
    for wrapper, cname in sorted(ops.REGISTERED_KERNELS.items()):
        if not callable(getattr(ops, wrapper, None)):
            out.append(Finding(
                "contract-registry", _PATH, 0,
                f"REGISTERED_KERNELS names missing ops wrapper "
                f"{wrapper!r}"))
        if cname not in contracts:
            out.append(Finding(
                "contract-registry", _PATH, 0,
                f"wrapper {wrapper!r} registered against unknown "
                f"contract {cname!r}"))
    covered = set(ops.REGISTERED_KERNELS.values())
    for name in sorted(contracts - covered):
        out.append(Finding(
            "contract-registry", _PATH, 0,
            f"contract {name!r} reached by no registered wrapper"))


def check_contract(contract, *, budget: Optional[int] = None,
                   refused: Optional[List[str]] = None) -> List[Finding]:
    """All findings for one KernelContract across its probes and
    candidates; the probes refused as the contract says are appended to
    ``refused`` (when given) as messages, not findings."""
    from repro_torch.kernels import autotune
    budget = autotune._smem_budget() if budget is None else budget
    out: List[Finding] = []
    for probe in contract.refused:
        tag = f"{contract.name}{_fmt_probe(probe)}"
        try:
            contract.candidates(probe)
        except ValueError as exc:
            if refused is not None:
                refused.append(f"{tag}: refused ({exc})")
            continue
        out.append(Finding(
            "contract-eval", _PATH, 0,
            f"{tag}: listed as refused, but a plan was made"))
    for probe in contract.probes:
        try:
            cands = contract.candidates(probe)
        # repro-check: allow[bare-except] — a probe whose plan raises is the finding itself
        except Exception:
            err = traceback.format_exc().strip().splitlines()[-1]
            out.append(Finding(
                "contract-eval", _PATH, 0,
                f"{contract.name}{_fmt_probe(probe)}: no plan: {err}"))
            continue
        if not cands:
            out.append(Finding(
                "contract-registry", _PATH, 0,
                f"{contract.name}{_fmt_probe(probe)}: empty candidate "
                "lattice"))
            continue
        sole = len(cands) == 1
        allowed = max(autotune.MAX_WASTE, cands[0].waste)
        for cand in cands:
            plan = cand.plan
            tag = (f"{contract.name}{_fmt_probe(probe)} candidate "
                   f"{_fmt_plan(plan)}")
            for field, mult in sorted(contract.align(plan).items()):
                value = getattr(plan, field, None)
                if value is None:
                    out.append(Finding(
                        "contract-alignment", _PATH, 0,
                        f"{tag}: missing field {field!r}"))
                elif mult <= 0 or value % mult != 0:
                    out.append(Finding(
                        "contract-alignment", _PATH, 0,
                        f"{tag}: {field}={value} is not a multiple of "
                        f"{mult} — its body would refuse or misread it"))
            for field, value in sorted(contract.exact(plan).items()):
                if getattr(plan, field, None) != value:
                    out.append(Finding(
                        "contract-alignment", _PATH, 0,
                        f"{tag}: {field}={getattr(plan, field, None)} is "
                        f"not the {value} its body is compiled for"))
            if cand.smem_bytes > budget:
                out.append(Finding(
                    "contract-smem", _PATH, 0,
                    f"{tag}: modeled shared memory {cand.smem_bytes} B "
                    f"exceeds the {budget} B budget"))
            grid = autotune.grid(contract.name, plan)
            if any(g < 1 or g > lim for g, lim in zip(grid, autotune.GRID)):
                out.append(Finding(
                    "contract-smem", _PATH, 0,
                    f"{tag}: grid {grid} outside {autotune.GRID}"))
            if cand.waste > allowed + 1e-9 and not sole:
                out.append(Finding(
                    "contract-waste", _PATH, 0,
                    f"{tag}: split partials waste {cand.waste:.2f} of the "
                    f"bytes moved, over {allowed:.2f}, with other "
                    "candidates available"))
            try:
                outs, ratio = contract.evaluate(probe, plan)
                got = tuple(tuple(o.shape) for o in outs)
                want = tuple(contract.expected(probe, plan))
            # repro-check: allow[bare-except] — any rejection of the candidate by its emulation is the finding itself
            except Exception:
                err = traceback.format_exc().strip().splitlines()[-1]
                out.append(Finding(
                    "contract-eval", _PATH, 0,
                    f"{tag}: emulation failed: {err}"))
                continue
            if got != want:
                out.append(Finding(
                    "contract-eval", _PATH, 0,
                    f"{tag}: emulated outputs {got} != contract "
                    f"expectation {want}"))
            if not ratio <= 1.0:
                out.append(Finding(
                    "contract-eval", _PATH, 0,
                    f"{tag}: emulation off the plain version by "
                    f"{ratio:.2f}x its tolerance"))
    return out


def check_kernel_contracts(refused: Optional[List[str]] = None
                           ) -> List[Finding]:
    """The full pass: registry coherence + every contract.  It runs on one
    thread: the emulations are many small elementwise ops, which threads
    only slow, most of all on a loaded machine."""
    import repro_torch._fp32  # noqa: F401  (TF32 off before any torch work)
    import torch
    out: List[Finding] = []
    _check_registry(out)
    from repro_torch.kernels.contracts import CONTRACTS
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in sorted(CONTRACTS):
            out.extend(check_contract(CONTRACTS[name], refused=refused))
    finally:
        torch.set_num_threads(threads)
    return out
