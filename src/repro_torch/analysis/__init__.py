"""repro-check for the port: dispatch hygiene and kernel contracts.

Counterpart of ``src/repro/analysis/__init__.py``.  Two passes:

1. **dispatch** (``analysis.dispatch``) — host syncs in loops, prints in
   library code, blanket excepts, allow markers without a reason
   (``analysis.findings`` holds the inline allowlist).
2. **kernel contracts** (``analysis.contracts`` driving
   ``kernels.contracts``) — every autotune candidate of every registered
   kernel checked on the host: alignment, shared memory and grid, waste,
   and its emulation against the plain version.

The JAX package's shard-spec and retrace passes wait for the port's
sharding and a jit to count.

CLI: ``python -m repro_torch.analysis [paths...]`` (default: the
``repro_torch`` package source) — exit 0 iff the checked files and the
contracts are clean; ``--no-contracts`` skips the contract pass.

This package stays import-light: it imports the standard library alone,
never ``torch`` (the ``repro_torch`` root imports none either), so a
pre-commit hook or an editor can run the dispatch pass without the
numerical stack; the contract pass imports torch inside its own function.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from repro_torch.analysis.findings import Finding

__all__ = ["Finding", "run", "iter_py_files", "default_root"]


def default_root() -> str:
    """The ``repro_torch`` package source tree (what the CLI checks)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__",)]
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(filenames)
                           if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return sorted(set(out))


def run(paths: Optional[Sequence[str]] = None, *,
        kernel_contracts: bool = True) -> List[Finding]:
    """Run every static pass; returns all findings (empty = clean).

    ``paths``: files/dirs for the dispatch pass (default: the repro_torch
    source).  ``kernel_contracts=False`` skips the contract pass (the one
    that imports torch), so the dispatch pass runs on the standard library
    alone."""
    from repro_torch.analysis import dispatch

    findings: List[Finding] = []
    for f in iter_py_files(list(paths) if paths else [default_root()]):
        findings.extend(dispatch.check_file(f))
    if kernel_contracts:
        from repro_torch.analysis.contracts import check_kernel_contracts
        findings.extend(check_kernel_contracts())
    return findings
