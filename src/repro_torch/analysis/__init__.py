"""repro-check for the port: the static dispatch-hygiene pass.

Counterpart of ``src/repro/analysis/__init__.py``.  One pass so far,
``analysis.dispatch`` (host syncs in loops, prints in library code,
blanket excepts, allow markers without a reason; ``analysis.findings``
holds the inline allowlist).  The JAX package's kernel-contract, shard-spec
and retrace passes wait for the port's autotuner, its sharding and a jit
to count.

CLI: ``python -m repro_torch.analysis [paths...]`` (default: the
``repro_torch`` package source) — exit 0 iff the checked files are clean.

This package stays import-light: it imports the standard library alone,
never ``torch`` (the ``repro_torch`` root imports none either), so a
pre-commit hook or an editor can run it without the numerical stack.
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


def run(paths: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run every static pass; returns all findings (empty = clean).
    ``paths``: files/dirs to check (default: the repro_torch source)."""
    from repro_torch.analysis import dispatch

    findings: List[Finding] = []
    for f in iter_py_files(list(paths) if paths else [default_root()]):
        findings.extend(dispatch.check_file(f))
    return findings
