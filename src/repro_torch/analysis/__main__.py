"""CLI: ``python -m repro_torch.analysis [paths...]``.

Runs every static pass over the given files/directories (default: the
``repro_torch`` package source) and prints one line per finding::

    src/repro_torch/core/pipeline.py:669: [host-sync-loop] .item() on a ...

Exit status: 0 clean, 1 findings, 2 usage error.  ``--no-contracts``
skips the kernel-contract pass (the only one that imports torch) for fast
editor / pre-commit loops on the dispatch rules alone.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-check for the port: dispatch hygiene (host "
                    "syncs in loops, prints in library code, blanket "
                    "excepts, allow markers without a reason) and kernel "
                    "contracts (every autotune candidate checked on the "
                    "host)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs for the dispatch pass (default: the "
                         "repro_torch package source)")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip the kernel-contract pass")
    args = ap.parse_args(argv)

    findings = run(args.paths or None,
                   kernel_contracts=not args.no_contracts)
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        print(f.format())
    if findings:
        print(f"repro-check: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print("repro-check: clean", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
