"""Finding records + the inline allowlist the checker recognizes.

Counterpart of ``src/repro/analysis/findings.py``, with the same marker
syntax and rules.  Every pass in ``repro_torch.analysis`` reports
violations as ``Finding``s.  A finding anchored to a source line can be
suppressed *in place* with an inline justification comment — the
allowlist is part of the code it excuses, reviewed in the same diff, and
a bare marker without a reason is itself a finding:

    x = float(loss)  # repro-check: allow[host-sync-loop] — parity path

The marker may sit on the offending line or on the line directly above it
(for statements too long to share a line with a justification).  Rule ids
match exactly; ``allow[*]`` suppresses every rule on that line (reserved
for generated code — prefer the precise id).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence

# marker anywhere in a comment: "repro-check: allow[rule-id] — reason".
# The separator accepts "-", "—", or ":"; the reason must be non-empty.
_ALLOW_RE = re.compile(
    r"#.*?repro-check:\s*allow\[([a-z0-9*][a-z0-9*-]*)\]\s*(?:[-—:]\s*(.*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation: rule id, location, and a human-readable message."""

    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Allowlist:
    """Per-file index of ``repro-check: allow[...]`` markers.

    ``allows(rule, line)`` honors a marker on the finding's line or the
    line directly above.  Markers with an empty justification do not
    suppress anything — they surface as ``allow-no-reason`` findings so an
    excuse can never be content-free.
    """

    def __init__(self, path: str, source: str):
        self.path = path
        self._marks: Dict[int, str] = {}
        self.malformed: List[Finding] = []
        for i, text in enumerate(source.splitlines(), start=1):
            m = _ALLOW_RE.search(text)
            if not m:
                continue
            rule, reason = m.group(1), (m.group(2) or "").strip()
            if not reason:
                self.malformed.append(Finding(
                    "allow-no-reason", path, i,
                    f"allow[{rule}] marker without a justification — "
                    "state why this site is exempt"))
                continue
            self._marks[i] = rule

    def allows(self, rule: str, line: int) -> bool:
        for ln in (line, line - 1):
            mark = self._marks.get(ln)
            if mark is not None and mark in (rule, "*"):
                return True
        return False


def apply_allowlist(findings: Sequence[Finding],
                    allow: Optional[Allowlist]) -> List[Finding]:
    """Drop findings the allowlist excuses; malformed markers join the
    output (an empty excuse is a violation, not a suppression)."""
    if allow is None:
        return list(findings)
    kept = [f for f in findings if not allow.allows(f.rule, f.line)]
    return kept + list(allow.malformed)
