"""What the kernel-contract audit shares with ``holo_tpu``'s lint core
(``holo_tpu/analysis/core.py``): the :class:`Finding` row and its rendering,
the ``# holo-lint: disable=<id>`` suppression comments
(:func:`parse_suppressions`) and the severity gate (:func:`gate_findings`).

Standard library only: the cached replay of the audit
(:mod:`holo_tpu_torch.analysis.cache`) runs on these without importing
torch.  The AST lint and its cache arm, which the rest of ``holo_tpu``'s
core serves, are not ported (ROADMAP A13d).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = ["Finding", "gate_findings", "parse_suppressions"]

# `# holo-lint: disable=<id>` (same line or the line above the finding).
# Multiple ids comma-separated; `disable=all` silences every rule.
_SUPPRESS_RE = re.compile(r"#\s*holo-lint:\s*disable=([A-Za-z0-9_,\s-]+)")


def parse_suppressions(source: str) -> dict[int, set[str]]:
    """1-based line -> set of suppressed rule ids (or {'all'})."""
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
            out[i] = ids
    return out


@dataclass(frozen=True)
class Finding:
    rule: str  # "HL301"
    path: str  # repo-relative posix path
    line: int  # 1-based
    context: str  # "kernel:<name>"
    message: str
    # "error" findings gate (exit 1); "warn" findings are reported only.
    severity: str = "error"

    def render(self) -> str:
        tag = "" if self.severity == "error" else f" ({self.severity})"
        return (
            f"{self.path}:{self.line}: {self.rule}{tag} "
            f"[{self.context}] {self.message}"
        )


def gate_findings(findings: list[Finding]) -> list[Finding]:
    """The subset that gates: error-tier findings.  Warn-tier findings
    render and land in the JSON report, but never exit 1."""
    return [f for f in findings if f.severity == "error"]
