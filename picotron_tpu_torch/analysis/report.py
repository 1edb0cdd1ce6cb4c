"""Finding/Report types shared by every shardcheck analyzer (port of
picotron_tpu/analysis/report.py, unchanged but for the vocabulary of
locations).

One flat vocabulary for everything the static-analysis pass can say: a
`Finding` is a single checkable fact gone wrong (or worth surfacing), pinned
to a precise location — a parameter name, a recorded collective, or a
source `file:line` — so the user can act on it without re-deriving where
it came from. A `Report` is an ordered bag of findings plus free-form `info`
tables (collective counts, donation coverage) that render even when
everything is green.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITIES = (ERROR, WARNING, INFO)


@dataclass(frozen=True)
class Finding:
    check: str     # analyzer name: spec_lint | collectives | donation | ...
    severity: str  # error | warning | info
    path: str      # parameter name / op reference / file:line
    message: str   # what is wrong and what would fix it

    def __post_init__(self):
        if self.severity not in _SEVERITIES:
            raise ValueError(f"severity must be one of {_SEVERITIES}, "
                             f"got {self.severity!r}")

    def render(self) -> str:
        return f"[{self.severity:7s}] {self.check}: {self.path}: {self.message}"


@dataclass
class Report:
    """Findings from one analyzer (or, merged, from a whole shardcheck run)."""

    findings: list[Finding] = field(default_factory=list)
    # analyzer-specific summary tables keyed by analyzer name — e.g.
    # {"collectives": {"all_reduce": 3, ...}} — rendered under the findings
    info: dict[str, Any] = field(default_factory=dict)

    def add(self, check: str, severity: str, path: str, message: str) -> None:
        self.findings.append(Finding(check, severity, path, message))

    def extend(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        self.info.update(other.info)
        return self

    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    def ok(self) -> bool:
        return not self.errors()

    def render(self, *, verbose: bool = False) -> str:
        """Human-readable report: errors first, then warnings; info-level
        findings and the summary tables only under `verbose`."""
        order = {ERROR: 0, WARNING: 1, INFO: 2}
        lines = [f.render() for f in
                 sorted(self.findings, key=lambda f: order[f.severity])
                 if verbose or f.severity != INFO]
        if verbose:
            for name, table in self.info.items():
                lines.append(f"-- {name} --")
                if isinstance(table, dict):
                    lines.extend(f"  {k}: {v}" for k, v in table.items())
                else:
                    lines.append(f"  {table}")
        n_err, n_warn = len(self.errors()), len(self.warnings())
        lines.append(f"shardcheck: {n_err} error(s), {n_warn} warning(s)")
        return "\n".join(lines)

    def raise_if_errors(self) -> None:
        if not self.ok():
            raise ShardcheckError(self)


class ShardcheckError(RuntimeError):
    """Raised by fail-fast consumers (train.py preflight) — carries the full
    report so the error output IS the actionable diagnosis."""

    def __init__(self, report: Report):
        self.report = report
        super().__init__("shardcheck found errors:\n" + report.render())
