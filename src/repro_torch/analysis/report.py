"""Findings and reports for the program auditor (twin of
``repro.analysis.report``).

Every check in :mod:`repro_torch.analysis` emits :class:`Finding`s into
a :class:`Report`; the CLI (``launch/analyze.py``) renders the report and
exits non-zero iff any finding is an error. Severities:

  * ``error`` — a contract is violated (a savings mismatch, an fp32
    contraction in a bf16 region, a host sync in a step, a launch out of
    bounds or over the shared-memory limit, a retrace budget blown).
  * ``warn``  — suspicious but not provably wrong (dead contraction
    FLOPs).
  * ``info``  — audit evidence (per-site counts, traffic totals) kept
    in the report so ``--json`` consumers get the numbers that backed
    the verdict.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

ERROR = "error"
WARN = "warn"
INFO = "info"

_LEVELS = (ERROR, WARN, INFO)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One check outcome at one site.

    ``check`` names the auditor pass (``savings``, ``dtype``,
    ``transfer``, ``dead``, ``retrace``, ``launch``); ``site`` the
    program point it applies to (a policy site path, kernel name, or
    step name); ``data`` carries the numbers behind the message.
    """

    check: str
    severity: str
    site: str
    message: str
    data: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        assert self.severity in _LEVELS, self.severity


@dataclasses.dataclass
class Report:
    """Accumulated findings for one audited program/config."""

    name: str
    findings: list[Finding] = dataclasses.field(default_factory=list)

    def add(self, check: str, severity: str, site: str, message: str,
            **data: Any) -> Finding:
        f = Finding(check, severity, site, message, data)
        self.findings.append(f)
        return f

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)

    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == WARN]

    @property
    def ok(self) -> bool:
        return not self.errors()

    def render(self, *, verbose: bool = False) -> str:
        """Human-readable table: one line per finding."""
        lines = [f"== {self.name} =="]
        shown = 0
        for f in self.findings:
            if f.severity == INFO and not verbose:
                continue
            shown += 1
            lines.append(f"  [{f.severity:5s}] {f.check:8s} {f.site}: {f.message}")
        lines.append(
            f"  {len(self.errors())} error(s), {len(self.warnings())} "
            f"warning(s), {len(self.findings) - shown} finding(s) hidden"
            if not verbose
            else f"  {len(self.errors())} error(s), "
            f"{len(self.warnings())} warning(s)"
        )
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "ok": self.ok,
                "findings": [dataclasses.asdict(f) for f in self.findings],
            },
            indent=2,
            default=str,
        )
