"""Finding/severity vocabulary shared by both static-audit passes: the
counterpart of `repro.analysis.findings`, a copy (it imports no JAX).

A finding is one rule firing at one location. ERROR findings are the CI
contract: `python -m repro_torch.launch.audit` exits non-zero iff any
config in the matrix produces one. WARNING marks structure the auditor
could not prove either way (it should be investigated, not gate CI); INFO
records positive evidence (e.g. the measured backward-pass count) so
AUDIT.json documents what WAS verified, not just what failed.
"""
from __future__ import annotations

import dataclasses

ERROR = "ERROR"
WARNING = "WARNING"
INFO = "INFO"
SEVERITIES = (ERROR, WARNING, INFO)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule firing: (rule id, severity, message, location)."""

    rule: str       # e.g. "JAXPR-CLIP-PATH", "HLO-DONATION"
    severity: str   # ERROR | WARNING | INFO
    message: str
    location: str = ""  # param leaf path / collective site / op name

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "message": self.message, "location": self.location}

    def __str__(self) -> str:
        loc = f" @ {self.location}" if self.location else ""
        return f"[{self.severity}] {self.rule}{loc}: {self.message}"


def errors(findings: list[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == ERROR]


def worst_severity(findings: list[Finding]) -> str | None:
    for sev in SEVERITIES:  # ordered worst-first
        if any(f.severity == sev for f in findings):
            return sev
    return None
