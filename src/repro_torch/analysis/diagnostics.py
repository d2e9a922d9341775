"""Structured diagnostics of the model-plane pre-flight (copy of
``repro/analysis/diagnostics.py``, without the source-level suppression
markers and the CLI's text/JSON rendering: the port runs no pass over
source files and has no analysis CLI).

Every check reports through one shape: a :class:`Diagnostic` with a
stable error code (``CIM3xx`` for the model plane), a severity, and a
location, here an object path over live model-plane objects
(``workload.nodes['s0b0_add'].inputs[1]``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

__all__ = ["Severity", "Diagnostic", "AnalysisError"]


class Severity:
    """Diagnostic severities, most severe first."""

    ERROR = "error"      # CI-blocking: the invariant is violated
    WARNING = "warning"  # suspicious but not contract-breaking
    NOTE = "note"        # informational (fix-it context, statistics)

    ORDER = (ERROR, WARNING, NOTE)

    @staticmethod
    def rank(sev: str) -> int:
        return Severity.ORDER.index(sev) if sev in Severity.ORDER else 99


@dataclasses.dataclass
class Diagnostic:
    """One finding: stable code, severity, location, message, fix-it hint."""

    code: str                       # e.g. "CIM101"
    severity: str                   # Severity.*
    message: str
    pass_name: str = ""
    file: Optional[str] = None      # repo-relative path for source findings
    line: Optional[int] = None      # 1-based
    obj: Optional[str] = None       # object path for semantic findings
    hint: Optional[str] = None      # how to fix (or how to suppress)
    suppressed: bool = False

    @property
    def location(self) -> str:
        if self.file is not None:
            return f"{self.file}:{self.line}" if self.line else self.file
        return self.obj or "<global>"

    def as_dict(self) -> Dict[str, object]:
        d = {"code": self.code, "severity": self.severity,
             "message": self.message, "pass": self.pass_name,
             "location": self.location, "suppressed": self.suppressed}
        for k in ("file", "line", "obj", "hint"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d


class AnalysisError(RuntimeError):
    """Raised by strict pre-flights when error-severity diagnostics exist."""

    def __init__(self, diags: Sequence[Diagnostic], where: str = "pre-flight"):
        self.diagnostics = list(diags)
        lines = [f"{where}: {len(self.diagnostics)} blocking diagnostic(s)"]
        lines += [f"  {d.code} [{d.location}] {d.message}"
                  for d in self.diagnostics]
        super().__init__("\n".join(lines))
