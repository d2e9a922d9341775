"""Structured diagnostics for the port's static invariant-verification
layer (copy of ``repro/analysis/diagnostics.py``).

Every check in :mod:`repro_torch.analysis` reports through one shape: a
:class:`Diagnostic` with a stable error code (``CIM1xx``–``CIM4xx``, the
reference's catalogue in ``docs/analysis.md``), a severity, and a *location* —
either ``file:line`` for source-level findings or an object path
(``workload.nodes['s0b0_add'].inputs[1]``) for semantic findings over
live model-plane objects.

Source-level diagnostics honour inline suppressions::

    import torch  # ciminus: ignore[CIM101] -- capture shim, guarded by CI

The marker may sit on the flagged line or on the line directly above it,
and may list several codes (``ignore[CIM101,CIM402]``) or ``ignore[*]``
for a blanket waiver.  Suppressed diagnostics are counted, not shown
(``--format json`` still carries them with ``suppressed: true`` so CI
artifacts record every waiver).
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence

__all__ = ["Severity", "Diagnostic", "AnalysisError", "suppressed_codes",
           "apply_suppressions", "render_text", "render_json"]


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


# -- suppression -------------------------------------------------------------

_IGNORE_RE = re.compile(r"#\s*ciminus:\s*ignore\[([^\]]*)\]")


def suppressed_codes(source_line: str) -> Optional[List[str]]:
    """Codes waived by a ``# ciminus: ignore[...]`` marker (None = no
    marker; ``["*"]`` = blanket)."""
    m = _IGNORE_RE.search(source_line)
    if not m:
        return None
    return [c.strip() for c in m.group(1).split(",") if c.strip()]


def _line_suppresses(lines: Sequence[str], lineno: int, code: str) -> bool:
    if not (1 <= lineno <= len(lines)):
        return False
    codes = suppressed_codes(lines[lineno - 1])
    return codes is not None and ("*" in codes or code in codes)


def apply_suppressions(diags: List[Diagnostic],
                       sources: Dict[str, Sequence[str]]) -> List[Diagnostic]:
    """Mark file:line diagnostics whose line (or the line directly above)
    carries a matching ``ciminus: ignore`` marker.  Mutates and returns
    ``diags``; ``sources`` maps repo-relative path → source lines."""
    for d in diags:
        if d.file is None or d.line is None:
            continue
        lines = sources.get(d.file)
        if lines is None:
            continue
        if (_line_suppresses(lines, d.line, d.code)
                or _line_suppresses(lines, d.line - 1, d.code)):
            d.suppressed = True
    return diags


# -- rendering ---------------------------------------------------------------

def _sorted(diags: Sequence[Diagnostic]) -> List[Diagnostic]:
    return sorted(diags, key=lambda d: (Severity.rank(d.severity),
                                        d.code, d.location))


def render_text(diags: Sequence[Diagnostic], *, show_suppressed: bool = False
                ) -> str:
    shown = [d for d in diags if show_suppressed or not d.suppressed]
    n_sup = sum(1 for d in diags if d.suppressed)
    out = []
    for d in _sorted(shown):
        tag = " (suppressed)" if d.suppressed else ""
        out.append(f"{d.severity}[{d.code}]{tag} {d.location}: {d.message}")
        if d.hint:
            out.append(f"    hint: {d.hint}")
    errors = sum(1 for d in shown if not d.suppressed
                 and d.severity == Severity.ERROR)
    warns = sum(1 for d in shown if not d.suppressed
                and d.severity == Severity.WARNING)
    out.append(f"{errors} error(s), {warns} warning(s), "
               f"{n_sup} suppressed")
    return "\n".join(out)


def render_json(diags: Sequence[Diagnostic], *,
                passes: Sequence[str] = ()) -> str:
    active = [d for d in diags if not d.suppressed]
    payload = {
        "passes": list(passes),
        "counts": {
            "error": sum(1 for d in active
                         if d.severity == Severity.ERROR),
            "warning": sum(1 for d in active
                           if d.severity == Severity.WARNING),
            "note": sum(1 for d in active if d.severity == Severity.NOTE),
            "suppressed": sum(1 for d in diags if d.suppressed),
        },
        "ok": not any(d.severity == Severity.ERROR for d in active),
        "diagnostics": [d.as_dict() for d in _sorted(diags)],
    }
    return json.dumps(payload, indent=2)
