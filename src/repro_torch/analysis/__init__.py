"""Model-plane pre-flight of the port (copy of ``repro.analysis``'s
``validate`` / ``preflight``; the source-level passes and their CLI
check the repository, not a serving run, and are not copied).

``ServeEngine`` calls :func:`preflight` on its ``lm_workload`` when it is
built, so a structurally broken config surfaces there rather than as a
shape error mid-request.  Set ``REPRO_ANALYSIS_PREFLIGHT=0`` to turn the
pre-flights off.
"""
from __future__ import annotations

import os
import warnings
from typing import List

from .diagnostics import AnalysisError, Diagnostic, Severity
from .modelplane_pass import validate

__all__ = ["AnalysisError", "Diagnostic", "Severity", "preflight", "validate"]

# set REPRO_ANALYSIS_PREFLIGHT=0 to disable library pre-flights (e.g.
# when intentionally simulating ill-formed inputs in experiments)
_PREFLIGHT_ENV = "REPRO_ANALYSIS_PREFLIGHT"

_warned: set = set()


def preflight(workload, arch=None, mapping=None, *, strict: bool = False,
              where: str = "pre-flight") -> List[Diagnostic]:
    """Validate model-plane inputs before expensive work.

    ``strict=True`` (CLI entry points) raises :class:`AnalysisError` on
    error-severity diagnostics; ``strict=False`` (library paths) emits
    one ``RuntimeWarning`` per offending workload and lets the caller
    proceed.  Returns the diagnostics either way.
    """
    if os.environ.get(_PREFLIGHT_ENV, "1") == "0":
        return []
    diags = validate(workload, arch, mapping)
    errors = [d for d in diags if d.severity == Severity.ERROR]
    if errors:
        if strict:
            raise AnalysisError(errors, where=where)
        key = (where, getattr(workload, "name", "?"),
               tuple(d.code for d in errors))
        if key not in _warned:
            _warned.add(key)
            head = "; ".join(f"{d.code} {d.message}" for d in errors[:3])
            more = f" (+{len(errors) - 3} more)" if len(errors) > 3 else ""
            warnings.warn(
                f"{where}: workload {getattr(workload, 'name', '?')!r} "
                f"failed model-plane validation: {head}{more}",
                RuntimeWarning, stacklevel=3)
    return diags
