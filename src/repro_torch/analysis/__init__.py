"""repro_torch.analysis — static invariant verification for the port
(copy of ``repro.analysis`` over ``repro_torch``).

A pass-based checker that keeps the port's load-bearing conventions
machine-enforced:

* ``import-boundary`` (CIM1xx) — the host plane (core/explore/trace/
  configs/calibrate/analysis/obs and the package root) stays torch- and
  triton-free; torch only through in-function lazy sites.
* ``cache-key`` (CIM2xx) — every ``simulate()`` knob participates in
  ``ExploreJob``'s content key and the CACHE_SCHEMA history.
* ``model-plane`` (CIM3xx) — semantic validation of live
  Workload/arch/mapping objects, also exposed as :func:`validate` /
  :func:`preflight` for pre-flight use (``ServeEngine`` calls it on its
  ``lm_workload`` when it is built).
* ``determinism`` (CIM4xx) — no entropy (torch's global generator
  included), wall clock, salted ``hash()``, or directory-order
  dependence in result-producing code.

CLI: ``python -m repro_torch.analysis [--all | --pass NAME] [--format
text|json]`` — exits non-zero on error-severity diagnostics.  The whole
package imports and runs without torch, triton or jax (it is itself part
of the protected plane it checks).  The codes are the reference's,
catalogued in ``docs/analysis.md``.
"""
from __future__ import annotations

import os
import warnings
from typing import List

from .diagnostics import (AnalysisError, Diagnostic, Severity,
                          render_json, render_text)
from .framework import (AnalysisPass, PassContext, all_passes, get_pass,
                        run_passes)
from .modelplane_pass import validate

__all__ = ["AnalysisError", "AnalysisPass", "Diagnostic", "PassContext",
           "Severity", "all_passes", "get_pass", "preflight",
           "render_json", "render_text", "run_passes", "validate"]

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
