"""Pass 2 — cache-key completeness: no simulate-affecting knob may
bypass the content-addressed cache (copy of
``repro/analysis/cachekey_pass.py`` over the port's package).

The explore plane memoises ``simulate()`` results under
``ExploreJob.content_key`` (sha256 over ``explore.job.canonical``).
Historically this contract broke silently three times — a new
simulate-affecting field landed without a ``CACHE_SCHEMA`` bump and
stale caches served wrong numbers.  This pass AST-diffs the three
anchors so the contract is machine-checked:

* ``core/costmodel.py::simulate`` — the semantic parameter surface,
* ``explore/job.py::ExploreJob`` — the cached key's field set (hashed
  generically: ``canonical`` must enumerate dataclass fields via
  ``_sorted_field_names``/``dataclasses.fields``, never a hand list),
* ``explore/runner.py::evaluate_job`` — the forwarding glue,
* the numbered ``# N:`` history block above ``CACHE_SCHEMA``.

Declared exceptions (each must stay justified here):

* ``tile_cache`` is a *memo*, not a semantic input — simulate results
  are bit-identical with or without it, so it must NOT enter the key.
* ``kind`` is key metadata (dense-twin vs simulate) consumed by
  ``evaluate_job``'s dispatch, not forwarded as a simulate kwarg.

Codes
-----
* ``CIM200`` (error) — an anchor (file/function/class) moved and the
  pass can no longer see it; fix the pass alongside the refactor.
* ``CIM201`` (error) — ``simulate()`` keyword absent from
  ``ExploreJob``: results would vary on a knob the cache key ignores.
* ``CIM202`` (error) — ``ExploreJob`` field never read by
  ``evaluate_job``: the key varies on a knob the evaluation ignores
  (dead weight at best, a stale-key refactor remnant at worst).
* ``CIM203`` (error) — ``canonical()`` no longer enumerates dataclass
  fields generically, so new fields would silently skip the digest.
* ``CIM204`` (error) — ``CACHE_SCHEMA`` has no matching ``# N:`` history
  entry for its current value.
* ``CIM205`` (error) — observability leaking into the cache key: an
  ``ExploreJob`` field or ``simulate()`` parameter named after the obs
  plane (``*obs*``), or ``explore/job.py`` importing ``repro_torch.obs`` at
  all.  ``repro_torch.obs`` is observational-only (it may read wall clocks,
  see the determinism pass waiver) — if any obs-derived value entered
  ``canonical()``, cache keys would vary run to run and the memoisation
  contract would dissolve.
* ``CIM206`` (error) — execution policy leaking into the cache key: an
  ``ExploreJob`` field or ``simulate()`` parameter with a fault/retry/
  timeout/backoff name, or ``explore/job.py`` importing
  ``repro_torch.explore.faults``.  Retry budgets, timeouts and fault plans
  change how a sweep *executes*, never what a job *computes* — they are
  runner-level knobs by contract (``SweepRunner(timeout_s=…,
  max_retries=…)``), and if one entered ``canonical()``, identical
  simulations run under different robustness settings would stop
  sharing cache entries (and a fault-injected chaos run would poison
  the fault-free cache namespace).
* ``CIM207`` (error) — batching/search execution knobs leaking into the
  cache key: an ``ExploreJob`` field or ``simulate()`` parameter with a
  batch/search/budget name, or ``explore/job.py`` importing
  ``repro_torch.explore.batch`` / ``repro_torch.explore.search``.  Batched
  evaluation is bit-identical to per-point evaluation by contract
  (``tests/test_batch.py``), and a guided search merely chooses *which*
  points evaluate — neither changes what a job computes.  If either
  entered ``canonical()``, a point found by ``--search halving`` under
  ``--batch 256`` would stop sharing its store entry with the same
  point in a plain exhaustive sweep, and resumability across execution
  configurations would dissolve.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .diagnostics import Diagnostic, Severity
from .framework import AnalysisPass, PassContext, register

__all__ = ["CacheKeyPass", "NON_SEMANTIC_SIMULATE_PARAMS",
           "NON_FORWARDED_JOB_FIELDS"]

# simulate() parameters that deliberately stay out of the cache key
# (pure memoisation, bit-identical results either way).
NON_SEMANTIC_SIMULATE_PARAMS = frozenset({"tile_cache"})

# ExploreJob fields that deliberately aren't forwarded to simulate()
# (consumed by evaluate_job's own dispatch instead).
NON_FORWARDED_JOB_FIELDS = frozenset({"kind"})

# name tokens that mark an execution-policy knob (CIM206): these belong
# on SweepRunner, never on the cache-key surface
_FAULT_TOKENS = frozenset({"fault", "faults", "retry", "retries",
                           "timeout", "timeouts", "backoff"})

# name tokens that mark a batching/search execution knob (CIM207):
# batched evaluation and guided search change how a sweep executes,
# never what a job computes
_BATCH_TOKENS = frozenset({"batch", "batched", "batches", "search",
                           "budget"})

_HISTORY_RE = re.compile(r"^\s*#\s*(\d+)\s*:")


def _find_def(tree: ast.Module, name: str) -> Optional[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _find_class(tree: ast.Module, name: str) -> Optional[ast.ClassDef]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def _dataclass_fields(cls: ast.ClassDef) -> Dict[str, int]:
    """Annotated instance fields of a dataclass body: name -> lineno
    (ClassVar annotations and underscored names excluded)."""
    fields: Dict[str, int] = {}
    for stmt in cls.body:
        if not isinstance(stmt, ast.AnnAssign):
            continue
        if not isinstance(stmt.target, ast.Name):
            continue
        ann = ast.unparse(stmt.annotation)
        if "ClassVar" in ann or stmt.target.id.startswith("_"):
            continue
        fields[stmt.target.id] = stmt.lineno
    return fields


def _signature_params(fn: ast.FunctionDef) -> Dict[str, int]:
    """All named parameters (positional + kw-only): name -> lineno."""
    params: Dict[str, int] = {}
    for a in (*fn.args.posonlyargs, *fn.args.args, *fn.args.kwonlyargs):
        params[a.arg] = a.lineno
    return params


def _attr_reads(fn: ast.FunctionDef, base: str) -> Set[str]:
    """Attribute names read off ``<base>.`` anywhere in the body."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == base):
            out.add(node.attr)
    return out


def _schema_assignment(tree: ast.Module) -> Optional[Tuple[int, int]]:
    """(value, lineno) of the module-level ``CACHE_SCHEMA = <int>``."""
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "CACHE_SCHEMA"
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)):
            return node.value.value, node.lineno
    return None


def _history_entries(lines: List[str], assign_lineno: int) -> Set[int]:
    """``# N:`` entries in the contiguous comment block directly above
    the CACHE_SCHEMA assignment."""
    entries: Set[int] = set()
    i = assign_lineno - 2                     # line above, 0-based
    while i >= 0 and lines[i].lstrip().startswith("#"):
        m = _HISTORY_RE.match(lines[i])
        if m:
            entries.add(int(m.group(1)))
        i -= 1
    return entries


@register
class CacheKeyPass(AnalysisPass):
    name = "cache-key"
    codes = ("CIM200", "CIM201", "CIM202", "CIM203", "CIM204", "CIM205",
             "CIM206", "CIM207")
    description = ("every simulate() knob must flow through ExploreJob, "
                   "canonical() must hash fields generically, "
                   "CACHE_SCHEMA history must cover the current value, "
                   "and nothing obs-, fault-policy-, or batch/search-"
                   "derived may enter the key")

    def _missing(self, what: str, rel: str) -> Diagnostic:
        return self.diag(
            "CIM200", Severity.ERROR,
            f"cache-key anchor not found: {what}",
            file=rel,
            hint="the cache-key pass tracks this symbol by name; update "
                 "repro_torch/analysis/cachekey_pass.py with the refactor")

    def run(self, ctx: PassContext) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        pkg = ctx.package

        cost_path = ctx.module_path(f"{pkg}.core.costmodel")
        job_path = ctx.module_path(f"{pkg}.explore.job")
        runner_path = ctx.module_path(f"{pkg}.explore.runner")
        for what, p in (("core/costmodel.py", cost_path),
                        ("explore/job.py", job_path),
                        ("explore/runner.py", runner_path)):
            if p is None:
                diags.append(self._missing(what, what))
        if any(p is None for p in (cost_path, job_path, runner_path)):
            return diags

        cost_rel, job_rel = ctx.rel(cost_path), ctx.rel(job_path)
        runner_rel = ctx.rel(runner_path)

        simulate = _find_def(ctx.tree(cost_path), "simulate")
        job_cls = _find_class(ctx.tree(job_path), "ExploreJob")
        canonical = _find_def(ctx.tree(job_path), "canonical")
        evaluate = _find_def(ctx.tree(runner_path), "evaluate_job")
        if simulate is None:
            diags.append(self._missing("simulate()", cost_rel))
        if job_cls is None:
            diags.append(self._missing("class ExploreJob", job_rel))
        if canonical is None:
            diags.append(self._missing("canonical()", job_rel))
        if evaluate is None:
            diags.append(self._missing("evaluate_job()", runner_rel))
        if None in (simulate, job_cls, canonical, evaluate):
            return diags

        params = _signature_params(simulate)
        fields = _dataclass_fields(job_cls)

        # CIM201 — simulate knob missing from the cache key
        for name, lineno in sorted(params.items()):
            if name in fields or name in NON_SEMANTIC_SIMULATE_PARAMS:
                continue
            diags.append(self.diag(
                "CIM201", Severity.ERROR,
                f"simulate() parameter {name!r} is not an ExploreJob "
                f"field — cached results would ignore it",
                file=cost_rel, line=lineno,
                hint=f"add {name!r} to ExploreJob (it enters canonical() "
                     f"automatically), bump CACHE_SCHEMA with a history "
                     f"entry, and forward it in evaluate_job; if it is "
                     f"pure memoisation, whitelist it in "
                     f"NON_SEMANTIC_SIMULATE_PARAMS with a justification"))

        # CIM202 — key field the evaluation never reads
        reads = _attr_reads(evaluate, "job")
        for name, lineno in sorted(fields.items()):
            if name in reads or name in NON_FORWARDED_JOB_FIELDS:
                continue
            diags.append(self.diag(
                "CIM202", Severity.ERROR,
                f"ExploreJob field {name!r} is never read by "
                f"evaluate_job — the cache key varies on a knob the "
                f"evaluation ignores",
                file=job_rel, line=lineno,
                hint="forward it to simulate() in evaluate_job, or drop "
                     "the field (bumping CACHE_SCHEMA either way)"))

        # CIM203 — canonical() must enumerate dataclass fields generically
        calls = {node.func.id if isinstance(node.func, ast.Name)
                 else getattr(node.func, "attr", "")
                 for node in ast.walk(canonical)
                 if isinstance(node, ast.Call)}
        if not calls & {"_sorted_field_names", "fields"}:
            diags.append(self.diag(
                "CIM203", Severity.ERROR,
                "canonical() no longer enumerates dataclass fields "
                "generically (_sorted_field_names / dataclasses.fields) "
                "— new fields would silently skip the content key",
                file=job_rel, line=canonical.lineno,
                hint="hash dataclasses via their full sorted field set; "
                     "hand-maintained field lists rot"))

        # CIM205 — nothing obs-derived may enter the cache key.  Two
        # shapes of the leak: (a) a field/parameter named after the obs
        # plane, (b) explore/job.py importing repro_torch.obs (even lazily —
        # the key module has no observational business at all).
        for name, lineno, rel in (
                [(n, ln, job_rel) for n, ln in sorted(fields.items())]
                + [(n, ln, cost_rel) for n, ln in sorted(params.items())]):
            if "obs" in name.lower().split("_") or name.lower() == "obs":
                diags.append(self.diag(
                    "CIM205", Severity.ERROR,
                    f"obs-derived name {name!r} in the cache-key surface "
                    f"— instrumentation must stay observational",
                    file=rel, line=lineno,
                    hint="repro_torch.obs reads wall clocks under a sanctioned "
                         "waiver; letting its state into ExploreJob/"
                         "simulate() would make cache keys nondeterministic"))
        for node in ast.walk(ctx.tree(job_path)):
            target = ""
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[:2] == [pkg, "obs"]:
                        target = alias.name
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level > 0:
                    names = {a.name for a in node.names}
                    if mod.split(".")[0] == "obs" or (
                            not mod and "obs" in names):
                        target = f"{pkg}.obs"
                elif mod.split(".")[:2] == [pkg, "obs"]:
                    target = mod
            if target:
                diags.append(self.diag(
                    "CIM205", Severity.ERROR,
                    f"explore/job.py imports {target} — the cache-key "
                    f"module must not touch the observability plane",
                    file=job_rel, line=node.lineno,
                    hint="record telemetry in the runner/sweeps layer; "
                         "job.py defines the memoisation contract and "
                         "stays obs-free by construction"))

        # CIM206 — execution policy may not enter the cache key.  Same
        # two leak shapes as CIM205: (a) a fault/retry/timeout/backoff-
        # named field or parameter, (b) explore/job.py importing the
        # fault-injection harness (repro_torch.explore.faults).
        for name, lineno, rel in (
                [(n, ln, job_rel) for n, ln in sorted(fields.items())]
                + [(n, ln, cost_rel) for n, ln in sorted(params.items())]):
            tokens = set(name.lower().split("_")) | {name.lower()}
            if tokens & _FAULT_TOKENS:
                diags.append(self.diag(
                    "CIM206", Severity.ERROR,
                    f"execution-policy name {name!r} in the cache-key "
                    f"surface — fault/retry/timeout knobs are "
                    f"runner-level by contract",
                    file=rel, line=lineno,
                    hint="put the knob on SweepRunner (timeout_s, "
                         "max_retries, backoff_s, failure_mode) or in a "
                         "FaultPlan; a job's key must not vary with how "
                         "robustly the sweep executes it"))
        for node in ast.walk(ctx.tree(job_path)):
            target = ""
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[:3] == [pkg, "explore",
                                                     "faults"]:
                        target = alias.name
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level > 0:
                    names = {a.name for a in node.names}
                    if mod.split(".")[0] == "faults" or (
                            not mod and "faults" in names):
                        target = f"{pkg}.explore.faults"
                elif mod.split(".")[:3] == [pkg, "explore", "faults"]:
                    target = mod
            if target:
                diags.append(self.diag(
                    "CIM206", Severity.ERROR,
                    f"explore/job.py imports {target} — the cache-key "
                    f"module must not touch the fault-injection plane",
                    file=job_rel, line=node.lineno,
                    hint="inject faults in the runner/cache layer "
                         "(evaluate_job, ResultStore.put); job.py "
                         "defines the memoisation contract and stays "
                         "fault-free by construction"))

        # CIM207 — batching/search knobs may not enter the cache key.
        # Same two leak shapes again: (a) a batch/search/budget-named
        # field or parameter, (b) explore/job.py importing the batched
        # evaluator or the search layer.
        for name, lineno, rel in (
                [(n, ln, job_rel) for n, ln in sorted(fields.items())]
                + [(n, ln, cost_rel) for n, ln in sorted(params.items())]):
            tokens = set(name.lower().split("_")) | {name.lower()}
            if tokens & _BATCH_TOKENS:
                diags.append(self.diag(
                    "CIM207", Severity.ERROR,
                    f"batch/search execution knob {name!r} in the "
                    f"cache-key surface — batched evaluation is "
                    f"bit-identical by contract and search only picks "
                    f"which points run",
                    file=rel, line=lineno,
                    hint="put batching on SweepRunner (batch_size) and "
                         "search on SearchPolicy; a job's key must not "
                         "vary with how the sweep is dispatched, or "
                         "batched and per-point runs would stop sharing "
                         "one store"))
        for node in ast.walk(ctx.tree(job_path)):
            target = ""
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[:3] in (
                            [pkg, "explore", "batch"],
                            [pkg, "explore", "search"]):
                        target = alias.name
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level > 0:
                    names = {a.name for a in node.names}
                    if mod.split(".")[0] in ("batch", "search") or (
                            not mod and names & {"batch", "search"}):
                        target = f"{pkg}.explore.{mod or 'batch/search'}"
                elif mod.split(".")[:3] in ([pkg, "explore", "batch"],
                                            [pkg, "explore", "search"]):
                    target = mod
            if target:
                diags.append(self.diag(
                    "CIM207", Severity.ERROR,
                    f"explore/job.py imports {target} — the cache-key "
                    f"module must not depend on the batch/search "
                    f"execution layer",
                    file=job_rel, line=node.lineno,
                    hint="the dependency points the other way: batch.py "
                         "derives base keys FROM job.canonical; job.py "
                         "defines the memoisation contract and stays "
                         "dispatch-free by construction"))

        # CIM204 — CACHE_SCHEMA history entry for the current value
        schema = _schema_assignment(ctx.tree(job_path))
        if schema is None:
            diags.append(self._missing("CACHE_SCHEMA assignment", job_rel))
        else:
            value, lineno = schema
            entries = _history_entries(ctx.source_lines(job_path), lineno)
            if value not in entries:
                known = ", ".join(str(e) for e in sorted(entries)) or "none"
                diags.append(self.diag(
                    "CIM204", Severity.ERROR,
                    f"CACHE_SCHEMA = {value} has no matching '# {value}:' "
                    f"history entry (recorded: {known})",
                    file=job_rel, line=lineno,
                    hint="every schema bump documents what changed in the "
                         "comment block directly above the assignment"))
        return diags
