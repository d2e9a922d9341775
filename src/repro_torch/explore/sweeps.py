"""Sweep definitions: enumerate grids as jobs, assemble comparison rows.

Copy of ``repro.explore.sweeps``: the port never imports the JAX package.

Each sweep builds a list of grid points — (sparse job, dense-baseline
job, row metadata) — hands every job to a :class:`SweepRunner` in one
batch, and assembles rows in grid-enumeration order.  Because jobs are
content-addressed, shared baselines (every ratio of a pattern sweep, the
re-swept best-organisation probe, …) are evaluated once regardless of
how many rows reference them.

Row schema matches the legacy ``repro_torch.core.explorer`` sweeps field for
field, so downstream CSV consumers are unaffected.
"""
from __future__ import annotations

import csv
import dataclasses
import itertools
import json
from pathlib import Path
from typing import (Callable, Dict, List, Optional, Sequence, Tuple, Union)

from .. import obs
from ..analysis import preflight
from ..calibrate.profile import CalibrationProfile
from ..core.costmodel import compare
from ..core.flexblock import FlexBlockSpec
from ..core.hardware import CIMArch
from ..core.mapping import MappingSpec, default_mapping
from ..core.report import CostReport
from ..core.schedule import POLICIES, SchedulePolicy
from ..core.workload import Workload
from .cache import ResultCache
from .job import ExploreJob
from .pareto import (DEFAULT_OBJECTIVES, ParetoFront, StreamingTopK,
                     pareto_front, top_k)
from .runner import RunStats, SweepRunner

__all__ = ["GridPoint", "SweepResult", "StreamResult", "run_grid",
           "stream_grid", "sparsity_sweep", "mapping_sweep", "org_sweep",
           "schedule_sweep"]


@dataclasses.dataclass(frozen=True)
class GridPoint:
    """One sweep row: a sparse evaluation, its baseline, and metadata."""

    job: ExploreJob
    dense: ExploreJob
    meta: Tuple[Tuple[str, object], ...] = ()


@dataclasses.dataclass
class SweepResult:
    """Ordered rows plus run accounting and post-processing views."""

    rows: List[Dict]
    stats: RunStats

    def pareto(self, objectives: Sequence[Tuple[str, str]] = DEFAULT_OBJECTIVES
               ) -> List[Dict]:
        return pareto_front(self.rows, objectives)

    def top_k(self, metric: str, k: int = 5, *, direction: str = "min"
              ) -> List[Dict]:
        return top_k(self.rows, metric, k, direction=direction)

    # -- serialisation ------------------------------------------------------
    def fieldnames(self) -> List[str]:
        names: List[str] = []
        for r in self.rows:
            for k in r:
                if k not in names:
                    names.append(k)
        return names

    def to_csv(self, path: Union[str, Path]) -> None:
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.fieldnames())
            w.writeheader()
            w.writerows(self.rows)

    def to_json(self, path: Optional[Union[str, Path]] = None) -> str:
        payload = json.dumps({"rows": self.rows,
                              "stats": self.stats.as_dict()}, indent=2)
        if path is not None:
            Path(path).write_text(payload + "\n")
        return payload


def _row(arch: CIMArch, wl: Workload, spec_name: str, ratio, mapping: str,
         rep: CostReport, cmp: Dict[str, float]) -> Dict:
    """Legacy explorer row schema (kept byte-compatible)."""
    return {
        "arch": arch.name,
        "workload": wl.name,
        "pattern": spec_name,
        "ratio": ratio,
        "mapping": mapping,
        "latency_ms": rep.latency_ms,
        "energy_uj": rep.total_energy_uj,
        "utilization": rep.utilization,
        "speedup": cmp["speedup"],
        "energy_saving": cmp["energy_saving"],
        "index_kib": rep.index_storage_bits / 8 / 1024,
    }


def _assemble_rows(points: Sequence[GridPoint],
                   reports: Sequence[Optional[CostReport]]) -> List[Dict]:
    """Assemble comparison rows in point order from interleaved
    ``[job, dense, job, dense, ...]`` reports."""
    rows: List[Dict] = []
    for i, p in enumerate(points):
        rep, dense = reports[2 * i], reports[2 * i + 1]
        meta = dict(p.meta)
        if rep is None or dense is None:
            # degrade-mode runner quarantined this point (or its
            # baseline): keep the row identifiable, mark it failed
            row = {"arch": p.job.arch.name, "workload": p.job.workload.name,
                   "pattern": meta.pop("pattern", ""),
                   "ratio": meta.pop("ratio", None),
                   "mapping": p.job.mapping.strategy, "failed": True}
            row.update(meta)
            rows.append(row)
            continue
        row = _row(p.job.arch, p.job.workload, meta.pop("pattern", ""),
                   meta.pop("ratio", None), p.job.mapping.strategy,
                   rep, compare(rep, dense))
        row.update(meta)
        rows.append(row)
    return rows


def _preflight_points(points: Sequence[GridPoint], checked: set,
                      where: str) -> None:
    # warn-only pre-flight (strict rejection lives in the CLIs): each
    # distinct workload/arch/mapping triple is validated once, O(ops),
    # before any simulation burns time on ill-formed inputs
    for p in points:
        key = (id(p.job.workload), id(p.job.arch), id(p.job.mapping))
        if key not in checked:
            checked.add(key)
            preflight(p.job.workload, p.job.arch, p.job.mapping,
                      strict=False, where=where)


def run_grid(points: Sequence[GridPoint], *,
             runner: Optional[SweepRunner] = None,
             workers: Optional[int] = None,
             cache: Optional[ResultCache] = None,
             tile_cache_capacity: Optional[int] = None,
             batch_size: Optional[int] = None) -> SweepResult:
    """Evaluate a grid and assemble rows in point order.

    ``tile_cache_capacity`` sizes the per-process tile-grid memo the
    simulator shares across grid points; ``batch_size`` enables the
    batched evaluation path (see :class:`SweepRunner`).  Both are
    ignored when ``runner`` is supplied — the runner already owns those
    settings."""
    runner = runner or SweepRunner(workers=workers, cache=cache,
                                   tile_cache_capacity=tile_cache_capacity,
                                   batch_size=batch_size)
    _preflight_points(points, set(), "explore.run_grid")
    jobs: List[ExploreJob] = []
    for p in points:
        jobs.append(p.job)
        jobs.append(p.dense)
    reports = runner.run(jobs)
    rows = _assemble_rows(points, reports)
    observer = obs.get_observer()
    if observer is not None:
        # observational artifact only: per-component energy attribution
        # for every sparse point, long-format, one CSV per recorded run
        from ..obs.energy import append_energy_csv, component_rows
        erows: List[Dict] = []
        for i, p in enumerate(points):
            if reports[2 * i] is None:
                continue
            erows.extend(component_rows(reports[2 * i], meta=dict(p.meta)))
        append_energy_csv(
            erows, observer.artifact_path("energy_components.csv"))
    return SweepResult(rows=rows, stats=runner.last_stats)


@dataclasses.dataclass
class StreamResult:
    """What a :func:`stream_grid` run keeps: the incremental fronts and
    merged accounting — NOT the full row list (that is the point)."""

    front_rows: List[Dict]
    topk_rows: List[Dict]
    stats: RunStats
    points: int                      # grid points streamed through
    rows: List[Dict]                 # only populated with keep_rows=True

    def pareto(self, objectives: Sequence[Tuple[str, str]]
               = DEFAULT_OBJECTIVES) -> List[Dict]:
        return self.front_rows

    def top_k(self, metric: str, k: int = 5, *, direction: str = "min"
              ) -> List[Dict]:
        return self.topk_rows[:k]

    # CSV/JSON mirror SweepResult's surface over the retained rows
    fieldnames = SweepResult.fieldnames
    to_csv = SweepResult.to_csv
    to_json = SweepResult.to_json


def stream_grid(point_iter, *,
                runner: SweepRunner,
                chunk: int = 4096,
                objectives: Sequence[Tuple[str, str]] = DEFAULT_OBJECTIVES,
                metric: str = "latency_ms",
                k: int = 5,
                direction: str = "min",
                keep_rows: bool = False,
                csv_path: Optional[Union[str, Path]] = None,
                total: Optional[int] = None) -> StreamResult:
    """Evaluate a (lazily generated) point stream in chunks, keeping
    only the incremental Pareto front and top-k — million-point sweeps
    never hold all rows in memory.

    Feeds ``chunk`` points at a time through ``runner.run`` (batched if
    the runner has a ``batch_size``), folds the assembled rows into a
    :class:`~repro_torch.explore.pareto.ParetoFront` and
    :class:`~repro_torch.explore.pareto.StreamingTopK` (both provably
    equivalent to their one-shot counterparts), optionally appends every
    row to ``csv_path``, then drops the rows unless ``keep_rows``.
    Progress surfaces through ``explore.stream`` heartbeats carrying
    points/s, chunk size, and current front size.
    """
    front = ParetoFront(objectives)
    topk = StreamingTopK(metric, k, direction=direction)
    stats = RunStats(workers=runner.workers)
    kept: List[Dict] = []
    checked: set = set()
    n_points = 0
    hb = obs.heartbeat("explore.stream", total=total or 0)
    csv_writer = None
    csv_file = None
    point_iter = iter(point_iter)
    try:
        while True:
            points = list(itertools.islice(point_iter, chunk))
            if not points:
                break
            _preflight_points(points, checked, "explore.stream_grid")
            jobs: List[ExploreJob] = []
            for p in points:
                jobs.append(p.job)
                jobs.append(p.dense)
            reports = runner.run(jobs)
            rows = _assemble_rows(points, reports)
            for row in rows:
                front.add(row)
                topk.add(row)
            if csv_path is not None:
                if csv_writer is None:
                    csv_file = open(csv_path, "w", newline="")
                    csv_writer = csv.DictWriter(
                        csv_file, fieldnames=list(rows[0].keys()),
                        extrasaction="ignore")
                    csv_writer.writeheader()
                csv_writer.writerows(rows)
            if keep_rows:
                kept.extend(rows)
            n_points += len(points)
            stats = stats.merge(runner.last_stats)
            hb.tick(n_points, chunk=len(points), front=len(front),
                    batches=runner.last_stats.batches)
    finally:
        if csv_file is not None:
            csv_file.close()
    stats.workers = runner.workers
    return StreamResult(front_rows=front.front(), topk_rows=topk.best(),
                        stats=stats, points=n_points, rows=kept)


# ---------------------------------------------------------------------------
# The paper's two exploration grids (§VII-B, §VII-C).
# ---------------------------------------------------------------------------

def sparsity_sweep(
    arch: CIMArch,
    workload_fn: Callable[[], Workload],
    patterns: Dict[str, FlexBlockSpec],
    *,
    ratios: Sequence[float] = (0.5, 0.6, 0.7, 0.8, 0.9),
    mapping: Optional[MappingSpec] = None,
    pattern_factory: Optional[Callable[[float], Dict[str, FlexBlockSpec]]] = None,
    input_sparsity: Optional[Dict[str, float]] = None,
    profile: Optional[CalibrationProfile] = None,
    schedule: Optional[SchedulePolicy] = None,
    runner: Optional[SweepRunner] = None,
    workers: Optional[int] = None,
    cache: Optional[ResultCache] = None,
    tile_cache_capacity: Optional[int] = None,
) -> SweepResult:
    """§VII-B: sparsity pattern × ratio grid on one architecture.

    All points share one dense baseline; the engine evaluates it once.
    ``profile`` switches the whole grid — sparse points and the shared
    baseline alike — to calibrated mode (:mod:`repro_torch.calibrate`);
    ``schedule`` likewise applies one scheduling policy to every point
    and its baseline (:mod:`repro_torch.core.schedule`).
    """
    mapping = mapping or default_mapping(arch)
    dense = ExploreJob.dense(arch, workload_fn(), mapping, profile=profile,
                             schedule=schedule)
    points: List[GridPoint] = []
    for ratio in ratios:
        pats = pattern_factory(ratio) if pattern_factory else patterns
        for name, spec in pats.items():
            wl = workload_fn().set_sparsity(spec)
            job = ExploreJob.simulate(arch, wl, mapping,
                                      input_sparsity=input_sparsity,
                                      profile=profile, schedule=schedule)
            points.append(GridPoint(job, dense,
                                    meta=(("pattern", name), ("ratio", ratio))))
    return run_grid(points, runner=runner, workers=workers, cache=cache,
                    tile_cache_capacity=tile_cache_capacity)


def mapping_sweep(
    arch_fn: Callable[[Tuple[int, int]], CIMArch],
    workload_fn: Callable[[], Workload],
    spec: FlexBlockSpec,
    *,
    orgs: Sequence[Tuple[int, int]] = ((8, 2), (4, 4), (2, 8)),
    strategies: Sequence[str] = ("spatial", "duplicate"),
    rearrange: Sequence[Optional[str]] = (None,),
    profile: Optional[CalibrationProfile] = None,
    schedule: Optional[SchedulePolicy] = None,
    runner: Optional[SweepRunner] = None,
    workers: Optional[int] = None,
    cache: Optional[ResultCache] = None,
    tile_cache_capacity: Optional[int] = None,
) -> SweepResult:
    """§VII-C: mapping strategy × macro organisation (× rearrangement)."""
    points: List[GridPoint] = []
    for org, strat, rr in itertools.product(orgs, strategies, rearrange):
        arch = arch_fn(org)
        mapping = default_mapping(arch, strat, rearrange=rr)
        wl = workload_fn().set_sparsity(spec)
        job = ExploreJob.simulate(arch, wl, mapping, profile=profile,
                                  schedule=schedule)
        dense = ExploreJob.dense(arch, wl, mapping, profile=profile,
                                 schedule=schedule)
        points.append(GridPoint(job, dense, meta=(
            ("pattern", spec.name), ("ratio", None),
            ("org", f"{org[0]}x{org[1]}"), ("rearrange", rr or "none"))))
    return run_grid(points, runner=runner, workers=workers, cache=cache,
                    tile_cache_capacity=tile_cache_capacity)


def org_sweep(
    arch_fn: Callable[[Tuple[int, int]], CIMArch],
    workload_fn: Callable[[], Workload],
    spec: FlexBlockSpec,
    orgs: Sequence[Tuple[int, int]],
    strategy: str = "spatial",
    **kw,
) -> SweepResult:
    return mapping_sweep(arch_fn, workload_fn, spec, orgs=orgs,
                         strategies=(strategy,), **kw)


def schedule_sweep(
    arch: CIMArch,
    workload_fn: Callable[[], Workload],
    spec: FlexBlockSpec,
    *,
    policies: Sequence[str] = POLICIES,
    strategies: Sequence[str] = ("spatial",),
    invocations: Sequence[int] = (1,),
    profile: Optional[CalibrationProfile] = None,
    runner: Optional[SweepRunner] = None,
    workers: Optional[int] = None,
    cache: Optional[ResultCache] = None,
    tile_cache_capacity: Optional[int] = None,
) -> SweepResult:
    """Scheduling-policy × mapping-strategy (× invocation-count) grid.

    The new exploration axis the multi-macro scheduling layer opens
    (paper §IV, use-case 2): how much does overlapping independent DAG
    branches (``partitioned``) or pinning weights across repeated
    executions (``resident``) buy on a given workload?  Each point's
    dense baseline shares its policy, so the ``speedup`` column isolates
    the sparsity gain while ``latency_ms`` is directly comparable across
    rows of one strategy.
    """
    points: List[GridPoint] = []
    for strat, pol, inv in itertools.product(strategies, policies,
                                             invocations):
        mapping = default_mapping(arch, strat)
        sched = SchedulePolicy(policy=pol, invocations=inv)
        wl = workload_fn().set_sparsity(spec)
        job = ExploreJob.simulate(arch, wl, mapping, profile=profile,
                                  schedule=sched)
        dense = ExploreJob.dense(arch, wl, mapping, profile=profile,
                                 schedule=sched)
        points.append(GridPoint(job, dense, meta=(
            ("pattern", spec.name), ("ratio", None),
            ("schedule", pol), ("invocations", inv))))
    return run_grid(points, runner=runner, workers=workers, cache=cache,
                    tile_cache_capacity=tile_cache_capacity)
