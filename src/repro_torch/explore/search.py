"""Guided search over exploration grids: seeded, deterministic, resumable.

Copy of ``repro.explore.search``: the port never imports the JAX package.

Combinatorial design spaces (dataflow × org × sparsity × schedule) grow
far past exhaustive enumeration.  This layer walks a
:class:`PointSpace` — a lazily-indexed grid (points are built on demand,
so a 10⁶-point space costs no memory up front) — under a
:class:`SearchPolicy`:

* ``exhaustive`` — every point (optionally budget-capped), streamed
  through :func:`~repro_torch.explore.sweeps.stream_grid`.
* ``halving`` — successive-halving promotion: rank ALL points on a
  cheap monolithic-schedule estimate (:func:`estimate_job` — the per-op
  costing pass without schedule/energy/baseline, hundreds of µs per
  point), promote the best ``budget`` (or ``1/eta``) and pay full
  evaluation — dense baseline, schedule, energy — only for them.
* ``evolve`` — a seeded evolutionary loop over the space's lattice
  coordinates: mutate mapping/org/sparsity knobs axis-wise from the
  fittest survivors, evaluate each generation as one batched grid.

Every policy is **deterministic** (seeded ``np.random.default_rng``,
index-ordered tie-breaks, no wall-clock dependence), so a re-run with
the same policy walks the same trajectory — and with a run
directory (``ResultStore`` + journal) every previously evaluated point
is a cache hit: resume after a crash re-pays estimates (cheap) but no
full evaluations.  Search knobs are execution policy by contract — they
never enter :class:`~repro_torch.explore.job.ExploreJob` or its cache key:
a point found by any search strategy shares its
store entry with the same point in an exhaustive sweep.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from collections import OrderedDict

from ..core.costmodel import _cost_ops, op_class
from .. import obs
from .job import ExploreJob
from .pareto import DEFAULT_OBJECTIVES, ParetoFront, StreamingTopK
from .runner import RunStats, SweepRunner
from .sweeps import (GridPoint, StreamResult, _assemble_rows,
                     _preflight_points, stream_grid)

__all__ = ["SearchPolicy", "PointSpace", "SearchResult", "estimate_job",
           "estimate_jobs", "run_search", "SEARCH_KINDS"]

SEARCH_KINDS = ("exhaustive", "halving", "evolve")


@dataclasses.dataclass(frozen=True)
class SearchPolicy:
    """How to walk a :class:`PointSpace`.

    ``budget``: full evaluations the search may spend.  ``None`` means
    ``size // eta`` for halving and ``4 × population`` for evolve;
    exhaustive ignores it unless set.
    ``eta``: halving's promotion factor (keep the top ``1/eta``).
    ``population``: evolve's generation size.
    ``metric``/``direction``: the scalar fitness evolve selects on (and
    the top-k ordering every search reports).
    """

    kind: str = "exhaustive"
    budget: Optional[int] = None
    seed: int = 0
    eta: int = 4
    population: int = 16
    metric: str = "latency_ms"
    direction: str = "min"

    def __post_init__(self):
        if self.kind not in SEARCH_KINDS:
            raise ValueError(f"unknown search kind {self.kind!r}; "
                             f"choose from {SEARCH_KINDS}")
        if self.budget is not None and self.budget < 1:
            raise ValueError(f"budget must be >= 1, got {self.budget}")
        if self.eta < 2:
            raise ValueError(f"eta must be >= 2, got {self.eta}")
        if self.direction not in ("min", "max"):
            raise ValueError(f"direction {self.direction!r} is not "
                             f"'min'/'max'")


@dataclasses.dataclass(frozen=True)
class PointSpace:
    """A lazily-indexed design space: ``factory(i)`` builds point ``i``.

    ``shape`` optionally names the mixed-radix lattice the flat index
    enumerates (row-major, last axis fastest) — evolve mutates along
    those axes; without it the space is treated as one axis.  Factories
    must be deterministic: point ``i`` is rebuilt on every visit (and
    on resume) and must produce content-identical jobs each time.
    """

    size: int
    factory: Callable[[int], "GridPoint"]
    shape: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.size < 0:
            raise ValueError(f"size must be >= 0, got {self.size}")
        if self.shape is not None:
            n = 1
            for s in self.shape:
                n *= s
            if n != self.size:
                raise ValueError(f"shape {self.shape} enumerates {n} "
                                 f"points, size says {self.size}")

    @staticmethod
    def from_points(points: Sequence["GridPoint"],
                    shape: Optional[Tuple[int, ...]] = None) -> "PointSpace":
        pts = list(points)
        return PointSpace(len(pts), pts.__getitem__, shape)

    def coords(self, i: int) -> Tuple[int, ...]:
        shape = self.shape or (self.size,)
        out = []
        for s in reversed(shape):
            out.append(i % s)
            i //= s
        return tuple(reversed(out))

    def index(self, coords: Sequence[int]) -> int:
        shape = self.shape or (self.size,)
        i = 0
        for c, s in zip(coords, shape):
            i = i * s + c
        return i


@dataclasses.dataclass
class SearchResult(StreamResult):
    """A :class:`~repro_torch.explore.sweeps.StreamResult` plus search
    accounting: how many points were *estimated* (cheap pass) vs fully
    evaluated (``points``)."""

    estimated: int = 0
    policy: Optional[SearchPolicy] = None


def estimate_job(job: ExploreJob) -> float:
    """Cheap fidelity: the op-serial (monolithic) total latency in
    cycles — the per-op costing pass alone, no schedule resolution, no
    energy aggregation, no dense baseline.  Deterministic, and served
    by the same process-wide tile-grid memo as full evaluation, so
    repeated shapes across the space cost microseconds."""
    costed = _cost_ops(
        job.arch, job.workload, job.mapping,
        input_sparsity=(dict(job.input_sparsity)
                        if job.input_sparsity else None),
        masks=dict(job.masks) if job.masks else None,
        profile=job.profile, tile_cache=None)
    return float(sum(oc.latency_cycles for _op, oc, _led in costed
                     if oc is not None))


def estimate_jobs(jobs: Sequence[ExploreJob]) -> List[float]:
    """Batch :func:`estimate_job`: one costing pass per variant group.

    Jobs are bucketed on the *identity* of the fields the estimate
    reads (arch, workload, mapping, masks, input-sparsity) — factories
    share those objects across schedule/profile variants, and identity
    equality implies content equality, so each bucket can pay
    ``_cost_ops`` once with ``profile=None``.  Every member re-derives
    its estimate by replaying the profile's per-op efficiency division
    — the exact float operations ``_cost_ops(profile=p)`` would apply,
    in the same per-op order, so each value is bit-identical to the
    per-job call; a factory that
    shares nothing merely degrades to one pass per job.  Identity
    grouping (no canonical-form hashing at all) is what makes halving's
    estimate pass ~cost_ops/|group| per point instead of cost_ops.
    """
    groups: "OrderedDict[tuple, List[int]]" = OrderedDict()
    for pos, job in enumerate(jobs):
        sig = (id(job.arch), id(job.workload), id(job.mapping),
               id(job.masks), id(job.input_sparsity))
        groups.setdefault(sig, []).append(pos)
    out = [0.0] * len(jobs)
    for positions in groups.values():
        rep = jobs[positions[0]]
        costed = _cost_ops(
            rep.arch, rep.workload, rep.mapping,
            input_sparsity=(dict(rep.input_sparsity)
                            if rep.input_sparsity else None),
            masks=dict(rep.masks) if rep.masks else None,
            profile=None, tile_cache=None)
        base_est = float(sum(oc.latency_cycles for _op, oc, _led in costed
                             if oc is not None))
        by_profile = {id(None): base_est}
        for pos in positions:
            prof = jobs[pos].profile
            est = by_profile.get(id(prof))
            if est is None:
                est = float(sum(
                    (oc.latency_cycles / eff
                     if (eff := prof.efficiency_for(op_class(op))) != 1.0
                     else oc.latency_cycles)
                    for op, oc, _led in costed if oc is not None))
                by_profile[id(prof)] = est
            out[pos] = est
    return out


def _stream_indices(space: PointSpace, indices: Sequence[int], *,
                    runner: SweepRunner, policy: SearchPolicy,
                    objectives, chunk: int, keep_rows: bool,
                    csv_path) -> StreamResult:
    return stream_grid((space.factory(i) for i in indices), runner=runner,
                       chunk=chunk, objectives=objectives,
                       metric=policy.metric, direction=policy.direction,
                       k=max(policy.population, 16), keep_rows=keep_rows,
                       csv_path=csv_path, total=len(indices))


def _search_halving(space: PointSpace, policy: SearchPolicy, *,
                    runner: SweepRunner, objectives, chunk: int,
                    keep_rows: bool, csv_path) -> SearchResult:
    keep = policy.budget if policy.budget is not None \
        else max(1, space.size // policy.eta)
    keep = min(keep, space.size)
    # rank every point on the cheap estimate, keeping only the current
    # top-`keep` in a bounded heap; (−est, −i) roots the worst kept
    # entry so ties promote the EARLIER index deterministically.
    # Estimates run through estimate_jobs in contiguous chunks: variant
    # neighbours share one costing pass, and the chunk bounds peak
    # memory on million-point spaces.
    hb = obs.heartbeat("explore.estimate", total=space.size)
    best: List[Tuple[Tuple[float, float], int]] = []
    for start in range(0, space.size, max(chunk, 1)):
        stop = min(start + max(chunk, 1), space.size)
        ests = estimate_jobs([space.factory(i).job
                              for i in range(start, stop)])
        for i, est in zip(range(start, stop), ests):
            entry = ((-est, -i), i)
            if len(best) < keep:
                heapq.heappush(best, entry)
            else:
                heapq.heappushpop(best, entry)
        hb.tick(stop, kept=len(best))
    survivors = sorted(i for _key, i in best)     # original grid order
    sr = _stream_indices(space, survivors, runner=runner, policy=policy,
                         objectives=objectives, chunk=chunk,
                         keep_rows=keep_rows, csv_path=csv_path)
    return SearchResult(front_rows=sr.front_rows, topk_rows=sr.topk_rows,
                        stats=sr.stats, points=sr.points, rows=sr.rows,
                        estimated=space.size, policy=policy)


def _search_evolve(space: PointSpace, policy: SearchPolicy, *,
                   runner: SweepRunner, objectives, chunk: int,
                   keep_rows: bool, csv_path) -> SearchResult:
    budget = policy.budget if policy.budget is not None \
        else 4 * policy.population
    budget = min(budget, space.size)
    rng = np.random.default_rng(policy.seed)
    shape = space.shape or (space.size,)
    sign = 1.0 if policy.direction == "min" else -1.0
    worst = float("inf")

    front = ParetoFront(objectives)
    topk = StreamingTopK(policy.metric, max(policy.population, 16),
                         direction=policy.direction)
    stats = RunStats(workers=runner.workers)
    kept: List[Dict] = []
    checked: set = set()
    fitness: Dict[int, float] = {}
    hb = obs.heartbeat("explore.search", total=budget)

    def evaluate(indices: List[int]) -> None:
        nonlocal stats
        new = sorted(i for i in set(indices) if i not in fitness)
        if not new:
            return
        points = [space.factory(i) for i in new]
        _preflight_points(points, checked, "explore.search")
        jobs = []
        for p in points:
            jobs.append(p.job)
            jobs.append(p.dense)
        reports = runner.run(jobs)
        rows = _assemble_rows(points, reports)
        for i, row in zip(new, rows):
            row["space_index"] = i
            val = row.get(policy.metric)
            fitness[i] = (sign * float(val)
                          if val is not None and not row.get("failed")
                          else worst)
            front.add(row)
            topk.add(row)
            if keep_rows:
                kept.append(row)
        stats = stats.merge(runner.last_stats)
        hb.tick(len(fitness), front=len(front))

    pop = min(policy.population, space.size, budget)
    # seeded init: distinct random indices, evaluated in sorted order (as
    # Python ints: a row's space_index goes into the CLI's JSON)
    evaluate([int(i) for i in rng.choice(space.size, size=pop, replace=False)])

    while len(fitness) < budget:
        ranked = sorted(fitness, key=lambda i: (fitness[i], i))
        parents = ranked[:max(1, len(ranked) // 2)]
        children: List[int] = []
        tries = 0
        want = min(pop, budget - len(fitness))
        while len(children) < want and tries < 50 * want:
            tries += 1
            base = parents[int(rng.integers(len(parents)))]
            coords = list(space.coords(base))
            axis = int(rng.integers(len(shape)))
            step = 1 if rng.random() < 0.5 else -1
            coords[axis] = min(shape[axis] - 1, max(0, coords[axis] + step))
            child = space.index(coords)
            if child not in fitness and child not in children:
                children.append(child)
        # stagnation: refill with random immigrants so the budget is
        # always spent exploring rather than spinning
        while len(children) < want:
            cand = int(rng.integers(space.size))
            if cand not in fitness and cand not in children:
                children.append(cand)
            elif len(fitness) + len(children) >= space.size:
                break
        if not children:
            break
        evaluate(children)

    return SearchResult(front_rows=front.front(), topk_rows=topk.best(),
                        stats=stats, points=len(fitness), rows=kept,
                        estimated=0, policy=policy)


def run_search(space: PointSpace, policy: SearchPolicy, *,
               runner: SweepRunner,
               objectives: Sequence[Tuple[str, str]] = DEFAULT_OBJECTIVES,
               chunk: int = 4096,
               keep_rows: bool = False,
               csv_path=None) -> SearchResult:
    """Walk ``space`` under ``policy``; returns a :class:`SearchResult`
    whose ``front_rows``/``topk_rows`` summarise every fully evaluated
    point (rows retained only with ``keep_rows``)."""
    with obs.span("explore.search", kind=policy.kind, size=space.size,
                  budget=policy.budget or 0, seed=policy.seed):
        if policy.kind == "halving":
            return _search_halving(space, policy, runner=runner,
                                   objectives=objectives, chunk=chunk,
                                   keep_rows=keep_rows, csv_path=csv_path)
        if policy.kind == "evolve":
            return _search_evolve(space, policy, runner=runner,
                                  objectives=objectives, chunk=chunk,
                                  keep_rows=keep_rows, csv_path=csv_path)
        indices = range(space.size if policy.budget is None
                        else min(policy.budget, space.size))
        sr = _stream_indices(space, list(indices), runner=runner,
                             policy=policy, objectives=objectives,
                             chunk=chunk, keep_rows=keep_rows,
                             csv_path=csv_path)
        return SearchResult(front_rows=sr.front_rows,
                            topk_rows=sr.topk_rows, stats=sr.stats,
                            points=sr.points, rows=sr.rows, estimated=0,
                            policy=policy)
