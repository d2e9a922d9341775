"""Multi-macro DAG scheduling layer (paper §IV, use-case 2).

Copy of ``repro.core.schedule``: the port never imports the JAX package.

The paper's pitch is that sparse-DNN cost modeling must account for "the
flexibility of a multi-macro CIM structure"; this module makes that
flexibility a first-class, sweepable modeling axis sitting between the
workload DAG and the per-op cost kernels.  The cost model prices each op
in isolation (:mod:`repro.core.costmodel`); a :class:`SchedulePolicy`
decides how those ops share the macro organisation **in time**:

* ``"monolithic"`` — the historical behaviour: every op maps onto the
  whole organisation and ops serialise in DAG (insertion) order.  Total
  latency is the plain sum of per-op latencies, bit-for-bit identical to
  the pre-scheduler simulator (asserted by ``tests/test_schedule.py``
  against :func:`repro.core.costmodel.simulate_reference`).
* ``"partitioned"`` — a greedy list scheduler over the DAG: independent
  ready ops run concurrently on **disjoint macro subsets** (ResNet
  shortcut convs, attention Q/K/V projections, MoE experts overlap in
  time).  Each op's macro demand is its *actual* band footprint — an op
  occupying 30 of 128 band slots never benefited from the idle macros,
  so its per-op latency and access counts are unchanged and total
  dynamic energy is identical to monolithic (the accounting identity);
  only the time arrangement (and therefore static energy) changes.
* ``"resident"`` — when the aggregate band demand of every MVM op fits
  the organisation, weights are pinned across the whole inference: load
  waves are paid once up-front (``preload_cycles``) and the steady-state
  per-op latency drops its load stage.  Combined with
  ``SchedulePolicy.invocations > 1`` (repeated DAG executions: decode
  steps, batched re-inference) the preload and the weight-buffer traffic
  amortise while compute scales — the classic weight-stationary CIM
  win.  Workloads that do not fit fall back to monolithic timing
  (``ScheduleResult.resident`` is False).

The scheduler consumes :class:`OpExec` records (built by the cost model
from its per-op :class:`~repro.core.report.OpCost`) so this module stays
free of energy/accounting concerns and imports nothing but the workload
DAG utilities (:meth:`~repro.core.workload.Workload.topo_order`).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

from .workload import Workload

__all__ = [
    "POLICIES", "SchedulePolicy", "OpExec", "ScheduledOp",
    "ScheduleResult", "build_schedule", "critical_path",
]

POLICIES = ("monolithic", "partitioned", "resident")


@dataclasses.dataclass(frozen=True)
class SchedulePolicy:
    """How the workload DAG shares the macro organisation.

    ``policy``: one of :data:`POLICIES` (see module docstring).
    ``invocations``: how many times the whole DAG executes (autoregressive
    decode steps, repeated batches).  Latency and dynamic energy scale
    linearly for every policy; under ``"resident"`` the weight
    preload/traffic is paid once and amortised across invocations.
    """

    policy: str = "monolithic"
    invocations: int = 1

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown schedule policy {self.policy!r}; "
                f"choose from {POLICIES}")
        if self.invocations < 1:
            raise ValueError(
                f"invocations must be >= 1, got {self.invocations}")


@dataclasses.dataclass(frozen=True)
class OpExec:
    """Scheduler-facing execution profile of one op.

    Built by the cost model from the op's :class:`OpCost`: how long it
    runs and which resources it occupies.  ``duration`` is the full
    per-invocation pipeline latency (loads included); ``steady`` is the
    same latency with weight loads hoisted (what a resident invocation
    costs); ``macros`` is the op's macro demand — the number of macros
    its bands (× duplication replicas) actually occupy, 0 for ops that
    run on the post-processing unit instead.
    """

    name: str
    duration: float
    steady: float = 0.0
    load_cycles: float = 0.0
    macros: int = 0
    bands: int = 0
    waves: int = 0
    uses_post: bool = False


@dataclasses.dataclass
class ScheduledOp:
    """Placement of one op in the schedule (cycles, one invocation)."""

    name: str
    start: float
    end: float
    macros: int
    macro_share: float


@dataclasses.dataclass
class ScheduleResult:
    """A fully resolved schedule for one (workload, arch, policy) triple.

    ``makespan_cycles`` covers one steady-state invocation;
    ``total_cycles`` = ``preload_cycles + invocations × makespan_cycles``
    and is what :class:`~repro.core.report.CostReport.latency_cycles`
    reports.  ``critical_path`` is the longest dependency chain through
    the DAG under the scheduled per-op durations — the latency floor no
    macro allocation can beat.  ``concurrency`` is the average
    parallelism achieved (Σ per-op durations / makespan; 1.0 for serial
    policies).
    """

    policy: str
    invocations: int
    makespan_cycles: float
    total_cycles: float
    preload_cycles: float
    resident: bool
    ops: List[ScheduledOp]
    critical_path: List[str]
    critical_path_cycles: float
    concurrency: float

    def op(self, name: str) -> ScheduledOp:
        for s in self.ops:
            if s.name == name:
                return s
        raise KeyError(name)

    def macro_time_utilization(self) -> float:
        """Fraction of the organisation's macro-time actually occupied:
        Σ(macro_share × op duration) / makespan.  1.0 would mean every
        macro busy for the whole invocation; serial policies on small
        ops sit far below.  0.0 for an empty/zero-length schedule."""
        if self.makespan_cycles <= 0:
            return 0.0
        busy = sum(s.macro_share * (s.end - s.start) for s in self.ops)
        return busy / self.makespan_cycles


def critical_path(workload: Workload,
                  durations: Dict[str, float]) -> Tuple[List[str], float]:
    """Longest dependency chain through the DAG.

    ``durations`` maps op name → cycles (missing names count as 0, e.g.
    ops outside the arch's ``eval_scope``).  Returns ``(path, cycles)``;
    ties break deterministically toward earlier-inserted ops.
    """
    order = workload.topo_order()
    dist: Dict[str, float] = {}
    pred: Dict[str, Optional[str]] = {}
    for name in order:
        best, best_pred = 0.0, None
        for inp in workload.nodes[name].inputs:
            if dist[inp] > best:
                best, best_pred = dist[inp], inp
        dist[name] = best + durations.get(name, 0.0)
        pred[name] = best_pred
    if not order:
        return [], 0.0
    end = max(order, key=lambda n: dist[n])
    path: List[str] = []
    cur: Optional[str] = end
    while cur is not None:
        path.append(cur)
        cur = pred[cur]
    path.reverse()
    return path, dist[end]


def _serial_walk(workload: Workload, execs: Dict[str, OpExec],
                 n_macros: int, *, steady: bool) -> Tuple[List[ScheduledOp],
                                                          float]:
    """Op-serial timeline in DAG insertion order.

    Accumulates left-to-right exactly like the pre-scheduler simulator's
    ``sum(latency for op in nodes)`` so the monolithic policy's makespan
    is bit-for-bit the historical total.
    """
    t = 0.0
    ops: List[ScheduledOp] = []
    for name in workload.nodes:
        ex = execs[name]
        dur = ex.steady if steady else ex.duration
        start = t
        t = t + dur
        share = ex.macros / n_macros if ex.macros else 0.0
        ops.append(ScheduledOp(name=name, start=start, end=t,
                               macros=ex.macros, macro_share=share))
    return ops, t


def _list_schedule(workload: Workload, execs: Dict[str, OpExec],
                   n_macros: int) -> Tuple[List[ScheduledOp], float]:
    """Greedy list scheduler: independent ready ops run concurrently on
    disjoint macro subsets; post-processing ops serialise on their (one)
    unit but overlap with CIM work.  Deterministic: ready ops start in
    DAG insertion order, completions break ties the same way."""
    idx = {name: i for i, name in enumerate(workload.nodes)}
    succ: Dict[str, List[str]] = {name: [] for name in workload.nodes}
    indeg: Dict[str, int] = {name: 0 for name in workload.nodes}
    workload.topo_order()                     # validates DAG (cycle check)
    for node in workload.nodes.values():
        for inp in node.inputs:
            succ[inp].append(node.name)
            indeg[node.name] += 1

    ready: List[Tuple[int, str]] = [
        (idx[n], n) for n in workload.nodes if indeg[n] == 0]
    heapq.heapify(ready)
    running: List[Tuple[float, int, str]] = []
    free = n_macros
    post_free = True
    t = 0.0
    placed: Dict[str, ScheduledOp] = {}

    def _finish(name: str) -> None:
        nonlocal free, post_free
        ex = execs[name]
        free += ex.macros
        if ex.uses_post:
            post_free = True
        for s in succ[name]:
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(ready, (idx[s], s))

    while ready or running:
        deferred: List[Tuple[int, str]] = []
        while ready:
            i, name = heapq.heappop(ready)
            ex = execs[name]
            if (ex.macros > free) or (ex.uses_post and not post_free):
                deferred.append((i, name))
                continue
            free -= ex.macros
            if ex.uses_post:
                post_free = False
            end = t + ex.duration
            share = ex.macros / n_macros if ex.macros else 0.0
            placed[name] = ScheduledOp(name=name, start=t, end=end,
                                       macros=ex.macros, macro_share=share)
            heapq.heappush(running, (end, i, name))
        for item in deferred:
            heapq.heappush(ready, item)
        if not running:
            if ready:      # every demand is capped at n_macros, so an
                # idle machine can always start the next ready op
                raise RuntimeError(
                    f"schedule deadlock in {workload.name!r}: "
                    f"{[n for _, n in ready]} cannot be placed")
            break
        end, _, name = heapq.heappop(running)
        t = end
        _finish(name)
        while running and running[0][0] == end:
            _, _, other = heapq.heappop(running)
            _finish(other)

    ops = [placed[name] for name in workload.nodes]
    makespan = max((s.end for s in ops), default=0.0)
    return ops, makespan


def build_schedule(workload: Workload, policy: SchedulePolicy,
                   execs: Dict[str, OpExec], *, n_macros: int,
                   band_slots: int) -> ScheduleResult:
    """Resolve ``policy`` into per-op start/end cycles and the totals.

    ``execs`` must cover every node of ``workload`` (ops outside the
    measured scope carry zero duration/demand and only convey
    dependencies).  ``band_slots`` is the organisation's total band
    capacity (``n_macros × rows/sub_rows``) the resident fit is checked
    against.
    """
    mvm = [ex for ex in execs.values() if ex.macros > 0]
    resident = False
    preload = 0.0
    if policy.policy == "partitioned":
        ops, makespan = _list_schedule(workload, execs, n_macros)
        durations = {name: execs[name].duration for name in workload.nodes}
    elif policy.policy == "resident":
        fits = (bool(mvm) and all(ex.waves <= 1 for ex in mvm)
                and sum(ex.bands for ex in mvm) <= band_slots)
        if fits:
            resident = True
            for name in workload.nodes:      # nodes order, like the walk
                preload += execs[name].load_cycles
            ops, makespan = _serial_walk(workload, execs, n_macros,
                                         steady=True)
            durations = {name: execs[name].steady for name in workload.nodes}
        else:
            ops, makespan = _serial_walk(workload, execs, n_macros,
                                         steady=False)
            durations = {name: execs[name].duration
                         for name in workload.nodes}
    else:                                    # monolithic
        ops, makespan = _serial_walk(workload, execs, n_macros, steady=False)
        durations = {name: execs[name].duration for name in workload.nodes}

    if policy.invocations == 1 and preload == 0.0:
        total = makespan                     # bit-exact monolithic total
    else:
        total = preload + policy.invocations * makespan
    cp_path, cp_cycles = critical_path(workload, durations)
    busy = sum(durations.values())
    concurrency = busy / makespan if makespan > 0 else 0.0
    return ScheduleResult(
        policy=policy.policy, invocations=policy.invocations,
        makespan_cycles=makespan, total_cycles=total,
        preload_cycles=preload, resident=resident, ops=ops,
        critical_path=cp_path, critical_path_cycles=cp_cycles,
        concurrency=concurrency)
