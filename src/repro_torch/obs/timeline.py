"""Schedule → Chrome-trace/Perfetto timeline export.

Copy of ``repro.obs.timeline``: the port never imports the JAX package.

Turns a :class:`~repro_torch.core.report.CostReport` carrying a resolved
:class:`~repro_torch.core.schedule.ScheduleResult` into Chrome Trace Event
Format JSON (``{"traceEvents": [...]}``) that loads directly in
``chrome://tracing`` or https://ui.perfetto.dev.

Track layout (one process per report):

* ``tid 0 .. n_macros-1`` — one track per **macro**.  A scheduled op
  occupying ``k`` macros emits one ``X`` (complete) event on each of its
  ``k`` lanes, so monolithic serialisation, partitioned overlap on
  disjoint macro subsets, and idle macros are all directly visible.
* ``tid n_macros`` — the post-processing unit (ops with zero macro
  demand: pooling/elementwise on the shared post unit).
* ``tid n_macros+1`` — the critical path: the DAG's longest dependency
  chain re-drawn as one lane, the latency floor no allocation beats.

Lane assignment replays the scheduler's allocation deterministically:
ops sorted by (start cycle, DAG insertion index), each taking the
lowest-numbered free macro lanes; lanes free at the occupant's end
cycle.  The scheduler admitted every op against the same macro budget,
so the replay never runs out of lanes.

Timestamps are microseconds (the Chrome trace unit), converted from
cycles via the report's own ``latency_ms / latency_cycles`` ratio (the
arch clock), falling back to 1 ns/cycle when the report is zero-length.
"""
from __future__ import annotations

import heapq
import json
from pathlib import Path
from typing import Dict, List, Optional, Union

from ..core.report import CostReport
from ..core.schedule import ScheduleResult

__all__ = ["chrome_trace", "write_chrome_trace", "check_chrome_trace"]


def _ns_per_cycle(report: CostReport) -> float:
    if report.latency_cycles > 0 and report.latency_ms > 0:
        return report.latency_ms * 1e6 / report.latency_cycles
    return 1.0


def _infer_n_macros(sched: ScheduleResult) -> int:
    """Recover the organisation's macro count from any op with a macro
    share (``macro_share == macros / n_macros`` exactly, by
    construction in the scheduler)."""
    for op in sched.ops:
        if op.macros > 0 and op.macro_share > 0:
            return max(1, round(op.macros / op.macro_share))
    return 1


def _assign_lanes(sched: ScheduleResult, n_macros: int) -> Dict[str, List[int]]:
    """Replay macro allocation: op name → occupied macro lane ids."""
    order = [op for _, op in sorted(
        ((i, op) for i, op in enumerate(sched.ops) if op.macros > 0),
        key=lambda t: (t[1].start, t[0]))]
    free = list(range(n_macros))
    heapq.heapify(free)
    running: List[tuple] = []            # (end, [lanes])
    lanes: Dict[str, List[int]] = {}
    for op in order:
        while running and running[0][0] <= op.start:
            _, done = heapq.heappop(running)
            for lane in done:
                heapq.heappush(free, lane)
        take = [heapq.heappop(free) for _ in range(min(op.macros, len(free)))]
        lanes[op.name] = take
        heapq.heappush(running, (op.end, take))
    return lanes


def chrome_trace(report: CostReport, *,
                 title: Optional[str] = None) -> Dict:
    """Chrome Trace Event Format dict for ``report.schedule``.

    Raises ``ValueError`` when the report carries no schedule (the
    retained pre-scheduler reference path)."""
    sched = report.schedule
    if sched is None:
        raise ValueError(
            f"report for {report.workload!r} has no schedule; run "
            f"simulate() (not simulate_reference) to get one")
    n_macros = _infer_n_macros(sched)
    ns_cycle = _ns_per_cycle(report)
    us = ns_cycle / 1000.0               # cycles → microseconds

    name = title or (f"{report.workload} on {report.arch} "
                     f"[{sched.policy}]")
    events: List[Dict] = [
        {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
         "args": {"name": name}},
    ]
    for lane in range(n_macros):
        events.append({"ph": "M", "pid": 0, "tid": lane,
                       "name": "thread_name",
                       "args": {"name": f"macro {lane}"}})
    post_tid, cp_tid = n_macros, n_macros + 1
    events.append({"ph": "M", "pid": 0, "tid": post_tid,
                   "name": "thread_name", "args": {"name": "post-proc"}})
    events.append({"ph": "M", "pid": 0, "tid": cp_tid,
                   "name": "thread_name", "args": {"name": "critical path"}})

    lanes = _assign_lanes(sched, n_macros)
    for op in sched.ops:
        if op.end <= op.start:           # zero-length (out-of-scope) ops
            continue
        args = {"macros": op.macros,
                "macro_share": round(op.macro_share, 6),
                "start_cycle": op.start, "end_cycle": op.end}
        tids = lanes.get(op.name, [post_tid])
        for tid in tids:
            events.append({"ph": "X", "pid": 0, "tid": tid,
                           "name": op.name, "cat": "op",
                           "ts": op.start * us,
                           "dur": (op.end - op.start) * us,
                           "args": args})

    on_cp = set(sched.critical_path)
    for op in sched.ops:
        if op.name in on_cp and op.end > op.start:
            events.append({"ph": "X", "pid": 0, "tid": cp_tid,
                           "name": op.name, "cat": "critical-path",
                           "ts": op.start * us,
                           "dur": (op.end - op.start) * us,
                           "args": {"critical_path_cycles":
                                    sched.critical_path_cycles}})

    return {
        "traceEvents": events,
        "displayTimeUnit": "ns",
        "otherData": {
            "workload": report.workload,
            "arch": report.arch,
            "mapping": report.mapping,
            "policy": sched.policy,
            "invocations": sched.invocations,
            "n_macros": n_macros,
            "makespan_cycles": sched.makespan_cycles,
            "critical_path_cycles": sched.critical_path_cycles,
            "macro_time_utilization": sched.macro_time_utilization(),
            "concurrency": sched.concurrency,
            "ns_per_cycle": ns_cycle,
        },
    }


def write_chrome_trace(report: CostReport, path: Union[str, Path], *,
                       title: Optional[str] = None) -> Path:
    path = Path(path)
    path.write_text(json.dumps(chrome_trace(report, title=title)) + "\n")
    return path


def check_chrome_trace(doc: Dict) -> List[str]:
    """Schema check for an exported trace (the CI obs-smoke gate).

    Returns a list of problems; empty means the document is a loadable
    Chrome trace with at least one op event."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    x_events = [e for e in events if e.get("ph") == "X"]
    if not x_events:
        problems.append("no complete ('X') events")
    for i, e in enumerate(events):
        if "ph" not in e or "name" not in e:
            problems.append(f"event {i}: missing ph/name")
            continue
        if e["ph"] == "X":
            for fld in ("ts", "dur", "pid", "tid"):
                if fld not in e:
                    problems.append(f"event {i} ({e['name']}): missing {fld}")
            if e.get("dur", 0) < 0:
                problems.append(f"event {i} ({e['name']}): negative dur")
    op_tids = {e["tid"] for e in x_events if e.get("cat") == "op"}
    n_macros = doc.get("otherData", {}).get("n_macros")
    if n_macros and n_macros > 1 and len(op_tids) < 2:
        problems.append(
            f"{n_macros} macro tracks declared but ops occupy "
            f"{len(op_tids)} track(s)")
    return problems
