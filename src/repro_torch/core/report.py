"""Cost report dataclasses produced by the CIMinus simulator.

Copy of ``repro.core.report``: the port never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from .schedule import ScheduledOp, ScheduleResult

__all__ = ["OpCost", "CostReport"]


@dataclasses.dataclass
class OpCost:
    name: str
    kind: str
    latency_cycles: float
    macs: int
    tiles: int
    waves: int
    utilization: float
    index_bits: int
    occupancy: float
    # scheduling layer (repro.core.schedule): the op's resident band
    # footprint (bands × duplication replicas), its per-wave weight-load
    # cycles, the macros those bands occupy (count + org fraction — the
    # partitioned scheduler's demand, computed once at costing time),
    # and its placement in the resolved schedule (cycles within one
    # invocation; for serial policies starts are simply cumulative).
    bands: int = 0
    load_cycles: float = 0.0
    macros: int = 0
    macro_share: float = 0.0
    start_cycle: float = 0.0
    end_cycle: float = 0.0


@dataclasses.dataclass
class CostReport:
    """System-level CIMinus output: overall latency + energy breakdown."""

    arch: str
    workload: str
    mapping: str
    latency_cycles: float
    latency_ms: float
    energy_pj: Dict[str, float]
    total_energy_uj: float
    utilization: float
    op_costs: List[OpCost]
    index_storage_bits: int
    index_capacity_ok: bool
    # Resolved multi-macro schedule (None for the retained pre-scheduler
    # reference path): per-op start/end cycles, critical path, macro
    # shares, resident/preload accounting.  ``latency_cycles`` above is
    # its ``total_cycles``.
    schedule: Optional[ScheduleResult] = None

    # -- views ---------------------------------------------------------------
    def energy_shares(self) -> Dict[str, float]:
        tot = max(sum(self.energy_pj.values()), 1e-12)
        return {k: v / tot for k, v in self.energy_pj.items() if v > 0}

    def grouped_energy(self) -> Dict[str, float]:
        """Power-breakdown groups used in the paper's Fig. 6(c)."""
        groups = {"cim_macro": 0.0, "buffers": 0.0, "pre_post": 0.0,
                  "sparsity": 0.0, "static": 0.0}
        for k, v in self.energy_pj.items():
            if k in ("cim_array", "adder_tree", "shift_add", "accumulator",
                     "local_buf"):
                groups["cim_macro"] += v
            elif k.endswith("_buf") or k == "global_buf":
                groups["buffers"] += v
            elif k in ("pre_proc", "post_proc"):
                groups["pre_post"] += v
            elif k in ("mux_index", "sparse_accum", "zero_detect", "index_mem"):
                groups["sparsity"] += v
            elif k == "static":
                groups["static"] += v
        return groups

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "CostReport":
        """Rebuild a report from :meth:`to_dict` output (e.g. a JSON
        artifact handed to ``python -m repro.obs timeline``)."""
        d = dict(d)
        d["op_costs"] = [OpCost(**oc) for oc in d.get("op_costs", [])]
        sched = d.get("schedule")
        if sched is not None:
            sched = dict(sched)
            sched["ops"] = [ScheduledOp(**so) for so in sched.get("ops", [])]
            d["schedule"] = ScheduleResult(**sched)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def summary(self) -> str:
        g = self.grouped_energy()
        sched = ""
        sched_line = ""
        if self.schedule is not None:
            s = self.schedule
            if s.policy != "monolithic" or s.invocations != 1:
                sched = f"/{s.policy}x{s.invocations}"
            sched_line = (
                f"\n  schedule[{s.policy}]: "
                f"critical-path={s.critical_path_cycles:.0f} cyc "
                f"({s.critical_path_cycles / max(s.makespan_cycles, 1e-12):.0%}"
                f" of makespan), "
                f"macro-util={s.macro_time_utilization():.1%}, "
                f"concurrency={s.concurrency:.2f}x")
        return (f"{self.workload} on {self.arch} [{self.mapping}{sched}]: "
                f"{self.latency_ms:.3f} ms, {self.total_energy_uj:.2f} uJ, "
                f"util={self.utilization:.2%}, "
                f"idx={self.index_storage_bits/8/1024:.1f} KiB, "
                f"E[macro/buf/prepost/sparse/static]="
                f"{g['cim_macro']:.2e}/{g['buffers']:.2e}/{g['pre_post']:.2e}/"
                f"{g['sparsity']:.2e}/{g['static']:.2e} pJ" + sched_line)
