"""Per-component energy attribution: tables and CSV/JSON artifacts.

Copy of ``repro.obs.energy``: the port never imports the JAX package.

The paper's headline analysis — "in-depth energy consumption analysis
at the level of individual components" — as a first-class artifact
instead of ad-hoc ``energy_pj`` dict spelunking.  Components are the
simulator's energy ledger keys (cim_array, adder_tree, …); groups are
the paper's Fig. 6(c) power-breakdown buckets, classified by the same
rules as :meth:`~repro_torch.core.report.CostReport.grouped_energy` so the
two views always partition identically.
"""
from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

from ..core.report import CostReport

__all__ = ["component_group", "component_rows", "energy_table",
           "write_energy_csv", "append_energy_csv", "write_energy_json"]

GROUPS = ("cim_macro", "buffers", "pre_post", "sparsity", "static")


def component_group(component: str) -> str:
    """Fig. 6(c) group for one energy-ledger component — the single
    classification shared with ``CostReport.grouped_energy``."""
    if component in ("cim_array", "adder_tree", "shift_add", "accumulator",
                     "local_buf"):
        return "cim_macro"
    if component.endswith("_buf") or component == "global_buf":
        return "buffers"
    if component in ("pre_proc", "post_proc"):
        return "pre_post"
    if component in ("mux_index", "sparse_accum", "zero_detect", "index_mem"):
        return "sparsity"
    if component == "static":
        return "static"
    return "other"


def component_rows(report: CostReport,
                   meta: Optional[Dict] = None) -> List[Dict]:
    """One row per energy component: name, group, pJ, share of total.

    ``meta`` (grid-point coordinates: pattern, ratio, mapping, …) is
    prefixed onto every row so rows from a whole sweep concatenate into
    one long-format CSV."""
    total = max(sum(report.energy_pj.values()), 1e-12)
    rows: List[Dict] = []
    for comp, pj in report.energy_pj.items():
        row = dict(meta) if meta else {}
        row.update({
            "workload": report.workload,
            "arch": report.arch,
            "mapping": report.mapping,
            "component": comp,
            "group": component_group(comp),
            "energy_pj": pj,
            "share": pj / total,
            "latency_ms": report.latency_ms,
        })
        rows.append(row)
    return rows


def energy_table(report: CostReport) -> str:
    """Human-readable per-component breakdown with group subtotals."""
    total = max(sum(report.energy_pj.values()), 1e-12)
    lines = [f"{report.workload} on {report.arch} [{report.mapping}] — "
             f"{report.total_energy_uj:.3f} uJ, {report.latency_ms:.3f} ms",
             f"  {'component':<14}{'group':<11}{'energy_pj':>14}{'share':>9}"]
    by_group: Dict[str, float] = {}
    for comp, pj in sorted(report.energy_pj.items(),
                           key=lambda kv: -kv[1]):
        g = component_group(comp)
        by_group[g] = by_group.get(g, 0.0) + pj
        lines.append(f"  {comp:<14}{g:<11}{pj:>14.3e}{pj / total:>8.1%}")
    lines.append(f"  {'-' * 46}")
    for g, pj in sorted(by_group.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {'':<14}{g:<11}{pj:>14.3e}{pj / total:>8.1%}")
    return "\n".join(lines)


def _collect(rows_or_reports: Sequence) -> List[Dict]:
    rows: List[Dict] = []
    for item in rows_or_reports:
        if isinstance(item, CostReport):
            rows.extend(component_rows(item))
        else:
            rows.append(item)
    return rows


def write_energy_csv(rows_or_reports: Sequence,
                     path: Union[str, Path]) -> Path:
    """Write long-format component rows (or reports, expanded) to CSV."""
    rows = _collect(rows_or_reports)
    path = Path(path)
    fieldnames: List[str] = []
    for r in rows:
        for k in r:
            if k not in fieldnames:
                fieldnames.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        w.writerows(rows)
    return path


def append_energy_csv(rows_or_reports: Sequence,
                      path: Union[str, Path]) -> Path:
    """Append component rows to a (possibly existing) long-format CSV.

    Used by the sweep hook so every ``run_grid`` call of a recorded run
    lands in one ``energy_components.csv`` artifact.  The first write
    fixes the header; later rows are projected onto it (missing fields
    empty, unknown fields dropped)."""
    rows = _collect(rows_or_reports)
    if not rows:
        return Path(path)
    path = Path(path)
    if path.exists() and path.stat().st_size > 0:
        with open(path, newline="") as f:
            fieldnames = next(csv.reader(f))
        write_header = False
    else:
        fieldnames = []
        for r in rows:
            for k in r:
                if k not in fieldnames:
                    fieldnames.append(k)
        write_header = True
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames,
                           extrasaction="ignore", restval="")
        if write_header:
            w.writeheader()
        w.writerows(rows)
    return path


def write_energy_json(rows_or_reports: Sequence,
                      path: Union[str, Path]) -> Path:
    path = Path(path)
    path.write_text(json.dumps({"rows": _collect(rows_or_reports)},
                               indent=1) + "\n")
    return path
