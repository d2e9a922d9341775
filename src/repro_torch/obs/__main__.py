"""``python -m repro_torch.obs`` — observability CLI.

Copy of ``python -m repro.obs``: the port never imports the JAX package.

Subcommands:

* ``timeline`` — simulate a model (or load a ``CostReport`` JSON) under
  a scheduling policy and export the schedule as Chrome-trace JSON for
  chrome://tracing / https://ui.perfetto.dev::

      python -m repro_torch.obs timeline --model resnet18 --policy partitioned \
          --out resnet18_partitioned.json

* ``energy`` — per-component energy attribution table (+ CSV/JSON
  artifacts) for one simulation or a report file::

      python -m repro_torch.obs energy --model resnet18 --ratio 0.8 \
          --csv energy_components.csv

* ``report`` — summarise a recorded trace directory (manifest, sweep
  runs, heartbeats, counters)::

      python -m repro_torch.obs report obs_runs/run-.../

* ``check`` — schema-validate an exported Chrome-trace JSON; exits non-zero on problems::

      python -m repro_torch.obs check resnet18_partitioned.json
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter as _Counter
from pathlib import Path
from typing import List, Optional

from ..core.report import CostReport
from .core import iter_runs, read_events, read_manifest
from .energy import energy_table, write_energy_csv, write_energy_json
from .timeline import check_chrome_trace, chrome_trace, write_chrome_trace


def _build_report(args) -> CostReport:
    """Load ``--report`` JSON, or simulate the named model fresh."""
    if args.report:
        return CostReport.from_dict(json.loads(Path(args.report).read_text()))
    from ..core import MODEL_BUILDERS, TABLE_II_PATTERNS, usecase_arch
    from ..core.costmodel import simulate
    from ..core.mapping import default_mapping
    from ..core.presets import PRESET_ARCHS
    from ..core.schedule import SchedulePolicy
    arch = (PRESET_ARCHS[args.arch]() if args.arch
            else usecase_arch(args.macros))
    wl = MODEL_BUILDERS[args.model](args.img)
    if args.ratio is not None:
        pats = TABLE_II_PATTERNS(args.ratio, c_in=16)
        if args.pattern not in pats:
            raise SystemExit(f"unknown pattern {args.pattern!r}; choose "
                             f"from {sorted(pats)}")
        wl = wl.set_sparsity(pats[args.pattern])
    sched = SchedulePolicy(policy=args.policy,
                           invocations=args.invocations)
    return simulate(arch, wl, default_mapping(arch), schedule=sched)


def _add_model_args(sp: argparse.ArgumentParser) -> None:
    sp.add_argument("--report", default=None, metavar="FILE",
                    help="CostReport JSON (CostReport.to_json output) "
                         "instead of simulating")
    sp.add_argument("--model", default="resnet18",
                    help="workload model to simulate (default resnet18)")
    sp.add_argument("--img", type=int, default=32)
    sp.add_argument("--arch", default=None,
                    help="preset architecture name (default: use-case "
                         "arch with --macros macros)")
    sp.add_argument("--macros", type=int, default=16)
    sp.add_argument("--policy", default="partitioned",
                    choices=("monolithic", "partitioned", "resident"))
    sp.add_argument("--invocations", type=int, default=1)
    sp.add_argument("--ratio", type=float, default=None,
                    help="apply a Table-II sparsity pattern at this ratio")
    sp.add_argument("--pattern", default="row-block",
                    help="Table-II pattern name for --ratio")


def _cmd_timeline(args) -> int:
    rep = _build_report(args)
    doc = chrome_trace(rep)
    out = args.out or (f"{rep.workload}_{doc['otherData']['policy']}"
                       ".trace.json")
    write_chrome_trace(rep, out)
    meta = doc["otherData"]
    print(f"wrote {len(doc['traceEvents'])} events to {out}")
    print(f"  {meta['workload']} on {meta['arch']} [{meta['policy']}]: "
          f"{meta['n_macros']} macro tracks, "
          f"makespan {meta['makespan_cycles']:.0f} cyc, "
          f"critical path {meta['critical_path_cycles']:.0f} cyc, "
          f"macro-util {meta['macro_time_utilization']:.1%}, "
          f"concurrency {meta['concurrency']:.2f}x")
    print("  open in chrome://tracing or https://ui.perfetto.dev")
    return 0


def _cmd_energy(args) -> int:
    rep = _build_report(args)
    print(energy_table(rep))
    if args.csv:
        write_energy_csv([rep], args.csv)
        print(f"wrote component rows to {args.csv}")
    if args.json:
        write_energy_json([rep], args.json)
        print(f"wrote component rows to {args.json}")
    return 0


def _cmd_report(args) -> int:
    trace_dir = Path(args.trace_dir)
    manifest = read_manifest(trace_dir)
    if manifest is None:
        print(f"error: no manifest.json under {trace_dir}", file=sys.stderr)
        return 1
    print(f"run {manifest['run_id']} (obs schema "
          f"{manifest.get('obs_schema')}), argv: "
          f"{' '.join(manifest.get('argv', []))}")
    events = read_events(trace_dir)
    kinds = _Counter((r.get("type"), r.get("name")) for r in events)
    pids = {r.get("pid") for r in events}
    print(f"{len(events)} records from {len(pids)} process(es)")
    for (typ, name), n in sorted(kinds.items(),
                                 key=lambda kv: (-kv[1], str(kv[0]))):
        print(f"  {n:>6}  {typ:<8} {name}")
    runs = list(iter_runs(trace_dir))
    if runs:
        print(f"sweep runs ({len(runs)}):")
        for r in runs:
            print(f"  requested={r.get('requested')} "
                  f"unique={r.get('unique')} "
                  f"evaluated={r.get('evaluated')} "
                  f"cache_hits={r.get('cache_hits')} "
                  f"workers={r.get('workers')} "
                  f"wall_s={r.get('wall_s')}")
    beats = [r for r in events if str(r.get("name", "")).endswith(".heartbeat")]
    if beats:
        last = beats[-1]["attrs"]
        print(f"last heartbeat: {last.get('done')}/{last.get('total')} "
              f"@ {last.get('points_per_s')} points/s")
    return 0


def _cmd_check(args) -> int:
    doc = json.loads(Path(args.trace_json).read_text())
    problems = check_chrome_trace(doc)
    if problems:
        for p in problems:
            print(f"FAIL: {p}", file=sys.stderr)
        return 1
    n = len([e for e in doc["traceEvents"] if e.get("ph") == "X"])
    print(f"ok: {args.trace_json} is a loadable Chrome trace "
          f"({n} complete events)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("timeline", help="export a schedule as Chrome trace")
    _add_model_args(sp)
    sp.add_argument("--out", default=None, metavar="FILE")
    sp.set_defaults(fn=_cmd_timeline)

    sp = sub.add_parser("energy", help="per-component energy attribution")
    _add_model_args(sp)
    sp.add_argument("--csv", default=None, metavar="FILE")
    sp.add_argument("--json", default=None, metavar="FILE")
    sp.set_defaults(fn=_cmd_energy)

    sp = sub.add_parser("report", help="summarise a recorded trace dir")
    sp.add_argument("trace_dir")
    sp.set_defaults(fn=_cmd_report)

    sp = sub.add_parser("check", help="schema-validate a Chrome trace JSON")
    sp.add_argument("trace_json")
    sp.set_defaults(fn=_cmd_check)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
