"""``python -m repro_torch.explore`` — run a named sweep from the command line.

Copy of ``python -m repro.explore``: the port never imports the JAX
package.  Its ``--workload traced:<config>`` captures the model with the
port's own :mod:`repro_torch.trace` (on ``meta`` tensors: no card, no
jax).

Named sweeps:

* ``sparsity`` — §VII-B: Table II patterns × sparsity ratios on one
  architecture (default: the 4-macro use-case arch, ResNet-50).
* ``mapping``  — §VII-C: mapping strategy × macro organisation
  (× rearrangement) on the 16-macro use-case arch.
* ``lm``       — lower one of the repo's LM configs to an MVM DAG and
  sweep Table II patterns × ratios over it.
* ``scale``    — a synthetic ratio × strategy × schedule lattice of
  ``--points`` points, generated lazily and streamed in ``--chunk``
  chunks: the million-point stress grid for the batched engine and the
  guided-search layer.

Examples::

    python -m repro_torch.explore sparsity --model resnet50 --ratios 0.7,0.8,0.9 \
        --workers 4 --cache-dir .cim_cache --csv sparsity.csv --pareto
    python -m repro_torch.explore mapping --model vgg16 --rearrange none,slice
    python -m repro_torch.explore lm --config llama3-8b --seq-len 64 --top-k 3

``--profile PATH`` (or ``--profile default``) reruns any sweep in
*calibrated* mode: every job carries the measured
:class:`repro_torch.calibrate.CalibrationProfile`, so rows are priced by
fitted peaks/efficiencies instead of the analytic assumptions.
``--diff-analytic`` additionally evaluates the analytic twin of every
row and prints the calibrated/analytic latency and energy ratios.

``--schedule POLICIES`` (comma list from {monolithic, partitioned,
resident}, or ``all``) reruns any sweep across multi-macro scheduling
policies (:mod:`repro_torch.core.schedule`) and adds a ``schedule`` column;
``--invocations N`` models N repeated DAG executions (decode steps /
batches) so the resident policy's weight-pinning amortisation shows up::

    python -m repro_torch.explore sparsity --model resnet18 --ratios 0.8 \
        --schedule all
    python -m repro_torch.explore lm --config llama3-8b --schedule \
        monolithic,resident --invocations 16

Fault tolerance: ``--run-dir DIR`` makes
the sweep durable — a crash-safe result store, a completed-keys
journal, and a ``sweep.json`` manifest land in DIR, every finished
point is committed immediately, and after any crash (even SIGKILL)
``--resume DIR`` replays the recorded invocation, re-evaluating only
the missing points.  ``--timeout`` / ``--retries`` / ``--backoff``
bound individual job failures; ``--degrade`` keeps going past
quarantined jobs (their rows are marked ``failed``) instead of exiting
non-zero.  ``--check-store DIR`` audits a run directory::

    python -m repro_torch.explore sparsity --model resnet50 --run-dir runs/s50 \
        --timeout 300 --retries 2
    python -m repro_torch.explore --resume runs/s50
    python -m repro_torch.explore --check-store runs/s50

Scale: ``--batch [N]`` turns on batched
evaluation — variant groups share one costing pass, tile grids
precompute in stacked reduceat passes; results stay bit-identical and
land under the same cache keys.  ``--search {exhaustive,halving,evolve}``
with ``--budget``/``--seed`` walks the ``scale`` lattice under a guided
:class:`repro_torch.explore.search.SearchPolicy` instead of exhaustively::

    python -m repro_torch.explore scale --points 1000000 --batch \
        --search halving --budget 2000 --run-dir runs/million
    python -m repro_torch.explore --resume runs/million   # re-evaluates nothing
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

from ..analysis import AnalysisError, preflight
from ..core import (TABLE_II_PATTERNS, MODEL_BUILDERS, FlexBlockSpec,
                    FullBlock, hybrid, lm_workload, usecase_arch)
from ..core.mapping import default_mapping
from ..core.presets import PRESET_ARCHS
from ..core.schedule import POLICIES, SchedulePolicy
from ..core.workload import Workload
from .cache import KeyJournal, ResultCache, ResultStore
from .job import CACHE_SCHEMA, ExploreJob
from .pareto import DEFAULT_OBJECTIVES
from .runner import SweepFailure, SweepRunner
from .search import (SEARCH_KINDS, PointSpace, SearchPolicy, SearchResult,
                     run_search)
from .sweeps import (GridPoint, SweepResult, mapping_sweep, sparsity_sweep)

_ROW_COLS = ("pattern", "ratio", "mapping", "org", "rearrange", "schedule",
             "latency_ms", "energy_uj", "utilization", "speedup",
             "energy_saving", "index_kib")


def _print_rows(rows: List[Dict], title: str) -> None:
    print(f"\n== {title} ({len(rows)} rows) ==")
    cols = [c for c in _ROW_COLS if any(c in r for r in rows)]
    print("  " + "  ".join(f"{c:>12}" for c in cols))
    for r in rows:
        cells = []
        for c in cols:
            v = r.get(c)
            if isinstance(v, float):
                cells.append(f"{v:>12.4f}")
            else:
                cells.append(f"{str(v):>12}")
        print("  " + "  ".join(cells))


_KEY_COLS = ("pattern", "ratio", "mapping", "org", "rearrange", "schedule")


def _print_diff(calibrated: List[Dict], analytic: List[Dict]) -> None:
    """Per-row calibrated-vs-analytic comparison (grids enumerate in the
    same order, so rows pair positionally; keys shown for readability)."""
    print(f"\n== calibrated vs analytic ({len(calibrated)} rows) ==")
    hdr = [c for c in _KEY_COLS if any(c in r for r in calibrated)]
    print("  " + "  ".join(f"{c:>10}" for c in hdr)
          + f"{'lat_ana_ms':>14}{'lat_cal_ms':>14}{'lat_ratio':>11}"
          + f"{'energy_ratio':>14}")
    for cal, ana in zip(calibrated, analytic):
        cells = [f"{str(cal.get(c)):>10}" for c in hdr]
        lr = cal["latency_ms"] / max(ana["latency_ms"], 1e-30)
        er = cal["energy_uj"] / max(ana["energy_uj"], 1e-30)
        print("  " + "  ".join(cells)
              + f"{ana['latency_ms']:>14.4f}{cal['latency_ms']:>14.4f}"
              + f"{lr:>11.3f}{er:>14.3f}")


def _finish(result: SweepResult, args: argparse.Namespace) -> int:
    _print_rows(result.rows, f"{args.sweep} sweep")
    if args.pareto:
        objs = [o for o in DEFAULT_OBJECTIVES
                if any(o[0] in r for r in result.rows)]
        _print_rows(result.pareto(objs),
                    "Pareto frontier (" + " / ".join(c for c, _ in objs) + ")")
    if args.top_k:
        _print_rows(result.top_k(args.metric, args.top_k),
                    f"top-{args.top_k} by {args.metric}")
    print(f"\nengine: {result.stats.stats_text()}")
    status = 0
    for path, write, what in ((args.csv, result.to_csv,
                               f"{len(result.rows)} rows"),
                              (args.json, result.to_json, "rows + stats")):
        if not path:
            continue
        try:
            write(path)
            print(f"wrote {what} to {path}")
        except OSError as e:
            print(f"error: could not write {path}: {e}", file=sys.stderr)
            status = 1
    return status


def _parse_floats(ap: argparse.ArgumentParser, text: str) -> List[float]:
    try:
        vals = [float(t) for t in text.split(",") if t]
    except ValueError:
        ap.error(f"--ratios expects comma-separated numbers, got {text!r}")
    if not vals:
        ap.error("--ratios must name at least one ratio")
    bad = [v for v in vals if not 0.0 < v < 1.0]
    if bad:
        ap.error(f"sparsity ratios must be in (0, 1), got {bad}")
    return vals


def _parse_orgs(ap: argparse.ArgumentParser, text: str) -> List[tuple]:
    orgs = []
    for t in text.split(","):
        if not t:
            continue
        try:
            r, c = t.lower().split("x")
            orgs.append((int(r), int(c)))
        except ValueError:
            ap.error(f"--orgs expects ROWSxCOLS entries like 4x4, got {t!r}")
    if not orgs:
        ap.error("--orgs must name at least one organisation")
    return orgs


def _runner(args: argparse.Namespace,
            journal: Optional[KeyJournal] = None) -> SweepRunner:
    # --run-dir supersedes --cache-dir: the run directory *is* the
    # durable tier (store + journal + manifest) for this invocation
    cache_path = args.run_dir or args.cache_dir
    cache = ResultCache(cache_path) if cache_path else None
    return SweepRunner(
        workers=args.workers, cache=cache,
        timeout_s=args.timeout, max_retries=args.retries,
        backoff_s=args.backoff,
        failure_mode="degrade" if args.degrade else "strict",
        journal=journal, batch_size=args.batch)


def _resume(run_dir: str) -> int:
    """Replay the invocation recorded in ``<run-dir>/sweep.json``; the
    store serves every completed point, so only missing ones evaluate."""
    manifest = Path(run_dir) / "sweep.json"
    if not manifest.exists():
        print(f"error: {manifest} not found — was this run started with "
              f"--run-dir?", file=sys.stderr)
        return 2
    try:
        saved = json.loads(manifest.read_text())
        argv = list(saved["argv"])
    except (OSError, json.JSONDecodeError, KeyError, TypeError) as e:
        print(f"error: could not read run manifest {manifest}: {e}",
              file=sys.stderr)
        return 2
    if saved.get("cache_schema") != CACHE_SCHEMA:
        print(f"warning: run recorded with cache_schema "
              f"{saved.get('cache_schema')}, this build keys with "
              f"{CACHE_SCHEMA} — every point will re-evaluate",
              file=sys.stderr)
    print(f"resuming: python -m repro_torch.explore {' '.join(argv)}",
          file=sys.stderr)
    return main(argv)


def _check_store(run_dir: str) -> int:
    """Audit a run directory: decode every store entry (dropping any
    that are corrupt) and cross-check the completed-keys journal."""
    try:
        store = ResultStore(run_dir)
    except Exception as e:
        print(f"error: could not open result store in {run_dir}: {e}",
              file=sys.stderr)
        return 1
    check = store.self_check()
    journal_keys = KeyJournal(Path(run_dir) / "journal.txt").keys()
    missing = sorted(journal_keys - store.keys())
    print(f"store [{check.backend}]: {check.entries} entries, "
          f"{check.readable} readable, {check.corrupt} corrupt (dropped)")
    print(f"journal: {len(journal_keys)} completed keys, "
          f"{len(missing)} journaled but absent from the store")
    if check.corrupt or missing:
        print(f"hint: rerun with --resume {run_dir} to re-evaluate the "
              f"missing points", file=sys.stderr)
        return 1
    print("store check: ok")
    return 0


_SCALE_STRATEGIES = ("spatial", "duplicate")
_SCALE_POLICIES = ("monolithic", "partitioned")


def _scale_workload() -> Workload:
    """The fixed DAG every scale point sweeps: two FC layers, small
    enough that a single point evaluates in sub-millisecond time."""
    w = Workload("scale")
    w.fc("fc1", 128, 128)
    w.fc("fc2", 128, 64, inputs=("fc1",))
    return w


def _scale_space(n_points: int, arch) -> PointSpace:
    """A lazily-generated ratio × strategy × schedule lattice of at
    least ``n_points`` points.

    The schedule axis is innermost so a point and its schedule variants
    are adjacent in flat-index order — they land in the same stream
    chunk and collapse into one batched costing pass.  The four dense
    baselines (strategy × policy) are shared by every ratio, so a
    million-point space evaluates exactly four baseline jobs.
    """
    inner = len(_SCALE_STRATEGIES) * len(_SCALE_POLICIES)
    n_ratios = max(1, -(-n_points // inner))
    shape = (n_ratios, len(_SCALE_STRATEGIES), len(_SCALE_POLICIES))
    mappings = {s: default_mapping(arch, s) for s in _SCALE_STRATEGIES}
    scheds = {p: SchedulePolicy(policy=p) for p in _SCALE_POLICIES}
    dense_wl = _scale_workload()
    dense_jobs = {
        (s, p): ExploreJob.dense(arch, dense_wl, mappings[s],
                                 schedule=scheds[p])
        for s in _SCALE_STRATEGIES for p in _SCALE_POLICIES}

    # One sparsified workload OBJECT per ratio, in a small LRU: a
    # point's schedule/strategy variants (and its revisits on resume or
    # promotion) must reuse the same object so batch keying's
    # shared-subform memo and estimate_jobs's identity grouping engage.
    # Content is deterministic either way; sharing is purely throughput.
    wl_lru: "OrderedDict[int, Workload]" = OrderedDict()

    def _ratio_wl(ri: int):
        wl = wl_lru.get(ri)
        if wl is None:
            ratio = 0.05 + 0.90 * (ri / max(1, n_ratios - 1))
            spec = FlexBlockSpec((FullBlock(16, 16, ratio),), name="full16")
            wl = _scale_workload().set_sparsity(spec)
            wl_lru[ri] = wl
            if len(wl_lru) > 4096:
                wl_lru.popitem(last=False)
        else:
            wl_lru.move_to_end(ri)
        return wl

    def factory(i: int) -> GridPoint:
        ri, rem = divmod(i, inner)
        si, pi = divmod(rem, len(_SCALE_POLICIES))
        ratio = 0.05 + 0.90 * (ri / max(1, n_ratios - 1))
        strat = _SCALE_STRATEGIES[si]
        pol = _SCALE_POLICIES[pi]
        job = ExploreJob.simulate(arch, _ratio_wl(ri), mappings[strat],
                                  schedule=scheds[pol])
        return GridPoint(job, dense_jobs[(strat, pol)], meta=(
            ("pattern", "full16"), ("ratio", round(ratio, 9)),
            ("schedule", pol)))

    return PointSpace(n_ratios * inner, factory, shape)


def _finish_stream(result: SearchResult, args: argparse.Namespace) -> int:
    est = f", {result.estimated} estimated" if result.estimated else ""
    print(f"\n== scale sweep: {result.points} points evaluated{est} ==")
    _print_rows(result.front_rows, "Pareto frontier")
    k = args.top_k or 5
    _print_rows(result.top_k(args.metric, k), f"top-{k} by {args.metric}")
    print(f"\nengine: {result.stats.stats_text()}")
    if args.csv:
        # rows streamed to the CSV during evaluation — report, don't rewrite
        print(f"wrote streamed rows to {args.csv}")
    if args.json:
        payload = json.dumps({"points": result.points,
                              "estimated": result.estimated,
                              "front": result.front_rows,
                              "topk": result.topk_rows,
                              "stats": result.stats.as_dict()}, indent=2)
        try:
            Path(args.json).write_text(payload + "\n")
            print(f"wrote front + top-k + stats to {args.json}")
        except OSError as e:
            print(f"error: could not write {args.json}: {e}",
                  file=sys.stderr)
            return 1
    return 0


def _run_scale(args: argparse.Namespace, ap: argparse.ArgumentParser,
               runner: SweepRunner) -> int:
    arch = PRESET_ARCHS[args.arch]() if args.arch else usecase_arch(4)
    space = _scale_space(args.points, arch)
    policy = SearchPolicy(kind=args.search or "exhaustive",
                          budget=args.budget, seed=args.seed,
                          metric=args.metric)
    print(f"scale lattice: {space.size} points {space.shape}, "
          f"search={policy.kind}"
          + (f", budget={policy.budget}" if policy.budget else ""),
          file=sys.stderr)
    try:
        result = run_search(space, policy, runner=runner, chunk=args.chunk,
                            csv_path=args.csv)
    except SweepFailure as e:
        print(f"error: {e}", file=sys.stderr)
        if args.run_dir:
            print(f"hint: `python -m repro_torch.explore --resume "
                  f"{args.run_dir}` retries only the failures",
                  file=sys.stderr)
        return 3
    return _finish_stream(result, args)


def _traced_wl_fn(ap: argparse.ArgumentParser, spec: str, seq_len: int):
    """Parse ``traced:<config>[:<step>]`` into a fresh-workload factory.

    The capture runs once, on ``meta`` tensors; every sweep evaluation
    gets a deep copy so per-job ``set_sparsity`` mutations never alias.
    The lowered DAG carries ``source_digest``, which
    :func:`job.canonical` folds into every content key.
    """
    parts = spec.split(":")
    if parts[0] != "traced" or len(parts) not in (2, 3) or not parts[1]:
        ap.error(f"--workload expects 'traced:<config>[:<step>]', "
                 f"got {spec!r}")
    step = parts[2] if len(parts) == 3 else "forward"
    from ..trace import traced_workload
    try:
        base = traced_workload(parts[1], step=step, seq_len=seq_len)
    except (KeyError, ValueError) as e:
        ap.error(f"--workload {spec!r}: {e}")
    import copy
    print(f"traced workload {base.name!r}: {len(base)} ops, "
          f"digest {base.source_digest[:16]}")
    return lambda: copy.deepcopy(base)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.explore",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("sweep", nargs="?", default=None,
                    choices=("sparsity", "mapping", "lm", "scale"))
    ap.add_argument("--model", choices=sorted(MODEL_BUILDERS),
                    default="resnet50", help="workload model (CNN sweeps)")
    ap.add_argument("--img", type=int, default=32,
                    help="input resolution for CNN models")
    ap.add_argument("--arch", choices=sorted(PRESET_ARCHS), default=None,
                    help="preset architecture (default per sweep)")
    ap.add_argument("--ratios", default="0.5,0.7,0.8,0.9",
                    help="comma-separated sparsity ratios")
    ap.add_argument("--spec-ratio", type=float, default=0.8,
                    help="overall ratio of the hybrid spec (mapping sweep)")
    ap.add_argument("--orgs", default="8x2,4x4,2x8",
                    help="macro organisations, e.g. 8x2,4x4")
    ap.add_argument("--strategies", default="spatial,duplicate")
    ap.add_argument("--rearrange", default="none",
                    help="comma list from {none,pad,slice}")
    ap.add_argument("--config", default="llama3-8b",
                    help="LM config name (lm sweep)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--workload", default=None, metavar="SPEC",
                    help="override the swept workload with a traced DAG: "
                         "'traced:<config>[:<step>]' lowers the config's "
                         "program captured on meta tensors (repro_torch."
                         "trace; step defaults to forward) instead of a "
                         "hand-built model — cached results are keyed by "
                         "the trace's content digest")
    ap.add_argument("--workers", type=int, default=None,
                    help="worker processes (default: one per CPU; 1 = serial)")
    ap.add_argument("--cache-dir", default=None,
                    help="on-disk result cache directory")
    ap.add_argument("--run-dir", default=None, metavar="DIR",
                    help="durable run directory: crash-safe result store, "
                         "completed-keys journal, and a sweep manifest that "
                         "--resume replays (supersedes --cache-dir)")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="replay the sweep recorded in DIR/sweep.json, "
                         "re-evaluating only points missing from its store")
    ap.add_argument("--check-store", default=None, metavar="DIR",
                    help="audit a run directory's store + journal and exit "
                         "(0 = consistent)")
    ap.add_argument("--timeout", type=float, default=None, metavar="S",
                    help="per-job wall-clock budget; a dispatch exceeding "
                         "it has its worker killed and is retried "
                         "(parallel runs only)")
    ap.add_argument("--retries", type=int, default=2, metavar="N",
                    help="extra dispatches a failing job gets before it "
                         "is quarantined (default 2)")
    ap.add_argument("--backoff", type=float, default=0.05, metavar="S",
                    help="base of the exponential retry backoff "
                         "(default 0.05)")
    ap.add_argument("--degrade", action="store_true",
                    help="keep going past quarantined jobs — their rows "
                         "are marked failed — instead of exiting non-zero")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--pareto", action="store_true",
                    help="print the Pareto frontier")
    ap.add_argument("--top-k", type=int, default=0, metavar="K",
                    help="print the top-K rows by --metric")
    ap.add_argument("--metric", default="latency_ms")
    ap.add_argument("--profile", default=None,
                    help="calibration profile JSON (or 'default'): run "
                         "the sweep in calibrated mode")
    ap.add_argument("--diff-analytic", action="store_true",
                    help="with --profile: also run the analytic twin of "
                         "every row and print the ratios")
    ap.add_argument("--obs", action="store_true",
                    help="record sweep telemetry (repro_torch.obs): run "
                         "manifest, live heartbeats on stderr, per-"
                         "component energy CSV — observational only, "
                         "rows and cache keys are unchanged")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="trace directory for --obs (default "
                         "obs_runs/<run-id>)")
    ap.add_argument("--batch", nargs="?", const=0, default=None, type=int,
                    metavar="N",
                    help="batched evaluation: group points sharing "
                         "everything but profile/schedule and evaluate "
                         "each group in one costing pass — bit-identical "
                         "results, same cache keys (N points per "
                         "dispatch; bare --batch sizes automatically)")
    ap.add_argument("--search", choices=SEARCH_KINDS, default=None,
                    help="guided search over the scale lattice (scale "
                         "sweep only): halving promotes on cheap "
                         "monolithic estimates, evolve mutates lattice "
                         "knobs from a seeded RNG")
    ap.add_argument("--budget", type=int, default=None, metavar="N",
                    help="full evaluations a guided search may spend "
                         "(default: size/4 for halving)")
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed for --search evolve (deterministic "
                         "per seed)")
    ap.add_argument("--points", type=int, default=10000, metavar="N",
                    help="scale sweep: lattice size (rounded up to a "
                         "whole number of ratio rows)")
    ap.add_argument("--chunk", type=int, default=4096, metavar="N",
                    help="scale sweep: points per streamed chunk "
                         "(bounds peak memory)")
    ap.add_argument("--schedule", default=None, metavar="POLICIES",
                    help="rerun the sweep across multi-macro scheduling "
                         "policies (comma list from "
                         f"{{{','.join(POLICIES)}}}, or 'all') and add a "
                         "schedule column")
    ap.add_argument("--invocations", type=int, default=1, metavar="N",
                    help="repeated DAG executions per evaluation (resident "
                         "amortises its weight preload across them)")
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = ap.parse_args(argv)

    if args.resume:
        return _resume(args.resume)
    if args.check_store:
        return _check_store(args.check_store)
    if args.sweep is None:
        ap.error("a sweep name is required "
                 "(or use --resume / --check-store)")

    journal = None
    if args.run_dir:
        run_dir = Path(args.run_dir)
        run_dir.mkdir(parents=True, exist_ok=True)
        # the manifest lands before any evaluation so a SIGKILL at any
        # later instant leaves a resumable run directory behind
        (run_dir / "sweep.json").write_text(json.dumps(
            {"argv": argv, "cache_schema": CACHE_SCHEMA}, indent=2) + "\n")
        journal = KeyJournal(run_dir / "journal.txt")

    observer = None
    if args.obs or args.obs_dir:
        from .. import obs
        observer = obs.enable(args.obs_dir, echo=True,
                              manifest={"cli": "repro_torch.explore",
                                        "sweep": args.sweep})
        print(f"obs: recording to {observer.dir}", file=sys.stderr)

    profile = None
    if args.profile is not None:
        from ..calibrate.profile import ProfileError, resolve_profile
        try:
            profile = resolve_profile(args.profile)
        except ProfileError as e:
            ap.error(str(e))
        print(f"calibrated mode: profile {profile.name!r} "
              f"(hash {profile.content_hash()[:12]})")
    if args.diff_analytic and profile is None:
        ap.error("--diff-analytic requires --profile")

    if args.invocations < 1:
        ap.error("--invocations must be >= 1")
    policies: List[Optional[str]] = [None]
    if args.schedule is not None:
        text = ",".join(POLICIES) if args.schedule == "all" else args.schedule
        policies = [t for t in text.split(",") if t]
        bad = [p for p in policies if p not in POLICIES]
        if bad:
            ap.error(f"unknown schedule policies {bad}; "
                     f"choose from {POLICIES} (or 'all')")
        if not policies:
            ap.error("--schedule must name at least one policy")

    if args.search and args.sweep != "scale":
        ap.error("--search applies to the scale sweep only")
    if args.sweep == "scale":
        for flag, name in ((args.profile, "--profile"),
                           (args.schedule, "--schedule"),
                           (args.workload, "--workload"),
                           (args.diff_analytic, "--diff-analytic")):
            if flag:
                ap.error(f"{name} does not apply to the scale sweep")
        if args.points < 1:
            ap.error("--points must be >= 1")
        if args.chunk < 1:
            ap.error("--chunk must be >= 1")
        try:
            preflight(_scale_workload(),
                      PRESET_ARCHS[args.arch]() if args.arch else None,
                      strict=True, where="repro_torch.explore")
        except AnalysisError as e:
            ap.error(str(e))
        status = _run_scale(args, ap, _runner(args, journal))
        if observer is not None:
            print(f"obs: trace recorded to {observer.dir}", file=sys.stderr)
        return status

    runner = _runner(args, journal)
    ratios = _parse_floats(ap, args.ratios)
    wl_override = (_traced_wl_fn(ap, args.workload, args.seq_len)
                   if args.workload else None)

    def run_sweep(prof, sched):
        if args.sweep == "sparsity":
            arch = PRESET_ARCHS[args.arch]() if args.arch else usecase_arch(4)
            wl_fn = (wl_override or
                     (lambda: MODEL_BUILDERS[args.model](args.img)))
            return sparsity_sweep(
                arch, wl_fn, {}, ratios=ratios, runner=runner, profile=prof,
                schedule=sched,
                pattern_factory=lambda r: TABLE_II_PATTERNS(r, c_in=16))
        if args.sweep == "mapping":
            wl_fn = (wl_override or
                     (lambda: MODEL_BUILDERS[args.model](args.img)))
            rearrange = [None if t == "none" else t
                         for t in args.rearrange.split(",") if t]
            if args.arch:
                base = PRESET_ARCHS[args.arch]
                arch_fn = lambda org: base().with_org(org)  # noqa: E731
            else:
                arch_fn = lambda org: usecase_arch(org[0] * org[1], org)  # noqa: E731
            return mapping_sweep(
                arch_fn, wl_fn,
                hybrid(2, 16, args.spec_ratio),
                orgs=_parse_orgs(ap, args.orgs),
                strategies=tuple(t for t in args.strategies.split(",") if t),
                rearrange=rearrange, runner=runner, profile=prof,
                schedule=sched)
        # lm
        from ..configs import get_config
        cfg = get_config(args.config)
        arch = PRESET_ARCHS[args.arch]() if args.arch else usecase_arch(16)
        wl_fn = (wl_override or
                 (lambda: lm_workload(cfg, seq_len=args.seq_len)))
        return sparsity_sweep(
            arch, wl_fn, {}, ratios=ratios, runner=runner, profile=prof,
            schedule=sched,
            pattern_factory=lambda r: TABLE_II_PATTERNS(r, c_in=16))

    def run_policies(prof) -> SweepResult:
        """One sweep per requested policy, concatenated with a
        ``schedule`` column (rows stay grid-ordered within a policy)."""
        results: List[SweepResult] = []
        for pol in policies:
            if pol is None:
                sched = (SchedulePolicy(invocations=args.invocations)
                         if args.invocations != 1 else None)
            else:
                sched = SchedulePolicy(policy=pol,
                                       invocations=args.invocations)
            r = run_sweep(prof, sched)
            if pol is not None:
                for row in r.rows:
                    row["schedule"] = pol
            results.append(r)
        if len(results) == 1:
            return results[0]
        stats = results[0].stats
        for r in results[1:]:
            stats = stats.merge(r.stats)
        return SweepResult(rows=[row for r in results for row in r.rows],
                           stats=stats)

    # strict pre-flight (CIMFlow-style front-end rejection): validate a
    # fresh instance of the swept workload — plus the preset arch, when
    # one is named — before any grid is built or simulated.  Costs one
    # extra workload build; saves hours on a million-point sweep fed an
    # ill-formed traced DAG.
    if args.sweep == "lm":
        from ..configs import get_config
        _wl = (wl_override
               or (lambda: lm_workload(get_config(args.config),
                                       seq_len=args.seq_len)))()
    else:
        _wl = (wl_override
               or (lambda: MODEL_BUILDERS[args.model](args.img)))()
    _arch = PRESET_ARCHS[args.arch]() if args.arch else None
    try:
        preflight(_wl, _arch, strict=True, where="repro_torch.explore")
    except AnalysisError as e:
        ap.error(str(e))

    try:
        result = run_policies(profile)
        if args.diff_analytic:
            _print_diff(result.rows, run_policies(None).rows)
    except SweepFailure as e:
        print(f"error: {e}", file=sys.stderr)
        for f in e.failures[:10]:
            print(f"  failed {f.key[:16]} ({f.reason}, {f.attempts} "
                  f"attempts): {f.error}", file=sys.stderr)
        if len(e.failures) > 10:
            print(f"  … {len(e.failures) - 10} more", file=sys.stderr)
        if args.run_dir:
            print(f"hint: surviving results are stored — "
                  f"`python -m repro_torch.explore --resume {args.run_dir}` "
                  f"retries only the failures", file=sys.stderr)
        return 3
    status = _finish(result, args)
    if observer is not None:
        ecsv = observer.artifact_path("energy_components.csv")
        print(f"obs: trace recorded to {observer.dir}"
              + (f" (energy CSV: {ecsv})" if ecsv.exists() else ""),
              file=sys.stderr)
        print(f"obs: inspect with `python -m repro_torch.obs report "
              f"{observer.dir}`", file=sys.stderr)
    return status


if __name__ == "__main__":
    sys.exit(main())
