"""``python -m repro_torch.trace`` — capture / lower / diff traced workloads
(the port's counterpart of ``python -m repro.trace``: the same flags,
pre-flight, exit codes and output).

Subcommands:

* ``lower``   — lower a saved TraceGraph (``--graph``) or a live capture
  (``--config``/``--cnn``, on ``meta`` tensors) into a Workload; print the
  op table, optionally simulate it under every schedule policy
  (``--simulate``) and save the graph JSON (``--save-graph``).
* ``diff``    — same sources, then diff against the hand-built sibling
  DAG (:func:`lm_workload` / the CNN builders).  Exits non-zero when the
  MVM totals disagree.
* ``fixture`` — write the port's golden graphs (the reference's
  ``FIXTURES`` set, at the same shapes) under ``tests/fixtures/trace_torch/``;
  run after changing the capture or the reference programs, commit the
  result.

Examples::

    python -m repro_torch.trace diff --graph tests/fixtures/trace/lm_llama3-8b_forward.json
    python -m repro_torch.trace lower --config dbrx-132b --step decode --simulate
    python -m repro_torch.trace diff --cnn resnet18 --img 32
    python -m repro_torch.trace fixture --out tests/fixtures/trace_torch
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ..core import (SchedulePolicy, default_mapping, lm_workload, simulate,
                    usecase_arch)
from ..core.schedule import POLICIES
from ..core.workload import MODEL_BUILDERS, Workload
from .diff import diff_table, diff_workloads
from .ir import TraceGraph
from .lower import lower_graph

# the golden set: (kind, config/model, step) — one LM config per step kind
# plus one CNN, small shapes so the JSON stays readable (the reference's)
FIXTURES = (
    ("lm", "llama3-8b", "forward"),
    ("lm", "llama3-8b", "prefill"),
    ("lm", "llama3-8b", "decode"),
    ("lm", "dbrx-132b", "forward"),
    ("cnn", "resnet18", None),
)
FIXTURE_SEQ_LEN = 8
FIXTURE_BATCH = 1
FIXTURE_IMG = 32


def fixture_name(kind: str, model: str, step: Optional[str]) -> str:
    return (f"lm_{model}_{step}.json" if kind == "lm"
            else f"cnn_{model}_{FIXTURE_IMG}.json")


def fixture_graph(kind: str, model: str, step: Optional[str]) -> TraceGraph:
    """One graph of the golden set, captured live."""
    from ..configs import get_config
    from .capture import cnn_graph, trace_model
    if kind == "lm":
        return trace_model(get_config(model), step=step, seq_len=FIXTURE_SEQ_LEN,
                           batch=FIXTURE_BATCH)
    return cnn_graph(model, FIXTURE_IMG, 100)


def _load_workload(ap, args) -> Workload:
    if args.graph:
        return lower_graph(TraceGraph.load(args.graph))
    if args.cnn:
        from .capture import traced_cnn
        return traced_cnn(args.cnn, args.img, args.classes)
    if args.config:
        from ..configs import get_config
        from .capture import trace_model
        graph = trace_model(get_config(args.config), step=args.step,
                            seq_len=args.seq_len, batch=args.batch,
                            source=args.source)
        if args.save_graph:
            graph.save(args.save_graph)
            print(f"saved graph to {args.save_graph} "
                  f"(digest {graph.digest()[:16]})")
        return lower_graph(graph)
    ap.error("one of --graph / --config / --cnn is required")


def _hand_sibling(ap, args, traced: Workload) -> Workload:
    """Reconstruct the hand DAG the traced workload mirrors."""
    if args.graph:
        meta = TraceGraph.load(args.graph).meta
        if "config" in meta:
            from ..configs import get_config
            if meta.get("step") == "decode":
                ap.error("decode fixtures have no hand-DAG sibling to "
                         "diff against (lm_workload models a full "
                         "sequence); use 'lower --simulate' instead")
            return lm_workload(get_config(meta["config"]),
                               seq_len=int(meta.get("seq_len", 128)),
                               batch=int(meta.get("batch", 1)))
        builder = MODEL_BUILDERS[meta["model"].replace("_", "")]
        return builder(int(meta.get("img", 32)),
                       int(meta.get("num_classes", 100)))
    if args.cnn:
        key = args.cnn.replace("_", "")
        return MODEL_BUILDERS[key](args.img, args.classes)
    from ..configs import get_config
    if args.step == "decode":
        ap.error("step=decode has no hand-DAG sibling (see above)")
    return lm_workload(get_config(args.config), seq_len=args.seq_len,
                       batch=args.batch)


def _print_workload(wl: Workload) -> None:
    print(wl)
    if wl.source_digest:
        print(f"source digest: {wl.source_digest[:16]}")
    print(f"{'op':30}{'kind':8}{'K':>8}{'N':>8}{'V':>12}"
          f"{'elements':>12}{'weights':>14}")
    for n in wl.nodes.values():
        print(f"{n.name:30}{n.kind:8}{n.K:>8}{n.N:>8}{n.V:>12}"
              f"{n.elements:>12}{n.weights:>14}")


def _simulate_all(wl_src) -> None:
    arch = usecase_arch(16)
    mapping = default_mapping(arch, "spatial")
    print(f"\n{'policy':14}{'cycles':>14}{'energy_uJ':>12}"
          f"{'concurrency':>12}")
    for pol in POLICIES:
        rep = simulate(arch, wl_src(), mapping,
                       schedule=SchedulePolicy(pol))
        conc = rep.schedule.concurrency if rep.schedule else 1.0
        print(f"{pol:14}{rep.latency_cycles:>14.0f}"
              f"{rep.total_energy_uj:>12.3f}{conc:>12.2f}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.trace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("cmd", choices=("lower", "diff", "fixture"))
    ap.add_argument("--graph", default=None,
                    help="saved TraceGraph JSON (replay)")
    ap.add_argument("--config", default=None, help="LM config to trace")
    ap.add_argument("--step", default="forward",
                    choices=("forward", "prefill", "decode"))
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--source", default="reference",
                    choices=("reference", "model"),
                    help="'reference': shape-faithful mirror (MVM-exact "
                         "vs the hand DAG); 'model': the port's own "
                         "transformer (diff is informational)")
    ap.add_argument("--cnn", default=None,
                    help="CNN reference to trace (vgg16/resnet18/resnet50)")
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--save-graph", default=None,
                    help="also save the captured TraceGraph JSON here")
    ap.add_argument("--simulate", action="store_true",
                    help="simulate under every schedule policy")
    ap.add_argument("--out", default="tests/fixtures/trace_torch",
                    help="fixture output directory (fixture cmd)")
    args = ap.parse_args(argv)

    if args.cmd == "fixture":
        os.makedirs(args.out, exist_ok=True)
        for kind, model, step in FIXTURES:
            graph = fixture_graph(kind, model, step)
            path = os.path.join(args.out, fixture_name(kind, model, step))
            graph.save(path)
            print(f"wrote {path} (eqns={graph.n_eqns()}, "
                  f"digest {graph.digest()[:16]})")
        return 0

    wl = _load_workload(ap, args)
    # strict pre-flight: CLI entry points reject broken DAGs outright
    from ..analysis import AnalysisError, preflight
    try:
        preflight(wl, strict=True, where="repro_torch.trace")
    except AnalysisError as e:
        ap.error(str(e))
    if args.cmd == "lower":
        _print_workload(wl)
        if args.simulate:
            _simulate_all(lambda: _load_workload(ap, args))
        return 0

    # diff
    hand = _hand_sibling(ap, args, wl)
    print(diff_table(wl, hand))
    if args.simulate:
        _simulate_all(lambda: _load_workload(ap, args))
    d = diff_workloads(wl, hand)
    if args.config and args.source == "model":
        return 0          # the port's own model: informational only
    return 0 if d["mvm_match"] else 1


if __name__ == "__main__":
    sys.exit(main())
