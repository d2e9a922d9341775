#!/usr/bin/env python3
"""Readings that set a cell's correctness limit: the program's widest
logit gap, and the control's, on several seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 8 \
        [--control] [--fault unchanged_cache|half_batch|altered_token|noncausal_prefill]

For each seed the cell runs as ``run.py`` runs it (set-up, the closed
loop, a window of ``--seconds``), and the reference is run over the
checked sample: the program's gaps are those of its served tokens.  With
``--control`` the reference is run again over the same prompts and
tokens with every matrix product in float8 e4m3 (the control: the
reference in the nearest precision below the configuration's bf16), and
the gap of the token it puts first at each position is read against the
float32 reference.  With ``--fault`` the program runs with that fault
planted underneath the timed path (:mod:`portbench.harness.faults`), and
its gaps are the faulty program's.  One JSON line per seed; nothing here
is a benchmark run, and the benchmark's runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, seconds: float, control: bool, device: str = "cuda",
             t_start: float = None, fault: str = None) -> dict:
    import torch
    from portbench.harness import check, faults
    from portbench.harness.cell import run_cell

    keep = {}
    undo = faults.plant(fault) if fault else (lambda: None)
    try:
        res = run_cell(cell, seed, seconds, False, t_start=t_start or time.perf_counter(),
                       device=device, limits={}, keep=keep)
    finally:
        undo()
    picked, ref_logits = keep["picked"], keep["logits"]
    g = check.gaps(ref_logits, [r.output for r in picked])
    out = {"seed": seed, "fault": fault, "tokens": int(g.size), "requests": len(picked),
           "max_gap": float(g.max()), "mean_gap": float(g.mean()),
           "flipped": int((g > 0).sum()), "correct_without_gap_limits": res["correct"],
           "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
    if control:
        ref = importlib.import_module(f"portbench.reference.{cell.config['reference']}")
        ctl = ref.served_logits(cell.config, seed, [(r.prompt, r.output) for r in picked],
                                device, quant="fp8")
        c = check.control_gaps(ref_logits, ctl)
        out.update(control_max_gap=float(c.max()), control_mean_gap=float(c.mean()),
                   control_flipped=int((c > 0).sum()))
        del ctl
    del ref_logits, keep
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.run import _caches
    _caches()
    sys.path.insert(1, str(ROOT / "src"))
    import torch
    from portbench.harness.cell import find_cell

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    cell = find_cell(ROOT, args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        t0 = T_START if i == 0 else time.perf_counter()
        out = readings(cell, seed, args.seconds, args.control, t_start=t0, fault=args.fault)
        out["wall_s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
