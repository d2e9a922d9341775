"""CLI for the port's static invariant checker.

  python -m repro_torch.analysis                    # --all
  python -m repro_torch.analysis --all --format json --out diagnostics.json
  python -m repro_torch.analysis --pass import-boundary --pass cache-key
  python -m repro_torch.analysis --list

Exit status: 0 when no error-severity diagnostics survive suppression,
1 otherwise (2 for usage errors).  Runs entirely without torch, triton
and jax: the passes read source, and the model-plane pass imports only
the port's torch-free host plane.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from .diagnostics import Severity, render_json, render_text
from .framework import all_passes, run_passes


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--all", action="store_true",
                    help="run every registered pass (default)")
    ap.add_argument("--pass", dest="passes", action="append", default=[],
                    metavar="NAME", help="run one pass (repeatable)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the rendered report to FILE")
    ap.add_argument("--root", default=None, metavar="DIR",
                    help="analyse the tree at DIR instead of this repo")
    ap.add_argument("--list", action="store_true",
                    help="list registered passes and their codes")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="include suppressed diagnostics in text output")
    args = ap.parse_args(argv)

    passes = all_passes()
    if args.list:
        for name, cls in passes.items():
            codes = ", ".join(cls.codes)
            print(f"{name:16s} [{codes}]\n    {cls.description}")
        return 0

    if args.passes and args.all:
        ap.error("--pass and --all are mutually exclusive")
    for name in args.passes:
        if name not in passes:
            ap.error(f"unknown pass {name!r} "
                     f"(known: {', '.join(sorted(passes))})")

    selected = args.passes or None            # None -> all, in order
    root = Path(args.root) if args.root else None
    diags = run_passes(selected, root=root)

    if args.format == "json":
        report = render_json(diags, passes=selected or list(passes))
    else:
        report = render_text(diags, show_suppressed=args.show_suppressed)
    print(report)
    if args.out:
        Path(args.out).write_text(report + "\n")

    failed = any(d.severity == Severity.ERROR and not d.suppressed
                 for d in diags)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
