"""``python -m repro_torch.calibrate`` — harvest → fit → inspect profiles.

Copy of ``python -m repro.calibrate``: the port never imports the JAX
package.  ``collect --kernels`` times the port's kernels on ``--device``
(the card unless ``--device cpu`` is given; with no card and no device it
fails rather than time the plain versions on the host), with the port's
``--impl`` vocabulary (``auto``, ``cuda``, ``ref``).  ``fit --device`` is
the reference's: a label written into the profile.

Subcommands::

    collect  harvest samples (kernel microbenchmarks and/or timed
             ledger records) into a samples JSONL
    fit      bounded least-squares roofline fit over one or more
             sample/ledger files → a CalibrationProfile JSON
    show     print (and validate) a profile; --json for the raw document
    diff     compare two profiles' peaks and efficiencies

Examples::

    python -m repro_torch.calibrate collect --kernels --out results/calib.jsonl
    python -m repro_torch.calibrate fit --ledger results/calib.jsonl \
        --name my-host --out results/profile.json
    python -m repro_torch.calibrate show results/profile.json
    python -m repro_torch.calibrate diff results/profile.json default
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .. import resolve_device
from .fit import FitError, fit_profile
from .harvest import HarvestReport, from_ledger, write_samples
from .profile import CalibrationProfile, ProfileError, resolve_profile

_PEAKS = (("peak_flops", "FLOP/s"), ("hbm_bw", "B/s"), ("ici_bw", "B/s/link"))


def _fmt_si(v: float) -> str:
    for scale, suffix in ((1e15, "P"), (1e12, "T"), (1e9, "G"), (1e6, "M")):
        if v >= scale:
            return f"{v / scale:.3g} {suffix}"
    return f"{v:.3g} "


def _harvest_many(paths: List[str]) -> HarvestReport:
    rep = HarvestReport(samples=[])
    for p in paths:
        rep = rep.merged(from_ledger(p))
    return rep


def _report_skips(rep: HarvestReport) -> None:
    if rep.skipped_untimed or rep.skipped_malformed:
        print(f"calibrate: skipped {rep.skipped_untimed} untimed and "
              f"{rep.skipped_malformed} malformed record(s)", file=sys.stderr)


def _cmd_collect(args) -> int:
    rep = _harvest_many(args.ledger)
    if args.kernels:
        from .harvest import microbench_kernels
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            print(f"calibrate: {e}", file=sys.stderr)
            return 2
        sizes = [int(t) for t in args.sizes.split(",") if t]
        rep = rep.merged(microbench_kernels(
            sizes=sizes, repeats=args.repeats, impl=args.impl,
            device=device))
    _report_skips(rep)
    if not rep.samples:
        print("calibrate: nothing harvested (no --kernels and no timed "
              "ledger records)", file=sys.stderr)
        return 1
    write_samples(rep.samples, args.out, append=not args.fresh)
    classes = {}
    for s in rep.samples:
        classes[s.op_class] = classes.get(s.op_class, 0) + 1
    print(f"wrote {len(rep.samples)} sample(s) to {args.out} "
          f"({', '.join(f'{c}×{n}' for c, n in sorted(classes.items()))})")
    return 0


def _cmd_fit(args) -> int:
    rep = _harvest_many(args.ledger)
    _report_skips(rep)
    try:
        prof = fit_profile(
            rep.samples, name=args.name, device=args.device,
            solver=args.solver,
            provenance={"sources": list(args.ledger)})
    except FitError as e:
        print(f"calibrate: fit failed: {e}", file=sys.stderr)
        return 1
    if args.out:
        prof.save(args.out)
        print(f"wrote profile to {args.out}")
    if args.profiles_dir:
        path = prof.save_addressed(args.profiles_dir)
        print(f"wrote content-addressed copy to {path}")
    _print_profile(prof)
    return 0


def _print_profile(prof: CalibrationProfile) -> None:
    print(f"profile {prof.name!r}  (device: {prof.device}, "
          f"schema v{prof.schema_version}, hash {prof.content_hash()[:12]})")
    for key, unit in _PEAKS:
        print(f"  {key:<11} {_fmt_si(getattr(prof, key))}{unit}")
    for c, e in sorted(prof.efficiency.items()):
        print(f"  efficiency[{c}] = {e:.3f}")
    for k, v in sorted(prof.residuals.items()):
        print(f"  residual {k} = {v:.4g}")
    n = prof.provenance.get("n_samples")
    if n is not None:
        print(f"  fitted from {n} sample(s) via "
              f"{prof.provenance.get('solver', '?')} solver")


def _cmd_show(args) -> int:
    prof = resolve_profile(args.profile)
    if args.json:
        print(json.dumps(prof.to_dict(), indent=2, sort_keys=True))
    else:
        _print_profile(prof)
    if args.check:
        # load() already validated; round-trip the document too
        CalibrationProfile.from_dict(json.loads(prof.to_json()))
        print("OK: schema-valid, round-trips")
    return 0


def _cmd_diff(args) -> int:
    a, b = resolve_profile(args.a), resolve_profile(args.b)
    print(f"{'':<14}{a.name:>16}{b.name:>16}{'b/a':>10}")
    for key, _unit in _PEAKS:
        va, vb = getattr(a, key), getattr(b, key)
        print(f"{key:<14}{_fmt_si(va):>16}{_fmt_si(vb):>16}{vb / va:>10.3f}")
    for c in sorted(set(a.efficiency) | set(b.efficiency)):
        ea, eb = a.efficiency_for(c), b.efficiency_for(c)
        print(f"eff[{c}]".ljust(14) + f"{ea:>16.3f}{eb:>16.3f}"
              f"{eb / ea:>10.3f}")
    same = a.content_hash() == b.content_hash()
    print("identical physical content (peaks + efficiencies)"
          if same else "profiles differ")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calibrate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("collect", help="harvest calibration samples")
    c.add_argument("--ledger", action="append", default=[],
                   help="JSONL ledger/sample file to ingest (repeatable)")
    c.add_argument("--kernels", action="store_true",
                   help="run the kernel microbenchmarks on --device")
    c.add_argument("--device", default=None,
                   help="torch device of the microbenchmarks (default: "
                        "cuda; fails when no card is present)")
    c.add_argument("--sizes", default="256,512",
                   help="comma-separated matrix/sequence sizes")
    c.add_argument("--repeats", type=int, default=3)
    c.add_argument("--impl", default="auto",
                   choices=("auto", "cuda", "ref"))
    c.add_argument("--out", default="results/calib_samples.jsonl")
    c.add_argument("--fresh", action="store_true",
                   help="overwrite --out instead of appending")
    c.set_defaults(fn=_cmd_collect)

    f = sub.add_parser("fit", help="fit a profile to samples")
    f.add_argument("--ledger", action="append", required=True,
                   help="sample/ledger JSONL (repeatable)")
    f.add_argument("--name", default="fitted")
    f.add_argument("--device", default=None)
    f.add_argument("--solver", default="auto",
                   choices=("auto", "scipy", "numpy"))
    f.add_argument("--out", default=None, help="profile JSON output path")
    f.add_argument("--profiles-dir", default=None,
                   help="also save a content-addressed copy here")
    f.set_defaults(fn=_cmd_fit)

    s = sub.add_parser("show", help="print and validate a profile")
    s.add_argument("profile", help="profile path, or 'default'")
    s.add_argument("--json", action="store_true")
    s.add_argument("--check", action="store_true",
                   help="assert the document round-trips the schema")
    s.set_defaults(fn=_cmd_show)

    d = sub.add_parser("diff", help="compare two profiles")
    d.add_argument("a", help="profile path, or 'default'")
    d.add_argument("b", help="profile path, or 'default'")
    d.set_defaults(fn=_cmd_diff)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except ProfileError as e:
        print(f"calibrate: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
