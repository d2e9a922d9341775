"""Roofline analysis over the dry-run ledger (copy of
``repro.launch.roofline``; the port never imports the JAX package).

Reads a ledger that :mod:`repro_torch.launch.dryrun` wrote and derives,
per (arch × cell × mesh):

    compute term    = flops / peak_FLOPs_per_chip
    memory term     = bytes_accessed / HBM_bandwidth_per_chip
    collective term = collective_bytes / ICI_bandwidth_per_chip

Also reports MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) and the
useful-compute ratio MODEL_FLOPS / (flops × chips), the dominant term,
and a one-line "what would move it" note.

Peaks come from a :class:`~repro_torch.calibrate.profile.CalibrationProfile`.
The bundled default is the reference's analytic profile
(``tpu-v5e-analytic``), kept for parity with the reference; its peaks are
no card's.  Read a card's records with ``--profile``: a profile fitted to
that card's samples (``chip_smoke.py`` fits one under ``build/profiles/``).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from ..calibrate.profile import (CalibrationProfile, ProfileError,
                                 default_profile, resolve_profile)

_DEFAULT_PROFILE = default_profile()

# Legacy module-level constants, kept as aliases of the bundled default
# profile so existing imports keep meaning exactly what they always did.
PEAK_FLOPS = _DEFAULT_PROFILE.peak_flops     # bf16 FLOP/s per chip
HBM_BW = _DEFAULT_PROFILE.hbm_bw             # bytes/s per chip
ICI_BW = _DEFAULT_PROFILE.ici_bw             # bytes/s per link per chip

__all__ = ["analyze", "load_ledger", "LedgerRecords", "main"]


class LedgerRecords(list):
    """Deduped ledger records, plus what loading had to skip.

    A plain ``list`` to callers; ``skipped`` / ``skipped_lines`` report
    undecodable lines so partial writes and corruption are visible
    instead of silently shrinking the analysis.
    """

    def __init__(self, records, skipped_lines: List[int]):
        super().__init__(records)
        self.skipped_lines = skipped_lines

    @property
    def skipped(self) -> int:
        return len(self.skipped_lines)


def load_ledger(path: str) -> LedgerRecords:
    recs = []
    skipped_lines: List[int] = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                skipped_lines.append(lineno)
    if skipped_lines:
        shown = ", ".join(map(str, skipped_lines[:8]))
        more = "" if len(skipped_lines) <= 8 else ", ..."
        print(f"roofline: skipped {len(skipped_lines)} undecodable ledger "
              f"line(s) in {path} (line {shown}{more})", file=sys.stderr)
    # keep the last record per (arch, cell, mesh, tag)
    dedup = {}
    for r in recs:
        dedup[(r.get("arch"), r.get("cell"), r.get("mesh"),
               r.get("tag", ""))] = r
    return LedgerRecords(dedup.values(), skipped_lines)


def model_flops(rec: Dict) -> float:
    """6·N_active·D per step (D = tokens processed)."""
    kind = rec.get("kind", "train")
    tokens = rec["global_batch"] * (rec["seq_len"] if kind != "decode" else 1)
    n = rec["active_params"]
    mult = 6.0 if kind == "train" else 2.0   # inference: fwd only
    return mult * n * tokens


def analyze(rec: Dict,
            profile: Optional[CalibrationProfile] = None) -> Optional[Dict]:
    if "error" in rec:
        return None
    prof = profile if profile is not None else _DEFAULT_PROFILE
    chips = rec["chips"]
    coll = sum(v for k, v in rec["collective_bytes"].items() if k != "count")
    t_comp = rec["flops"] / prof.peak_flops
    t_mem = rec["bytes_accessed"] / prof.hbm_bw
    t_coll = coll / prof.ici_bw
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dom = max(terms, key=terms.get)
    mf = model_flops(rec)
    useful = mf / max(rec["flops"] * chips, 1.0)
    bound = max(terms.values())
    # roofline fraction: useful model FLOPs per chip-second at the bound
    frac = (mf / chips / prof.peak_flops) / max(bound, 1e-30)
    hint = {
        "compute": "cut non-model FLOPs (remat policy, fused ops, "
                   "cheaper logits) or improve sharding balance",
        "memory": "improve reuse/layout (fuse elementwise chains, larger "
                  "tiles, bf16 partials, ring-buffer caches)",
        "collective": "reshard to cut resharding collectives / overlap "
                      "comm with compute / compress cross-pod traffic",
    }[dom]
    return {
        **{k: rec[k] for k in ("arch", "cell", "mesh", "tag", "chips",
                               "kind", "peak_bytes")},
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dom,
        "model_flops": mf,
        "useful_ratio": useful,
        "roofline_fraction": frac,
        "hint": hint,
    }


def fmt_table(rows: List[Dict]) -> str:
    hdr = ("| arch | cell | mesh | t_comp (ms) | t_mem (ms) | t_coll (ms) | "
           "dominant | peak GiB/dev | useful | roofline |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in sorted(rows, key=lambda x: (x["arch"], x["cell"], x["mesh"])):
        lines.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} "
            f"| {r['t_compute_s']*1e3:.2f} | {r['t_memory_s']*1e3:.2f} "
            f"| {r['t_collective_s']*1e3:.2f} | **{r['dominant']}** "
            f"| {r['peak_bytes']/2**30:.2f} | {r['useful_ratio']:.2f} "
            f"| {r['roofline_fraction']:.2f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ledger", default="results/dryrun.jsonl")
    ap.add_argument("--json", action="store_true", help="emit JSON rows")
    ap.add_argument("--tag", default=None, help="filter by ledger tag")
    ap.add_argument("--profile", default=None,
                    help="calibration profile JSON (or 'default') "
                         "supplying the per-chip peaks")
    args = ap.parse_args(argv)
    try:
        profile = resolve_profile(args.profile)
    except ProfileError as e:
        ap.error(str(e))
    rows = []
    errors = []
    for rec in load_ledger(args.ledger):
        if args.tag is not None and rec.get("tag", "") != args.tag:
            continue
        a = analyze(rec, profile)
        if a is None:
            errors.append(rec)
        else:
            rows.append(a)
    if args.json:
        print(json.dumps(rows, indent=1))
    else:
        print(fmt_table(rows))
        if errors:
            print(f"\n{len(errors)} FAILED cells:")
            for e in errors:
                print(f"  {e['arch']} {e['cell']} {e['mesh']}: "
                      f"{e['error'][:160]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
