"""Op histogram of a counted cell: the port's counterpart of
``repro/launch/hlo_histogram.py`` (the name kept so that a reader finds
it), ranking the ATen ops of a :func:`~repro_torch.launch.counting.count`
run by result bytes, as the reference ranks HLO opcodes by theirs.  Views
and allocations (``empty``) are ranked too, as the reference ranks
``bitcast`` and ``reshape``, though ``bytes_accessed`` sums neither; they
count as fusible, so the fusion-adjusted estimate holds only traffic.  It
locates the per-layer byte whale of a cell without a card.

The counting mode sees the ATen ops a step dispatches (forward,
backward, recompute), a kernel of the port as one entry under its name;
no exported graph is needed, and the histogram shares its one mechanism
with the dry-run's counts.

Usage (counts on the ``meta`` device, no card):
  python -m repro_torch.launch.hlo_histogram --arch qwen3-4b --cell prefill_32k
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

import torch

from ..configs import get_config
from ..configs.base import SHAPE_CELLS
from .counting import NO_TRAFFIC
from .dryrun import count_cell

__all__ = ["histogram", "fused_bytes_estimate", "fusible", "main"]

# copies Inductor folds into a neighbouring kernel, besides the
# pointwise-tagged ops and the views
_COPIES = {"clone", "_to_copy", "copy_"}


def fusible(op: str) -> bool:
    """Whether the ATen op ``op`` is one Inductor would fuse into its
    neighbours (its result then never round-trips device memory): an
    overload tagged pointwise, a view, a copy, or an allocation that moves
    no bytes.  A kernel's entry (a name that is no ATen op) is not."""
    if op in _COPIES or op in NO_TRAFFIC:
        return True
    packet = getattr(torch.ops.aten, op, None)
    if packet is None or not hasattr(packet, "overloads"):
        return False
    for name in packet.overloads():
        ov = getattr(packet, name)
        if torch.Tag.pointwise in ov.tags or ov.is_view:
            return True
    return False


def fused_bytes_estimate(oplog: Mapping[str, Sequence[int]]) -> Tuple[int, int]:
    """(raw result bytes, fusion-adjusted bytes) over an op log: the
    adjusted sum leaves out the ops :func:`fusible` names, a lower
    estimate of the memory term (the truth lies between)."""
    raw = sum(int(b) for b, _ in oplog.values())
    fused = sum(int(b) for op, (b, _) in oplog.items() if not fusible(op))
    return raw, fused


def histogram(oplog: Mapping[str, Sequence[int]], top: int = 25) -> Dict[str, Tuple[int, int]]:
    """op → (total result bytes, calls), descending by bytes."""
    ranked = sorted(oplog.items(), key=lambda kv: -kv[1][0])[:top]
    return {k: (int(v[0]), int(v[1])) for k, v in ranked}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", required=True, choices=list(SHAPE_CELLS))
    ap.add_argument("--layers", type=int, default=2,
                    help="truncated layer count (keeps the count fast)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--remat-policy", default="dots")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    counted = count_cell(cfg, SHAPE_CELLS[args.cell], remat=True,
                         remat_policy=args.remat_policy)
    hist = histogram(counted.oplog, args.top)
    total = sum(b for b, _ in hist.values())
    raw, fused = fused_bytes_estimate(counted.oplog)
    print(f"{args.arch} × {args.cell} (L={args.layers}) — "
          f"top {args.top} ops by result bytes:")
    for op, (b, n) in hist.items():
        print(f"  {op:28s} {b/1e9:10.2f} GB  ×{n:5d}  ({b / max(total, 1):5.1%})")
    print(f"  result bytes {raw/1e9:.2f} GB in all, {fused/1e9:.2f} GB outside fusible ops")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
