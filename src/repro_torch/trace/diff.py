"""Traced-vs-hand Workload comparison (jax-free).

Copy of ``repro.trace.diff``: the port never imports the JAX package.

The differential contract (tests/test_trace.py, tests/test_torch_trace.py):
a traced DAG must agree with its hand-built sibling *bit-exactly*
on MVM ``total_macs()`` and MVM weight storage; the elementwise volume
is expected to differ — the hand DAGs fold most of it away — and is
reported rather than asserted, so the omission is a visible number
instead of silent drift.
"""
from __future__ import annotations

from typing import Dict, List

from ..core.workload import Workload

__all__ = ["summarize", "diff_workloads", "diff_table"]


def summarize(w: Workload) -> Dict[str, int]:
    mvm = w.mvm_ops()
    other = w.other_ops()
    return {
        "n_mvm": len(mvm),
        "n_other": len(other),
        "mvm_macs": w.total_macs(),
        "mvm_weights": sum(n.weights for n in mvm),
        "total_weights": w.total_weights(),
        "elementwise": sum(n.elements for n in other),
    }


def diff_workloads(traced: Workload, hand: Workload) -> Dict[str, object]:
    """Structured diff; ``mvm_match`` is the hard differential criterion."""
    t, h = summarize(traced), summarize(hand)
    return {
        "traced": t,
        "hand": h,
        "mvm_macs_equal": t["mvm_macs"] == h["mvm_macs"],
        "mvm_weights_equal": t["mvm_weights"] == h["mvm_weights"],
        "total_weights_equal": t["total_weights"] == h["total_weights"],
        "mvm_match": (t["mvm_macs"] == h["mvm_macs"]
                      and t["mvm_weights"] == h["mvm_weights"]),
        # what the hand DAG leaves unpriced on the post-processing unit
        "elementwise_surplus": t["elementwise"] - h["elementwise"],
    }


def diff_table(traced: Workload, hand: Workload) -> str:
    """Human-readable diff table for the CLI / CI log."""
    d = diff_workloads(traced, hand)
    t, h = d["traced"], d["hand"]
    rows: List[str] = [
        f"{'':22}{'traced':>18}{'hand':>18}{'match':>8}",
        f"{'workload':22}{traced.name:>18}{hand.name:>18}",
    ]
    for key, exact in (("n_mvm", False), ("mvm_macs", True),
                       ("mvm_weights", True), ("total_weights", True),
                       ("n_other", False), ("elementwise", False)):
        mark = ""
        if exact:
            mark = "OK" if t[key] == h[key] else "DIFF"
        rows.append(f"{key:22}{t[key]:>18}{h[key]:>18}{mark:>8}")
    rows.append(f"{'elementwise surplus':22}"
                f"{d['elementwise_surplus']:>18} (traced - hand)")
    rows.append(f"MVM differential: {'PASS' if d['mvm_match'] else 'FAIL'}")
    return "\n".join(rows)
