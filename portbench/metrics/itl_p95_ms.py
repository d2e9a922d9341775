"""itl_p95_ms: the 95th percentile of every gap between consecutive
output tokens of a request, over the gaps that end in the window."""
from portbench.harness.rundata import percentile


def read(run):
    gaps = [r.stamps[i] - r.stamps[i - 1] for r in run.records
            for i in range(1, len(r.stamps)) if run.w0 < r.stamps[i] <= run.w1]
    p = percentile(gaps, 95)
    return None if p is None else 1e3 * p
