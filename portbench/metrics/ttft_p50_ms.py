"""ttft_p50_ms: the median (numpy's linear interpolation) over every
request whose first token came in the window, from the moment its client
sent it to the end of the step that handed the token back."""
from portbench.harness.rundata import percentile


def read(run):
    ttft = [r.stamps[0] - r.sent for r in run.records
            if r.stamps and run.w0 < r.stamps[0] <= run.w1]
    p = percentile(ttft, 50)
    return None if p is None else 1e3 * p
