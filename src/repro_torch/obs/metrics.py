"""Serving metrics (copy of ``repro.obs.metrics``): counters and
streaming histograms with exposition.

Pure-python accumulators the serve engine updates inline
(:class:`ServeMetrics` is cheap enough to keep on unconditionally —
a histogram observe is one bisect + three adds).  The streaming
histogram uses fixed log-spaced buckets (1 µs … ~500 s, ~12% resolution)
so p50/p99 come from bucket interpolation without retaining samples —
the standard Prometheus-style trade.
"""
from __future__ import annotations

import bisect
import json
import math
from typing import Dict, List, Optional

__all__ = ["StreamingHistogram", "ServeMetrics"]


def _log_bounds(lo: float = 1e-6, hi: float = 512.0,
                per_decade: int = 20) -> List[float]:
    n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
    return [lo * 10 ** (i / per_decade) for i in range(n)]


_DEFAULT_BOUNDS = _log_bounds()


class StreamingHistogram:
    """Fixed-bucket streaming histogram over positive floats (seconds).

    ``percentile(p)`` interpolates linearly inside the winning bucket;
    exact min/max are tracked so p0/p100 are sample-exact and a
    single-sample histogram reports that sample for every percentile.
    """

    __slots__ = ("bounds", "counts", "count", "total", "min", "max")

    def __init__(self, bounds: Optional[List[float]] = None):
        self.bounds = bounds if bounds is not None else _DEFAULT_BOUNDS
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100]."""
        if self.count == 0:
            return 0.0
        if p <= 0:
            return self.min
        if p >= 100:
            return self.max
        rank = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= rank and c > 0:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo, hi = max(lo, self.min), min(max(hi, lo), self.max)
                frac = (rank - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.max

    def snapshot(self) -> Dict[str, float]:
        return {"count": self.count, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


class ServeMetrics:
    """Request/latency accounting for :class:`repro_torch.serve.engine.ServeEngine`.

    Cumulative across the engine's lifetime — ``snapshot()`` is a pure
    read, so repeated ``run()`` calls keep accumulating (mirroring the
    sweep engine's cumulative ``stats`` vs per-call ``last_stats``
    split).  All latencies are wall seconds from ``time.monotonic()``
    callers pass in; this module never reads a clock itself.
    """

    def __init__(self):
        self.requests_submitted = 0
        self.requests_completed = 0
        self.requests_rejected = 0     # refused admission (queue full)
        self.requests_expired = 0      # deadline passed (queued or decoding)
        self.tokens_generated = 0
        self.steps = 0
        self.queue_depth = 0           # gauge: waiting, not yet in a slot
        self.active_slots = 0          # gauge: slots decoding right now
        self.busy_s = 0.0              # wall seconds inside step()
        self.ttft = StreamingHistogram()
        self.token_latency = StreamingHistogram()

    # -- update points (called by the engine) --------------------------------
    def on_submit(self) -> None:
        self.requests_submitted += 1
        self.queue_depth += 1

    def on_scheduled(self) -> None:
        self.queue_depth -= 1

    def on_reject(self) -> None:
        # a rejected request never entered the queue: no submit/depth
        self.requests_rejected += 1

    def on_expire(self, queued: bool = True) -> None:
        # ``queued``: expired while waiting (it held a queue_depth unit);
        # False = cut off mid-decode (its slot is released by the engine)
        self.requests_expired += 1
        if queued:
            self.queue_depth -= 1

    def on_first_token(self, ttft_s: float) -> None:
        self.ttft.observe(ttft_s)

    def on_tokens(self, n: int, step_s: float) -> None:
        # each of the n tokens (one per active slot) experienced the
        # full decode-step latency — that is the user-visible
        # inter-token latency, so it is what the histogram records
        self.tokens_generated += n
        if n > 0 and step_s > 0:
            for _ in range(n):
                self.token_latency.observe(step_s)

    def on_step(self, active: int, step_s: float) -> None:
        self.steps += 1
        self.active_slots = active
        self.busy_s += step_s

    def on_complete(self) -> None:
        self.requests_completed += 1

    # -- exposition ----------------------------------------------------------
    def snapshot(self) -> Dict:
        toks_per_s = (self.tokens_generated / self.busy_s
                      if self.busy_s > 0 else 0.0)
        return {
            "requests": {"submitted": self.requests_submitted,
                         "completed": self.requests_completed,
                         "queue_depth": self.queue_depth},
            # kept out of "requests" so long-standing consumers of that
            # sub-dict (and its exact shape) are unaffected
            "failures": {"rejected": self.requests_rejected,
                         "expired": self.requests_expired},
            "steps": self.steps,
            "active_slots": self.active_slots,
            "tokens_generated": self.tokens_generated,
            "tokens_per_s": toks_per_s,
            "busy_s": self.busy_s,
            "ttft_s": self.ttft.snapshot(),
            "token_latency_s": self.token_latency.snapshot(),
        }

    def render_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1)

    def render_text(self) -> str:
        s = self.snapshot()
        t, tl = s["ttft_s"], s["token_latency_s"]
        f = s["failures"]
        return "\n".join([
            f"serve.requests submitted={s['requests']['submitted']} "
            f"completed={s['requests']['completed']} "
            f"queue_depth={s['requests']['queue_depth']} "
            f"rejected={f['rejected']} expired={f['expired']}",
            f"serve.steps {s['steps']} active_slots={s['active_slots']}",
            f"serve.tokens {s['tokens_generated']} "
            f"({s['tokens_per_s']:.1f} tok/s over {s['busy_s']:.3f}s busy)",
            f"serve.ttft_s count={t['count']} mean={t['mean']:.4f} "
            f"p50={t['p50']:.4f} p99={t['p99']:.4f}",
            f"serve.token_latency_s count={tl['count']} "
            f"mean={tl['mean']:.5f} p50={tl['p50']:.5f} p99={tl['p99']:.5f}",
        ])
