"""The closed loop that drives ``ServeEngine`` through the window.

``clients`` clients each keep one request in the engine: when a request
is done, its client sends the next one from the stream before the next
``step()``.  After every step the loop stamps each new output token of
each live request with the step's end on the host clock, the moment the
engine hands it back.  The window opens at the end of the first step by
which ``warmup_completions`` requests have completed (so every slot has
been refilled at least about once and the start's burst of prefills is
over), and closes at the end of the first step that ends ``seconds``
after it opened.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["Record", "run"]


@dataclasses.dataclass
class Record:
    index: int
    prompt: np.ndarray
    new_tokens: int
    sent: float
    stamps: List[float] = dataclasses.field(default_factory=list)
    end: Optional[float] = None
    output: Optional[List[int]] = None
    rejected: Optional[str] = None


def run(engine, requests: Iterator, *, clients: int, warmup_completions: int,
        seconds: float, on_open: Optional[Callable[[float], None]] = None,
        on_step: Optional[Callable[[float], None]] = None,
        clock: Callable[[], float] = time.perf_counter) -> Tuple[List[Record], float, float]:
    """Run the loop; returns (records, window start, window end)."""
    from repro_torch.serve.engine import Request

    records: List[Record] = []
    live = []

    def send() -> None:
        spec = next(requests)
        req = Request(prompt=spec.prompt, max_new_tokens=spec.new_tokens, eos_id=-1)
        rec = Record(spec.index, spec.prompt, spec.new_tokens, sent=clock())
        records.append(rec)
        if engine.submit(req):
            live.append((rec, req))
        else:
            rec.end, rec.rejected, rec.output = rec.sent, req.reject_reason, []

    for _ in range(clients):
        send()
    w0 = None
    completed = 0
    while True:
        engine.step()
        now = clock()
        still, finished = [], 0
        for rec, req in live:
            n = len(req.output)
            if n > len(rec.stamps):
                rec.stamps.extend([now] * (n - len(rec.stamps)))
            if req.done or req.reject_reason is not None:
                rec.end, rec.output, rec.rejected = now, list(req.output), req.reject_reason
                finished += 1
            else:
                still.append((rec, req))
        live[:] = still
        completed += finished
        for _ in range(finished):
            send()
        if on_step is not None:
            on_step(now)
        if w0 is None:
            if completed >= warmup_completions:
                w0 = now
                if on_open is not None:
                    on_open(now)
        elif now - w0 >= seconds:
            return records, w0, now
