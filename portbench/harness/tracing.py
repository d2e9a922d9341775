"""Spans and the device trace of a ``--trace 1`` run, recorded from the
benchmark's side of the calls into the port.

:class:`Tracer` wraps, on the engine under test, ``ServeEngine.step`` and
``ServeEngine._prefill_slot`` (instance attributes) and the engine
module's ``decode_step`` name, keeping a host-clock span of each call for
the whole run; and it wraps the ops of :mod:`repro_torch.kernels.ops`
that the kernel-work files under ``portbench/work/`` name, recording each
call's shapes while the profiler runs.  Every wrapper also opens a
``torch.profiler.record_function`` range (``portbench.step``,
``portbench.prefill``, ``portbench.decode_step``, ``portbench.op.<kernel>``)
so that the device work the trace holds can be put down to the call
that launched it: a kernel belongs to a range when the runtime call that
launched it lies inside the range on the host.

The profiler runs over the last ``trace_seconds`` of the window only
(:meth:`Tracer.start` / :meth:`Tracer.stop`), and its events are
aggregated in the run from the raw kineto events; no trace file is
written.
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Tracer", "summarize", "WINDOW"]

WINDOW = "portbench.trace_window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
_NAME_CHARS = 100


class Tracer:
    def __init__(self, engine, work_modules: Dict[str, object],
                 clock: Callable[[], float] = time.perf_counter):
        self.engine, self.work_modules, self.clock = engine, work_modules, clock
        self.spans: List[Tuple[str, float, float, Optional[int]]] = []
        self.calls: List[Tuple[str, dict]] = []
        self.ctx: Dict[str, int] = {}
        self.profiling = False
        self.prof = None
        self.span_start: Optional[float] = None    # host clock at the profiler's start
        self.summary: Optional[dict] = None
        self._undo: List[Callable[[], None]] = []

    def install(self) -> None:
        import repro_torch.serve.engine as engine_mod
        from repro_torch.kernels import ops
        from torch.profiler import record_function

        eng, clock, spans = self.engine, self.clock, self.spans
        step0, prefill0, decode0 = eng.step, eng._prefill_slot, engine_mod.decode_step

        def step():
            t0 = clock()
            with record_function("portbench.step"):
                n = step0()
            spans.append(("step", t0, clock(), n))
            return n

        def prefill_slot(s, req):
            S = len(req.prompt)
            self.ctx["prefill_len"] = S
            t0 = clock()
            try:
                with record_function("portbench.prefill"):
                    prefill0(s, req)
            finally:
                self.ctx.pop("prefill_len", None)
            spans.append(("prefill", t0, clock(), S))

        def decode_step(*args, **kwargs):
            t0 = clock()
            with record_function("portbench.decode_step"):
                out = decode0(*args, **kwargs)
            spans.append(("decode", t0, clock(), None))
            return out

        eng.step, eng._prefill_slot, engine_mod.decode_step = step, prefill_slot, decode_step
        self._undo.append(lambda: setattr(engine_mod, "decode_step", decode0))
        for kernel, mod in self.work_modules.items():
            fn = getattr(ops, mod.OP)
            setattr(ops, mod.OP, self._wrap(kernel, mod, fn, record_function))
            self._undo.append(lambda op=mod.OP, fn=fn: setattr(ops, op, fn))

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    def _wrap(self, kernel: str, mod, fn, record_function):
        name = f"portbench.op.{kernel}"

        def op(*args, **kwargs):
            if not self.profiling:
                return fn(*args, **kwargs)
            self.calls.append((kernel, mod.describe(self.ctx, *args, **kwargs)))
            with record_function(name):
                return fn(*args, **kwargs)
        return op

    def _sync(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        loads and initialises CUPTI, which would otherwise eat into the
        traced window."""
        self.start()
        self.stop()
        self.span_start, self.summary = None, None
        self.calls.clear()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._sync()
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        self.profiling = True
        self.span_start = self.clock()

    def stop(self) -> None:
        self.profiling = False
        self._sync()
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self.summary = summarize(self.prof.profiler.kineto_results.events())
        self.prof = None


class _Ranges:
    """Sorted, non-overlapping [start, end] ranges of one name."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges)
        self.starts = [s for s, _ in self.ranges]

    def find(self, t: int) -> Optional[int]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.ranges[i][1] >= t:
            return i
        return None


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _kind(e) -> Optional[str]:
    """``annotation`` (a ``portbench.*`` range on the host), ``launch`` (a
    CUDA runtime or driver call), a device activity (``kernel``,
    ``gpu_memcpy``, ``gpu_memset``), or None.  Read from the event's
    activity type where the installed torch gives it, else from its
    device and name."""
    name = e.name()
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        if kind == "user_annotation":
            return "annotation" if name.startswith("portbench.") else None
        if kind in ("cuda_runtime", "cuda_driver"):
            return "launch"
        return kind if kind in DEVICE_ACTIVITIES else None
    on_device = "CUDA" in str(e.device_type())
    if name.startswith("portbench."):
        return None if on_device else "annotation"
    if not on_device:
        return "launch" if name.startswith("cu") else None
    if "memcpy" in name.lower():
        return "gpu_memcpy"
    if "memset" in name.lower():
        return "gpu_memset"
    return "kernel"


def summarize(events) -> dict:
    """Aggregate raw kineto events: the traced window's length and the
    seconds in which a device operation ran inside it; per kernel name
    the device seconds; per ``portbench.op.<kernel>`` range kind the
    device seconds of the work launched inside its ranges; the kernels
    launched inside ``portbench.decode_step`` ranges and the number of
    such ranges; the window's idle gaps put down to the innermost range
    the host was in at each gap's middle."""
    ann = collections.defaultdict(list)
    launched_at: Dict[int, int] = {}
    device = []
    for e in events:
        kind = _kind(e)
        if kind is None:
            continue
        s = e.start_ns()
        if kind == "annotation":
            ann[e.name()].append((s, s + e.duration_ns()))
        elif kind == "launch":
            launched_at[e.correlation_id()] = s
        else:
            device.append((s, s + e.duration_ns(), e.name(), kind,
                           e.correlation_id(), e.linked_correlation_id()))
    if not ann.get(WINDOW):
        return {}
    ws, we = ann.pop(WINDOW)[0]
    ranges = {name: _Ranges(rs) for name, rs in ann.items()}
    decode = ranges.get("portbench.decode_step")
    ops = {name[len("portbench.op."):]: r for name, r in ranges.items()
           if name.startswith("portbench.op.")}

    busy, by_name = [], collections.Counter()
    op_device = collections.Counter()
    decode_kernels = matched = 0
    for s, e, name, kind, corr, linked in device:
        cs, ce = max(s, ws), min(e, we)
        if ce > cs:
            busy.append((cs, ce))
            by_name[name[:_NAME_CHARS]] += (ce - cs) / 1e9
        t = launched_at.get(corr, launched_at.get(linked))
        if t is None:
            continue
        matched += 1
        for kernel, r in ops.items():
            if r.find(t) is not None:
                op_device[kernel] += (e - s) / 1e9
                break
        if kind == "kernel" and decode is not None and decode.find(t) is not None:
            decode_kernels += 1
    merged = _merge(busy)
    busy_s = sum(e - s for s, e in merged) / 1e9

    # idle gaps, put down to what the host was doing at each gap's middle
    order = ["portbench.op." + k for k in ops] + ["portbench.prefill", "portbench.decode_step",
                                                  "portbench.step"]
    gaps = collections.Counter()
    edge = ws
    for s, e in merged + [[we, we]]:
        if s > edge:
            mid = (edge + s) // 2
            where = next((n for n in order if n in ranges and ranges[n].find(mid) is not None),
                         "harness loop (between steps)")
            gaps[where.replace("portbench.", "")] += (s - edge) / 1e9
        edge = max(edge, e)
    decode_steps = 0 if decode is None else sum(1 for s, e in decode.ranges if ws <= s and e <= we)
    return {"window_s": (we - ws) / 1e9, "busy_s": busy_s,
            "device_ops": [[n, v] for n, v in by_name.most_common(10)],
            "idle_gaps": [[n, v] for n, v in gaps.most_common(10)],
            "op_device_s": dict(op_device), "decode_kernels": decode_kernels,
            "decode_steps": decode_steps, "device_events": len(device),
            "launches_matched": matched}
