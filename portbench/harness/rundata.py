"""What a run hands its metric readers (``portbench/metrics/<name>.py``):
the loop's records and window, the host-clock spans of the traced calls,
the device trace's summary, the recorded kernel calls, the set-up times,
the configuration and the device's published peaks.  Each reader takes a
:class:`RunData` and returns a number, or None where it finds nothing to
read."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["RunData", "percentile", "reader", "read_metric", "kernel_of"]


@dataclasses.dataclass
class RunData:
    cfg: dict
    records: list
    t_start: float                 # process start, host clock
    w0: float                      # window opens
    w1: float                      # window closes
    prune_s: float
    spans: list = dataclasses.field(default_factory=list)
    span_end: Optional[float] = None     # spans read up to here (the profiler's start)
    trace: Optional[dict] = None
    calls: list = dataclasses.field(default_factory=list)
    peaks: Optional[dict] = None

    # -- the window's tokens -------------------------------------------------
    def window_tokens(self) -> List[Tuple[object, int, float]]:
        """(record, token index, stamp) of every token stamped in the window."""
        out = []
        for r in self.records:
            for i, t in enumerate(r.stamps):
                if self.w0 < t <= self.w1:
                    out.append((r, i, t))
        return out

    # -- spans ---------------------------------------------------------------
    def steps(self) -> List[dict]:
        """Each ``step()`` span that ended in the window (before the
        profiler's start in a traced run), with the prefill and decode
        spans inside it."""
        end = self.span_end if self.span_end is not None else self.w1
        out, prefills, decodes = [], [], []
        for kind, t0, t1, info in self.spans:
            if kind == "prefill":
                prefills.append((t0, t1, info))
            elif kind == "decode":
                decodes.append((t0, t1))
            elif kind == "step":
                if self.w0 < t1 <= end:
                    out.append({"t0": t0, "t1": t1, "prefills": prefills, "decodes": decodes})
                prefills, decodes = [], []
        return out

    # -- trace ---------------------------------------------------------------
    def roofline(self, kernel: str) -> Optional[float]:
        """Σ least time over the kernel's calls in the traced window / Σ
        its device time there, in %: least time is the larger of the
        call's flops over the bf16 peak and its bytes over the HBM peak."""
        if not self.trace or not self.peaks:
            return None
        device_s = self.trace.get("op_device_s", {}).get(kernel, 0.0)
        calls = [c for k, c in self.calls if k == kernel]
        if not calls or device_s <= 0:
            return None
        work = importlib.import_module(f"portbench.work.{kernel}").work
        least = 0.0
        for c in calls:
            flops, nbytes = work(c)
            least += max(flops / self.peaks["bf16_flops_per_s"],
                         nbytes / self.peaks["hbm_bytes_per_s"])
        return 100.0 * least / device_s


def percentile(values, q: float) -> Optional[float]:
    """numpy's linear percentile, or None with no values."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if len(values) else None


_READERS: Dict[str, object] = {}


def reader(name: str):
    """The reader ``portbench/metrics/<name>.py``, loaded by its path.  A
    name ``<metric>.<variant>`` with no file of its own is read by
    ``<metric>``'s reader: a variant is the same quantity under a name of
    its own, for cells whose end-to-end metrics (and so their bounds, and
    what a per-layer metric moves) are their own."""
    if name not in _READERS:
        metrics = Path(__file__).resolve().parent.parent / "metrics"
        path = metrics / f"{name}.py"
        if not path.is_file() and "." in name:
            return reader(name.split(".")[0])
        spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _READERS[name] = mod
    return _READERS[name]


def read_metric(name: str, run: RunData) -> Optional[float]:
    return reader(name).read(run)


def kernel_of(metric: str) -> Optional[str]:
    """The kernel of a ``<kernel>_roofline`` metric (``<kernel>_roofline.<split>`` too)."""
    base = metric.split(".")[0]
    return base[:-len("_roofline")] if base.endswith("_roofline") else None
