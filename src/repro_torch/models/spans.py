"""Spans of the model and the serving engine, tied to the execution plane.

:mod:`repro_torch.obs` imports no torch, so it leaves two hooks open
(:func:`~repro_torch.obs.core.set_span_hooks`), which importing this
module fills: a span records nothing under a trace capture
(:func:`~repro_torch.kernels.hook.capturing`), where the model's code runs
once to be recorded rather than to compute; and while a torch profiler
records, each span opens a ``torch.profiler.record_function`` range of its
own name, so that the profiler stamps the span on its own clock beside the
device work launched inside it.  Whether a profiler records is one read of
``torch.autograd.profiler._is_profiler_enabled``; both hooks are asked
only while an observer is enabled, so with none a span costs one check.
"""
from __future__ import annotations

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

from .. import obs
from ..kernels import hook

__all__ = ["span"]

span = obs.span


def _capturing() -> bool:
    return hook.capturing() is not None


def _mirror(name: str):
    return record_function(name) if _profiler._is_profiler_enabled else None


obs.core.set_span_hooks(suppressed=_capturing, mirror=_mirror)
