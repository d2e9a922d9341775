"""The kernels' hook into a count of a step.

:func:`repro_torch.launch.counting.count` pushes its counter here for the
length of its block; :mod:`.ops` asks :func:`active` whether one is open
and, if so, reports each op as one launch of its CUDA kernel through
:func:`kernel`.  The kernels layer thus needs nothing of the launch layer
above it: only this stack, which the counter fills.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, List, Optional

__all__ = ["active", "paused", "kernel"]

# the open count blocks' counters, innermost last
_STACK: List[Any] = []


def active() -> Optional[Any]:
    """The innermost count block's counter, or None."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """Count none of the ops run inside the block (work reckoned off the
    record, as :mod:`.work` reads an index tensor)."""
    counter = active()
    if counter is not None:
        counter._paused += 1
    try:
        yield
    finally:
        if counter is not None:
            counter._paused -= 1


@contextlib.contextmanager
def kernel(name: str, *, flops: int, bytes: int) -> Iterator[Callable]:
    """One launch of the CUDA kernel ``name`` that does ``flops`` and
    moves ``bytes``: yields ``adopt(out) -> out``, to be called on what the
    kernel returns.  Outside a count block it counts nothing."""
    counter = active()
    if counter is None:
        yield lambda out: out
        return
    with counter._kernel(name, flops, bytes) as adopt:
        yield adopt
