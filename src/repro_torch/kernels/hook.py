"""The kernels' hook into a count or a capture of a step.

:func:`repro_torch.launch.counting.count` pushes its counter here for the
length of its block, and :func:`repro_torch.trace.capture.capture` its
recorder; :mod:`.ops` asks :func:`active` whether one is open and, if so,
reports each op as one launch of its CUDA kernel through :func:`kernel`,
with the op's name and operands, from which a recorder writes the op's
math.  The model's layer loop asks :func:`capturing` whether to run as a
loop or be recorded as one scan.  The kernels layer thus needs nothing of
the launch or trace layers above it: only this stack, which they fill.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, List, Optional, Tuple

__all__ = ["active", "capturing", "paused", "kernel"]

# the open blocks' counters and recorders, innermost last
_STACK: List[Any] = []


def active() -> Optional[Any]:
    """The innermost block's counter or recorder, or None."""
    return _STACK[-1] if _STACK else None


def capturing() -> Optional[Any]:
    """The innermost block's recorder when that block is a capture (it sets
    ``captures``), else None."""
    top = active()
    return top if getattr(top, "captures", False) else None


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
def kernel(name: str, *, flops: int, bytes: int, op: Optional[str] = None,
           operands: Optional[Tuple[tuple, dict]] = None) -> Iterator[Callable]:
    """One launch of the CUDA kernel ``name`` that does ``flops`` and
    moves ``bytes``, made by the public op ``op`` on ``operands`` (its
    ``(args, kwargs)``): yields ``adopt(out) -> out``, to be called on what
    the kernel returns.  Outside a block it counts nothing; a counter reads
    the work, a capture's recorder the op and its operands."""
    counter = active()
    if counter is None:
        yield lambda out: out
        return
    with counter._kernel(name, flops, bytes, op=op, operands=operands) as adopt:
        yield adopt
