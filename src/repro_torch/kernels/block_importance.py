"""Eq. 1 block losses on Hopper: wrapper of ``csrc/block_importance.cu``.

Replaces ``repro/kernels/block_importance.py:34``
(``block_importance_pallas``).  The CUDA source says how each variant is
laid out and what bounds it; :func:`plans.bi_plan` picks the variant
(``strip`` for 128 x 128 blocks, else ``general``) before the launch.
The plain version is ``ref.block_importance_ref``.
"""
from __future__ import annotations

import torch

from . import _build
from .plans import bi_plan

__all__ = ["block_importance_cuda", "launches", "variant_launches"]

CRITERIA = {"l1": 0, "l2": 1}

# launches of the CUDA kernel since the last reset (see ops.reset_launch_counts),
# in all and per variant
launches = 0
variant_launches = {"strip": 0, "general": 0}


def block_importance_cuda(w: torch.Tensor, bm: int, bn: int,
                          criterion: str = "l1") -> torch.Tensor:
    """(M, N) CUDA weight → (M/bm, N/bn) f32 block losses."""
    global launches
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w must be bf16 or f32, got {w.dtype}")
    M, N = w.shape
    if M % bm or N % bn:
        raise ValueError(f"matrix {tuple(w.shape)} not divisible by block ({bm},{bn})")
    if not w.is_cuda:
        raise ValueError("block_importance_cuda takes a CUDA tensor")
    w = w.contiguous()
    out = torch.empty(M // bm, N // bn, dtype=torch.float32, device=w.device)
    variant = bi_plan(M, N, bm, bn, w.dtype, _build.alignment(w.data_ptr()))
    fn = ("bi_bf16" if w.dtype == torch.bfloat16 else "bi_f32") + (
        "_strip" if variant == "strip" else "")
    lib = _build.load("block_importance")
    with torch.cuda.device(w.device):
        if variant == "strip":
            rc = getattr(lib, fn)(w.data_ptr(), out.data_ptr(), M, N, CRITERIA[criterion],
                                  _build.stream_ptr(w.device))
        else:
            rc = getattr(lib, fn)(w.data_ptr(), out.data_ptr(), M, N, bm, bn,
                                  CRITERIA[criterion], _build.stream_ptr(w.device))
    _build.check(rc, fn)
    launches += 1
    variant_launches[variant] += 1
    return out
