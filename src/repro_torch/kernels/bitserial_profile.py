"""Bit-serial zero-plane profile (§IV-B) on Hopper: wrapper of
``csrc/bitserial_profile.cu``.

Replaces ``repro/kernels/bitserial_profile.py:41``
(``bitserial_zero_profile_pallas``).  The CUDA source says how the kernel
is laid out and what bounds it.  The result equals the plain version
``ref.bitserial_zero_profile_ref`` exactly.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import check_slot_count

__all__ = ["bitserial_zero_profile_cuda", "launches"]

# launches of the CUDA kernel since the last reset (see ops.reset_launch_counts)
launches = 0


def bitserial_zero_profile_cuda(q: torch.Tensor, group_rows: int,
                                n_bits: int = 8) -> torch.Tensor:
    """int32 ``[skippable, total]`` of int8 ``q`` (V, K) on a CUDA device.

    Raises where ``V·⌈K/g⌉·n_bits`` does not fit int32, and for
    ``n_bits`` outside [1, 32].
    """
    global launches
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"q must be 2-D int8, got {q.dtype} of shape {tuple(q.shape)}")
    if not 1 <= n_bits <= 32:
        raise ValueError(f"n_bits must lie in [1, 32], got {n_bits}")
    V, K = q.shape
    check_slot_count(V, K, group_rows, n_bits)
    if not q.is_cuda:
        raise ValueError("bitserial_zero_profile_cuda takes CUDA tensors")
    q = q.contiguous()
    counter = torch.empty(1, dtype=torch.int64, device=q.device)
    out = torch.empty(2, dtype=torch.int32, device=q.device)
    lib = _build.load("bitserial_profile")
    with torch.cuda.device(q.device):
        rc = lib.bsp_count(q.data_ptr(), counter.data_ptr(), out.data_ptr(), V, K,
                           group_rows, n_bits, _build.stream_ptr(q.device))
    _build.check(rc, "bsp_count")
    launches += 1
    return out
