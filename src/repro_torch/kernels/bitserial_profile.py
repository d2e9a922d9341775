"""Bit-serial zero-plane profile (§IV-B) on Hopper: wrapper of
``csrc/bitserial_profile.cu``.

Replaces ``repro/kernels/bitserial_profile.py:41``
(``bitserial_zero_profile_pallas``).  The CUDA source says how each
variant is laid out and what bounds it; :func:`plans.bsp_plan` picks the
variant before the launch: ``strip`` or ``general`` for an int8 count,
``fused`` for the quantise-and-count of a bf16 or f32 activation.  The
results equal the plain versions ``ref.bitserial_zero_profile_ref`` and
``ref.quantized_zero_profile_ref`` exactly.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build
from .plans import bsp_plan
from .ref import check_slot_count, quantize_int8

__all__ = ["bitserial_zero_profile_cuda", "quantized_zero_profile_cuda", "launches",
           "variant_launches"]

# launches of the CUDA kernel since the last reset (see ops.reset_launch_counts),
# in all and per variant
launches = 0
variant_launches = {"strip": 0, "fused": 0, "general": 0}

# The one-launch variants' accumulator per device: one 64-bit word, zeroed
# once; each call leaves it at 0 again.  Calls on one device must
# therefore not overlap on two streams (the profile issues them in order
# on one stream).
_ACCUMULATORS: Dict[int, torch.Tensor] = {}


def _accumulator(device: torch.device) -> torch.Tensor:
    acc = _ACCUMULATORS.get(device.index)
    if acc is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the bit-serial profile's first call on a device must come "
                               "before a CUDA graph capture (it allocates the device's "
                               "accumulator)")
        acc = torch.zeros(1, dtype=torch.int64, device=device)
        _ACCUMULATORS[device.index] = acc
    return acc


def _check(t: torch.Tensor, group_rows: int, n_bits: int) -> None:
    if t.dim() != 2:
        raise TypeError(f"expected a 2-D tensor, got shape {tuple(t.shape)}")
    if not 1 <= n_bits <= 32:
        raise ValueError(f"n_bits must lie in [1, 32], got {n_bits}")
    check_slot_count(t.shape[0], t.shape[1], group_rows, n_bits)


def bitserial_zero_profile_cuda(q: torch.Tensor, group_rows: int,
                                n_bits: int = 8) -> torch.Tensor:
    """int32 ``[skippable, total]`` of int8 ``q`` (V, K) on a CUDA device.

    Raises where ``V·⌈K/g⌉·n_bits`` does not fit int32, and for
    ``n_bits`` outside [1, 32].
    """
    global launches
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"q must be 2-D int8, got {q.dtype} of shape {tuple(q.shape)}")
    _check(q, group_rows, n_bits)
    if not q.is_cuda:
        raise ValueError("bitserial_zero_profile_cuda takes CUDA tensors")
    q = q.contiguous()
    V, K = q.shape
    plan = bsp_plan(V, K, group_rows, q.dtype, _build.alignment(q.data_ptr()))
    out = torch.empty(2, dtype=torch.int32, device=q.device)
    lib = _build.load("bitserial_profile")
    with torch.cuda.device(q.device):
        stream = _build.stream_ptr(q.device)
        if plan.variant == "strip":
            rc = lib.bsp_count_strip(q.data_ptr(), _accumulator(q.device).data_ptr(),
                                     out.data_ptr(), V, K, group_rows, n_bits, plan.grid, stream)
        else:
            counter = torch.empty(1, dtype=torch.int64, device=q.device)
            rc = lib.bsp_count(q.data_ptr(), counter.data_ptr(), out.data_ptr(), V, K,
                               group_rows, n_bits, stream)
    _build.check(rc, f"bsp_count ({plan.variant})")
    launches += 1
    variant_launches[plan.variant] += 1
    return out


def quantized_zero_profile_cuda(x: torch.Tensor, group_rows: int, n_bits: int = 8, *,
                                per_tensor_scale: Optional[float] = None) -> torch.Tensor:
    """int32 ``[skippable, total]`` of ``quantize_int8(x)`` for a float
    ``x`` (V, K) on a CUDA device.

    The ``fused`` variant reads x once (after ``torch.aminmax`` for the
    scale, unless one is given) and writes no int8 tensor.  A shape,
    dtype or alignment it does not take is quantised by plain tensor ops
    on the card and counted by :func:`bitserial_zero_profile_cuda`.
    """
    global launches
    if not x.is_floating_point():
        raise TypeError(f"x must be a float tensor, got {x.dtype}")
    _check(x, group_rows, n_bits)
    if not x.is_cuda:
        raise ValueError("quantized_zero_profile_cuda takes CUDA tensors")
    x = x.contiguous()
    V, K = x.shape
    plan = bsp_plan(V, K, group_rows, x.dtype, _build.alignment(x.data_ptr()))
    if plan.variant != "fused":
        return bitserial_zero_profile_cuda(quantize_int8(x, per_tensor_scale=per_tensor_scale),
                                           group_rows, n_bits)
    amin = amax = None
    if per_tensor_scale is None and x.numel():
        amin, amax = torch.aminmax(x)
    out = torch.empty(2, dtype=torch.int32, device=x.device)
    fn = "bsp_fused_bf16" if x.dtype == torch.bfloat16 else "bsp_fused_f32"
    lib = _build.load("bitserial_profile")
    with torch.cuda.device(x.device):
        stream = _build.stream_ptr(x.device)
        rc = getattr(lib, fn)(x.data_ptr(), None if amin is None else amin.data_ptr(),
                              None if amax is None else amax.data_ptr(),
                              float(per_tensor_scale or 0.0),
                              _accumulator(x.device).data_ptr(), out.data_ptr(), V, K,
                              group_rows, n_bits, plan.grid, stream)
    _build.check(rc, fn)
    launches += 1
    variant_launches["fused"] += 1
    return out
