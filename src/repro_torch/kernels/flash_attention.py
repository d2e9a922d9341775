"""Flash attention on Hopper: wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py:94`` (``flash_attention_pallas``).
The CUDA source says how each variant is laid out and what bounds it;
:func:`plans.fa_plan` picks the variant (``wgmma``, ``general`` or
``f32``) and its tile sizes before the launch, from dtype, head dim,
shape and alignment.  This wrapper checks its inputs, allocates the output
and launches on PyTorch's current stream; it never falls back to another
variant or to the plain version (``ref.flash_attention_ref``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .plans import fa_plan

__all__ = ["flash_attention_cuda", "launches", "variant_launches"]

HEAD_DIMS = (64, 128, 256)

# launches of the CUDA kernel since the last reset (see ops.reset_launch_counts),
# in all and per variant
launches = 0
variant_launches = {"wgmma": 0, "general": 0, "f32": 0}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Attention over (B, S, H, hd) CUDA tensors; kv head = q head // G."""
    global launches
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q/k/v must share bf16 or f32, got {q.dtype}/{k.dtype}/{v.dtype}")
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, Hkv, hd) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} mismatches q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    plan = fa_plan(B, Sq, Skv, Hq, Hkv, hd, q.dtype, bool(causal), window,
                   _build.alignment(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()))
    lib = _build.load("flash_attention")
    scale = 1.0 / math.sqrt(hd)
    stream = _build.stream_ptr(q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        if plan.variant == "wgmma":
            fn = "fa_fwd_bf16_wgmma"
            rc = lib.fa_fwd_bf16_wgmma(*ptrs, B, Sq, Hq, Hkv, hd, int(window or 0), scale,
                                       plan.rows, plan.keys, plan.pack, stream)
        else:
            fn = "fa_fwd_bf16" if plan.variant == "general" else "fa_fwd_f32"
            rc = getattr(lib, fn)(*ptrs, B, Sq, Skv, Hq, Hkv, hd, int(causal), int(window or 0),
                                  scale, stream)
    _build.check(rc, fn)
    launches += 1
    variant_launches[plan.variant] += 1
    return out
