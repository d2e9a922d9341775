"""FullBlock block-sparse matmul on Hopper: wrapper of
``csrc/block_sparse_matmul.cu``.

Replaces ``repro/kernels/block_sparse_matmul.py:49``
(``block_sparse_matmul_pallas``).  The CUDA source says how each variant
is laid out and what bounds it; :func:`plans.bsm_plan` picks the variant
(``decode``, ``prefill``, ``general`` or ``f32``) and the cluster size
before the launch, from shapes, dtype and alignment.  Rows of ``x`` need
no padding: every variant zero-fills the ragged last row tile itself.
The plain version is ``ref.block_sparse_matmul_ref``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _build
from .plans import bsm_plan

__all__ = ["block_sparse_matmul_cuda", "launches", "variant_launches", "shape_launches"]

# launches of the CUDA kernel since the last reset (see ops.reset_launch_counts),
# in all, per variant and per (variant, K, N) of the weight
launches = 0
variant_launches = {"decode": 0, "prefill": 0, "general": 0, "f32": 0}
shape_launches: Dict[Tuple[str, int, int], int] = {}


def block_sparse_matmul_cuda(x: torch.Tensor, w_comp: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """(B, K) @ compressed (Gn, L, bm, bn) weight → (B, Gn*bn), CUDA tensors."""
    global launches
    if x.dtype != w_comp.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x/w_comp must share bf16 or f32, got {x.dtype}/{w_comp.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    B, K = x.shape
    Gn, L, bm, bn = w_comp.shape
    if K % bm:
        raise ValueError(f"K={K} not a multiple of block rows {bm}")
    if idx.shape != (Gn, L):
        raise ValueError(f"idx shape {tuple(idx.shape)} != {(Gn, L)}")
    if x.dtype == torch.bfloat16 and (bm % 16 or bn % 16 or bn > 512):
        raise ValueError(f"bf16 kernel needs bm, bn multiples of 16 and bn <= 512, got {bm}, {bn}")
    if not (x.is_cuda and w_comp.is_cuda and idx.is_cuda):
        raise ValueError("block_sparse_matmul_cuda takes CUDA tensors")
    x, w_comp, idx = x.contiguous(), w_comp.contiguous(), idx.contiguous()
    y = torch.empty(B, Gn * bn, dtype=x.dtype, device=x.device)
    if B == 0:
        return y
    plan = bsm_plan(B, K, Gn, L, bm, bn, x.dtype, _build.alignment(x.data_ptr(),
                                                                      w_comp.data_ptr()))
    lib = _build.load("block_sparse_matmul")
    args = (x.data_ptr(), w_comp.data_ptr(), idx.data_ptr(), y.data_ptr(), B, K, Gn, L)
    fn = {"decode": "bsm_bf16_decode", "prefill": "bsm_bf16_prefill",
          "general": "bsm_bf16_general", "f32": "bsm_f32"}[plan.variant]
    with torch.cuda.device(x.device):
        tail = (plan.cluster,) if plan.variant in ("decode", "prefill") else (bm, bn)
        rc = getattr(lib, fn)(*args, *tail, _build.stream_ptr(x.device))
    _build.check(rc, fn)
    launches += 1
    variant_launches[plan.variant] += 1
    key = (plan.variant, K, Gn * bn)
    shape_launches[key] = shape_launches.get(key, 0) + 1
    return y
