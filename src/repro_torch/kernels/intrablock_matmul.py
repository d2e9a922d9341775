"""Row-aligned IntraBlock gather-matmul on Hopper: wrapper of
``csrc/intrablock_matmul.cu``.

Replaces ``repro/kernels/intrablock_matmul.py:41``
(``intrablock_gather_matmul_pallas``).  The CUDA source says how each
variant is laid out and what bounds it; :func:`plans.igm_plan` picks the
variant (``decode``, ``prefill``, ``general`` or ``f32``) and the cluster
size before the launch, from shapes, dtype, the row stride and the
alignment of ``w_comp``.  Neither the rows of ``x`` nor the columns of
``w_comp`` need padding: every variant zero-fills the ragged tiles itself.
``w_comp`` may be a row-strided view (stride (ldw, 1), ldw >= N), as
``sparsity.apply`` stores a weight whose N is no multiple of 8: the
kernels read it in place, with no copy.  The prefill variant gathers x
into a scratch buffer that this wrapper allocates, then multiplies (two
kernels, one call).  The plain version is
``ref.intrablock_gather_matmul_ref``, which takes the same views.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build
from .plans import igm_plan

__all__ = ["intrablock_gather_matmul_cuda", "check_row_idx", "row_stride", "launches",
           "variant_launches", "shape_launches"]

# calls that launched the CUDA kernel since the last reset (see
# ops.reset_launch_counts), in all, per variant and per (variant, Kc, N)
launches = 0
variant_launches = {"decode": 0, "prefill": 0, "general": 0, "f32": 0}
shape_launches: Dict[Tuple[str, int, int], int] = {}


def check_row_idx(row_idx: torch.Tensor, K: int) -> None:
    """Raise unless every entry of ``row_idx`` lies in [0, K).  Reads the
    tensor's extremes back to the host, so on a card it synchronises."""
    if row_idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(row_idx))
        if lo < 0 or hi >= K:
            raise ValueError(f"row_idx entries must lie in [0, {K}), got [{lo}, {hi}]")


def row_stride(w: torch.Tensor) -> Optional[int]:
    """The row stride (elements) of a (Kc, N) weight whose rows are
    contiguous and do not overlap (stride (ldw, 1), ldw >= N), else None.
    A one-row weight counts as stride N."""
    Kc, N = w.shape
    if N > 1 and w.stride(1) != 1:
        return None
    if Kc <= 1:
        return N
    return w.stride(0) if w.stride(0) >= N else None


def intrablock_gather_matmul_cuda(x: torch.Tensor, w_comp: torch.Tensor, row_idx: torch.Tensor,
                                  *, check_range: bool = True) -> torch.Tensor:
    """``x[:, row_idx] @ w_comp`` for CUDA tensors: x (B, K), w_comp (Kc, N),
    row_idx (Kc,) int32 → (B, N) in x's dtype.  ``w_comp`` is read in
    place when its rows are contiguous (stride (ldw, 1), ldw >= N), and
    copied to a contiguous tensor otherwise.

    ``check_range=False`` skips the range check of ``row_idx``, which
    synchronises with the card; only a caller that has checked the same
    indices already may pass it (:class:`~repro_torch.models.layers.IntraBlockLinear`
    checks its indices once, when it is built).
    """
    global launches
    if x.dtype != w_comp.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x/w_comp must share bf16 or f32, got {x.dtype}/{w_comp.dtype}")
    if row_idx.dtype != torch.int32:
        raise TypeError(f"row_idx must be int32, got {row_idx.dtype}")
    if x.dim() != 2 or w_comp.dim() != 2 or row_idx.dim() != 1:
        raise ValueError(f"want x (B, K), w_comp (Kc, N), row_idx (Kc,), got "
                         f"{tuple(x.shape)}, {tuple(w_comp.shape)}, {tuple(row_idx.shape)}")
    B, K = x.shape
    Kc, N = w_comp.shape
    if row_idx.shape[0] != Kc:
        raise ValueError(f"row_idx has {row_idx.shape[0]} entries, w_comp {Kc} rows")
    if not (x.is_cuda and w_comp.is_cuda and row_idx.is_cuda):
        raise ValueError("intrablock_gather_matmul_cuda takes CUDA tensors")
    if not (x.device == w_comp.device == row_idx.device):
        raise ValueError("x, w_comp and row_idx must be on one device")
    if check_range:
        check_row_idx(row_idx, K)
    x, row_idx = x.contiguous(), row_idx.contiguous()
    ldw = row_stride(w_comp)
    if ldw is None:
        w_comp = w_comp.contiguous()
        ldw = N
    y = torch.empty(B, N, dtype=x.dtype, device=x.device)
    if B == 0 or N == 0:
        return y
    plan = igm_plan(B, Kc, N, x.dtype, _build.alignment(w_comp.data_ptr()), ldw)
    lib = _build.load("intrablock_matmul")
    ptrs = (x.data_ptr(), w_comp.data_ptr(), row_idx.data_ptr())
    with torch.cuda.device(x.device):
        stream = _build.stream_ptr(x.device)
        if plan.variant == "decode":
            fn = "igm_bf16_decode"
            rc = lib.igm_bf16_decode(*ptrs, y.data_ptr(), B, K, Kc, N, ldw, plan.cluster,
                                     stream)
        elif plan.variant == "prefill":
            fn = "igm_bf16_prefill"
            Kp = -(-Kc // 8) * 8
            xg = torch.empty(B, Kp, dtype=x.dtype, device=x.device)
            rc = lib.igm_bf16_prefill(*ptrs, xg.data_ptr(), y.data_ptr(), B, K, Kc, Kp, N, ldw,
                                      plan.cluster, stream)
        else:
            fn = "igm_bf16_general" if plan.variant == "general" else "igm_f32"
            rc = getattr(lib, fn)(*ptrs, y.data_ptr(), B, K, Kc, N, ldw, stream)
    _build.check(rc, fn)
    launches += 1
    variant_launches[plan.variant] += 1
    shape_launches[plan.variant, Kc, N] = shape_launches.get((plan.variant, Kc, N), 0) + 1
    return y
