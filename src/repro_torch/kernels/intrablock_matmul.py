"""Row-aligned IntraBlock gather-matmul on Hopper: wrapper of
``csrc/intrablock_matmul.cu``.

Replaces ``repro/kernels/intrablock_matmul.py:41``
(``intrablock_gather_matmul_pallas``).  The CUDA source says how the
kernel is laid out and what bounds it.  Neither the rows of ``x`` nor the
columns of ``w_comp`` need padding: the kernel zero-fills the ragged
tiles itself.  The plain version is ``ref.intrablock_gather_matmul_ref``.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["intrablock_gather_matmul_cuda", "check_row_idx", "launches"]

# launches of the CUDA kernel since the last reset (see ops.reset_launch_counts)
launches = 0


def check_row_idx(row_idx: torch.Tensor, K: int) -> None:
    """Raise unless every entry of ``row_idx`` lies in [0, K).  Reads the
    tensor's extremes back to the host, so on a card it synchronises."""
    if row_idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(row_idx))
        if lo < 0 or hi >= K:
            raise ValueError(f"row_idx entries must lie in [0, {K}), got [{lo}, {hi}]")


def intrablock_gather_matmul_cuda(x: torch.Tensor, w_comp: torch.Tensor, row_idx: torch.Tensor,
                                  *, check_range: bool = True) -> torch.Tensor:
    """``x[:, row_idx] @ w_comp`` for CUDA tensors: x (B, K), w_comp (Kc, N),
    row_idx (Kc,) int32 → (B, N) in x's dtype.

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
    x, w_comp, row_idx = x.contiguous(), w_comp.contiguous(), row_idx.contiguous()
    y = torch.empty(B, N, dtype=x.dtype, device=x.device)
    if B == 0 or N == 0:
        return y
    fn = "igm_bf16" if x.dtype == torch.bfloat16 else "igm_f32"
    lib = _build.load("intrablock_matmul")
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn)(x.data_ptr(), w_comp.data_ptr(), row_idx.data_ptr(),
                              y.data_ptr(), B, K, Kc, N, _build.stream_ptr(x.device))
    _build.check(rc, fn)
    launches += 1
    return y
