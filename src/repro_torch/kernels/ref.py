"""Plain PyTorch versions of the ported kernels.

Each function computes what the matching oracle in
``repro/kernels/ref.py`` computes, on the same layouts.  They are the
CPU path of :mod:`repro_torch.kernels.ops` and the yardstick the CUDA
kernels are held to on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["flash_attention_ref", "block_sparse_matmul_ref",
           "block_importance_ref"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Dense softmax attention over (BH, S, hd) with causal/window masks."""
    hd = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(hd)
    qi = torch.arange(q.shape[1], device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    ok = torch.ones(s.shape[1:], dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    s = s.masked_fill(~ok[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def block_sparse_matmul_ref(x: torch.Tensor, w_comp: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """y[b, j*bn:(j+1)*bn] = Σ_l x[b, idx[j,l]*bm : +bm] @ w_comp[j, l].

    Slots with ``idx == -1`` add nothing, wherever they sit.  The sum is
    taken in f32 and cast to ``x.dtype`` once, as the oracle does.
    """
    Gn, L, bm, bn = w_comp.shape
    B = x.shape[0]
    xf = x.float()
    cols = torch.arange(bm, device=x.device)
    acc = torch.zeros(B, Gn, bn, dtype=torch.float32, device=x.device)
    for l in range(L):
        i = idx[:, l].long()
        valid = i >= 0
        xb = xf[:, (i.clamp(min=0)[:, None] * bm + cols).reshape(-1)]
        part = torch.einsum("bgk,gkn->bgn", xb.reshape(B, Gn, bm),
                            w_comp[:, l].float())
        acc += torch.where(valid[None, :, None], part, torch.zeros_like(part))
    return acc.reshape(B, Gn * bn).to(x.dtype)


def block_importance_ref(w: torch.Tensor, bm: int, bn: int,
                         criterion: str = "l1") -> torch.Tensor:
    """Eq. 1 block losses: (M/bm, N/bn) f32 sums of ρ(w) per block."""
    M, N = w.shape
    if M % bm or N % bn:
        raise ValueError(f"matrix {tuple(w.shape)} not divisible by block ({bm},{bn})")
    rho = w.abs() if criterion == "l1" else w.square()
    return rho.float().reshape(M // bm, bm, N // bn, bn).sum(dim=(1, 3))
