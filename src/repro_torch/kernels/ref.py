"""Plain PyTorch versions of the ported kernels.

Each function computes what the matching oracle in
``repro/kernels/ref.py`` computes, on the same layouts.  They are the
CPU path of :mod:`repro_torch.kernels.ops` and the yardstick the CUDA
kernels are held to on the card.  ``quantize_int8`` is the port of
``repro/core/input_sparsity.py``'s, here because the fused quantise-and-
count op (``quantized_zero_profile_ref``) is defined by it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["flash_attention_ref", "block_sparse_matmul_ref",
           "intrablock_gather_matmul_ref", "block_importance_ref",
           "bitserial_zero_profile_ref", "check_slot_count", "quantize_scale",
           "quantize_int8", "quantized_zero_profile_ref"]


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


def intrablock_gather_matmul_ref(x: torch.Tensor, w_comp: torch.Tensor,
                                 row_idx: torch.Tensor) -> torch.Tensor:
    """y = x[:, row_idx] @ w_comp: the row-aligned IntraBlock matmul, the
    row gather standing in for the CIM mux input selection.  The sum is
    taken in f32 and cast to ``x.dtype`` once, as the oracle does."""
    xg = x[:, row_idx.long()]
    return (xg.float() @ w_comp.float()).to(x.dtype)


def block_importance_ref(w: torch.Tensor, bm: int, bn: int,
                         criterion: str = "l1") -> torch.Tensor:
    """Eq. 1 block losses: (M/bm, N/bn) f32 sums of ρ(w) per block."""
    M, N = w.shape
    if M % bm or N % bn:
        raise ValueError(f"matrix {tuple(w.shape)} not divisible by block ({bm},{bn})")
    rho = w.abs() if criterion == "l1" else w.square()
    return rho.float().reshape(M // bm, bm, N // bn, bn).sum(dim=(1, 3))


def check_slot_count(V: int, K: int, group_rows: int, n_bits: int) -> int:
    """The slot count V·⌈K/g⌉·n_bits, raising where it does not fit int32
    (the ``[skippable, total]`` result is int32 and must not wrap)."""
    if group_rows < 1 or n_bits < 0:
        raise ValueError(f"group_rows must be >= 1 and n_bits >= 0, got {group_rows}, {n_bits}")
    total = V * (-(-K // group_rows)) * n_bits
    if total >= 2**31:
        raise ValueError(f"V*G*n_bits = {total} slots overflow the int32 result")
    return total


def bitserial_zero_profile_ref(q: torch.Tensor, group_rows: int,
                               n_bits: int = 8) -> torch.Tensor:
    """int32 ``[skippable, total]``: of the (vector, group, bit) slots of
    int8 ``q`` (V, K), those whose bit b of |q| is 0 across the group.

    K is zero-padded to whole groups (padding is skippable).  |−128| is
    128, so its bit 7 is set.
    """
    V, K = q.shape
    total = check_slot_count(V, K, group_rows, n_bits)
    mag = q.to(torch.int32).abs()
    pad = (-K) % group_rows
    if pad:
        mag = torch.nn.functional.pad(mag, (0, pad))
    grouped = mag.reshape(V, mag.shape[1] // group_rows, group_rows)
    skippable = torch.zeros((), dtype=torch.int64, device=q.device)
    for b in range(n_bits):
        group_or = ((grouped >> b) & 1).amax(dim=-1)
        skippable += (group_or == 0).sum()
    return torch.stack([skippable, skippable.new_tensor(total)]).to(torch.int32)


def quantize_scale(x: torch.Tensor, per_tensor_scale: Optional[float] = None) -> torch.Tensor:
    """The f32 scale of :func:`quantize_int8` as a 0-d tensor on x's device.

    ``max(amax, 1e-8) / 127.0`` in f64 rounded to f32, as the reference
    computes it on the host (a Python float that numpy rounds to f32 when
    it divides an f32 array); a given scale is rounded to f32 the same
    way.  Computed on the device with no host copy, so a CUDA tensor costs
    no host sync; the divisor is a tensor, so that no backend divides by
    multiplying with the reciprocal.
    """
    if per_tensor_scale is not None:
        return torch.full((), per_tensor_scale, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        amax = torch.zeros((), dtype=torch.float64, device=x.device)
    else:
        amax = x.abs().amax().double()
    return (amax.clamp(min=1e-8) / torch.full_like(amax, 127.0)).float()


def quantize_int8(x: torch.Tensor, *, per_tensor_scale: Optional[float] = None) -> torch.Tensor:
    """Symmetric int8 quantisation (round half to even, saturating).

    Matches the reference bit for bit in f32 and in bf16: numpy promotes
    a bf16 array divided by a Python float to f32, so the reference
    divides ``f32(x)`` by ``f32(scale)``; so does this.  The divisor is
    an expanded tensor, not a scalar, so that no backend turns the
    division into a multiply by the reciprocal.
    """
    xf = x.float()
    s = quantize_scale(x, per_tensor_scale).expand_as(xf)
    return torch.round(xf / s).clamp_(-128, 127).to(torch.int8)


def quantized_zero_profile_ref(x: torch.Tensor, group_rows: int, n_bits: int = 8, *,
                               per_tensor_scale: Optional[float] = None) -> torch.Tensor:
    """int32 ``[skippable, total]`` of ``quantize_int8(x)`` (V, K): what the
    reference's profile counts for one activation."""
    return bitserial_zero_profile_ref(quantize_int8(x, per_tensor_scale=per_tensor_scale),
                                      group_rows, n_bits)
