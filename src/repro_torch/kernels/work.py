"""The work of one launch of each CUDA kernel: its flops and the bytes it
must move (each input read once, each output written once), reckoned from
the shapes and from the plan (:mod:`.plans`) that the kernel's wrapper
would pick for CUDA tensors of those shapes.

:mod:`.ops` reports these to a :func:`~repro_torch.launch.counting.count`
block in place of the ATen ops of the plain stand-in that runs off the
card, so that a count on the ``meta`` device (the dry-run) reads the work
the card does: flash attention over its live kv tiles only, where the
plain version materialises every score.  Each function takes the
arguments of the op of the same name in :mod:`.ops` and returns
``{"flops": ..., "bytes": ...}``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build
from .plans import bsp_plan, fa_live_tiles, fa_plan

__all__ = ["flash_attention", "block_sparse_matmul", "intrablock_gather_matmul",
           "block_importance", "bitserial_zero_profile", "quantized_zero_profile"]

# the general flash kernel's tile (BQ query rows x BK keys, csrc/flash_attention.cu)
_FA_GENERAL_TILE = (64, 64)


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _align(*ts: torch.Tensor) -> int:
    """The alignment the wrappers read off the addresses (a ``meta``
    tensor's address is 0: aligned, as the card's allocator aligns)."""
    return _build.alignment(*(t.data_ptr() for t in ts))


def _work(flops: int, nbytes: int) -> Dict[str, int]:
    return {"flops": int(flops), "bytes": int(nbytes)}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, **_) -> Dict[str, int]:
    """4·hd flops for each (query row, key) pair of every kv tile a CTA
    visits: the ``wgmma`` variant walks tiles of ``keys`` keys for ``rows /
    pack`` query positions over the live range of ``plans.fa_live_tiles``,
    the ``general`` one 64 x 64 tiles, the ``f32`` one each live key of
    each row.  Bytes: q, k and v read, the output written."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    plan = fa_plan(B, Sq, Skv, Hq, Hkv, hd, q.dtype, bool(causal), window, _align(q, k, v))
    if plan.variant == "wgmma":
        P, keys = plan.rows // plan.pack, plan.keys
    elif plan.variant == "general":
        P, keys = _FA_GENERAL_TILE
    else:
        P, keys = 1, 1
    pairs = 0                      # (query row, key) pairs of one (batch, q head)
    for p_lo in range(0, Sq, P):
        p_hi = min(p_lo + P, Sq) - 1
        lo, hi = fa_live_tiles(p_lo, p_hi, keys, window)
        hi = min(hi, (Skv - 1) // keys) if causal else (Skv - 1) // keys
        pairs += P * max(hi - lo + 1, 0) * keys
    return _work(4 * hd * B * Hq * pairs, _nbytes(q, k, v, q))


def block_sparse_matmul(x: torch.Tensor, w_comp: torch.Tensor, idx: torch.Tensor,
                        **_) -> Dict[str, int]:
    """2·B·bm·bn flops per live block (``idx >= 0``; on ``meta``, where idx
    has no values, every slot); bytes: x, the live blocks and idx read, y
    written."""
    B = x.shape[0]
    Gn, L, bm, bn = w_comp.shape
    live = Gn * L if idx.is_meta else int((idx >= 0).sum())
    return _work(2 * B * bm * bn * live,
                 _nbytes(x, idx) + live * bm * bn * w_comp.element_size()
                 + B * Gn * bn * x.element_size())


def intrablock_gather_matmul(x: torch.Tensor, w_comp: torch.Tensor, row_idx: torch.Tensor,
                             **_) -> Dict[str, int]:
    """2·B·Kc·N flops; bytes: x, w_comp and row_idx read, y written."""
    B = x.shape[0]
    Kc, N = w_comp.shape
    return _work(2 * B * Kc * N, _nbytes(x, row_idx) + Kc * N * w_comp.element_size()
                 + B * N * x.element_size())


def block_importance(w: torch.Tensor, bm: int, bn: int, criterion: str = "l1",
                     **_) -> Dict[str, int]:
    """2 flops a weight (its |w| or w², then the add); bytes: w read, the
    (M/bm, N/bn) f32 losses written."""
    M, N = w.shape
    return _work(2 * M * N, _nbytes(w) + (M // bm) * (N // bn) * 4)


def bitserial_zero_profile(q: torch.Tensor, group_rows: int, n_bits: int = 8,
                           **_) -> Dict[str, int]:
    """2 flops an int8 element (the group's OR, the bit test); bytes: q
    read, the two int32 counts written."""
    return _work(2 * q.numel(), _nbytes(q) + 8)


def quantized_zero_profile(x: torch.Tensor, group_rows: int, n_bits: int = 8, *,
                           per_tensor_scale: Optional[float] = None, **_) -> Dict[str, int]:
    """The ``fused`` variant: 4 flops an element (divide, clamp, round, OR)
    on one read of x, after a ``torch.aminmax`` pass (1 flop and one read
    an element) unless a scale is given.  Any other plan: the int8 count
    after plain quantisation on the card (x read, int8 written)."""
    V, K = x.shape
    n = x.numel()
    if bsp_plan(V, K, group_rows, x.dtype, _align(x)).variant != "fused":
        count = bitserial_zero_profile(x, group_rows, n_bits)
        return _work(4 * n + count["flops"], _nbytes(x) + n + n + 8)
    amin = per_tensor_scale is None and n > 0
    return _work(4 * n + (n if amin else 0), _nbytes(x) * (2 if amin else 1) + 8)
