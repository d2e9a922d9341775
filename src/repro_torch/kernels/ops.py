"""Public kernel API of the port: layout builders + ``impl`` dispatch.

``impl`` for every op:

* ``"auto"`` — the Hopper CUDA kernel for a CUDA tensor, the plain
  PyTorch version for a CPU tensor.
* ``"cuda"`` — the CUDA kernel (a CPU tensor raises).
* ``"ref"``  — the plain PyTorch version, on any device.

Shapes, layouts and errors follow ``repro/kernels/ops.py``.  Each CUDA
wrapper counts its launches in a plain integer; :func:`launch_counts`
reads them, :func:`variant_counts` reads the per-variant counts of the
five kernels, and :func:`reset_launch_counts` sets them all to 0.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import bitserial_profile as _bsp
from . import block_importance as _bi
from . import block_sparse_matmul as _bsm
from . import flash_attention as _fa
from . import intrablock_matmul as _igm
from . import ref as _ref

__all__ = ["IMPLS", "compress_fullblock", "compress_fullblock_torch",
           "compress_intrablock", "compress_intrablock_torch", "decompress_intrablock",
           "block_sparse_matmul", "intrablock_gather_matmul", "block_importance",
           "bitserial_zero_profile", "quantized_zero_profile", "flash_attention",
           "launch_counts", "variant_counts", "reset_launch_counts"]

IMPLS = ("auto", "cuda", "ref")
_KERNELS = {"flash_attention": _fa, "block_sparse_matmul": _bsm,
            "block_importance": _bi, "intrablock_gather_matmul": _igm,
            "bitserial_zero_profile": _bsp}


def _resolve(impl: str, t: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "cuda" if t.is_cuda else "ref"
    return impl


def launch_counts() -> Dict[str, int]:
    """CUDA kernel launches per op since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def variant_counts() -> Dict[str, Dict[str, int]]:
    """Launches per variant (see :mod:`~repro_torch.kernels.plans`) of the
    five kernels, since the last reset."""
    return {name: dict(mod.variant_launches) for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
        for v in mod.variant_launches:
            mod.variant_launches[v] = 0


# ---------------------------------------------------------------------------
# Layout builders (run once, at pruning time)
# ---------------------------------------------------------------------------

def compress_fullblock(w: np.ndarray, keep: np.ndarray, bm: int,
                       bn: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a FullBlock-pruned matrix into the kernel layout (numpy).

    A copy of ``repro.kernels.ops.compress_fullblock``.  ``keep``:
    (K/bm, N/bn) bool block keep-grid.  Returns ``w_comp`` (Gn, L, bm, bn)
    and ``idx`` (Gn, L) int32 with -1 padding, L = max surviving K-blocks
    over the output-column groups.
    """
    K, N = w.shape
    gk, gn = keep.shape
    if gk * bm != K or gn * bn != N:
        raise ValueError(f"keep grid {keep.shape} mismatches {w.shape}/({bm},{bn})")
    L = max(1, int(keep.sum(axis=0).max()))
    w_comp = np.zeros((gn, L, bm, bn), dtype=w.dtype)
    idx = np.full((gn, L), -1, dtype=np.int32)
    for j in range(gn):
        ks = np.nonzero(keep[:, j])[0]
        for l, kblk in enumerate(ks):
            w_comp[j, l] = w[kblk * bm:(kblk + 1) * bm, j * bn:(j + 1) * bn]
            idx[j, l] = kblk
    return w_comp, idx


def compress_fullblock_torch(w: torch.Tensor, keep: torch.Tensor, bm: int, bn: int,
                             L: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`compress_fullblock` on the tensor's own device, by indexing.

    Gives the same bytes as the numpy builder.  ``L`` may raise the slot
    count above the minimum (extra slots are -1 padding), so that the
    layers of a stacked weight share one shape.
    """
    K, N = w.shape
    gk, gn = keep.shape
    if gk * bm != K or gn * bn != N:
        raise ValueError(f"keep grid {tuple(keep.shape)} mismatches {tuple(w.shape)}/({bm},{bn})")
    keep = keep.to(torch.bool)
    counts = keep.sum(dim=0)
    L_min = max(1, int(counts.max()))
    L = L_min if L is None else L
    if not L_min <= L <= gk:
        raise ValueError(f"L={L} outside [{L_min}, {gk}] for this keep grid")
    # kept K-blocks of each column group first, in ascending order
    order = torch.sort((~keep).to(torch.uint8), dim=0, stable=True).indices   # (gk, gn)
    kblk = order[:L].T                                                       # (gn, L)
    valid = torch.arange(L, device=w.device)[None, :] < counts[:, None]      # (gn, L)
    idx = torch.where(valid, kblk, torch.full_like(kblk, -1)).to(torch.int32)
    blocks = w.reshape(gk, bm, gn, bn).permute(2, 0, 1, 3)                    # (gn, gk, bm, bn)
    w_comp = blocks[torch.arange(gn, device=w.device)[:, None], kblk.clamp(min=0)]
    w_comp = torch.where(valid[:, :, None, None], w_comp, torch.zeros_like(w_comp))
    return w_comp.contiguous(), idx


def compress_intrablock(w: np.ndarray, mask: np.ndarray,
                        m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a *row-aligned* IntraBlock(m,1)-pruned matrix (numpy).

    A copy of ``repro.kernels.ops.compress_intrablock``.  When the
    survivors of every m-row block sit in the same rows for every column
    (``intrablock_mask(..., align_cols=True)``), compression is a row
    subset: ``w_comp`` (Kc, N) = ``w[row_idx]`` with ``row_idx`` (Kc,)
    int32.  Raises if the mask is not row-aligned or the survivor counts
    are not uniform per block.
    """
    K, N = w.shape
    if K % m:
        raise ValueError(f"K={K} not a multiple of intra block m={m}")
    nblocks = K // m
    mb = mask.reshape(nblocks, m, N).astype(bool)
    if not np.all(mb == mb[:, :, :1]):
        raise ValueError(
            "mask is not row-aligned across columns; per-column IntraBlock "
            "has no gather layout — use decompress_intrablock()")
    pattern = mb[:, :, 0]                       # (nblocks, m)
    counts = pattern.sum(axis=1)
    phi = int(counts.max())
    if phi == 0:
        raise ValueError("mask keeps nothing")
    if not np.all(counts == phi):
        raise ValueError(f"non-uniform survivors per block: {set(counts.tolist())}")
    row_idx = np.nonzero(pattern.reshape(-1))[0].astype(np.int32)   # (nblocks*phi,)
    w_comp = np.ascontiguousarray(w[row_idx, :])
    return w_comp, row_idx


def decompress_intrablock(w: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """General per-column IntraBlock: masked-dense weights (numpy copy of
    the reference's)."""
    return np.asarray(w) * np.asarray(mask, dtype=w.dtype)


def compress_intrablock_torch(w: torch.Tensor, mask: torch.Tensor,
                              m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`compress_intrablock` on the tensor's own device.

    Gives the same bytes and raises the same errors as the numpy version.
    """
    K, N = w.shape
    if K % m:
        raise ValueError(f"K={K} not a multiple of intra block m={m}")
    mb = mask.reshape(K // m, m, N).to(torch.bool)
    pattern = mb[:, :, 0]                                          # (nblocks, m)
    if not torch.equal(mb, pattern[:, :, None].expand_as(mb)):
        raise ValueError(
            "mask is not row-aligned across columns; per-column IntraBlock "
            "has no gather layout — use decompress_intrablock()")
    counts = pattern.sum(dim=1)
    phi = int(counts.max()) if counts.numel() else 0
    if phi == 0:
        raise ValueError("mask keeps nothing")
    if not bool((counts == phi).all()):
        raise ValueError(f"non-uniform survivors per block: {set(counts.tolist())}")
    row_idx = torch.nonzero(pattern.reshape(-1)).reshape(-1).to(torch.int32)
    return w[row_idx.long()].contiguous(), row_idx


# ---------------------------------------------------------------------------
# Dispatch wrappers
# ---------------------------------------------------------------------------

def _check_tiles(**tiles: int) -> None:
    """The reference's tile arguments only pad B, N or V, so the result
    does not depend on them; here they are checked and otherwise unused
    (:mod:`.plans` picks the launch)."""
    for name, v in tiles.items():
        if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
            raise ValueError(f"{name} must be a positive int, got {v!r}")


def block_sparse_matmul(x: torch.Tensor, w_comp: torch.Tensor, idx: torch.Tensor, *,
                        impl: str = "auto", tile_b: int = 128) -> torch.Tensor:
    """(B, K) @ FullBlock-compressed weight (Gn, L, bm, bn) → (B, Gn*bn).
    ``tile_b`` is the reference's; see :func:`_check_tiles`."""
    _check_tiles(tile_b=tile_b)
    if _resolve(impl, x) == "ref":
        return _ref.block_sparse_matmul_ref(x, w_comp, idx)
    return _bsm.block_sparse_matmul_cuda(x, w_comp, idx)


def intrablock_gather_matmul(x: torch.Tensor, w_comp: torch.Tensor, row_idx: torch.Tensor, *,
                             impl: str = "auto", tile_b: int = 128, tile_n: int = 128,
                             check_range: bool = True) -> torch.Tensor:
    """``x[:, row_idx] @ w_comp``: x (B, K), w_comp (Kc, N), row_idx (Kc,)
    int32 → (B, N).  ``check_range`` as in
    :func:`~repro_torch.kernels.intrablock_matmul.intrablock_gather_matmul_cuda`;
    ``tile_b`` / ``tile_n`` are the reference's (see :func:`_check_tiles`)."""
    _check_tiles(tile_b=tile_b, tile_n=tile_n)
    if _resolve(impl, x) == "ref":
        return _ref.intrablock_gather_matmul_ref(x, w_comp, row_idx)
    return _igm.intrablock_gather_matmul_cuda(x, w_comp, row_idx, check_range=check_range)


def bitserial_zero_profile(q: torch.Tensor, group_rows: int, n_bits: int = 8, *,
                           impl: str = "auto", tile_v: int = 128) -> torch.Tensor:
    """int32 ``[skippable, total]`` zero-plane slots of int8 q (V, K).
    ``tile_v`` is the reference's; see :func:`_check_tiles`."""
    _check_tiles(tile_v=tile_v)
    if _resolve(impl, q) == "ref":
        return _ref.bitserial_zero_profile_ref(q, group_rows, n_bits)
    return _bsp.bitserial_zero_profile_cuda(q, group_rows, n_bits)


def quantized_zero_profile(x: torch.Tensor, group_rows: int, n_bits: int = 8, *,
                           per_tensor_scale: Optional[float] = None,
                           impl: str = "auto") -> torch.Tensor:
    """int32 ``[skippable, total]`` of ``quantize_int8(x)`` for a float x
    (V, K): the §IV-B profile of one activation.  On the card the
    quantisation is fused into the count's read of x."""
    if _resolve(impl, x) == "ref":
        return _ref.quantized_zero_profile_ref(x, group_rows, n_bits,
                                               per_tensor_scale=per_tensor_scale)
    return _bsp.quantized_zero_profile_cuda(x, group_rows, n_bits,
                                            per_tensor_scale=per_tensor_scale)


def block_importance(w: torch.Tensor, bm: int, bn: int, criterion: str = "l1", *,
                     impl: str = "auto", tile_n: int = 0) -> torch.Tensor:
    """Eq. 1 block losses (M/bm, N/bn) f32.  ``tile_n`` keeps the TPU
    kernel's column-strip contract: it must tile N in whole blocks."""
    if criterion not in _bi.CRITERIA:
        raise ValueError(f"criterion must be one of {tuple(_bi.CRITERIA)}, got {criterion!r}")
    if _resolve(impl, w) == "ref":
        return _ref.block_importance_ref(w, bm, bn, criterion)
    M, N = w.shape
    if M % bm or N % bn:
        raise ValueError(f"matrix {tuple(w.shape)} not divisible by block ({bm},{bn})")
    TN = tile_n or N
    if TN % bn or N % TN:
        raise ValueError(f"tile_n={TN} must tile N={N} in whole blocks of {bn}")
    return _bi.block_importance_cuda(w, bm, bn, criterion)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    impl: str = "auto", tile_q: int = 128,
                    tile_k: int = 128) -> torch.Tensor:
    """Fused attention over (B, S, H, hd) tensors with GQA broadcast.

    q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd) with Hq % Hkv == 0.  The
    CUDA path requires Sq and Skv to tile by ``tile_q``/``tile_k``, as
    the TPU kernel does.
    """
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if _resolve(impl, q) == "ref":
        G = Hq // Hkv
        if G > 1:
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)
        qf = q.transpose(1, 2).reshape(B * Hq, Sq, hd)
        kf = k.transpose(1, 2).reshape(B * Hq, Skv, hd)
        vf = v.transpose(1, 2).reshape(B * Hq, Skv, hd)
        of = _ref.flash_attention_ref(qf, kf, vf, causal=causal, window=window)
        return of.reshape(B, Hq, Sq, hd).transpose(1, 2)
    if Sq % tile_q or Skv % tile_k:
        raise ValueError(f"Sq={Sq}/Skv={Skv} must tile by {tile_q}/{tile_k}")
    return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
