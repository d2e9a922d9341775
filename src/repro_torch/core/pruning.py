"""FullBlock pruning (paper §IV-D) on tensors, on their own device.

Port of ``block_losses``, ``fullblock_mask`` and ``flexblock_mask`` of
``repro/core/pruning.py``.  The Eq. 1 block losses come from the
``block_importance`` op, so on a CUDA tensor they run in the Hopper
kernel.  The ``r·n_blocks`` lowest-loss blocks are pruned; ties break by
block index exactly as the reference's stable argsort does.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops
from .flexblock import FlexBlockSpec, FullBlock

__all__ = ["block_losses", "keep_from_losses", "fullblock_keep", "fullblock_mask",
           "flexblock_mask"]


def block_losses(w: torch.Tensor, m: int, n: int, criterion: str = "l1", *,
                 impl: str = "auto") -> torch.Tensor:
    """Eq. 1: per-block aggregated importance, (ceil(M/m), ceil(N/n)) f32.

    The matrix is zero-padded up to whole blocks; padding adds no loss.
    """
    M, N = w.shape
    pm, pn = (-M) % m, (-N) % n
    if pm or pn:
        w = torch.nn.functional.pad(w, (0, pn, 0, pm))
    return ops.block_importance(w, m, n, criterion, impl=impl)


def keep_from_losses(losses: torch.Tensor, n_keep: int,
                     eligible: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keep-grid (bool) of the ``n_keep`` highest-loss blocks; ties break
    by block index (stable sort), as the reference's argsort does.
    ``eligible`` (block-grid bool) marks blocks already zero from a prior
    pattern: they count as pruned for free."""
    flat = losses.reshape(-1)
    if eligible is not None:
        flat = torch.where(eligible.reshape(-1).to(flat.device), flat,
                           torch.full_like(flat, float("-inf")))
    order = torch.sort(-flat, stable=True).indices
    keep = torch.zeros(flat.numel(), dtype=torch.bool, device=losses.device)
    keep[order[:n_keep]] = True
    return keep.reshape(losses.shape)


def fullblock_keep(w: torch.Tensor, pattern: FullBlock, criterion: str = "l1", *,
                   eligible: Optional[torch.Tensor] = None,
                   impl: str = "auto") -> torch.Tensor:
    """Block keep-grid (bool, (gm, gn)) keeping the highest-loss blocks."""
    p = pattern.bind(tuple(w.shape))
    losses = block_losses(w, p.m, p.n, criterion, impl=impl)
    return keep_from_losses(losses, p.nonzero_blocks(tuple(w.shape)), eligible)


def _expand(keep: torch.Tensor, m: int, n: int, shape) -> torch.Tensor:
    mask = keep.repeat_interleave(m, dim=0).repeat_interleave(n, dim=1)
    return mask[: shape[0], : shape[1]]


def fullblock_mask(w: torch.Tensor, pattern: FullBlock, criterion: str = "l1", *,
                   eligible: Optional[torch.Tensor] = None,
                   impl: str = "auto") -> torch.Tensor:
    """Binary keep-mask (bool, 1 = keep) for FullBlock sparsity."""
    p = pattern.bind(tuple(w.shape))
    keep = fullblock_keep(w, pattern, criterion, eligible=eligible, impl=impl)
    return _expand(keep, p.m, p.n, w.shape)


def flexblock_mask(w: torch.Tensor, spec: FlexBlockSpec, criterion: str = "l1", *,
                   impl: str = "auto") -> torch.Tensor:
    """The spec's keep-mask (bool).  Only FullBlock specs are ported."""
    spec = spec.bind(tuple(w.shape))
    spec.validate_for(tuple(w.shape))
    if spec.intra is not None:
        raise NotImplementedError("IntraBlock pruning is not ported to repro_torch yet")
    if spec.is_dense:
        return torch.ones(w.shape, dtype=torch.bool, device=w.device)
    return fullblock_mask(w, spec.full, criterion, impl=impl)
