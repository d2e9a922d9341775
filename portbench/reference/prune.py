"""Plain PyTorch recomputation of which weights FlexBlock pruning keeps
(paper §IV-D), from the dense weights alone.

* IntraBlock(m, 1) row-aligned (Eq. 2 with one pattern per m-row block
  shared by every column): each row's importance is the sum of |w| over
  its columns, and each block of m rows keeps its φ = ⌊(1 - r)·m⌋ rows of
  highest importance, the lower row first on ties.  The sums are taken
  in f32 over a (blocks, columns, m) array, the layout in which the
  importances are laid out for the choice.
* FullBlock(bm, bn) (Eq. 1): each bm×bn block's loss is the sum of |w|
  over it (the matrix zero-padded to whole blocks), and the
  ⌊(1 - r)·blocks⌋ blocks of highest loss are kept, the lower block
  index first on ties.

A layer's weight is viewed as the matrix it is masked as: (K, N) for a
projection (``wq`` (d, Hq, hd) as (d, Hq·hd)), and (E, d·ff) for an
expert leaf (E, d, ff).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["as_matrix", "intrablock_mask", "fullblock_mask", "mask_of"]


def as_matrix(w: torch.Tensor) -> torch.Tensor:
    return w if w.dim() == 2 else w.reshape(w.shape[0], -1)


def intrablock_mask(w: torch.Tensor, m: int, ratio: float) -> torch.Tensor:
    K, N = w.shape
    phi = math.floor((1 - ratio) * m)
    pad = (-K) % m
    a = F.pad(w.abs().float(), (0, 0, 0, pad)) if pad else w.abs().float()
    gm = a.shape[0] // m
    imp = a.reshape(gm, m, N, 1).permute(0, 2, 1, 3).reshape(gm, N, m).sum(dim=1)
    top = torch.sort(-imp, dim=-1, stable=True).indices[:, :phi]
    keep = torch.zeros_like(imp, dtype=torch.bool)
    keep.scatter_(-1, top, True)
    rows = keep.reshape(-1)[:K]
    return rows[:, None].expand(K, N)


def fullblock_mask(w: torch.Tensor, bm: int, bn: int, ratio: float) -> torch.Tensor:
    M, N = w.shape
    pm, pn = (-M) % bm, (-N) % bn
    a = w.abs().float()
    if pm or pn:
        a = F.pad(a, (0, pn, 0, pm))
    gm, gn = a.shape[0] // bm, a.shape[1] // bn
    losses = a.reshape(gm, bm, gn, bn).sum(dim=(1, 3)).reshape(-1)
    n_keep = math.floor((1 - ratio) * gm * gn)
    order = torch.sort(-losses, stable=True).indices
    keep = torch.zeros(gm * gn, dtype=torch.bool, device=w.device)
    keep[order[:n_keep]] = True
    grid = keep.reshape(gm, gn)
    mask = grid.repeat_interleave(bm, dim=0).repeat_interleave(bn, dim=1)
    return mask[:M, :N]


def mask_of(w: torch.Tensor, pruning: dict) -> torch.Tensor:
    """The keep-mask of one layer ``w`` in ``w``'s own shape."""
    mat = as_matrix(w)
    if pruning["pattern"] == "intrablock":
        mask = intrablock_mask(mat, pruning["m"], pruning["ratio"])
    elif pruning["pattern"] == "fullblock":
        mask = fullblock_mask(mat, pruning["bm"], pruning["bn"], pruning["ratio"])
    else:
        raise ValueError(f"unknown pattern {pruning['pattern']!r}")
    return mask.reshape(w.shape)
