"""FlexBlock pruning (paper §IV-D) on tensors, on their own device.

Port of ``block_losses``, ``fullblock_mask``, ``intrablock_mask`` and
``flexblock_mask`` of ``repro/core/pruning.py``.

* FullBlock: the Eq. 1 block losses come from the ``block_importance``
  op, so on a CUDA tensor they run in the Hopper kernel.  The
  ``r·n_blocks`` lowest-loss blocks are pruned; ties break by block
  index exactly as the reference's stable argsort does.
* IntraBlock: per block, the pattern that keeps the most importance
  (Eq. 2): top-φ with stable ties for the full pattern set, else the
  first best pattern of ``pattern_set``.  ``align_cols`` shares one
  pattern per row-block across every column.  ρ(w) is taken in the
  weight's dtype as the reference does; the column sums of
  ``align_cols`` are taken in f32 (the reference sums in the array's
  dtype, so for bf16 weights near-ties may order differently).
* :func:`prune_matrix` composes the mask and its bookkeeping
  (:class:`PruningResult`) as the reference's does.

torch and the kernels are imported in the functions that use them, so
that ``repro_torch.core`` imports without torch.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from .flexblock import FlexBlockSpec, FullBlock, IntraBlock

if TYPE_CHECKING:
    import torch

__all__ = ["block_losses", "keep_from_losses", "fullblock_keep", "fullblock_mask",
           "intrablock_mask", "flexblock_mask", "prune_matrix", "PruningResult"]


def block_losses(w: torch.Tensor, m: int, n: int, criterion: str = "l1", *,
                 impl: str = "auto") -> torch.Tensor:
    """Eq. 1: per-block aggregated importance, (ceil(M/m), ceil(N/n)) f32.

    The matrix is zero-padded up to whole blocks; padding adds no loss.
    """
    import torch

    from ..kernels import ops

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
    import torch

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


def intrablock_mask(w: torch.Tensor, pattern: IntraBlock, criterion: str = "l1", *,
                    align_cols: bool = False) -> torch.Tensor:
    """Binary keep-mask (bool) for IntraBlock sparsity via Eq. 2.

    For the default (exhaustive) pattern set this is top-φ magnitude
    selection per block; for a restricted ``pattern_set`` each block
    takes ``argmax_P Σ_{P=1} ρ(w)`` (the first on ties).  With
    ``align_cols`` the importance is summed over the column grid, so one
    pattern per row-block is shared by every column: such masks compress
    to a row subset (:func:`~repro_torch.kernels.ops.compress_intrablock_torch`).
    """
    import torch

    if criterion not in ("l1", "l2"):
        raise ValueError(f"criterion must be l1 or l2, got {criterion!r}")
    m, n = pattern.m, pattern.n
    M, N = w.shape
    pm, pn = (-M) % m, (-N) % n
    if pm or pn:
        w = torch.nn.functional.pad(w, (0, pn, 0, pm))
    gm, gn = w.shape[0] // m, w.shape[1] // n
    rho = w.abs() if criterion == "l1" else w.square()
    # (gm, gn, m*n) per-block element importances
    imp = rho.reshape(gm, m, gn, n).permute(0, 2, 1, 3).reshape(gm, gn, m * n)
    if align_cols:
        # one shared pattern per row-block: the column-broadcast sums give
        # every column the same choice, so choose once and expand
        imp = imp.float().sum(dim=1, keepdim=True)
    if pattern.pattern_set is None:
        top = torch.sort(-imp, dim=-1, stable=True).indices[..., :pattern.phi]
        keep = torch.zeros(imp.shape, dtype=torch.bool, device=w.device)
        keep.scatter_(-1, top, True)
    else:
        pats = torch.tensor(pattern.patterns(), dtype=torch.float64, device=w.device)
        best = torch.argmax(imp.double() @ pats.T, dim=-1)             # (gm, gn')
        keep = pats[best].to(torch.bool)
    keep = keep.expand(gm, gn, m * n)
    mask = keep.reshape(gm, gn, m, n).permute(0, 2, 1, 3).reshape(gm * m, gn * n)
    return mask[:M, :N]


def flexblock_mask(w: torch.Tensor, spec: FlexBlockSpec, criterion: str = "l1", *,
                   align_cols: bool = False, impl: str = "auto") -> torch.Tensor:
    """Compose the spec's patterns into one keep-mask (bool).

    Coarse FullBlock first, then IntraBlock on the surviving weights
    ``w * mask``, as the §IV-D workflow (and the reference) orders them.
    """
    import torch

    spec = spec.bind(tuple(w.shape))
    spec.validate_for(tuple(w.shape))
    mask = torch.ones(w.shape, dtype=torch.bool, device=w.device)
    if spec.full is not None:
        mask &= fullblock_mask(w, spec.full, criterion, impl=impl)
    if spec.intra is not None:
        mask &= intrablock_mask(w * mask, spec.intra, criterion, align_cols=align_cols)
    return mask


class PruningResult:
    """Mask + bookkeeping produced by :func:`prune_matrix`."""

    __slots__ = ("mask", "spec", "block_keep", "density")

    def __init__(self, mask: torch.Tensor, spec: FlexBlockSpec,
                 block_keep: Optional[torch.Tensor], density: float):
        self.mask = mask              # (M, N) bool keep-mask
        self.spec = spec
        self.block_keep = block_keep  # coarse block-grid keep map (or None)
        self.density = density

    def apply(self, w: torch.Tensor) -> torch.Tensor:
        """``w`` times the mask, which moves to ``w``'s device and dtype."""
        return w * self.mask.to(device=w.device, dtype=w.dtype)


def prune_matrix(w: torch.Tensor, spec: FlexBlockSpec, criterion: str = "l1", *,
                 align_cols: bool = False, impl: str = "auto") -> PruningResult:
    """:func:`flexblock_mask` with the reference's bookkeeping: the bound
    spec, the FullBlock grid's keep map (a block keeps when any of its
    weights does) and the kept fraction."""
    import torch

    mask = flexblock_mask(w, spec, criterion, align_cols=align_cols, impl=impl)
    spec_b = spec.bind(tuple(w.shape))
    block_keep = None
    if spec_b.full is not None:
        f = spec_b.full
        gm, gn = f.grid(tuple(w.shape))
        M, N = mask.shape
        mp = torch.nn.functional.pad(mask.to(torch.int32), (0, gn * f.n - N, 0, gm * f.m - M))
        block_keep = mp.reshape(gm, f.m, gn, f.n).sum(dim=(1, 3)) > 0
    density = int(mask.sum()) / mask.numel()
    return PruningResult(mask, spec_b, block_keep, density)
