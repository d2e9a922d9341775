"""FlexBlock sparsity on live model parameters (port of
``repro/sparsity/apply.py``), plus the compressed execution layout.

* ``prune_params``   — a FlexBlock mask per layer of each eligible
  stacked weight, viewed as its (K, N) matmul matrix; returns
  (pruned_params, masks).  Block losses run in the ``block_importance``
  op, so on the card in the Hopper kernel.
* ``sparsity_report`` — per-tensor density.
* ``compress_params`` — replaces each masked projection with a
  :class:`~repro_torch.models.layers.BlockSparseLinear` in the
  ``compress_fullblock`` layout, which the model runs through the
  ``block_sparse_matmul`` op.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from .. import resolve_device
from ..core.flexblock import FlexBlockSpec
from ..core.pruning import flexblock_mask
from ..kernels.ops import compress_fullblock_torch
from ..models.layers import BlockSparseLinear

__all__ = ["PRUNABLE_KEYS", "prune_params", "sparsity_report", "compress_params"]

PRUNABLE_KEYS = ("w_gate", "w_up", "w_down", "w_in", "w_out",
                 "wq", "wk", "wv", "wo")


def _as_matrix(w: torch.Tensor) -> torch.Tensor:
    """Collapse one layer's weight to 2-D (shape[0], rest), as the
    reference does: the matmul matrix for wq/wk/wv/w_*, but (Hq, hd·d)
    for ``wo``, which is not its matmul orientation."""
    return w if w.dim() == 2 else w.reshape(w.shape[0], -1)


def prune_params(params: Dict[str, Any], spec: FlexBlockSpec, *, criterion: str = "l1",
                 keys: Tuple[str, ...] = PRUNABLE_KEYS, impl: str = "auto",
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Prune every eligible stacked layer weight; returns (params, masks).

    ``masks["layers"]`` mirrors ``params["layers"]``: a bool tensor of the
    weight's shape per pruned key, None elsewhere.  The weights are moved
    to ``device`` (default ``cuda``); the given tensors are left as they
    were.
    """
    dev = resolve_device(device)
    layers = params["layers"]
    new_layers = dict(layers)
    masks: Dict[str, Any] = {"layers": {}}
    for name, w in layers.items():
        if name not in keys:
            masks["layers"][name] = None
            continue
        w = w.to(dev)
        mask = torch.empty(w.shape, dtype=torch.bool, device=dev)
        for l in range(w.shape[0]):
            mat = _as_matrix(w[l])
            if 1 in mat.shape:
                mask[l] = True
                continue
            mask[l] = flexblock_mask(mat, spec, criterion, impl=impl).reshape(w.shape[1:])
        masks["layers"][name] = mask
        new_layers[name] = w * mask
    out = dict(params)
    out["layers"] = new_layers
    return out, masks


def sparsity_report(params: Dict[str, Any], masks: Dict[str, Any]) -> Dict[str, float]:
    rep = {}
    nz = total = 0.0
    for name, m in masks.get("layers", {}).items():
        if m is None:
            continue
        kept = float(m.sum())
        rep[f"layers/{name}"] = kept / m.numel()
        nz += kept
        total += m.numel()
    rep["overall_density"] = nz / max(total, 1)
    return rep


def compress_params(params: Dict[str, Any], masks: Dict[str, Any], bm: int,
                    bn: int) -> Dict[str, Any]:
    """Turn each masked projection into the FullBlock-compressed layout.

    A projection's per-layer (K, N) mask must be whole bm×bn blocks (a
    FullBlock mask).  The layers of one key share the slot count Ls (the
    largest over layers; extra slots are -1 padding).  The returned dict
    holds no reference to the dense projections it replaced, so once the
    caller drops the input params those weights are freed.
    """
    new_layers = dict(params["layers"])
    for name, mask in masks["layers"].items():
        if mask is None:
            continue
        w = params["layers"][name]
        if name == "wo" or w.dim() not in (3, 4):
            raise ValueError(f"{name}: only (L, K, ...) input-major projections compress")
        L, K = w.shape[0], w.shape[1]
        mats = w.reshape(L, K, -1)
        N = mats.shape[2]
        if K % bm or N % bn:
            raise ValueError(f"{name}: ({K}, {N}) does not tile by ({bm}, {bn})")
        blk = mask.reshape(L, K // bm, bm, N // bn, bn)
        keep = blk.any(dim=4).any(dim=2)                       # (L, gk, gn)
        full = keep[:, :, None, :, None].expand_as(blk)
        if not torch.equal(full, blk):
            raise ValueError(f"{name}: mask is not whole ({bm}, {bn}) blocks")
        Ls = max(1, int(keep.sum(dim=1).max()))
        comps, idxs = [], []
        for l in range(L):
            wc, ix = compress_fullblock_torch(mats[l], keep[l], bm, bn, L=Ls)
            comps.append(wc)
            idxs.append(ix)
        new_layers[name] = BlockSparseLinear(torch.stack(comps), torch.stack(idxs), K,
                                             tuple(w.shape[2:]))
    out = dict(params)
    out["layers"] = new_layers
    return out
