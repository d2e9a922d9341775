"""FlexBlock sparsity on live model parameters (port of
``repro/sparsity/apply.py``), plus the compressed execution layout.

* ``prune_params``   — a FlexBlock mask per layer of each eligible
  stacked weight, viewed as its (K, N) matmul matrix; returns
  (pruned_params, masks).  Block losses run in the ``block_importance``
  op, so on the card in the Hopper kernel.
* ``sparsity_report`` — per-tensor density.
* ``compress_params`` — replaces each masked projection with a
  compressed module: a :class:`~repro_torch.models.layers.BlockSparseLinear`
  in the ``compress_fullblock`` layout (``block_sparse_matmul`` op), or,
  for row-aligned IntraBlock masks, an
  :class:`~repro_torch.models.layers.IntraBlockLinear` in the
  ``compress_intrablock`` layout (``intrablock_gather_matmul`` op).
  A masked weight that is no input-major projection (``wo``, which the
  reference prunes as (Hq, hd·d)) stays the masked dense weight.
* ``cim_cost_of_model`` — lower the arch to a CIMinus workload and cost
  it on a CIM architecture (the reference's modeling-plane round trip,
  host-side numpy).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..core.costmodel import compare, dense_baseline, simulate
from ..core.flexblock import FlexBlockSpec
from ..core.mapping import default_mapping
from ..core.pruning import flexblock_mask
from ..core.workload import lm_workload
from ..kernels.ops import compress_fullblock_torch, compress_intrablock_torch
from ..models.layers import BlockSparseLinear, IntraBlockLinear

__all__ = ["PRUNABLE_KEYS", "prune_params", "sparsity_report", "compress_params",
           "cim_cost_of_model"]

PRUNABLE_KEYS = ("w_gate", "w_up", "w_down", "w_in", "w_out",
                 "wq", "wk", "wv", "wo")


def _as_matrix(w: torch.Tensor) -> torch.Tensor:
    """Collapse one layer's weight to 2-D (shape[0], rest), as the
    reference does: the matmul matrix for wq/wk/wv/w_*, but (Hq, hd·d)
    for ``wo``, which is not its matmul orientation."""
    return w if w.dim() == 2 else w.reshape(w.shape[0], -1)


def prune_params(params: Dict[str, Any], spec: FlexBlockSpec, *, criterion: str = "l1",
                 align_cols: bool = False, keys: Tuple[str, ...] = PRUNABLE_KEYS,
                 impl: str = "auto", device: Optional[Union[str, torch.device]] = None
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Prune every eligible stacked layer weight; returns (params, masks).

    ``masks["layers"]`` mirrors ``params["layers"]``: a bool tensor of the
    weight's shape per pruned key, None elsewhere.  ``align_cols`` shares
    each IntraBlock pattern across the columns of a matrix (see
    :func:`~repro_torch.core.pruning.intrablock_mask`).  The weights are
    moved to ``device`` (default ``cuda``); the given tensors are left as
    they were.
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
            mask[l] = flexblock_mask(mat, spec, criterion, align_cols=align_cols,
                                     impl=impl).reshape(w.shape[1:])
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


def compress_params(params: Dict[str, Any], masks: Dict[str, Any], bm: Optional[int] = None,
                    bn: Optional[int] = None, *, m: Optional[int] = None) -> Dict[str, Any]:
    """Turn each masked projection into a compressed layout.

    Give ``bm, bn`` for FullBlock masks, or ``m`` for row-aligned
    IntraBlock(m, 1) masks (``prune_params(..., align_cols=True)``).

    * FullBlock: a projection's per-layer (K, N) mask must be whole
      bm×bn blocks.  The layers of one key share the slot count Ls (the
      largest over layers; extra slots are -1 padding).
    * IntraBlock: each layer's mask must be row-aligned with the same
      survivor count in every m-row block, as ``compress_intrablock``
      requires; the layers of one key must keep the same row count Kc.
    * ``wo``, and any other masked weight that is no (L, K, ...)
      input-major projection, has no compressed layout: it stays the
      masked dense weight ``prune_params`` stored, which is what the
      reference runs.

    The returned dict holds no reference to the dense projections it
    replaced, so once the caller drops the input params those weights are
    freed.
    """
    if (m is None) == (bm is None or bn is None):
        raise ValueError("give either bm and bn (FullBlock) or m (IntraBlock)")
    new_layers = dict(params["layers"])
    for name, mask in masks["layers"].items():
        if mask is None:
            continue
        w = params["layers"][name]
        if name == "wo" or w.dim() not in (3, 4):
            continue
        L, K = w.shape[0], w.shape[1]
        mats = w.reshape(L, K, -1)
        masks_l = mask.reshape(L, K, -1)
        if m is not None:
            new_layers[name] = _compress_intra(name, mats, masks_l, m, tuple(w.shape[2:]))
        else:
            new_layers[name] = _compress_full(name, mats, masks_l, bm, bn, tuple(w.shape[2:]))
    out = dict(params)
    out["layers"] = new_layers
    return out


def _compress_full(name, mats, mask, bm, bn, out_shape) -> BlockSparseLinear:
    L, K, N = mats.shape
    if K % bm or N % bn:
        raise ValueError(f"{name}: ({K}, {N}) does not tile by ({bm}, {bn})")
    blk = mask.reshape(L, K // bm, bm, N // bn, bn)
    keep = blk.any(dim=4).any(dim=2)                       # (L, gk, gn)
    full = keep[:, :, None, :, None].expand_as(blk)
    if not torch.equal(full, blk):
        raise ValueError(f"{name}: mask is not whole ({bm}, {bn}) blocks")
    Ls = max(1, int(keep.sum(dim=1).max()))
    comps, idxs = zip(*(compress_fullblock_torch(mats[l], keep[l], bm, bn, L=Ls)
                        for l in range(L)))
    return BlockSparseLinear(torch.stack(comps), torch.stack(idxs), K, out_shape)


def _compress_intra(name, mats, mask, m, out_shape) -> IntraBlockLinear:
    L, K, _ = mats.shape
    try:
        comps, idxs = zip(*(compress_intrablock_torch(mats[l], mask[l], m) for l in range(L)))
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if len({c.shape[0] for c in comps}) != 1:
        raise ValueError(f"{name}: layers keep different row counts "
                         f"{sorted({c.shape[0] for c in comps})}")
    return IntraBlockLinear(torch.stack(comps), torch.stack(idxs), K, out_shape)


def cim_cost_of_model(
    cfg: ArchConfig,
    cim_arch,
    spec: FlexBlockSpec,
    *,
    seq_len: int = 128,
    batch: int = 1,
    mapping_strategy: str = "duplicate",
    input_sparsity: Optional[Dict[str, float]] = None,
):
    """Modeling-plane round trip: arch → MVM DAG → CIMinus cost report
    (sparse vs dense baseline)."""
    wl = lm_workload(cfg, seq_len=seq_len, batch=batch).set_sparsity(spec)
    mapping = default_mapping(cim_arch, mapping_strategy)
    rep = simulate(cim_arch, wl, mapping, input_sparsity=input_sparsity)
    dense = dense_baseline(cim_arch, wl, mapping)
    return rep, compare(rep, dense)
