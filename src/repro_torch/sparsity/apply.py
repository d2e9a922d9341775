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
  Only ``wq``/``wk``/``wv`` and the 3-D (L, K, N) projections (a dense
  MLP's, the SSM mixer's ``w_in``/``w_out``) have such a layout; ``wo``
  (which the reference prunes as (Hq, hd·d)) and the MoE expert leaves
  (L, E, K, N) stay the masked dense weight, which is what the reference
  runs.  The SSM's ``conv_w``, ``A_log``, ``dt_bias`` and ``D_skip`` are
  not in ``PRUNABLE_KEYS``, as in the reference.
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
from ..distributed.sharding import layer_spec, local_shard
from ..kernels.ops import aligned_rows, compress_fullblock_torch, compress_intrablock_torch
from ..models.layers import BlockSparseLinear, IntraBlockLinear

__all__ = ["PRUNABLE_KEYS", "prune_params", "prune_local", "sparsity_report",
           "compress_params", "cim_cost_of_model"]

PRUNABLE_KEYS = ("w_gate", "w_up", "w_down", "w_in", "w_out",
                 "wq", "wk", "wv", "wo")


def _as_matrix(w: torch.Tensor) -> torch.Tensor:
    """Collapse one layer's weight to 2-D (shape[0], rest), as the
    reference does: the matmul matrix for wq/wk/wv/w_*, but (Hq, hd·d)
    for ``wo``, which is not its matmul orientation."""
    return w if w.dim() == 2 else w.reshape(w.shape[0], -1)


def _has_compressed_layout(name: str, w) -> bool:
    """Whether ``compress_params`` gives the stacked leaf ``w`` a compressed
    layout: ``wq``/``wk``/``wv`` (L, d, H, hd) and the 3-D (L, K, N)
    projections of a dense MLP or the SSM mixer.  ``wo`` (L, Hq, hd, d) and
    the MoE expert leaves (L, E, K, N) have none.  No config is at hand, so the rule
    rests on name and rank."""
    return w.dim() == 3 or (w.dim() == 4 and name in ("wq", "wk", "wv"))


def prune_params(params: Dict[str, Any], spec: FlexBlockSpec, *, criterion: str = "l1",
                 align_cols: bool = False, keys: Tuple[str, ...] = PRUNABLE_KEYS,
                 impl: str = "auto", device: Optional[Union[str, torch.device]] = None
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Prune every eligible stacked layer weight; returns (params, masks).

    ``masks["layers"]`` mirrors ``params["layers"]``: a bool tensor of the
    weight's shape per pruned key, None elsewhere.  ``align_cols`` shares
    each IntraBlock pattern across the columns of a matrix (see
    :func:`~repro_torch.core.pruning.intrablock_mask`).  The given tensors
    are left as they were.

    Each pruned leaf is built in a new tensor on ``device`` (default
    ``cuda``), one layer at a time: a leaf given on the host never stands
    whole on the device beside its pruned copy.  A mask stays on
    ``device`` where :func:`compress_params` reads it (a leaf with a
    compressed layout) and goes to the host otherwise (``wo``, the expert
    leaves), where the reference keeps all its masks: at
    qwen3-moe-30b-a3b's width the expert masks alone hold 29 GB.
    """
    dev = resolve_device(device)
    layers = params["layers"]
    new_layers = dict(layers)
    masks: Dict[str, Any] = {"layers": {}}
    for name, w in layers.items():
        if name not in keys:
            masks["layers"][name] = None
            continue
        out = torch.empty(w.shape, dtype=w.dtype, device=dev)
        mask = torch.empty(w.shape, dtype=torch.bool,
                           device=dev if _has_compressed_layout(name, w) else "cpu")
        for l in range(w.shape[0]):
            wl = w[l].to(dev)
            mat = _as_matrix(wl)
            if 1 in mat.shape:
                m = torch.ones(wl.shape, dtype=torch.bool, device=dev)
            else:
                m = flexblock_mask(mat, spec, criterion, align_cols=align_cols,
                                   impl=impl).reshape(wl.shape)
            torch.mul(wl, m, out=out[l])
            mask[l] = m
        masks["layers"][name] = mask
        new_layers[name] = out
    out = dict(params)
    out["layers"] = new_layers
    return out, masks


def prune_local(w: torch.Tensor, key: str, spec: FlexBlockSpec, mesh, *,
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prune one layer ``w`` (E, K, N) of an MoE expert leaf whole and keep
    this rank's experts: (pruned slice, its mask), each a new tensor on
    ``device`` (the mask on the host, as :func:`prune_params` keeps an
    expert mask).  The reference masks the layer as (E, K·N), so a
    FullBlock block spans the experts of every rank and no rank can pick
    its part of the mask from its own experts; pruned whole, the slice is
    the single-process mask's.  The rank's experts are those the expert
    path takes (the leaf's spec on ``mesh``, "model" on E)."""
    if w.dim() != 3 or key not in ("w_gate", "w_up", "w_down"):
        raise ValueError(f"{key} {tuple(w.shape)}: not one layer of an expert leaf")
    one, masks = prune_params({"layers": {key: w[None]}}, spec, keys=(key,), device=device)
    cut = layer_spec(key, tuple(w.shape), fsdp=False)
    return (local_shard(one["layers"][key][0], cut, mesh).clone(),
            local_shard(masks["layers"][key][0], cut, mesh).clone())


def sparsity_report(params: Dict[str, Any], masks: Dict[str, Any]) -> Dict[str, float]:
    rep = {}
    nz = total = 0.0
    for name, m in masks.get("layers", {}).items():
        if m is None:
            continue
        kept = float(torch.count_nonzero(m))   # 16x a bool sum's speed on the host
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
      largest over layers; extra slots are -1 padding).  A matrix that
      does not tile by (bm, bn) raises "does not tile": the SSM mixer's
      ``w_in`` at (768, 3352) (mamba2-130m) or (1600, 6482) (hymba-1.5b)
      at (128, 128).  ``prune_params`` masks it, padded as the reference
      pads it, but the reference has no compressed layout for it either.
    * IntraBlock: each layer's mask must be row-aligned with the same
      survivor count in every m-row block, as ``compress_intrablock``
      requires; the layers of one key must keep the same row count Kc.
      Where a row of w_comp is not a multiple of 16 bytes long, w_comp is
      a (L, Kc, N) view of a zero-padded buffer (``ops.aligned_rows``).
    * Only ``wq``/``wk``/``wv`` (L, d, H, hd) and the 3-D (L, K, N) leaves
      (a dense MLP's, the SSM mixer's ``w_in``/``w_out``) are compressed.
      ``wo`` and the MoE expert leaves (L, E, K, N), which the reference
      masks as (Hq, hd·d) and (E, d·ff), have no compressed layout (the
      reference has none either): each stays the masked dense weight
      ``prune_params`` stored, which is what the reference runs.
      ``compress_params`` has no config, so this rule rests on the leaf's
      name and rank.

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
        if not _has_compressed_layout(name, w):
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
    return IntraBlockLinear(aligned_rows(torch.stack(comps)), torch.stack(idxs), K, out_shape)



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
