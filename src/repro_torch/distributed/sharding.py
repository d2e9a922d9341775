"""Sharding rules for the production mesh (port of
``repro/distributed/sharding.py``), and the active-mesh context.

Mesh axes: single-pod ``("data", "model")`` = (16, 16); multi-pod
``("pod", "data", "model")`` = (2, 16, 16).  Batch shards over
("pod", "data"); weights tensor-parallel over "model"; embeddings
vocab-sharded; MoE experts expert-parallel on "model"; with ``fsdp`` a
second dimension over "data".

A spec is :class:`P`, a tuple of axis entries (None, an axis name, or a
tuple of names), which compares with the reference's ``PartitionSpec``
entry by entry: as ``PartitionSpec`` does, a one-name tuple is kept as
the name and an empty tuple as None.

The port runs in the *global view*: every rank of a mesh holds the same
global tensors, and only the two mesh paths of
:mod:`repro_torch.models.layers` (the expert-parallel MoE block and the
sequence-parallel window attention) cut a rank's slice on entry by these
specs and gather the global result on exit
(:mod:`repro_torch.distributed.collectives`).  So :func:`maybe_shard`,
a layout constraint, changes no value and is the identity here, as it
changes none in the reference.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` activated by
:func:`set_mesh`; :func:`active_mesh` is the counterpart of the
reference's ``compat.get_abstract_mesh()`` (None where it is empty).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["P", "maybe_shard", "batch_axes", "spec_for_param", "tree_specs",
           "tree_shardings", "batch_spec", "cache_specs", "logits_spec",
           "filter_spec", "ShardOpts", "get_options", "set_options", "options",
           "set_mesh", "active_mesh", "axis_names", "axis_size", "mesh_batch_axes",
           "coordinate", "local_shard", "layer_spec", "placements",
           "path_counts", "reset_path_counts"]


class P(tuple):
    """A partition spec: one entry per tensor dim, each None, a mesh axis
    name or a tuple of names (the dim split over their product)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# Tunable sharding strategy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardOpts:
    """Global sharding strategy knobs: the reference's, less ``zero1``
    (optimizer-state sharding), which only its dry-run on a mesh reads.

    fsdp            — additionally shard weights over the "data" axis on a
                      second (divisible) dimension; the expert path
                      gathers them per use.
    attn_kv_fallback— head counts that do not divide the model axis:
                      "replicate" or "head_dim" (legacy).
    ep_shardmap     — dispatch the MoE block through the expert-parallel
                      path on a mesh.
    """
    fsdp: bool = False
    attn_kv_fallback: str = "replicate"
    ep_shardmap: bool = True


_OPTS = ShardOpts()


def get_options() -> ShardOpts:
    return _OPTS


def set_options(**kw) -> ShardOpts:
    global _OPTS
    _OPTS = dataclasses.replace(_OPTS, **kw)
    return _OPTS


@contextlib.contextmanager
def options(**kw):
    global _OPTS
    prev = _OPTS
    _OPTS = dataclasses.replace(_OPTS, **kw)
    try:
        yield _OPTS
    finally:
        _OPTS = prev


# ---------------------------------------------------------------------------
# The active mesh
# ---------------------------------------------------------------------------

_MESHES: list = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Activate ``mesh`` (a ``DeviceMesh`` with named dims) for the block:
    the model's mesh paths and :func:`filter_spec` read it."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def active_mesh():
    """The innermost :func:`set_mesh` mesh, or None."""
    return _MESHES[-1] if _MESHES else None


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def axis_size(mesh, name: str) -> int:
    return int(mesh.shape[axis_names(mesh).index(name)])


def mesh_batch_axes(mesh) -> Tuple[str, ...]:
    """The axes of ``mesh`` a global batch dimension shards over."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def coordinate(mesh, axes) -> Tuple[int, int]:
    """This rank's (index, count) over ``axes`` (a name or a tuple of names)
    of ``mesh``, the axes flattened in the order given (row-major, as a
    ``PartitionSpec`` entry orders them)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names, coord = axis_names(mesh), mesh.get_coordinate()
    idx, n = 0, 1
    for a in axes:
        d = names.index(a)
        idx, n = idx * int(mesh.shape[d]) + int(coord[d]), n * int(mesh.shape[d])
    return idx, n


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of ``t`` cut by ``spec`` on ``mesh`` (a view): each
    dim whose entry names mesh axes is split evenly over their product
    and the rank keeps the part at its coordinate.  Axes absent from the
    mesh are ignored, as :func:`filter_spec` drops them."""
    names = axis_names(mesh)
    for d, entry in enumerate(spec):
        axes = tuple(a for a in _entry_axes(entry) if a in names)
        if not axes:
            continue
        i, n = coordinate(mesh, axes)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split over {axes} ({n})")
        size = t.shape[d] // n
        t = t.narrow(d, i * size, size)
    return t


# Times each mesh path of the model was taken (the chip smoke's check).
_PATHS: collections.Counter = collections.Counter()


def path_counts() -> Dict[str, int]:
    """How often each mesh path ran since the last reset: ``moe_ep`` and
    ``swa_seqpar``."""
    return {k: _PATHS[k] for k in ("moe_ep", "swa_seqpar")}


def reset_path_counts() -> None:
    _PATHS.clear()


def count_path(name: str) -> None:
    _PATHS[name] += 1


# ---------------------------------------------------------------------------
# Specs against the active mesh
# ---------------------------------------------------------------------------

def _mesh_axis_names() -> Tuple[str, ...]:
    return axis_names(active_mesh())


def filter_spec(spec) -> Optional[P]:
    """Drop axes absent from the active mesh; None when no mesh."""
    names = _mesh_axis_names()
    if not names:
        return None
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            out.append(kept if kept else None)
        else:
            out.append(entry if entry in names else None)
    return P(*out)


def maybe_shard(x: torch.Tensor, spec) -> torch.Tensor:
    """The identity.  The reference's ``with_sharding_constraint`` sets a
    layout and changes no value; in the port's global view every rank
    holds the global tensor, so there is no layout to set."""
    return x


def batch_axes() -> Any:
    """The mesh axes a global batch dimension shards over."""
    axes = mesh_batch_axes(active_mesh())
    return axes if axes else None


# ---------------------------------------------------------------------------
# Spec assignment: per-leaf, driven by (trailing key name, leaf shape).
# ---------------------------------------------------------------------------

_MODEL = 16  # production "model" axis size


def _b(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def _div(n: int) -> bool:
    return n % _MODEL == 0


_DATA = 16   # production "data" axis size (per pod)


def _fsdp_augment(spec_entries, shape) -> P:
    """Add "data" sharding on the largest still-unsharded divisible axis
    (FSDP / ZeRO second-axis sharding)."""
    entries = list(spec_entries)
    best, best_ax = 0, -1
    for ax, (e, n) in enumerate(zip(entries, shape)):
        if ax == 0 and len(shape) >= 3:
            continue   # never shard the layer axis
        if e is None and n % _DATA == 0 and n > best:
            best, best_ax = n, ax
    if best_ax >= 0:
        entries[best_ax] = "data"
    return P(*entries)


def spec_for_param(key: str, shape: Tuple[int, ...],
                   fsdp: Optional[bool] = None) -> P:
    nd = len(shape)
    fsdp = _OPTS.fsdp if fsdp is None else fsdp

    def out(*entries):
        if fsdp:
            return _fsdp_augment(entries, shape)
        return P(*entries)

    if key == "embed":
        if _div(shape[0]):
            return out("model", None)
        return out(None, "model")
    if key == "lm_head":
        if _div(shape[1]):
            return out(None, "model")
        return out("model", None)
    if key in ("wq", "wo") and nd == 4:
        # (L, D, Hq, hd) / (L, Hq, hd, D): heads when divisible; with the
        # "replicate" fallback never q's head_dim (the score contraction)
        h_ax = 2 if key == "wq" else 1
        spec = [None] * nd
        if _div(shape[h_ax]):
            spec[h_ax] = "model"
        elif _OPTS.attn_kv_fallback == "head_dim":
            spec[3 if key == "wq" else 2] = "model"
        return out(*spec)
    if key in ("wk", "wv") and nd == 4:
        # (L, D, Hkv, hd): kv heads when divisible, else replicate (or the
        # legacy head_dim split)
        spec = [None] * nd
        if _div(shape[2]):
            spec[2] = "model"
        elif _OPTS.attn_kv_fallback == "head_dim":
            spec[3] = "model"
        return out(*spec)
    if key in ("w_gate", "w_up") and nd == 4:      # (L, E, D, F) experts
        return out(None, "model", None, None)
    if key == "w_down" and nd == 4:                # (L, E, F, D)
        return out(None, "model", None, None)
    if key in ("w_gate", "w_up") and nd == 3:      # (L, D, F)
        return out(None, None, "model")
    if key == "w_down" and nd == 3:                # (L, F, D)
        return out(None, "model", None)
    if key == "w_in" and nd == 3:                  # (L, D, e)
        return out(None, None, "model") if _div(shape[2]) else out(*([None] * nd))
    if key == "w_out" and nd == 3:                 # (L, din, D)
        return out(None, "model", None) if _div(shape[1]) else out(*([None] * nd))
    if key == "conv_w":                            # (L, 4, din)
        return out(None, None, "model") if _div(shape[2]) else out(*([None] * nd))
    if key == "w_router":                          # (L, D, E)
        return out(None, None, "model") if _div(shape[2]) else out(None, None, None)
    return P(*([None] * nd))                       # norms, biases, dynamics


def _map_with_key(fn, tree, key: str = ""):
    """``fn(key, leaf)`` over a nested dict/list/tuple; ``key`` is the last
    dict key on the leaf's path (the reference's ``_leaf_key``)."""
    if isinstance(tree, dict):
        return {k: _map_with_key(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_key(fn, v, key) for v in tree)
    if tree is None:
        return None
    return fn(key, tree)


def tree_specs(template, fsdp: Optional[bool] = None) -> Any:
    """Spec tree matching a params/opt-state tree (leaves with ``.shape``)."""
    return _map_with_key(
        lambda key, leaf: spec_for_param(key, tuple(leaf.shape), fsdp=fsdp), template)


def placements(mesh, spec) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim ``Shard(d)``
    for the tensor dim whose entry names it, else ``Replicate()``.  A dim
    split over several axes takes ``Shard(d)`` on each, in the entry's
    order (DTensor's default order is the mesh's: the reference's specs
    list axes in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if a in names:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def tree_shardings(mesh, template, fsdp: Optional[bool] = None) -> Any:
    """Per-leaf DTensor placements (``Shard(d)`` / ``Replicate()`` per mesh
    dim) of a params tree on ``mesh``: the counterpart of the reference's
    ``NamedSharding`` tree."""
    return _map_with_key(
        lambda key, leaf: placements(mesh, spec_for_param(key, tuple(leaf.shape), fsdp=fsdp)),
        template)


def batch_spec(*, multi_pod: bool = False) -> P:
    return P(_b(multi_pod), None)


def logits_spec(*, multi_pod: bool = False) -> P:
    return P(_b(multi_pod), None, "model")


def cache_specs(cfg, cell, *, multi_pod: bool = False) -> Dict[str, Any]:
    """KV/SSM cache specs for serving.

    decode_32k (large batch): batch over ("pod","data"), kv-heads over
    "model" when divisible else sequence over "model".
    long_500k (batch=1): sequence over every mesh axis (sequence
    parallelism); SSM state replicated.
    """
    b = _b(multi_pod)
    data_size = 16 * (2 if multi_pod else 1)
    batched = cell.global_batch >= data_size
    if batched:
        if cfg.n_kv_heads % _MODEL == 0:
            kv = P(None, b, None, "model", None)
        else:
            kv = P(None, b, "model", None, None)
    else:
        kv = P(None, None, b + ("model",), None, None)
    specs: Dict[str, Any] = {"pos": P()}
    if cfg.attention != "none":
        specs["k"] = specs["v"] = kv
    if cfg.ssm_state > 0:
        # state (L, B, H, Pd, N), conv (L, B, 3, din)
        if batched:
            nspec = "model" if _div(cfg.ssm_state) else None
            specs["ssm"] = P(None, b, None, None, nspec)
            din = cfg.ssm_inner()
            specs["conv"] = P(None, b, None, "model" if _div(din) else None)
        else:
            specs["ssm"] = P(None, None, None, None, None)
            specs["conv"] = P(None, None, None, None)
    if cfg.enc_dec:
        hspec = "model" if _div(cfg.n_kv_heads) else None
        cb = b if batched else None
        specs["cross_k"] = P(None, cb, None, hspec, None)
        specs["cross_v"] = P(None, cb, None, hspec, None)
    return specs


def layer_spec(key: str, shape: Tuple[int, ...], fsdp: Optional[bool] = None) -> P:
    """The spec of one layer of a stacked leaf whose per-layer shape is
    ``shape``: :func:`spec_for_param` of the (1, *shape) stack, less its
    layer entry (the reference's shard_map ``in_specs`` of a layer)."""
    return P(*spec_for_param(key, (1,) + tuple(shape), fsdp=fsdp)[1:])
