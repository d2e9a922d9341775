"""The collectives of the mesh paths, on ``torch.distributed``, with the
gradients of the port's global view.

Every rank of a mesh holds the same global tensors and computes the same
loss from them.  A mesh path (the expert-parallel MoE block, the
sequence-parallel window attention in :mod:`repro_torch.models.layers`)
is the one place where ranks hold different values, so its collectives
carry gradients so that, after a backward, every rank holds the global
gradient the single-process program would give:

* :func:`enter` — this rank's slice of a global tensor by a spec (the
  reference's shard_map ``in_specs``); backward puts the slice's gradient
  in place and sums over the mesh, since each rank's gradient holds its
  own slice's contribution only.  A weight used whole inside a path is
  entered with an all-``None`` spec: the identity, whose backward sums the
  ranks' partial gradients (the transpose of a replicated input);
* :func:`all_to_all` — the exchange of (M, ...) blocks over one mesh axis
  (torch's autograd ``all_to_all_single``: its backward is the same
  exchange of the gradients);
* :func:`all_gather` — inside a path, tiled along a dim over one axis;
  backward sums the gradients over that axis and keeps this rank's part
  (the reference's reduce-scatter transpose);
* :func:`gather_grid` — the exit: every rank's piece, gathered into a grid
  over the batch axes and "model"; backward keeps this rank's part of the
  gradient with no communication, since every rank holds the same one.

Transport is the process group the mesh was built on.  Several ranks on
one card cannot use NCCL (it refuses a duplicate device), so they use
gloo, which takes CUDA tensors and stages them through the host.  A
collective is never skipped or caught: a rank that dies or times out
fails its peers at the group's timeout.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed import _functional_collectives as fc

from .sharding import axis_names, axis_size, coordinate, local_shard

__all__ = ["enter", "all_to_all", "all_gather", "gather_grid", "mesh_group"]


def mesh_group(mesh):
    """The process group of every rank of ``mesh`` (the world: a mesh of
    :mod:`repro_torch.launch.mesh` spans it)."""
    if mesh.mesh.numel() != dist.get_world_size():
        raise ValueError(f"the mesh spans {mesh.mesh.numel()} of {dist.get_world_size()} ranks")
    return dist.group.WORLD


def _check_device(t: torch.Tensor, mesh) -> None:
    if mesh.device_type == "cuda" and not t.is_cuda:
        raise RuntimeError(f"a collective on a CUDA mesh was given a {t.device} tensor")


class _SumGrad(torch.autograd.Function):
    """Identity forward; backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def enter(t, spec, mesh):
    """This rank's slice of the global tensor ``t`` by ``spec`` (a view
    under no grad); a non-tensor (a compressed projection) passes as it
    is."""
    if not torch.is_tensor(t):
        return t
    _check_device(t, mesh)
    if t.requires_grad:
        t = _SumGrad.apply(t, mesh_group(mesh))
    return local_shard(t, spec, mesh)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Exchange the blocks of ``x`` (M, ...) over ``axis`` (M ranks): block
    j goes to the rank at coordinate j, and block j of the result came
    from it (``jax.lax.all_to_all(x, axis, 0, 0)``)."""
    _check_device(x, mesh)
    if x.shape[0] != axis_size(mesh, axis):
        raise ValueError(f"all_to_all over {axis!r} needs {axis_size(mesh, axis)} blocks, "
                         f"got {tuple(x.shape)}")
    return fc.all_to_all_single_autograd(x.contiguous(), None, None, mesh.get_group(axis))


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim``; backward sums the gradient over the group
    and keeps this rank's part.  torch's own autograd all-gather warns as
    deprecated in torch 2.13 (``torch.distributed.nn.functional.all_gather``,
    ``_functional_collectives.all_gather_tensor_autograd``), and its
    successor (``all_gather_single_autograd``) is not in torch 2.11."""

    @staticmethod
    def forward(ctx, x, dim, group, idx, n):
        ctx.dim, ctx.group, ctx.idx, ctx.n = dim, group, idx, n
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.idx].contiguous(), None, None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``x`` gathered over ``axis`` and joined along ``dim`` in coordinate
    order (``jax.lax.all_gather(..., tiled=True)``)."""
    _check_device(x, mesh)
    idx, n = coordinate(mesh, axis)
    return _AllGather.apply(x, dim, mesh.get_group(axis), idx, n)


def _grid_ranks(mesh, groups: Sequence[Tuple[str, ...]]):
    """For each grid cell (one flattened coordinate per axis group), the
    lowest rank of ``mesh`` there; and this rank's cell."""
    names = axis_names(mesh)
    sizes = [math.prod(axis_size(mesh, a) for a in g) for g in groups]
    ranks = {}
    for pos, r in zip(torch.cartesian_prod(*[torch.arange(s) for s in mesh.shape])
                      .reshape(-1, len(names)).tolist(), mesh.mesh.reshape(-1).tolist()):
        cell = []
        for g in groups:
            i = 0
            for a in g:
                d = names.index(a)
                i = i * int(mesh.shape[d]) + pos[d]
            cell.append(i)
        cell = tuple(cell)
        ranks[cell] = min(r, ranks.get(cell, r))
    mine = tuple(coordinate(mesh, g)[0] if g else 0 for g in groups)
    return sizes, ranks, mine


class _GatherGrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, world, sizes, ranks, mine):
        ctx.mine, ctx.taken = mine, ranks[mine] == dist.get_rank()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        cells = [parts[ranks[c]] for c in sorted(ranks)]
        return torch.stack(cells).reshape(*sizes, *x.shape)

    @staticmethod
    def backward(ctx, g):
        mine = g[ctx.mine].contiguous()
        return (mine if ctx.taken else torch.zeros_like(mine)), None, None, None, None, None


def gather_grid(x: torch.Tensor, mesh, groups: Sequence[Tuple[str, ...]]) -> torch.Tensor:
    """Every rank's ``x`` in a grid (n_1, ..., n_k, *x.shape), one grid dim
    per axis group of ``groups`` (e.g. ``(("data",), ("model",))``), at each
    rank's flattened coordinate over the group's axes.  Ranks that share a
    cell (over an axis in no group) hold the same piece; the lowest one's
    is taken, and only its rank's piece gets a gradient."""
    _check_device(x, mesh)
    groups = [tuple(g) for g in groups]
    sizes, ranks, mine = _grid_ranks(mesh, groups)
    return _GatherGrid.apply(x, mesh_group(mesh), dist.get_world_size(), sizes, ranks, mine)
