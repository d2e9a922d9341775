"""Mesh construction over a ``torch.distributed`` world (port of
``repro/launch/mesh.py``).

Functions, never module-level constants, so importing this module starts
no process group.  A mesh is a ``DeviceMesh`` over every rank of the
initialised world, with named dims; its device type is the card's
(``cuda``) where one is present, else ``cpu``.
"""
from __future__ import annotations

import datetime
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["init_world", "make_mesh", "make_local_mesh", "make_production_mesh"]

# A group's collective waits this long for a peer before it fails.
TIMEOUT_S = 120


def init_world(rank: int, world_size: int, init_method: str, *,
               timeout_s: float = TIMEOUT_S) -> None:
    """Join a gloo world of ``world_size`` ranks at ``init_method`` (a
    ``file://`` path or ``tcp://localhost:<port>``) with a timeout on every
    collective.  gloo, since ranks that share one card cannot take NCCL: it
    refuses two ranks on the same device."""
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: Optional[str] = None):
    """A mesh of ``shape`` with dims named ``axes`` over the whole world
    (the counterpart of ``jax.make_mesh``); its size must be the world's."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks; "
                         f"the world has {world}")
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def make_local_mesh():
    """(world, 1) over ("data", "model")."""
    return make_mesh((dist.get_world_size(), 1), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks); raises
    unless the world has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise RuntimeError(f"the production mesh {shape} needs a world of "
                           f"{math.prod(shape)} ranks; this one has {world}")
    return make_mesh(shape, axes)
