"""Gradient compression numerics (port of ``repro/distributed/compress.py``).

Block-wise symmetric int8 quantisation with stochastic rounding, applied
in the train step as quantise → dequantise around each gradient leaf: the
numerics of an int8 cross-pod all-reduce.

The reference draws its rounding noise from ``jax.random`` with a fixed
``PRNGKey(seed)`` on every call, one split key per leaf.  The port draws
it from a ``torch.Generator`` seeded with ``seed`` on every call, one draw
per leaf in the reference's leaf order (:mod:`repro_torch.tree`): the same
noise at every step, as there, but other values.  ``noise=`` takes a given
draw instead (``uniform - 0.5`` per leaf); the tests pass JAX's own.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..tree import leaves_with_paths, map_with_path

__all__ = ["quantize_int8_stochastic", "dequantize_int8", "compress_decompress_grads"]

_BLOCK = 256


def quantize_int8_stochastic(x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                             noise: Optional[torch.Tensor] = None) -> tuple:
    """Block-wise symmetric int8 with stochastic rounding: returns (q int8
    (nblocks, 256), scale f32 (nblocks, 1), shape, pad).  The noise is
    ``noise`` (nblocks, 256) when given, else uniform [0, 1) from
    ``generator`` minus 0.5."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % _BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    scaled = blocks / scale
    if noise is None:
        noise = torch.rand(scaled.shape, generator=generator, device=scaled.device) - 0.5
    q = torch.clamp(torch.round(scaled + noise.to(scaled.device)), -127, 127).to(torch.int8)
    return q, scale, tuple(x.shape), pad


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, pad: int) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compress_decompress_grads(grads: Any, seed: int = 0, *,
                              noise: Optional[Sequence[torch.Tensor]] = None) -> Any:
    """Round-trip every gradient leaf through int8 (the numerics of a
    compressed cross-pod all-reduce); each leaf keeps its dtype.  Noise
    comes from a generator seeded with ``seed`` on each device (or from
    ``noise``, one draw per leaf in leaf order)."""
    paths = list(leaves_with_paths(grads))
    if noise is not None and len(noise) != len(paths):
        raise ValueError(f"noise has {len(noise)} draws for {len(paths)} leaves")
    gens: Dict[torch.device, torch.Generator] = {}
    out: Dict[Tuple[str, ...], torch.Tensor] = {}
    for i, (path, leaf) in enumerate(paths):
        gen = gens.get(leaf.device)
        if gen is None:
            gen = gens[leaf.device] = torch.Generator(device=leaf.device).manual_seed(seed)
        q, s, shape, pad = quantize_int8_stochastic(
            leaf, gen, noise=None if noise is None else noise[i])
        out[path] = dequantize_int8(q, s, shape, pad).to(leaf.dtype)
    return map_with_path(lambda path, _: out[path], grads)
