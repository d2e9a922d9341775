"""Seeded weights of a decoder configuration, drawn per (leaf, layer).

Every weight of layer ``l`` of leaf ``name`` comes from its own
``torch.Generator`` seeded from ``(seed, name, l)``, so any one layer can
be drawn again without drawing the others: the program's set-up draws
them all on the card, and the plain reference draws each layer again when
it reaches it.  The values are drawn in f32, scaled, and stored in the
configuration's serving dtype (bf16); the reference widens the stored
values back to f32, so both sides start from the same numbers.

The layout is the port's: per-layer leaves stacked on a leading L axis
(``wq`` (L, d, Hq, hd), ``wo`` (L, Hq, hd, d), ``w_gate`` (L, d, ff) or
(L, E, d, ff) for an expert leaf, ...), plus ``embed``, ``final_norm`` and
``lm_head`` where the embedding is not tied.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

__all__ = ["layer_shapes", "std_of", "leaf_seed", "draw", "draw_global", "make_params",
           "global_shapes"]

NORMS = ("ln1", "ln2", "q_norm", "k_norm")


def layer_shapes(arch: dict) -> Dict[str, Tuple[int, ...]]:
    """One decoder layer's leaf shapes for a GQA decoder with global
    attention, optional q/k norms, and a gated MLP or a top-k MoE block."""
    d, hd = arch["d_model"], arch.get("head_dim") or arch["d_model"] // arch["n_heads"]
    Hq, Hkv, ff = arch["n_heads"], arch["n_kv_heads"], arch["d_ff"]
    shapes = {"ln1": (d,), "ln2": (d,), "wq": (d, Hq, hd), "wk": (d, Hkv, hd),
              "wv": (d, Hkv, hd), "wo": (Hq, hd, d)}
    if arch.get("qk_norm"):
        shapes.update({"q_norm": (hd,), "k_norm": (hd,)})
    E = arch.get("n_experts", 1)
    if E > 1:
        shapes.update({"w_router": (d, E), "w_gate": (E, d, ff), "w_up": (E, d, ff),
                       "w_down": (E, ff, d)})
    else:
        shapes.update({"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)})
    return shapes


def global_shapes(arch: dict) -> Dict[str, Tuple[int, ...]]:
    d, V = arch["d_model"], arch["vocab_size"]
    shapes = {"embed": (V, d), "final_norm": (d,)}
    if not arch.get("tie_embeddings"):
        shapes["lm_head"] = (d, V)
    return shapes


def std_of(arch: dict, init: dict, name: str, shape: Tuple[int, ...]) -> float:
    """A norm scale is drawn around 0 (the port's norms multiply by
    1 + scale) with ``init["norm_std"]``; every other weight is normal with
    std 1/sqrt(fan_in), fan_in being the contracted width: d for the
    projections from the residual stream, the router and the embedding
    (its rows have the unit norm of a tied head's columns), Hq*hd for
    ``wo``, ff for ``w_down``.  An expert takes a dense MLP's std."""
    if name in NORMS or name == "final_norm":
        return float(init["norm_std"])
    d = arch["d_model"]
    if name == "wo":
        fan_in = shape[0] * shape[1]
    elif name == "w_down":
        fan_in = shape[-2]
    else:
        fan_in = d
    return 1.0 / math.sqrt(fan_in)


def leaf_seed(seed: int, name: str, layer: int) -> int:
    """A 63-bit generator seed for (seed, leaf, layer)."""
    h = hashlib.blake2b(f"{int(seed)}/{name}/{int(layer)}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << 63) - 1)


def _normal(shape, std: float, key: int, device, dtype) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(key)
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return w.mul_(std).to(dtype)


def draw(arch: dict, init: dict, seed: int, name: str, layer: int, device,
         dtype=torch.bfloat16) -> torch.Tensor:
    """Layer ``layer`` of leaf ``name``, as stored in ``dtype``."""
    shape = layer_shapes(arch)[name]
    return _normal(shape, std_of(arch, init, name, shape), leaf_seed(seed, name, layer),
                   device, dtype)


def draw_global(arch: dict, init: dict, seed: int, name: str, device,
                dtype=torch.bfloat16) -> torch.Tensor:
    """``embed``, ``final_norm`` or ``lm_head``."""
    shape = global_shapes(arch)[name]
    std = std_of(arch, init, name, shape) if name == "final_norm" else \
        1.0 / math.sqrt(arch["d_model"])
    return _normal(shape, std, leaf_seed(seed, name, 0), device, dtype)


def make_params(arch: dict, init: dict, seed: int, device,
                dtype=torch.bfloat16) -> dict:
    """Every weight in the port's layout, each stacked leaf written one
    layer at a time into its (L, ...) buffer on ``device``."""
    L = arch["n_layers"]
    layers = {}
    for name, shape in layer_shapes(arch).items():
        buf = torch.empty((L,) + shape, dtype=dtype, device=device)
        for l in range(L):
            buf[l] = draw(arch, init, seed, name, l, device, dtype)
        layers[name] = buf
    params = {name: draw_global(arch, init, seed, name, device, dtype)
              for name in global_shapes(arch)}
    params["layers"] = layers
    return params
