"""Model FLOPs of served tokens, from a configuration and its pruning.

Counted as the work the tokens need, whatever the program spends: 2 flops
per live weight per token (a pruned projection counts its kept weights
only; an MoE token counts its router and its top-k experts, not the
capacity slabs every expert runs over), 4·hd flops per causal (query,
key) pair per q head and layer over the filled positions only, and the
head's 2·d·V for each token whose logits the engine reads: the last
prompt token of a prefill and each decode token.
"""
from __future__ import annotations

import math
from typing import Dict

from .weights import layer_shapes

__all__ = ["density", "live_weights_per_token", "prefill_flops", "decode_flops"]


def density(pruning: dict, key: str, shape) -> float:
    """The kept share of one layer of ``key`` under the configuration's
    pattern, on the matrix the port masks: (K, N) for a projection,
    (Hq, hd·d) for ``wo``, (E, d·ff) for an expert leaf."""
    if key not in pruning["keys"]:
        return 1.0
    if pruning["pattern"] == "intrablock":
        return math.floor((1 - pruning["ratio"]) * pruning["m"]) / pruning["m"]
    rows, cols = shape[0], math.prod(shape[1:])
    gm, gn = math.ceil(rows / pruning["bm"]), math.ceil(cols / pruning["bn"])
    return math.floor((1 - pruning["ratio"]) * gm * gn) / (gm * gn)


def live_weights_per_token(arch: dict, pruning: dict) -> float:
    """Live weights one token multiplies by in the decoder layers."""
    shapes: Dict[str, tuple] = layer_shapes(arch)
    E, K = arch.get("n_experts", 1), arch.get("top_k", 1)
    total = 0.0
    for key, shp in shapes.items():
        if len(shp) < 2:
            continue                       # norm scales
        n = math.prod(shp) * density(pruning, key, shp)
        if E > 1 and key in ("w_gate", "w_up", "w_down"):
            n *= K / E                     # the token's top-k experts
        total += n
    return total * arch["n_layers"]


def _head(arch: dict) -> int:
    return 2 * arch["d_model"] * arch["vocab_size"]


def _attn_pair(arch: dict) -> int:
    hd = arch.get("head_dim") or arch["d_model"] // arch["n_heads"]
    return 4 * hd * arch["n_heads"] * arch["n_layers"]


def prefill_flops(arch: dict, pruning: dict, S: int) -> float:
    return (2 * S * live_weights_per_token(arch, pruning)
            + _attn_pair(arch) * S * (S + 1) // 2 + _head(arch))


def decode_flops(arch: dict, pruning: dict, pos: int) -> float:
    """The decode step whose input token sits at position ``pos`` (it
    attends ``pos + 1`` keys)."""
    return 2 * live_weights_per_token(arch, pruning) + _attn_pair(arch) * (pos + 1) + _head(arch)
