"""Logical work of one call of the flash-attention kernel
(``csrc/flash_attention.cu``, op ``ops.flash_attention``).

4·hd flops for each (query, key) pair a causal (optionally windowed) mask
lets through, per batch row and q head, over the unpadded length: the
prefill pads q/k/v at the tail to a multiple of 128, and the padding is
no work the inputs need.  Bytes: q, k and v of the unpadded length read
once, the output written once.
"""
from __future__ import annotations

from typing import Optional, Tuple

OP = "flash_attention"


def describe(ctx: dict, q, k, v, *, causal: bool = True, window: Optional[int] = None,
             **_) -> dict:
    """The call's shapes; ``ctx["prefill_len"]`` is the unpadded length of
    the prefill that made the call, where one is running."""
    B, Sq, Hq, hd = q.shape
    return {"B": B, "Sq": Sq, "Skv": k.shape[1], "Hq": Hq, "Hkv": k.shape[2], "hd": hd,
            "causal": bool(causal), "window": window, "valid": ctx.get("prefill_len"),
            "elt": q.element_size()}


def pairs(S: int, causal: bool = True, window: Optional[int] = None) -> int:
    """(query, key) pairs of self-attention over S positions: key <= query
    when causal, and query - key < window where a window is given."""
    if not causal:
        return S * S
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def work(c: dict) -> Tuple[int, int]:
    S = c["valid"] if c["valid"] is not None else c["Sq"]
    flops = 4 * c["hd"] * c["B"] * c["Hq"] * pairs(S, c["causal"], c["window"])
    nbytes = c["elt"] * c["B"] * S * c["hd"] * (2 * c["Hq"] + 2 * c["Hkv"])
    return flops, nbytes
