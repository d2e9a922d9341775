"""Logical work of one call of the FullBlock block-sparse matmul
(``csrc/block_sparse_matmul.cu``, op ``ops.block_sparse_matmul``):
x (B, K) @ a weight compressed to w_comp (Gn, Ls, bm, bn) with block
indices idx (Gn, Ls), -1 for an empty slot.

2·B·bm·bn flops per live block (idx >= 0), never the padding slots.
Bytes: x, the live blocks and idx read once, y (B, Gn·bn) written once.
"""
from __future__ import annotations

from typing import Dict, Tuple

OP = "block_sparse_matmul"

_live: Dict[Tuple[int, Tuple[int, ...]], int] = {}


def describe(ctx: dict, x, w_comp, idx, **_) -> dict:
    Gn, Ls, bm, bn = w_comp.shape
    return {"B": x.shape[0], "K": x.shape[1], "Gn": Gn, "Ls": Ls, "bm": bm, "bn": bn,
            "idx": idx, "elt": x.element_size()}


def live_blocks(idx) -> int:
    """Live blocks of an index table (read once per table: after the
    window, where the read's sync costs nothing measured)."""
    key = (idx.data_ptr(), tuple(idx.shape))
    if key not in _live:
        _live[key] = int((idx >= 0).sum())
    return _live[key]


def work(c: dict) -> Tuple[int, int]:
    live = live_blocks(c["idx"])
    B, bm, bn, elt = c["B"], c["bm"], c["bn"], c["elt"]
    nbytes = (elt * (B * c["K"] + live * bm * bn + B * c["Gn"] * bn)
              + c["idx"].element_size() * c["idx"].numel())
    return 2 * B * live * bm * bn, nbytes
