"""Logical work of one call of the row-aligned IntraBlock gather-matmul
(``csrc/intrablock_matmul.cu``, op ``ops.intrablock_gather_matmul``):
``x[:, row_idx] @ w_comp`` with x (B, K), w_comp (Kc, N).

2·B·Kc·N flops: the live weights only.  Bytes: the Kc columns of x the
product needs, w_comp and row_idx read once, y (B, N) written once.
"""
from __future__ import annotations

from typing import Tuple

OP = "intrablock_gather_matmul"


def describe(ctx: dict, x, w_comp, row_idx, **_) -> dict:
    return {"B": x.shape[0], "K": x.shape[1], "Kc": w_comp.shape[0], "N": w_comp.shape[1],
            "elt": x.element_size(), "idx_elt": row_idx.element_size()}


def work(c: dict) -> Tuple[int, int]:
    B, Kc, N, elt = c["B"], c["Kc"], c["N"], c["elt"]
    return 2 * B * Kc * N, elt * (B * Kc + Kc * N + B * N) + c["idx_elt"] * Kc
