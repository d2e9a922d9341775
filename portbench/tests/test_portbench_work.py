"""Each kernel's logical work and the model FLOPs against hand counts:
causal pairs, live rows, live blocks."""
from __future__ import annotations

import math

import pytest
import torch
from _tiny import tiny_cell

from portbench.harness import modelflops
from portbench.work import block_sparse_matmul as bsm
from portbench.work import flash_attention as fa
from portbench.work import intrablock_matmul as igm


def _brute_pairs(S, window):
    return sum(1 for q in range(S) for k in range(S)
               if k <= q and (window is None or q - k < window))


@pytest.mark.parametrize("S,window", [(1, None), (5, None), (5, 2), (7, 7), (130, 64),
                                      (257, None)])
def test_causal_pairs(S, window):
    assert fa.pairs(S, True, window) == _brute_pairs(S, window)


def test_flash_counts_the_unpadded_prompt():
    q = torch.zeros(1, 256, 4, 16, dtype=torch.bfloat16)
    k = torch.zeros(1, 256, 2, 16, dtype=torch.bfloat16)
    c = fa.describe({"prefill_len": 200}, q, k, k, causal=True)
    flops, nbytes = fa.work(c)
    assert flops == 4 * 16 * 4 * 200 * 201 // 2
    assert nbytes == 2 * 200 * 16 * (2 * 4 + 2 * 2)
    c = fa.describe({}, q, k, k)             # outside a prefill: the given length
    assert fa.work(c)[0] == 4 * 16 * 4 * 256 * 257 // 2


def test_gather_matmul_counts_live_rows():
    from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock
    from repro_torch.core.pruning import flexblock_mask
    from repro_torch.kernels.ops import compress_intrablock_torch
    w = torch.randn(64, 24)
    mask = flexblock_mask(w, FlexBlockSpec((IntraBlock(4, 1, 0.5),)), align_cols=True)
    w_comp, row_idx = compress_intrablock_torch(w, mask, 4)
    live_rows = int(mask[:, 0].sum())
    assert live_rows == 32
    x = torch.zeros(3, 64)
    flops, nbytes = igm.work(igm.describe({}, x, w_comp, row_idx))
    assert flops == 2 * 3 * live_rows * 24
    assert nbytes == 4 * (3 * live_rows + live_rows * 24 + 3 * 24) + 4 * live_rows


def test_block_sparse_counts_live_blocks():
    w_comp = torch.zeros(3, 2, 4, 8, dtype=torch.bfloat16)       # Gn 3, Ls 2, bm 4, bn 8
    idx = torch.tensor([[0, 1], [2, -1], [-1, -1]], dtype=torch.int32)
    x = torch.zeros(5, 12, dtype=torch.bfloat16)
    flops, nbytes = bsm.work(bsm.describe({}, x, w_comp, idx))
    assert flops == 2 * 5 * 3 * 4 * 8
    assert nbytes == 2 * (5 * 12 + 3 * 4 * 8 + 5 * 3 * 8) + 4 * 6


def test_model_flops_by_hand():
    cfg = tiny_cell().config
    arch, pruning = cfg["arch"], cfg["pruning"]
    d, ff, L, V = arch["d_model"], arch["d_ff"], arch["n_layers"], arch["vocab_size"]
    Hq, Hkv, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    per_layer = 0.5 * (d * Hq * hd + 2 * d * Hkv * hd + 3 * d * ff) + Hq * hd * d
    assert modelflops.live_weights_per_token(arch, pruning) == pytest.approx(L * per_layer)
    S = 10
    want = 2 * S * L * per_layer + 4 * hd * Hq * L * S * (S + 1) // 2 + 2 * d * V
    assert modelflops.prefill_flops(arch, pruning, S) == pytest.approx(want)
    assert modelflops.decode_flops(arch, pruning, 10) == pytest.approx(
        2 * L * per_layer + 4 * hd * Hq * L * 11 + 2 * d * V)


def test_moe_counts_top_k_experts_and_block_density():
    arch = dict(tiny_cell().config["arch"], n_experts=8, top_k=2)
    pruning = {"pattern": "fullblock", "bm": 4, "bn": 16, "ratio": 0.5,
               "keys": ["wq", "w_gate", "w_up", "w_down"]}
    d, ff, L = arch["d_model"], arch["d_ff"], arch["n_layers"]
    # an expert leaf (E, d, ff) is masked as (E, d*ff): 2 x 512 blocks, half kept
    assert modelflops.density(pruning, "w_up", (8, d, ff)) == 0.5
    assert modelflops.density(pruning, "wk", (d, 2, 16)) == 1.0
    Hq, Hkv, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    per_layer = (0.5 * d * Hq * hd + 2 * d * Hkv * hd + Hq * hd * d + d * 8
                 + 2 / 8 * 0.5 * 3 * 8 * d * ff)
    assert modelflops.live_weights_per_token(arch, pruning) == pytest.approx(L * per_layer)
    assert modelflops.density(dict(pruning, bm=3), "w_up", (8, d, ff)) == \
        math.floor(0.5 * 3 * 512) / (3 * 512)
