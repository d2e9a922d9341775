"""Launch plans of the port's block-sparse matmul and IntraBlock
gather-matmul (``repro_torch.kernels.plans``), on the CPU.

The CUDA variants split each output tile's reduction over a cluster of
CTAs by the plan's partition and sum the ranks' f32 partials in rank
order.  These tests hold the partition (every live slot or Kc chunk once,
no -1 slot, wherever it sits), the choice of variant and cluster at the
main-path shapes, and a plain emulation of the split sum (the kernels'
arithmetic: each rank's f32 partial over its share, summed in rank order)
against the plain versions in ``ref.py``.
"""
from typing import List

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, plans, ref

BF16, F32 = torch.bfloat16, torch.float32


def _rank_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """Partials summed in rank order from 0, as the kernels' reduction."""
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc = acc + p
    return acc


def emulate_block_sparse(x: torch.Tensor, w_comp: torch.Tensor, idx: torch.Tensor,
                         c: int) -> torch.Tensor:
    """The split-K block-sparse matmul in f32: each rank's partial over its
    live slots, summed in rank order, per column group."""
    Gn, L, bm, bn = w_comp.shape
    xf, wf = x.float(), w_comp.float()
    cols = []
    for j in range(Gn):
        parts = []
        for slots in plans.live_partition(idx[j].tolist(), c):
            p = torch.zeros(x.shape[0], bn, dtype=torch.float32)
            for l in slots:
                kb = int(idx[j, l])
                p = p + xf[:, kb * bm:(kb + 1) * bm] @ wf[j, l]
            parts.append(p)
        cols.append(_rank_sum(parts))
    return torch.cat(cols, dim=1)


def emulate_intrablock(x: torch.Tensor, w_comp: torch.Tensor, row_idx: torch.Tensor,
                       c: int) -> torch.Tensor:
    """The split-K gather-matmul in f32: each rank's partial over its Kc
    chunks, summed in rank order."""
    xg = x.float()[:, row_idx.long()]
    wf = w_comp.float()
    parts = []
    for ranges in plans.chunk_partition(w_comp.shape[0], c):
        p = torch.zeros(x.shape[0], w_comp.shape[1], dtype=torch.float32)
        for k0, k1 in ranges:
            p = p + xg[:, k0:k1] @ wf[k0:k1]
        parts.append(p)
    return _rank_sum(parts)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("c", [1, 2, 3, 4, 8])
def test_live_partition_covers_every_live_slot_once(seed, c):
    rng = np.random.default_rng(seed)
    L = int(rng.integers(1, 70))
    row = rng.integers(0, 200, size=L)
    row[rng.random(L) < rng.random()] = -1            # -1 anywhere, any share
    parts = plans.live_partition(row.tolist(), c)
    assert len(parts) == c
    flat = [l for p in parts for l in p]
    assert flat == [l for l in range(L) if row[l] >= 0]  # each live slot once, in order
    assert all(row[l] >= 0 for l in flat)
    sizes = [len(p) for p in parts]
    assert max(sizes) - min(sizes) <= 1                   # balanced to one slot


def test_live_partition_of_padding_only_row_is_empty():
    assert plans.live_partition([-1] * 9, 4) == [[], [], [], []]
    assert plans.live_partition([-1, 3, -1], 4) == [[], [], [], [1]]


@pytest.mark.parametrize("Kc", [1, 63, 64, 65, 500, 1280, 4864])
@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_chunk_partition_covers_kc_once(Kc, c):
    parts = plans.chunk_partition(Kc, c)
    rows = [k for p in parts for k0, k1 in p for k in range(k0, k1)]
    assert rows == list(range(Kc))
    assert all(k1 - k0 <= plans.CHUNK for p in parts for k0, k1 in p)


@pytest.mark.parametrize("n,c", [(0, 4), (1, 8), (7, 3), (66, 8), (20, 8)])
def test_split_range_tiles_the_units(n, c):
    ranges = [plans.split_range(n, c, r) for r in range(c)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


# llama3-8b FullBlock(128, 128, 0.5): (K, Gn, L) per projection; L is the
# stack-wide slot count, a little above half the K-blocks.
LLAMA = {"wq": (4096, 32, 22), "wk": (4096, 8, 22), "w_gate": (4096, 112, 22),
         "w_down": (14336, 32, 66)}
# qwen3-4b row-aligned IntraBlock(4, 1, 0.5): (Kc, N) per projection.
QWEN = {"wq": (1280, 4096), "wk": (1280, 1024), "w_gate": (1280, 9728), "w_down": (4864, 2560)}


@pytest.mark.parametrize("key", sorted(LLAMA))
@pytest.mark.parametrize("B", [4, 512])
def test_bsm_plan_takes_the_main_variants_at_llama_shapes(key, B):
    K, Gn, L = LLAMA[key]
    plan = plans.bsm_plan(B, K, Gn, L, 128, 128, BF16, align=256)
    assert plan.variant == ("decode" if B == 4 else "prefill")
    assert 1 <= plan.cluster <= 8 and plan.cluster & (plan.cluster - 1) == 0
    if B == 4:   # decode: the CTA target where the cluster limit allows
        assert Gn * plan.cluster >= plans.BSM_DECODE_CTAS or plan.cluster == 8
    assert L // plan.cluster >= 1


def test_bsm_plan_cluster_sizes_at_decode():
    got = {k: plans.bsm_plan(4, K, Gn, L, 128, 128, BF16, 256).cluster
           for k, (K, Gn, L) in LLAMA.items()}
    assert got == {"wq": 4, "wk": 8, "w_gate": 2, "w_down": 4}
    # prefill splits only where the grid is small (wk/wv: Gn = 8)
    assert plans.bsm_plan(512, 4096, 8, 22, 128, 128, BF16, 256).cluster == 4
    assert plans.bsm_plan(512, 4096, 112, 22, 128, 128, BF16, 256).cluster == 1
    assert plans.bsm_plan(512, 4096, 32, 22, 128, 128, BF16, 256).cluster == 1


@pytest.mark.parametrize("key", sorted(QWEN))
@pytest.mark.parametrize("B", [4, 512])
def test_igm_plan_takes_the_main_variants_at_qwen_shapes(key, B):
    Kc, N = QWEN[key]
    plan = plans.igm_plan(B, Kc, N, BF16, align=256)
    assert plan.variant == ("decode" if B == 4 else "prefill")
    assert -(-Kc // plans.CHUNK) // plan.cluster >= 1


def test_igm_plan_cluster_sizes_at_decode():
    got = {k: plans.igm_plan(4, Kc, N, BF16, 256).cluster for k, (Kc, N) in QWEN.items()}
    assert got == {"wq": 8, "wk": 8, "w_gate": 4, "w_down": 8}
    ctas = {k: got[k] * QWEN[k][1] // 128 for k in QWEN}
    assert ctas["wk"] >= 64 and ctas["w_down"] >= 160
    assert plans.igm_plan(512, 1280, 1024, BF16, 256).cluster == 4
    assert plans.igm_plan(512, 4864, 2560, BF16, 256).cluster == 2
    assert plans.igm_plan(512, 1280, 9728, BF16, 256).cluster == 1


@pytest.mark.parametrize("bm,bn,align,B", [(32, 32, 256, 4), (64, 64, 256, 70),
                                           (128, 64, 256, 5), (128, 128, 8, 4),
                                           (128, 128, 2, 512)])
def test_bsm_plan_general_variant(bm, bn, align, B):
    assert plans.bsm_plan(B, 1024, 4, 8, bm, bn, BF16, align).variant == "general"


@pytest.mark.parametrize("N,align,B", [(130, 256, 4), (1000, 256, 70), (64, 256, 4),
                                       (1024, 8, 4), (1024, 2, 512), (136, 256, 16)])
def test_igm_plan_general_variant(N, align, B):
    assert plans.igm_plan(B, 500, N, BF16, align).variant == "general"


def test_plans_send_f32_to_the_reference_kernel():
    assert plans.bsm_plan(4, 4096, 32, 22, 128, 128, F32, 256).variant == "f32"
    assert plans.igm_plan(4, 1280, 4096, F32, 256).variant == "f32"


def test_decode_and_prefill_meet_at_sixteen_rows():
    for B, want in [(1, "decode"), (16, "decode"), (17, "prefill")]:
        assert plans.bsm_plan(B, 1024, 8, 8, 128, 128, BF16, 16).variant == want
        assert plans.igm_plan(B, 500, 1024, BF16, 16).variant == want


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("c", [1, 2, 3, 8])
def test_split_sum_emulation_equals_plain_block_sparse(seed, c):
    """Ragged live counts per column group, -1 slots in mid-list, one
    column group of padding only."""
    g = torch.Generator().manual_seed(seed)
    gk, Gn, bm, bn, B = 6, 4, 16, 8, 5
    keep = torch.rand(gk, Gn, generator=g) < 0.5
    keep[:, 2] = False
    w_comp, idx = ops.compress_fullblock_torch(torch.randn(gk * bm, Gn * bn, generator=g),
                                               keep, bm, bn, L=gk)
    perm = torch.randperm(gk, generator=g)
    w_comp, idx = w_comp[:, perm].contiguous(), idx[:, perm].contiguous()
    x = torch.randn(B, gk * bm, generator=g)
    got = emulate_block_sparse(x, w_comp, idx, c)
    torch.testing.assert_close(got, ref.block_sparse_matmul_ref(x, w_comp, idx),
                               rtol=1e-5, atol=1e-5)
    assert not got[:, 2 * bn:3 * bn].any()


@pytest.mark.parametrize("Kc,c", [(500, 8), (64, 2), (200, 3), (130, 1)])
def test_split_sum_emulation_equals_plain_intrablock(Kc, c):
    g = torch.Generator().manual_seed(Kc)
    K, N, B = 2 * Kc + 3, 24, 7
    row_idx = torch.randint(0, K, (Kc,), generator=g, dtype=torch.int32)
    w_comp, x = torch.randn(Kc, N, generator=g), torch.randn(B, K, generator=g)
    torch.testing.assert_close(emulate_intrablock(x, w_comp, row_idx, c),
                               ref.intrablock_gather_matmul_ref(x, w_comp, row_idx),
                               rtol=1e-5, atol=1e-5)


def test_alignment_reads_the_largest_power_of_two():
    from repro_torch.kernels import _build
    assert _build.alignment(4096) == 256
    assert _build.alignment(4096, 4096 + 48) == 16
    assert _build.alignment(4096 + 2) == 2
