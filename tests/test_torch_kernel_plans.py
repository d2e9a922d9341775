"""Launch plans of the port's kernels that have variants
(``repro_torch.kernels.plans``), on the CPU.

Block-sparse matmul and IntraBlock gather-matmul: the CUDA variants split
each output tile's reduction over a cluster of CTAs by the plan's
partition and sum the ranks' f32 partials in rank order.  These tests
hold the partition (every live slot or Kc chunk once, no -1 slot,
wherever it sits), the choice of variant and cluster at the main-path
shapes, and a plain emulation of the split sum (the kernels' arithmetic:
each rank's f32 partial over its share, summed in rank order) against the
plain versions in ``ref.py``.

Bit-serial zero profile: the variant (``strip``, ``fused``, ``general``)
per dtype, K, group size and alignment, and the grid of the one-launch
variants.

Flash attention and block importance: the variant per dtype, head dim,
window, shape, alignment and block size; the Python mirrors of the flash
kernel's live kv-tile range, its masked tiles and its heavy-first launch
order against brute force; and an emulation of the wgmma variant's
tiling and masking against the plain version.

Decode attention: the splits of ``da_plan`` at the cells' shapes, and an
emulation of the kernel's splits, tiles and per-warp online softmax
against the plain version, within the rounding bound its card tests use.
"""
import math
from typing import List

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, plans, ref

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8


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
    """general only where a tensor map cannot read the weight's rows: a row
    stride that is no multiple of 16 bytes (N 130 contiguous) or a base
    off 16 bytes.  N % 128 != 0 alone (1000, 64, 136) no longer sends a
    weight there: the main variants' last 128-column tile is ragged.  With
    its rows padded to 8 elements, as compress_params stores them, a
    16-byte aligned weight of any N takes the main variant."""
    main = "decode" if B <= 16 else "prefill"
    want = "general" if (2 * N) % 16 or align % 16 else main
    assert plans.igm_plan(B, 500, N, BF16, align).variant == want
    padded = -(-N // 8) * 8
    assert plans.igm_plan(B, 500, N, BF16, align, padded).variant == (
        "general" if align % 16 else main)


def test_plans_send_f32_to_the_reference_kernel():
    assert plans.bsm_plan(4, 4096, 32, 22, 128, 128, F32, 256).variant == "f32"
    assert plans.igm_plan(4, 1280, 4096, F32, 256).variant == "f32"


def test_decode_and_prefill_meet_at_sixteen_rows():
    for B, want in [(1, "decode"), (16, "decode"), (17, "prefill")]:
        assert plans.bsm_plan(B, 1024, 8, 8, 128, 128, BF16, 16).variant == want
        assert plans.igm_plan(B, 500, 1024, BF16, 16).variant == want


# the SSM paths' projections (Kc, N) at row-aligned 2:4: mamba2-130m's w_in,
# hymba-1.5b's wq / w_down / w_out, wk / wv and w_in
SSM_PROJ = {"mamba2 w_in": (384, 3352), "hymba wq": (800, 1600), "hymba w_down": (2752, 1600),
            "hymba wk": (800, 320), "hymba w_in": (800, 6482)}


@pytest.mark.parametrize("key", sorted(SSM_PROJ))
@pytest.mark.parametrize("B", [1, 4, 16, 17, 512])
def test_igm_plan_takes_the_main_variants_at_ssm_shapes(key, B):
    """N % 128 != 0: ceil(N/128) column tiles, the cluster sized from them,
    and every rank keeps a chunk.  hymba's w_in (N 6482, rows of 12,964
    bytes) reaches the main variants only through its padded stride."""
    Kc, N = SSM_PROJ[key]
    ldw = -(-N // 8) * 8
    plan = plans.igm_plan(B, Kc, N, BF16, 256, ldw)
    assert plan.variant == ("decode" if B <= 16 else "prefill")
    chunks = -(-Kc // plans.CHUNK)
    assert chunks // plan.cluster >= 1
    tiles = -(-N // 128) * (1 if B <= 16 else -(-B // plans.PREFILL_ROWS))
    target = plans.IGM_DECODE_CTAS if B <= 16 else plans.PREFILL_CTAS
    if B <= 16:
        c = plans.choose_cluster(tiles, chunks, target)
        while c > 1 and tiles * c > plans.IGM_DECODE_CAP:
            c //= 2
        assert plan.cluster == c
        assert tiles * plan.cluster <= plans.IGM_DECODE_CAP
    else:
        assert plan.cluster == plans.choose_cluster(tiles, chunks, target, min_units=2)
    assert plans.igm_plan(B, Kc, N, BF16, 256).variant == ("general" if N % 8 else plan.variant)


def test_igm_plan_cluster_sizes_at_ssm_decode():
    got = {k: plans.igm_plan(4, Kc, N, BF16, 256, -(-N // 8) * 8).cluster
           for k, (Kc, N) in SSM_PROJ.items()}
    assert got == {"mamba2 w_in": 4, "hymba wq": 8, "hymba w_down": 8, "hymba wk": 8,
                   "hymba w_in": 4}


@pytest.mark.parametrize("N,ldw,align,want", [
    (6482, 6482, 256, "general"),      # hymba w_in as a contiguous tensor: 12,964-byte rows
    (6482, 6488, 256, "decode"),       # the same, rows padded to 8 elements
    (6482, 6486, 256, "general"),      # padded, but to 12,972 bytes
    (6482, 6488, 8, "general"),        # padded, base off 16 bytes
    (3352, 3352, 256, "decode"), (320, 320, 256, "decode"), (320, 328, 16, "decode"),
    (1600, 1601, 256, "general"), (4, 8, 256, "decode"), (4, 4, 256, "general")])
def test_igm_plan_reads_the_row_stride_and_base(N, ldw, align, want):
    assert plans.igm_plan(4, 800, N, BF16, align, ldw).variant == want
    assert plans.igm_plan(4, 800, N, F32, align, ldw).variant == "f32"


def test_row_stride_of_views():
    from repro_torch.kernels.intrablock_matmul import row_stride
    buf = torch.zeros(6, 16)
    assert row_stride(buf) == 16
    assert row_stride(buf[:, :13]) == 16
    assert row_stride(buf[1:4, 2:9]) == 16
    assert row_stride(buf.t()) is None                    # columns not contiguous
    assert row_stride(buf.reshape(12, 8)[::2]) == 16
    assert row_stride(torch.zeros(1, 5)[:, :3]) == 3      # one row: its own width
    assert row_stride(torch.zeros(4, 5).as_strided((4, 5), (3, 1))) is None   # rows overlap


@pytest.mark.parametrize("N,dtype,ldw", [(6482, BF16, 6488), (3352, BF16, 3352),
                                         (298, BF16, 304), (298, F32, 300), (300, F32, 300)])
def test_aligned_rows_pads_only_rows_off_16_bytes(N, dtype, ldw):
    """The layout compress_params stores: a (L, Kc, N) view whose rows are
    16-byte multiples apart, zero beyond N, equal to the input, and read
    by the plain gather-matmul as the contiguous weight."""
    from repro_torch.kernels.intrablock_matmul import row_stride
    g = torch.Generator().manual_seed(N)
    w = torch.randn(2, 5, N, generator=g).to(dtype)
    out = ops.aligned_rows(w)
    assert out.shape == w.shape and torch.equal(out, w)
    assert out.stride() == (5 * ldw, ldw, 1) and (out is w) == (ldw == N)
    assert not out.as_strided((2, 5, ldw), (5 * ldw, ldw, 1))[..., N:].any()
    assert row_stride(out[1]) == ldw
    x, idx = torch.randn(3, 9, generator=g).to(dtype), torch.tensor([8, 0, 3, 3, 1],
                                                                   dtype=torch.int32)
    assert torch.equal(ref.intrablock_gather_matmul_ref(x, out[1], idx),
                       ref.intrablock_gather_matmul_ref(x, w[1].contiguous(), idx))


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


# ---------------------------------------------------------------------------
# Flash attention and block importance
# ---------------------------------------------------------------------------

def _fa(S=512, Hq=32, Hkv=8, hd=128, dtype=BF16, causal=True, window=None, align=256, Skv=None):
    return plans.fa_plan(1, S, S if Skv is None else Skv, Hq, Hkv, hd, dtype, causal, window,
                         align)


@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (8, 2), (32, 32), (12, 4)])
@pytest.mark.parametrize("window", [None, 64, 1000])
@pytest.mark.parametrize("S", [128, 512, 2048])
def test_fa_plan_takes_wgmma_for_bf16_hd128_causal(Hq, Hkv, window, S):
    plan = _fa(S, Hq, Hkv, window=window)
    assert plan.variant == "wgmma"
    assert plan.rows in (64, 128) and plan.keys in (64, 128)
    assert (Hq // Hkv) % plan.pack == 0 and plan.pack in (1, 4)


@pytest.mark.parametrize("kw,want", [
    (dict(hd=64), "wgmma"), (dict(hd=256), "wgmma"),              # every built head dim
    (dict(causal=False), "general"), (dict(Skv=1024), "general"),
    (dict(S=200), "general"), (dict(align=8), "general"), (dict(align=2), "general"),
    (dict(dtype=F32), "f32"), (dict(dtype=F32, hd=64), "f32"),
    (dict(align=16), "wgmma"),
])
def test_fa_plan_variant_by_dtype_head_dim_shape_and_alignment(kw, want):
    assert _fa(**kw).variant == want


@pytest.mark.parametrize("hd", plans.FA_HEAD_DIMS)
@pytest.mark.parametrize("Hq,Hkv", [(25, 5), (16, 16), (32, 8), (8, 2)])
@pytest.mark.parametrize("window", [None, 1024])
@pytest.mark.parametrize("S", [128, 512, 1664, 2048])
def test_fa_plan_takes_wgmma_at_every_built_head_dim(hd, Hq, Hkv, window, S):
    """hd 64, 128 and 256, MHA and GQA (hymba's 25 / 5, gemma-7b's 16 / 16),
    a window or none: the wgmma variant at the head dim's levers, a setting
    the kernel is built with for the group."""
    plan = _fa(S, Hq, Hkv, hd=hd, window=window)
    assert plan.variant == "wgmma"
    rows, keys, pack = plans.FA_LEVERS[hd]
    assert (plan.rows, plan.keys) == (rows, keys)
    assert plan.pack == (pack if (Hq // Hkv) % pack == 0 else 1)
    assert (plan.rows, plan.keys, plan.pack) in plans.fa_settings(hd, Hq // Hkv)


def test_fa_levers_per_head_dim():
    """Each head dim has its own levers, each a built setting; hd 256 has
    no 128-key tile and no 128-row CTA."""
    assert set(plans.FA_LEVERS) == set(plans.FA_HEAD_DIMS)
    for hd, (rows, keys, pack) in plans.FA_LEVERS.items():
        assert (rows, keys, pack) in plans.fa_settings(hd, 4)
        assert (rows, keys, pack) in plans.FA_BUILT[hd]
    assert plans.FA_LEVERS[128] == (128, 64, 1)
    assert plans.FA_LEVERS[256][1] == 64


@pytest.mark.parametrize("group", [1, 4, 5, 8])
def test_fa_settings_leave_out_128_key_tiles_at_hd_256(group):
    at256 = plans.fa_settings(256, group)
    assert at256 and all(keys == 64 and rows == 64 for rows, keys, _ in at256)
    assert all(group % pack == 0 for _, _, pack in at256)
    for hd in (64, 128):
        got = plans.fa_settings(hd, group)
        assert {keys for _, keys, _ in got} == {64, 128}
        assert all(group % pack == 0 for _, _, pack in got)
    assert plans.fa_settings(96, group) == []


def test_fa_built_settings_per_head_dim():
    """hd 64 and 128 build rows 64/128 x keys 64/128 x pack 1/4; hd 256
    builds 64 rows and 64 keys at pack 1 and 4; fa_settings at a group of
    4 is the whole list, at a group of 1 the pack-1 settings."""
    full = {(r, k, p) for r in (64, 128) for k in (64, 128) for p in (1, 4)}
    assert set(plans.FA_BUILT[64]) == set(plans.FA_BUILT[128]) == full
    assert plans.FA_BUILT[256] == [(64, 64, 1), (64, 64, 4)]
    assert plans.FA_HEAD_DIMS == (64, 128, 256)
    for hd, built in plans.FA_BUILT.items():
        assert len(set(built)) == len(built)
        assert plans.fa_settings(hd, 4) == built
        assert plans.fa_settings(hd, 1) == [s for s in built if s[2] == 1]


def test_fa_plan_packs_only_whole_groups():
    """A packed CTA holds `pack` q heads of one kv head, so pack must
    divide the group size; otherwise the plan packs one head."""
    assert _fa(Hq=32, Hkv=32).pack == 1
    assert _fa(Hq=6, Hkv=3).pack == 1


@pytest.mark.parametrize("M,N,bm,bn,align,dtype,want", [
    (4096, 14336, 128, 128, 256, BF16, "strip"), (14336, 4096, 128, 128, 256, F32, "strip"),
    (4096, 1024, 128, 128, 16, BF16, "strip"), (256, 384, 128, 128, 8, BF16, "general"),
    (256, 384, 64, 128, 256, BF16, "general"), (256, 384, 128, 64, 256, BF16, "general"),
    (128, 256, 32, 16, 256, F32, "general")])
def test_bi_plan_variant(M, N, bm, bn, align, dtype, want):
    assert plans.bi_plan(M, N, bm, bn, dtype, align) == want


def _live_pairs(p_lo, p_hi, k0, k1, window):
    """(position, key) pairs of positions [p_lo, p_hi] and keys [k0, k1]
    that the causal (and window) mask keeps, and the number removed."""
    kept = removed = 0
    for p in range(p_lo, p_hi + 1):
        for k in range(k0, k1 + 1):
            ok = k <= p and (window is None or k > p - window)
            kept += ok
            removed += not ok
    return kept, removed


@pytest.mark.parametrize("S", [128, 256, 384])
@pytest.mark.parametrize("rows,pack", [(128, 1), (64, 1), (128, 4), (64, 4)])
@pytest.mark.parametrize("keys", [64, 128])
@pytest.mark.parametrize("window", [None, 1, 17, 64, 100, 128, 300])
def test_fa_live_tiles_and_masks_match_brute_force(S, rows, pack, keys, window):
    """For every CTA and each of its warpgroups (64 rows each): the kernel's
    live kv range holds every tile with a kept pair and no other, and the
    tiles it masks are exactly those that hold a removed pair."""
    P = rows // pack
    for q_lo in range(0, S, P):
        spans = [(q_lo, q_lo + P - 1)] + [
            (q_lo + w * 64 // pack, q_lo + (w * 64 + 63) // pack) for w in range(rows // 64)]
        for p_lo, p_hi in spans:
            lo, hi = plans.fa_live_tiles(p_lo, p_hi, keys, window)
            for t in range(S // keys):
                kept, removed = _live_pairs(p_lo, p_hi, t * keys, t * keys + keys - 1, window)
                assert (lo <= t <= hi) == (kept > 0), (p_lo, p_hi, t)
                if lo <= t <= hi:
                    assert plans.fa_tile_needs_mask(t, p_lo, p_hi, keys, window) == (removed > 0)


@pytest.mark.parametrize("S,B,Hq,rows,pack", [(512, 1, 32, 128, 1), (512, 1, 32, 128, 4),
                                               (2048, 2, 8, 64, 4), (384, 3, 4, 64, 1)])
def test_fa_tile_order_is_a_heavy_first_permutation(S, B, Hq, rows, pack):
    order = plans.fa_tile_order(S, B, Hq, rows, pack)
    P = rows // pack
    everything = {(qt, b, h) for qt in range(S // P) for b in range(B)
                  for h in range(0, Hq, pack)}
    assert len(order) == len(everything) and set(order) == everything
    for keys in (64, 128):
        live = [plans.fa_live_tiles(qt * P, qt * P + P - 1, keys, None) for qt, _, _ in order]
        counts = [hi - lo + 1 for lo, hi in live]
        assert counts == sorted(counts, reverse=True)
        assert counts[0] == S // keys


def emulate_flash_wgmma(q, k, v, window, rows, keys, pack):
    """The wgmma variant's arithmetic in f32 on the CPU: CTAs of `rows`
    (position, head) rows, each 64-row warpgroup walking its own live kv
    tiles, the mask applied only on the tiles fa_tile_needs_mask names,
    the online softmax in the log2 domain and P rounded to bf16 before
    P.V, as the kernel does."""
    B, S, Hq, hd = q.shape
    G = Hq // k.shape[2]
    c = math.log2(math.e) / math.sqrt(hd)
    out = torch.empty(B, S, Hq, hd)
    P = rows // pack
    for qt, b, h0 in plans.fa_tile_order(S, B, Hq, rows, pack):
        q_lo = qt * P
        for w in range(rows // 64):
            R = torch.arange(w * 64, w * 64 + 64)
            pos, head = q_lo + R // pack, h0 + R % pack
            qr = q[b, pos, head].float()                                   # (64, hd)
            p_lo, p_hi = int(pos[0]), int(pos[-1])
            lo, hi = plans.fa_live_tiles(p_lo, p_hi, keys, window)
            m = torch.full((64,), -1e30)
            l = torch.zeros(64)
            acc = torch.zeros(64, hd)
            for t in range(lo, hi + 1):
                kt = k[b, t * keys:(t + 1) * keys, h0 // G].float()
                vt = v[b, t * keys:(t + 1) * keys, h0 // G]
                s = (qr @ kt.T) * c
                if plans.fa_tile_needs_mask(t, p_lo, p_hi, keys, window):
                    key = torch.arange(t * keys, (t + 1) * keys)[None, :]
                    ok = key <= pos[:, None]
                    if window:
                        ok &= key > pos[:, None] - window
                    s = torch.where(ok, s, torch.tensor(-1e30))
                n = torch.maximum(m, s.max(dim=1).values)
                corr = torch.exp2(m - n)
                p = torch.exp2(s - n[:, None])
                l = l * corr + p.sum(dim=1)
                acc = acc * corr[:, None] + p.to(vt.dtype).float() @ vt.float()
                m = n
            out[b, pos, head] = acc / torch.clamp(l, min=1e-20)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("rows,keys,pack", [(128, 128, 1), (128, 64, 4), (64, 64, 1),
                                            (64, 128, 4)])
@pytest.mark.parametrize("window", [None, 50])
def test_flash_wgmma_emulation_equals_plain(rows, keys, pack, window):
    """Skipping the mask on the tiles the kernel skips it on, and each
    warpgroup's own tile range, change nothing against the plain version."""
    g = torch.Generator().manual_seed(rows + keys + pack)
    q = torch.randn(2, 256, 8, 128, generator=g).to(BF16)
    k = torch.randn(2, 256, 2, 128, generator=g).to(BF16)
    v = torch.randn(2, 256, 2, 128, generator=g).to(BF16)
    got = emulate_flash_wgmma(q, k, v, window, rows, keys, pack)
    want = ops.flash_attention(q, k, v, window=window, impl="ref")
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("hd,Hq,Hkv", [(64, 25, 5), (256, 4, 4)])
@pytest.mark.parametrize("window", [None, 100])
def test_flash_wgmma_emulation_equals_plain_at_hd_64_and_256(hd, Hq, Hkv, window):
    """The same emulation at the other built head dims and their levers
    (hymba-1.5b's 25 q / 5 kv heads of 64, gemma-7b's MHA at 256)."""
    g = torch.Generator().manual_seed(hd + Hq)
    S = 256
    q = torch.randn(1, S, Hq, hd, generator=g).to(BF16)
    k = torch.randn(1, S, Hkv, hd, generator=g).to(BF16)
    v = torch.randn(1, S, Hkv, hd, generator=g).to(BF16)
    plan = _fa(S, Hq, Hkv, hd=hd, window=window)
    got = emulate_flash_wgmma(q, k, v, window, plan.rows, plan.keys, plan.pack)
    want = ops.flash_attention(q, k, v, window=window, impl="ref")
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)


# ---------------------------------------------------------------------------
# Bit-serial zero profile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V,K,g,dtype,align,want,lanes", [
    # the qwen3-4b profile: activations of d_model and d_ff features, groups of 32
    (1916, 2560, 32, I8, 256, "strip", 2), (1916, 9728, 32, I8, 256, "strip", 2),
    (1916, 2560, 32, BF16, 256, "fused", 4), (1916, 9728, 32, BF16, 256, "fused", 4),
    (1916, 2560, 32, F32, 256, "fused", 8),
    # K a multiple of 16 but not of g: the last group of a row is short
    (100, 96, 64, I8, 16, "strip", 4), (7, 40, 16, BF16, 16, "fused", 2),
    # a group of one chunk and of 32 chunks
    (16, 64, 16, I8, 16, "strip", 1), (4, 1024, 512, I8, 16, "strip", 32),
    (4, 64, 4, F32, 16, "fused", 1), (4, 512, 256, BF16, 16, "fused", 32),
    # ragged K, small or odd groups, wide groups, misaligned, other dtypes
    (100, 100, 32, I8, 256, "general", 0), (16, 64, 8, I8, 256, "general", 0),
    (16, 96, 48, I8, 256, "general", 0), (4, 2048, 1024, I8, 256, "general", 0),
    (16, 64, 16, I8, 8, "general", 0), (16, 100, 32, BF16, 256, "general", 0),
    (16, 64, 4, BF16, 256, "general", 0), (16, 64, 32, BF16, 2, "general", 0),
    (16, 64, 32, torch.float16, 256, "general", 0), (16, 64, 2, F32, 256, "general", 0)])
def test_bsp_plan_variant(V, K, g, dtype, align, want, lanes):
    plan = plans.bsp_plan(V, K, g, dtype, align)
    assert (plan.variant, plan.lanes) == (want, lanes)
    if want != "general":
        assert plan.lanes * (16 // torch.empty((), dtype=dtype).element_size()) == g


@pytest.mark.parametrize("V,K,g,dtype", [(1916, 2560, 32, I8), (2048, 9728, 32, I8),
                                         (1916, 9728, 32, BF16), (100, 96, 64, I8),
                                         (1, 16, 16, I8), (0, 64, 16, I8), (5, 0, 16, BF16)])
def test_bsp_plan_grid_is_at_most_one_wave_and_covers_the_slots(V, K, g, dtype):
    """At most BSP_CTAS_PER_SM CTAs on each SM (the kernel's ticket counts
    to 65535), at least one CTA, and no more CTAs than the slots need."""
    plan = plans.bsp_plan(V, K, g, dtype, 256)
    slots = V * -(-K // g) * plan.lanes
    per_cta = plans.BSP_THREADS * plans.BSP_UNROLL
    wave = plans.SMS * plans.BSP_CTAS_PER_SM
    assert 1 <= plan.grid <= wave < 2**16
    assert plan.grid == wave or plan.grid * per_cta >= slots
    assert plan.grid == 1 or (plan.grid - 1) * per_cta < slots
    if (V, K) == (2048, 9728):
        assert plan.grid == wave


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Smax,Hkv,want", [(32, 8320, 8, (512, 17)), (64, 4608, 8, (512, 9)),
                                             (1, 8256, 4, (128, 65)), (8, 32768, 8, (512, 64)),
                                             (2, 100, 2, (128, 1)), (3, 1000, 2, (128, 8))])
def test_da_plan_splits_cover_the_cache_from_the_shapes(B, Smax, Hkv, want):
    """The longdoc, session-decode and MoE cells' caches, decode_32k's and
    small ones: whole ring stages a split, 2 to 8 of them, the splits
    covering every key, as many as bring the grid to DA_CTAS where the
    cache is long enough."""
    chunk, nsplit = plans.da_plan(B, Smax, Hkv)
    assert (chunk, nsplit) == want
    lo, hi = plans.DA_SPLIT_TILES
    assert chunk % plans.DA_TILE == 0 and lo <= chunk // plans.DA_TILE <= hi
    assert (nsplit - 1) * chunk < Smax <= nsplit * chunk
    assert B * Hkv * nsplit >= plans.DA_CTAS or chunk == lo * plans.DA_TILE or chunk >= Smax


def _da_emulate(q: torch.Tensor, K: torch.Tensor, V: torch.Tensor, n: int,
                chunk: int) -> torch.Tensor:
    """The decode-attention kernel's arithmetic for one (slot, kv head):
    q (G, hd), K/V (Smax, hd) bf16, keys 0..n-1.  Each split of ``chunk``
    keys walks 64-key tiles; each of 4 warps takes 16 keys of a tile with
    its own online softmax (p rounded to bf16 against the warp's running
    max); the warps' states merge, then the live splits'."""
    G, hd = q.shape
    inf = float("-inf")

    def merge(states):
        M = torch.stack([m for m, _, _ in states]).amax(0)
        Ms = torch.where(torch.isinf(M), torch.zeros_like(M), M)
        L, A = torch.zeros(G), torch.zeros(G, hd)
        for m, l, a in states:
            e = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - Ms))
            L, A = L + l * e, A + a * e[:, None]
        return M, L, A

    splits = []
    for c0 in range(0, max(1, -(-n // chunk)) * chunk, chunk):
        kend = min(c0 + chunk, n)
        warps = [[torch.full((G,), inf), torch.zeros(G), torch.zeros(G, hd)] for _ in range(4)]
        for t0 in range(c0, kend, 64):
            for w, st in enumerate(warps):
                keys = list(range(t0 + 16 * w, min(t0 + 16 * w + 16, kend)))
                if not keys:
                    continue
                s = q.float() @ K[keys].float().T / math.sqrt(hd)
                m_new = torch.maximum(st[0], s.amax(-1))
                ms = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
                corr = torch.where(torch.isinf(st[0]), torch.zeros_like(ms), torch.exp(st[0] - ms))
                p = torch.exp(s - ms[:, None])
                st[1] = st[1] * corr + p.sum(-1)
                st[2] = st[2] * corr[:, None] + p.bfloat16().float() @ V[keys].float()
                st[0] = m_new
        splits.append(merge(warps))
    _, L, A = merge(splits)
    return (A / L.clamp(min=1e-20)[:, None]).bfloat16()


@pytest.mark.parametrize("pos", [[0, 1, 63, 64, 150, 299], [299, 300, 17, 200, 128, 8]])
@pytest.mark.parametrize("sharp", [1.0, 8.0])
def test_decode_attention_emulation_within_rounding_of_plain(pos, sharp):
    """The kernel's split / tile / warp arithmetic over ragged positions
    (0, a tile's last key, a split's first, Smax - 1, Smax: the write
    dropped) stays within the rounding bound the card tests hold the
    kernel to: |out - plain| <= 2^-7 (|V|'s attention + |plain|)."""
    B, Smax, Hq, Hkv, hd, chunk = 6, 300, 8, 2, 32, 128
    g = torch.Generator().manual_seed(int(sharp))
    q = (torch.randn(B, 1, Hq, hd, generator=g) * sharp).bfloat16()
    k, v = (torch.randn(B, 1, Hkv, hd, generator=g).bfloat16() for _ in range(2))
    K, V = (torch.randn(B, Smax, Hkv, hd, generator=g).bfloat16() for _ in range(2))
    p = torch.tensor(pos)
    want = ref.decode_attention_ref(q, k, v, K1 := K.clone(), V1 := V.clone(), p)
    mag = ref.decode_attention_ref(q, k, v.abs(), K.clone(), V.abs(), p)
    G = Hq // Hkv
    for b in range(B):
        n = min(pos[b], Smax - 1) + 1
        for h in range(Hkv):
            out = _da_emulate(q[b, 0, h * G:(h + 1) * G], K1[b, :, h], V1[b, :, h], n, chunk)
            w = want[b, 0, h * G:(h + 1) * G].float()
            bound = 2 ** -7 * (mag[b, 0, h * G:(h + 1) * G].float() + w.abs())
            assert ((out.float() - w).abs() <= bound).all(), (b, h)
