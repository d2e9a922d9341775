"""Launch plans of the port's kernels that have variants.

A plan is decided on the host before the launch, from shapes, dtype and
pointer alignment alone (it never reads a tensor back from the card).

Block-sparse matmul and IntraBlock gather-matmul (``bsm_plan``,
``igm_plan``):

* the **variant** — ``"decode"`` (bf16, B <= 16: TMA ring + mma.sync +
  cluster split-K), ``"prefill"`` (bf16, B > 16: TMA ring + wgmma),
  ``"general"`` (bf16 shapes or alignments the two do not take: the first
  kernel, kept) or ``"f32"`` (the precision reference).  The gather-matmul
  tiles N by 128 with a ragged last tile, so its main variants take any N
  whose weight rows a tensor map can describe (row stride a multiple of
  16 bytes, base 16-byte aligned);
* the **cluster** size ``c``: how many CTAs split one output tile's
  reduction;
* the **partition** of that reduction over the cluster's ranks: rank r
  takes units ``split_range(n, c, r)`` of the tile's n units, where a unit
  is a live slot of the idx row (block-sparse) or a 64-row chunk of Kc
  (gather-matmul).  The CUDA kernels compute the same ranges in the same
  way (``csrc/block_sparse_matmul.cu``, ``csrc/intrablock_matmul.cu``) and
  sum the ranks' f32 partials in rank order.

Flash attention (``fa_plan``): ``"wgmma"`` (bf16, hd 64, 128 or 256,
causal, Sq = Skv a multiple of 128, aligned: TMA ring + wgmma, softmax in
registers) with its rows per CTA, keys per kv tile and q heads packed per
CTA, chosen per head dim (``FA_LEVERS``; ``FA_BUILT`` lists the ones
the kernel is built with); ``"general"`` (the first kernel) or ``"f32"``.
``fa_live_tiles``,
``fa_tile_needs_mask`` and ``fa_tile_order`` mirror the kernel's live kv
range, its masked tiles and its launch order.

Block importance (``bi_plan``): ``"strip"`` (128 x 128 blocks, aligned)
or ``"general"``.

Decode attention (``da_plan``): the keys each split of a (slot, kv head)
takes, from the shapes alone, so that a launch never depends on the
positions and a CUDA graph can replay it.

Bit-serial zero profile (``bsp_plan``): ``"strip"`` (int8 in 16-byte
chunks, a group's chunks on neighbouring lanes), ``"fused"`` (bf16 or
f32 quantised in registers and counted, the same layout) or
``"general"`` (the first int8 kernel; for a float input, quantisation by
plain tensor ops on the card, then the int8 count), with the grid of the
two one-launch variants.

The plan functions are memoised: a decode step asks for the same few
plans on every layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["Plan", "DECODE_MAX_B", "CHUNK", "TILE_N", "SMS", "BSM_DECODE_CTAS",
           "IGM_DECODE_CTAS", "IGM_DECODE_CAP", "PREFILL_CTAS", "split_range",
           "choose_cluster", "bsm_plan", "igm_plan", "live_partition", "chunk_partition",
           "FaPlan", "FA_BUILT", "FA_HEAD_DIMS", "FA_LEVERS", "fa_settings", "fa_plan", "fa_live_tiles", "fa_tile_needs_mask", "fa_tile_order",
           "DA_TILE", "DA_CTAS", "da_plan", "bi_plan", "BspPlan", "BSP_THREADS", "BSP_UNROLL", "BSP_CTAS_PER_SM", "bsp_plan"]

DECODE_MAX_B = 16      # rows of x one mma.sync tile holds
CHUNK = 64             # Kc rows of one gather-matmul stage
TILE_N = 128           # output columns of one tile (both kernels' main variants)
PREFILL_ROWS = 128     # output rows of one prefill tile
SMS = 132              # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8        # portable thread-block cluster size
ALIGN = 16             # bytes: bulk copies and tensor maps need 16-byte aligned rows


@dataclass(frozen=True)
class Plan:
    variant: str       # "decode" | "prefill" | "general" | "f32"
    cluster: int       # CTAs that split one output tile's reduction


def split_range(n: int, c: int, r: int) -> Tuple[int, int]:
    """Units [lo, hi) of rank r when n units are split over c ranks."""
    return r * n // c, (r + 1) * n // c


# CTAs a grid should reach before the reduction is split further, per
# variant; read off a sweep of c = 1, 2, 4, 8 at the main-path shapes on an
# H100 (chip_smoke.py prints it beside every bf16 kernel row).  The
# block-sparse decode CTA streams 32 KB blocks and one per SM already
# keeps enough bytes in flight; the gather-matmul decode CTA streams 16 KB
# chunks and wants two or three per SM; at prefill each further split
# costs a 64 KB partial through distributed shared memory, worth it only
# on small grids.  IGM_DECODE_CAP: see igm_plan.
BSM_DECODE_CTAS = 128
IGM_DECODE_CTAS = 2 * SMS
IGM_DECODE_CAP = 330
PREFILL_CTAS = 128


def choose_cluster(tiles: int, units: int, target: int, min_units: int = 1) -> int:
    """The smallest power of two c <= 8 with tiles * c >= target, kept
    small enough that every rank has at least ``min_units`` units."""
    c = 1
    while c < MAX_CLUSTER and tiles * c < target and units >= 2 * c * min_units:
        c *= 2
    return c


@lru_cache(maxsize=1024)
def bsm_plan(B: int, K: int, Gn: int, L: int, bm: int, bn: int, dtype: torch.dtype,
             align: int) -> Plan:
    """Plan of ``block_sparse_matmul`` for x (B, K), w_comp (Gn, L, bm, bn).

    ``align`` is the largest power of two dividing the addresses of x and
    w_comp.  The cluster is sized from L, the slot count (the live count
    of each row is only known on the card; ``compress_fullblock`` makes L
    the largest live count of the stack).
    """
    if dtype == torch.float32:
        return Plan("f32", 1)
    if bm != TILE_N or bn != TILE_N or align % ALIGN:
        return Plan("general", 1)
    if B <= DECODE_MAX_B:
        return Plan("decode", choose_cluster(Gn, L, BSM_DECODE_CTAS))
    tiles = Gn * -(-B // PREFILL_ROWS)
    return Plan("prefill", choose_cluster(tiles, L, PREFILL_CTAS, min_units=2))


@lru_cache(maxsize=1024)
def igm_plan(B: int, Kc: int, N: int, dtype: torch.dtype, align: int,
             ldw: Optional[int] = None) -> Plan:
    """Plan of ``intrablock_gather_matmul`` for x (B, K), w_comp (Kc, N)
    with row stride ``ldw`` elements (default N: contiguous).

    ``align`` is the largest power of two dividing the address of w_comp
    (x is gathered element by element, so its address does not matter).
    The main variants read w_comp through a TMA tensor map, whose row
    stride must be a multiple of 16 bytes: a bf16 weight whose row stride
    is not a multiple of 8 elements (``sparsity.apply`` pads such rows
    when it compresses) or whose base is not 16-byte aligned takes
    ``general``.  N need not be a multiple of 128: the last 128-column
    tile is ragged.
    """
    if dtype == torch.float32:
        return Plan("f32", 1)
    ldw = N if ldw is None else ldw
    if (2 * ldw) % ALIGN or align % ALIGN:
        return Plan("general", 1)
    chunks = -(-Kc // CHUNK)
    col_tiles = -(-N // TILE_N)
    if B <= DECODE_MAX_B:
        # A cap on the decode grid, fitted to the one served shape where it
        # binds: hymba-1.5b's w_in (51 column tiles, 13 chunks) ran
        # 0.0100 ms at c = 4 (204 CTAs) and 0.0126 ms at c = 8 (408) in the
        # cluster sweep chip_smoke.py prints (H100 80GB HBM3, 700 W).  The
        # other served grids stay under it, so their clusters are unchanged.
        c = choose_cluster(col_tiles, chunks, IGM_DECODE_CTAS)
        while c > 1 and col_tiles * c > IGM_DECODE_CAP:
            c //= 2
        return Plan("decode", c)
    tiles = col_tiles * -(-B // PREFILL_ROWS)
    return Plan("prefill", choose_cluster(tiles, chunks, PREFILL_CTAS, min_units=2))


def live_partition(idx_row: Sequence[int], c: int) -> List[List[int]]:
    """The slot positions each of c ranks takes from one idx row: its
    share of the live slots (entries >= 0), in slot order."""
    live = [l for l, v in enumerate(idx_row) if int(v) >= 0]
    return [live[slice(*split_range(len(live), c, r))] for r in range(c)]


def chunk_partition(Kc: int, c: int) -> List[List[Tuple[int, int]]]:
    """The Kc row ranges [k0, k1) each of c ranks takes, one per chunk."""
    chunks = [(k0, min(k0 + CHUNK, Kc)) for k0 in range(0, Kc, CHUNK)]
    return [chunks[slice(*split_range(len(chunks), c, r))] for r in range(c)]


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaPlan:
    variant: str       # "wgmma" | "general" | "f32"
    rows: int = 0      # (query position, q head) rows per CTA: 64 or 128
    keys: int = 0      # keys per kv tile: 64 or 128
    pack: int = 1      # q heads of one kv head that share a CTA: 1 or 4


# (rows, keys, pack) settings the wgmma kernel is built with, per head dim:
# the FA_CASE lines of fa_fwd_bf16_wgmma in csrc/flash_attention.cu.  At hd
# 256 only 64 rows and 64 keys: a 128-key stage does not fit beside the
# 3-stage ring of 64 KB stages, and 128 rows neither fit nor kept O, S and P
# in registers without spilling.
_BUILT_64_128 = [(128, 128, 1), (128, 128, 4), (128, 64, 1), (128, 64, 4),
                 (64, 128, 1), (64, 128, 4), (64, 64, 1), (64, 64, 4)]
FA_BUILT = {64: _BUILT_64_128, 128: _BUILT_64_128, 256: [(64, 64, 1), (64, 64, 4)]}
FA_HEAD_DIMS = tuple(FA_BUILT)   # head dims the wgmma variant is built for

# wgmma levers (rows, keys, pack) per head dim, read off the sweep of rows
# x keys x pack that chip_smoke.py prints beside the flash-attention rows
# on an H100.  hd 128 (q (1, S, 32, 128), k/v (1, S, 8, 128), S = 512 and
# 2048): two warpgroups of 64 rows per CTA and tiles of 64 keys were the
# fastest setting, or within 2% of it, in every sweep (one warpgroup per
# CTA varied by 1.4x between builds); packing the 4 q heads of a kv head
# into one CTA saved nothing (the K/V tiles come from L2 either way).
# hd 64 (q (1, 1664, 25, 64), k/v 5 heads, window 1024: hymba-1.5b's
# prefill) and hd 256 (q/k/v (1, 512, 16, 256): gemma-7b's): one
# warpgroup of 64 rows and 64-key tiles, the fastest or within 3% of it
# at both and at S = 256 (PERF.md §6); at hd 256 the only rows built.
FA_LEVERS = {64: (64, 64, 1), 128: (128, 64, 1), 256: (64, 64, 1)}


def fa_settings(hd: int, group: int) -> List[Tuple[int, int, int]]:
    """The (rows, keys, pack) settings of ``FA_BUILT`` at head dim ``hd``
    that a group of ``group`` q heads per kv head can take (pack divides
    the group)."""
    return [s for s in FA_BUILT.get(hd, []) if group % s[2] == 0]


@lru_cache(maxsize=1024)
def fa_plan(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, hd: int, dtype: torch.dtype,
            causal: bool, window: Optional[int], align: int) -> FaPlan:
    """Plan of ``flash_attention`` for q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd).

    ``align`` is the largest power of two dividing the addresses of q, k,
    v and the output.  The wgmma variant takes bf16, hd 64, 128 or 256,
    causal attention with or without a window, Sq = Skv a multiple of 128
    and 16-byte aligned tensors, at its head dim's levers (``FA_LEVERS``;
    pack 1 where the head group does not divide); every other shape runs
    the first kernel.
    """
    if dtype == torch.float32:
        return FaPlan("f32")
    if (hd not in FA_HEAD_DIMS or not causal or Sq != Skv or Sq % 128 or Hq % Hkv
            or align % ALIGN):
        return FaPlan("general")
    rows, keys, pack = FA_LEVERS[hd]
    pack = pack if (Hq // Hkv) % pack == 0 else 1
    return FaPlan("wgmma", rows, keys, pack)


def fa_live_tiles(p_lo: int, p_hi: int, keys: int, window: Optional[int]) -> Tuple[int, int]:
    """kv tiles [lo, hi] (inclusive) that query positions [p_lo, p_hi] see
    under the causal mask and an optional window."""
    lo = max(p_lo - window + 1, 0) // keys if window else 0
    return lo, p_hi // keys


def fa_tile_needs_mask(t: int, p_lo: int, p_hi: int, keys: int,
                       window: Optional[int]) -> bool:
    """Whether kv tile t holds a (position, key) pair the mask removes,
    for positions [p_lo, p_hi]: the diagonal and the window's edge."""
    return t * keys + keys - 1 > p_lo or bool(window) and t * keys <= p_hi - window


def fa_tile_order(S: int, B: int, Hq: int, rows: int, pack: int) -> List[Tuple[int, int, int]]:
    """(query tile, batch, first q head) of each CTA in launch order: the
    last query tiles, which see the most kv tiles, first."""
    P, groups = rows // pack, Hq // pack
    n_qt, per_qt = S // P, B * groups
    order = []
    for cta in range(n_qt * per_qt):
        rem = cta % per_qt
        order.append((n_qt - 1 - cta // per_qt, rem // groups, (rem % groups) * pack))
    return order


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------

# Keys of one ring stage of csrc/decode_attention.cu; the
# CTAs a grid should reach (two resident on each SM, two waves), and the
# bounds of a split, 2 to 8 stages: fewer leave a CTA's ring without a
# tile to prefetch, more leave the last wave ragged where slots' lengths
# differ.
DA_TILE = 64
DA_CTAS = 4 * SMS
DA_SPLIT_TILES = (2, 8)


@lru_cache(maxsize=1024)
def da_plan(B: int, Smax: int, Hkv: int) -> Tuple[int, int]:
    """``(chunk, nsplit)`` of ``decode_attention`` over a (B, Smax, Hkv, hd)
    cache: each (slot, kv head) is split into ``nsplit`` ranges of
    ``chunk`` keys (a multiple of DA_TILE), as many as bring the grid to
    DA_CTAS CTAs within DA_SPLIT_TILES stages a split."""
    tiles = -(-Smax // DA_TILE)
    want = -(-DA_CTAS // (B * Hkv))
    lo, hi = DA_SPLIT_TILES
    chunk = min(hi, max(lo, -(-tiles // want))) * DA_TILE
    return chunk, -(-Smax // chunk)


# ---------------------------------------------------------------------------
# Block importance
# ---------------------------------------------------------------------------

@lru_cache(maxsize=256)
def bi_plan(M: int, N: int, bm: int, bn: int, dtype: torch.dtype, align: int) -> str:
    """Variant of ``block_importance`` for w (M, N) in bm x bn blocks:
    ``"strip"`` for 128 x 128 blocks of a 16-byte aligned bf16 or f32
    weight, else ``"general"``."""
    if bm == TILE_N and bn == TILE_N and align % ALIGN == 0 and M % bm == 0 and N % bn == 0:
        return "strip"
    return "general"


# ---------------------------------------------------------------------------
# Bit-serial zero profile
# ---------------------------------------------------------------------------

BSP_THREADS = 256      # threads of one CTA
BSP_UNROLL = 4         # 16-byte chunk loads in flight per lane
BSP_CTAS_PER_SM = 4    # resident CTAs an SM is given: the grid is at most one wave
_BSP_ESIZE = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 4}


@dataclass(frozen=True)
class BspPlan:
    variant: str       # "strip" | "fused" | "general"
    lanes: int = 0     # 16-byte chunks (lanes) of one group
    grid: int = 0      # CTAs of the one-launch variants


@lru_cache(maxsize=256)
def bsp_plan(V: int, K: int, g: int, dtype: torch.dtype, align: int) -> BspPlan:
    """Variant of the bit-serial count of (V, K) in groups of g rows.

    int8 takes ``"strip"``, bf16 and f32 take ``"fused"``, where K and g
    are multiples of a 16-byte chunk's elements, a group is a power of two
    of at most 32 chunks and the input is 16-byte aligned; everything else
    takes ``"general"``.  The grid covers the V * ceil(K/g) * lanes chunk
    slots with BSP_UNROLL per thread, at most one wave of
    BSP_CTAS_PER_SM CTAs on each of the SMS SMs.
    """
    esize = _BSP_ESIZE.get(dtype)
    if esize is None:
        return BspPlan("general")
    per_chunk = ALIGN // esize
    lanes = g // per_chunk
    if (K % per_chunk or g % per_chunk or not 1 <= lanes <= 32 or lanes & (lanes - 1)
            or align % ALIGN):
        return BspPlan("general")
    slots = V * -(-K // g) * lanes
    grid = max(1, min(-(-slots // (BSP_THREADS * BSP_UNROLL)), SMS * BSP_CTAS_PER_SM))
    return BspPlan("strip" if dtype == torch.int8 else "fused", lanes, grid)
