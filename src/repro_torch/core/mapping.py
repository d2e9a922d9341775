"""Mapping description interface (paper §IV-C, Fig. 5(c)).

Copy of ``repro.core.mapping``: the port never imports the JAX package.

Two halves:

① *Data reshaping* — flattening the (multi-dim) weight into a 2-D matrix
  (flattening sequence), compressing it along the row or column
  orientation according to its FlexBlock mask, padding/aligning to the
  tile size, and optionally *rearranging* ragged compressed shapes
  (equalisation by padding or slicing with a user slice size).

② *Operation mapping* — a loopnest over the tiled matrix dims where each
  loop is temporal (sequential) or spatial (assigned to a macro-
  organisation dimension).  Spatially mapped weight loops *unroll* the
  matrix across macros; feature loops *duplicate* weights so macros chew
  different input vectors in parallel (§VII-C's two strategies).

Performance note (Fig. 7): :func:`reshape_and_compress` is the analytic
hot path — every simulated MVM op tiles through it.  The occupancy and
band reductions are vectorised (``np.add.reduceat`` over the compressed
column profile) and the resulting :class:`TileGrid` is memoised in a
content-addressed :class:`TileGridCache`, so repeated layer shapes — the
common case in CNN stages and transformer stacks, and across every grid
point of a sweep — pay for one grid computation.  The scalar loop
implementations are retained (``_occupancy_loop`` / ``_band_stats_loop``)
as the reference the equivalence tests replay via
:func:`reference_loops`; vectorised results are bit-for-bit identical.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .flexblock import FlexBlockSpec
from .hardware import CIMArch
from .workload import OpNode

__all__ = [
    "ReshapeSpec", "Loop", "MappingSpec", "TileGrid", "TileGridCache",
    "reshape_and_compress", "precompute_tile_grids", "reference_loops",
    "default_tile_cache", "spatial_mapping", "duplicate_mapping",
    "default_mapping",
]


@dataclasses.dataclass(frozen=True)
class ReshapeSpec:
    """Data reshaping description (§IV-C ①)."""

    flatten_order: str = "channel_major"   # 'channel_major' | 'kernel_major'
    compress_orient: str = "auto"          # 'auto' | 'row' | 'col'
    tile: Optional[Tuple[int, int]] = None  # defaults to macro (rows, cols)
    rearrange: Optional[str] = None        # None | 'pad' | 'slice'
    slice_size: int = 0                    # for rearrange='slice'
    slice_axis: str = "row"


@dataclasses.dataclass(frozen=True)
class Loop:
    """One loopnest level."""

    dim: str           # 'k_tile' | 'n_tile' | 'v_tile'
    extent: int
    kind: str          # 'temporal' | 'spatial'
    org_axis: int = -1  # for spatial loops: macro-organisation axis (0|1)


@dataclasses.dataclass(frozen=True)
class MappingSpec:
    """Full mapping description for MVM ops."""

    reshape: ReshapeSpec
    strategy: str = "spatial"   # 'spatial' (unroll weights) | 'duplicate'
    # which org axes serve weight-K, weight-N, and feature duplication
    k_axis: int = 0
    n_axis: int = 1
    mapping_dict: Tuple[Tuple[str, str], ...] = (
        ("conv", "cim_macro"), ("fc", "cim_macro"), ("matmul", "cim_macro"),
        ("dwconv", "cim_macro"),
        ("pool", "post_proc"), ("act", "post_proc"), ("add", "post_proc"),
        ("norm", "post_proc"), ("embed", "post_proc"),
    )

    def target_of(self, kind: str) -> str:
        for k, v in self.mapping_dict:
            if k == kind:
                return v
        return "post_proc"


@dataclasses.dataclass
class TileGrid:
    """Result of reshape+compress+tile for one MVM op.

    ``occupancy[kt, nt]`` = fraction of the (tile_k × tile_n) tile that
    holds real (non-padding) weight rows×cols; drives utilisation and
    energy.  ``row_lengths[nt]`` = compressed K extent per column tile
    (ragged when FullBlock pruning removes different row counts per
    column group).

    Instances may come out of a shared :class:`TileGridCache` — treat
    them (and their arrays) as immutable.
    """

    K: int                      # original contraction extent
    N: int                      # original output extent
    k_eff: np.ndarray           # per-column-tile compressed row count
    n_eff: int                  # compressed output extent
    tile_k: int
    tile_n: int
    occupancy: np.ndarray       # (kt, nt) in [0,1]
    intra_fanin: int = 1        # inputs broadcast per array row (IntraBlock m)
    misaligned: bool = False    # FullBlock boundaries cross sub-array rows

    @property
    def grid(self) -> Tuple[int, int]:
        return self.occupancy.shape

    @property
    def n_tiles(self) -> int:
        return int(np.prod(self.occupancy.shape))

    @property
    def mean_occupancy(self) -> float:
        if self.occupancy.size == 0:
            return 0.0
        return float(self.occupancy.mean())

    def band_stats(self, sub_rows: int) -> Tuple[int, int, float, bool]:
        """Per-N-tile band accounting for the cost model (memoised).

        Returns ``(bands_sum, n_tiles, row_demand, ragged)`` — see
        :func:`_band_stats_vectorized`.  The result depends only on the
        grid's column profile and ``sub_rows``, so it is computed once
        per (grid, sub_rows) pair however many ops share the grid.
        """
        memo = self.__dict__.setdefault("_band_stats_memo", {})
        hit = memo.get(sub_rows)
        if hit is None:
            hit = _band_stats_vectorized(self.k_eff, self.K, self.tile_n,
                                         sub_rows)
            memo[sub_rows] = hit
        return hit


# ---------------------------------------------------------------------------
# Reference (scalar-loop) ↔ vectorized implementations of the hot path.
#
# The loop variants are the original per-tile formulation and are kept as
# the ground truth for the equivalence tests; `reference_loops()` routes
# the whole simulator through them (and past every cache).
# ---------------------------------------------------------------------------

_REFERENCE = False


@contextlib.contextmanager
def reference_loops():
    """Route the cost-model hot path through the retained scalar-loop
    reference implementations, bypassing every memo/cache.  Test-only —
    results must be bit-for-bit identical to the vectorized default."""
    global _REFERENCE
    prev = _REFERENCE
    _REFERENCE = True
    try:
        yield
    finally:
        _REFERENCE = prev


def _tile_counts(k_cols: np.ndarray, k_base: int,
                 tile_k: int, tile_n: int) -> Tuple[int, int]:
    kt = max(1, math.ceil((int(k_cols.max()) if k_cols.size else k_base)
                          / tile_k))
    nt = max(1, math.ceil(len(k_cols) / tile_n))
    return kt, nt


def _occupancy_loop(k_cols: np.ndarray, k_base: int,
                    tile_k: int, tile_n: int) -> np.ndarray:
    """Reference: per-(kt, nt) tile occupancy via the original loop."""
    kt, nt = _tile_counts(k_cols, k_base, tile_k, tile_n)
    occ = np.zeros((kt, nt))
    for j in range(nt):
        cols = k_cols[j * tile_n:(j + 1) * tile_n]
        width_frac = len(cols) / tile_n
        for i in range(kt):
            lo, hi = i * tile_k, (i + 1) * tile_k
            rows = np.clip(cols - lo, 0, tile_k)
            if len(cols):
                occ[i, j] = float(rows.mean()) / tile_k * width_frac
    return occ


def _occupancy_vectorized(k_cols: np.ndarray, k_base: int,
                          tile_k: int, tile_n: int) -> np.ndarray:
    """Vectorized occupancy: clip the whole column profile against every
    K-tile at once, then segment-sum per N-tile with ``np.add.reduceat``.

    Column counts are integers, so the segment sums are exact and the
    final float expression replays the loop's association order —
    ``(mean / tile_k) * width_frac`` — making the result bit-identical
    to :func:`_occupancy_loop`.
    """
    kt, nt = _tile_counts(k_cols, k_base, tile_k, tile_n)
    if not k_cols.size:
        return np.zeros((kt, nt))
    n = len(k_cols)
    starts = np.arange(nt) * tile_n
    lo = np.arange(kt, dtype=np.int64) * tile_k
    rows = np.clip(k_cols[None, :].astype(np.int64, copy=False)
                   - lo[:, None], 0, tile_k)
    sums = np.add.reduceat(rows, starts, axis=1)          # (kt, nt) exact
    lens = np.diff(np.append(starts, n))                  # per-tile widths
    return (sums / lens / tile_k) * (lens / tile_n)


def _band_stats_loop(k_cols: np.ndarray, K: int, tile_n: int,
                     sub_rows: int) -> Tuple[int, int, float, bool]:
    """Reference: the original per-N-tile band-demand loop.

    Returns ``(bands_sum, n_tiles, row_demand, ragged)`` where
    ``bands_sum`` is the total band demand Σ ceil(k_max / sub_rows) over
    non-empty tiles, ``n_tiles`` the count of non-empty tiles,
    ``row_demand`` the Σ over tiles of the tile's mean real rows per
    column (the op's total real array-row demand — each tile's columns
    share band rows, so the per-column mean is that tile's row
    footprint), and ``ragged`` whether any tile mixes column lengths.
    """
    kc = k_cols if len(k_cols) else np.array([K])
    nt = max(1, math.ceil(len(k_cols) / tile_n))
    tile_bands: List[int] = []
    tile_rows: List[float] = []
    for j in range(nt):
        cols = kc[j * tile_n:(j + 1) * tile_n]
        k_max = int(cols.max()) if len(cols) else 0
        if k_max <= 0:
            continue
        tile_bands.append(math.ceil(k_max / sub_rows))
        tile_rows.append(float(cols.sum()) / max(len(cols), 1))
    ragged = any(
        len(set(int(c) for c in kc[j * tile_n:(j + 1) * tile_n])) > 1
        for j in range(nt))
    return (int(sum(tile_bands)), len(tile_bands),
            float(sum(r for r in tile_rows)), ragged)


def _band_stats_vectorized(k_cols: np.ndarray, K: int, tile_n: int,
                           sub_rows: int) -> Tuple[int, int, float, bool]:
    """Vectorized band accounting via segmented reduceat reductions.

    Bit-for-bit contract with :func:`_band_stats_loop`: segment sums /
    maxima are exact integer reductions; ``row_demand`` replays the
    loop's left-to-right Python float summation so no pairwise-summation
    reassociation can creep in.
    """
    kc = k_cols if len(k_cols) else np.array([K])
    nt = max(1, math.ceil(len(k_cols) / tile_n))
    n = len(kc)
    starts = np.arange(nt) * tile_n
    maxs = np.maximum.reduceat(kc, starts)
    mins = np.minimum.reduceat(kc, starts)
    sums = np.add.reduceat(kc.astype(np.int64, copy=False), starts)
    lens = np.diff(np.append(starts, n))
    sel = maxs > 0
    bands = -(-maxs[sel].astype(np.int64) // sub_rows)    # exact int ceil
    tile_rows = sums[sel] / np.maximum(lens[sel], 1)
    # left-to-right like the reference's Python sum (not np pairwise)
    row_demand = float(sum(tile_rows.tolist()))
    return (int(bands.sum()), int(sel.sum()), row_demand,
            bool(np.any(mins != maxs)))


# ---------------------------------------------------------------------------
# Content-addressed memoisation: synthesised keep-grids + tile grids.
# ---------------------------------------------------------------------------

class TileGridCache:
    """LRU cache of :class:`TileGrid` results keyed by content.

    Key: ``(K, N, bound sparsity spec, reshape, tile, sub-array dims,
    mask identity)`` — everything :func:`reshape_and_compress` reads.
    Synthesised keep-grids are themselves content-addressed (seeded by
    shape + pattern), so the sentinel ``('synth',)`` suffices for them;
    externally supplied masks key by a blake2b digest of their bytes.

    One module-level instance (:func:`default_tile_cache`) serves a whole
    process: sequential sweeps share it across jobs and each ProcessPool
    worker of :class:`repro.explore.runner.SweepRunner` warms its own
    copy once.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._d: "OrderedDict[tuple, TileGrid]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple) -> Optional[TileGrid]:
        grid = self._d.get(key)
        if grid is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return grid

    def put(self, key: tuple, grid: TileGrid) -> None:
        if self.capacity <= 0:
            return
        self._d[key] = grid
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def resize(self, capacity: int) -> None:
        """Change the entry budget in place, evicting LRU overflow —
        keeps warm entries and the stats object identity intact."""
        self.capacity = capacity
        if capacity <= 0:
            self._d.clear()
            return
        while len(self._d) > capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._d),
                "capacity": self.capacity}


_DEFAULT_TILE_CACHE = TileGridCache()
# synthesised keep-grids are tiny relative to their permutation cost;
# bounded separately so huge row-wise grids can't evict tile grids
_KEEP_GRID_CACHE: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
_KEEP_GRID_CAPACITY = 2048


def default_tile_cache() -> TileGridCache:
    """The process-wide :class:`TileGridCache` ``simulate()`` uses unless
    handed an explicit one."""
    return _DEFAULT_TILE_CACHE


def set_default_tile_cache(cache: TileGridCache) -> TileGridCache:
    """Swap the process-wide tile cache (e.g. to resize it in explore
    workers); returns the previous one."""
    global _DEFAULT_TILE_CACHE
    prev = _DEFAULT_TILE_CACHE
    _DEFAULT_TILE_CACHE = cache
    return prev


def _synth_keep_grid(seed_src: str, gm: int, gn: int,
                     n_keep: int) -> np.ndarray:
    """blake2b-seeded random keep-grid with exactly ``n_keep`` survivors,
    memoised on its full content address (the permutation dominates the
    synthesis cost for large grids)."""
    key = (seed_src, gm, gn, n_keep)
    if not _REFERENCE:
        hit = _KEEP_GRID_CACHE.get(key)
        if hit is not None:
            _KEEP_GRID_CACHE.move_to_end(key)
            return hit
    seed = int.from_bytes(
        hashlib.blake2b(seed_src.encode(), digest_size=4).digest(), "little")
    rng = np.random.default_rng(seed)
    keep = np.zeros(gm * gn, dtype=bool)
    keep[rng.permutation(gm * gn)[:n_keep]] = True
    keep = keep.reshape(gm, gn)
    keep.setflags(write=False)                 # cached: treat as immutable
    if not _REFERENCE:
        _KEEP_GRID_CACHE[key] = keep
        while len(_KEEP_GRID_CACHE) > _KEEP_GRID_CAPACITY:
            _KEEP_GRID_CACHE.popitem(last=False)
    return keep


def _block_keep_grid(op: OpNode, spec: FlexBlockSpec) -> Optional[np.ndarray]:
    """Deterministic pseudo-random block keep-grid for costing.

    The cost model needs *which* blocks survive to measure raggedness.
    When real masks are supplied (from the pruning workflow) the caller
    passes them in; otherwise we synthesise a seeded random grid with the
    exact block keep-count Φ — the paper's auto-generated randomised
    sparsity mask path (§IV-C).

    The seed is content-addressed by the matrix shape and the bound
    pattern (NOT the op name): Python's ``hash()`` is salted per process
    — which would make parallel sweep workers disagree with sequential
    runs — and same-shape ops repeat dozens of times per workload, so
    one synthesised grid (and the tile grid derived from it) serves all
    of them.
    """
    full = spec.full
    if full is None:
        return None
    shape = (op.K, op.N)
    f = full.bind(shape)
    gm, gn = f.grid(shape)
    n_keep = f.nonzero_blocks(shape)
    seed_src = f"{op.K}x{op.N}|{f.m}|{f.n}|{round(f.ratio, 6)}"
    return _synth_keep_grid(seed_src, gm, gn, n_keep)


def _mask_identity(block_keep: Optional[np.ndarray],
                   spec: FlexBlockSpec) -> Optional[tuple]:
    if block_keep is not None:
        arr = np.ascontiguousarray(block_keep)
        digest = hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest()
        return ("mask", str(arr.dtype), arr.shape, digest)
    if spec.full is not None:
        return ("synth",)      # fully determined by (K, N, bound spec)
    return None


def reshape_and_compress(
    op: OpNode,
    arch: CIMArch,
    reshape: ReshapeSpec,
    *,
    block_keep: Optional[np.ndarray] = None,
    cache: Optional[TileGridCache] = None,
) -> TileGrid:
    """① Data reshaping: compress the op's K×N weight view per its
    FlexBlock spec, align to the tile size, optionally rearrange.

    Memoised in ``cache`` (default: the process-wide
    :func:`default_tile_cache`): the returned :class:`TileGrid` may be
    shared between ops/calls — callers must not mutate it.
    """
    spec = op.sparsity.bind((op.K, op.N))
    tile_k, tile_n = reshape.tile or (arch.macro.rows, arch.macro.cols)

    key = None
    if not _REFERENCE:
        if cache is None:
            cache = _DEFAULT_TILE_CACHE
        key = _grid_key(op, arch, reshape, spec, tile_k, tile_n, block_keep)
        hit = cache.get(key)
        if hit is not None:
            return hit

    k_cols, k_base, intra_fanin, misaligned = _column_profile(
        op, arch, reshape, spec, block_keep)

    # --- tiling -------------------------------------------------------------
    n_eff = len(k_cols)
    if _REFERENCE:
        occ = _occupancy_loop(k_cols, k_base, tile_k, tile_n)
    else:
        occ = _occupancy_vectorized(k_cols, k_base, tile_k, tile_n)
    k_cols.setflags(write=False)
    occ.setflags(write=False)
    grid = TileGrid(K=op.K, N=op.N, k_eff=k_cols, n_eff=n_eff,
                    tile_k=tile_k, tile_n=tile_n, occupancy=occ,
                    intra_fanin=intra_fanin, misaligned=misaligned)
    if key is not None:
        cache.put(key, grid)
    return grid


def _grid_key(op: OpNode, arch: CIMArch, reshape: ReshapeSpec,
              spec: FlexBlockSpec, tile_k: int, tile_n: int,
              block_keep: Optional[np.ndarray]) -> tuple:
    """The :class:`TileGridCache` content key for one tiling request —
    everything :func:`reshape_and_compress` reads (the *incoming*
    reshape, before orientation resolution)."""
    return (op.K, op.N, spec, reshape, tile_k, tile_n,
            arch.macro.sub_rows, arch.macro.sub_cols,
            _mask_identity(block_keep, spec))


def _column_profile(
    op: OpNode, arch: CIMArch, reshape: ReshapeSpec, spec: FlexBlockSpec,
    block_keep: Optional[np.ndarray],
) -> Tuple[np.ndarray, int, int, bool]:
    """② The compressed column profile of one MVM op: the cheap half of
    :func:`reshape_and_compress` (no tiling reductions).

    Returns ``(k_cols, k_base, intra_fanin, misaligned)``.
    """
    intra = spec.intra
    full = spec.full

    # Resolve 'auto' compression orientation from the pattern structure:
    # IntraBlock always compresses column-wise along K ('row' profile);
    # FullBlock patterns spanning every matrix row (column/filter-wise
    # pruning) compress out whole output columns instead.
    orient = reshape.compress_orient
    if orient == "auto":
        if intra is not None or full is None:
            orient = "row"
        else:
            fb = full.bind((op.K, op.N))
            orient = "col" if fb.m >= op.K else "row"
    reshape = dataclasses.replace(reshape, compress_orient=orient)

    # --- IntraBlock: uniform column-wise compression of the K dim ---------
    intra_fanin = 1
    k_base = op.K
    if intra is not None:
        intra_fanin = intra.m
        k_base = math.ceil(op.K * intra.phi / intra.m)

    # --- FullBlock: block-grid compression (possibly ragged) --------------
    misaligned = False
    if full is not None:
        f = full.bind((op.K, op.N))
        keep = block_keep if block_keep is not None else _block_keep_grid(op, spec)
        gm, gn = keep.shape
        # row-extent removed per block-column group
        if reshape.compress_orient == "row":
            # compress along K: per block-column, count surviving block rows
            rows_per_block = f.m if intra is None else max(1, round(f.m * intra.phi / intra.m))
            k_per_bcol = keep.sum(axis=0) * rows_per_block          # (gn,)
            # expand block columns to element columns
            col_width = f.n if f.n > 0 else op.N
            # ragged: element-columns in group j have k_per_bcol[j] rows
            k_cols = np.repeat(k_per_bcol, col_width)[: op.N]
            misaligned = (f.m % arch.macro.sub_rows != 0) and (f.m != 1) \
                and (intra is None)
        else:
            # compress along N: per block-row, surviving block columns
            n_keep_cols = int(keep.sum(axis=1).max()) if keep.size else 0
            n_eff = n_keep_cols * f.n
            k_cols = np.full(max(n_eff, 1), k_base)
            misaligned = (f.n % arch.macro.sub_cols != 0) and (f.n != 1)
    else:
        k_cols = np.full(op.N, k_base)

    # --- rearrangement: equalise ragged compressed shapes ------------------
    if reshape.rearrange == "pad" and k_cols.size:
        k_cols = np.full_like(k_cols, int(k_cols.max()))
    elif reshape.rearrange == "slice" and reshape.slice_size > 0 and k_cols.size:
        # slice long columns into chunks of slice_size and restack: the
        # effective profile flattens toward the mean, at the cost of extra
        # tiles when max length exceeds the slice size.
        total = int(k_cols.sum())
        width = len(k_cols)
        mean_len = total / width
        lvl = max(reshape.slice_size, int(math.ceil(mean_len)))
        k_cols = np.full(width, lvl)

    return k_cols, k_base, intra_fanin, misaligned


def precompute_tile_grids(
    requests: List[Tuple[OpNode, CIMArch, ReshapeSpec,
                         Optional[np.ndarray]]],
    *,
    cache: Optional[TileGridCache] = None,
) -> Dict[tuple, TileGrid]:
    """Batch-tile many MVM ops in stacked segment-reduction passes.

    ``requests`` is a list of ``(op, arch, reshape, block_keep)``
    tuples — exactly the arguments each per-op
    :func:`reshape_and_compress` call would receive.  Requests are
    deduped on the tile-grid content key, cache hits are skipped, and
    the remaining cold grids are computed together: column profiles
    sharing a ``(tile_k, tile_n, kt)`` shape concatenate into ONE
    ``np.add.reduceat`` occupancy pass, and ALL new profiles share one
    stacked ``maximum/minimum/add.reduceat`` band-stats pass whose
    per-grid results seed each grid's ``band_stats`` memo.  Every
    reduction is an exact integer segment reduction and every float
    expression is elementwise, so the resulting grids are bit-identical
    to per-op calls — the batched explore plane relies on that.

    Under :func:`reference_loops` this is a no-op (the reference path
    bypasses every cache by design).  Returns ``{key: TileGrid}`` for
    every request (hits included) keyed by the content key.
    """
    if _REFERENCE:
        return {}
    if cache is None:
        cache = _DEFAULT_TILE_CACHE

    # -- dedupe + cache probe ------------------------------------------------
    out: Dict[tuple, TileGrid] = {}
    cold: "OrderedDict[tuple, tuple]" = OrderedDict()   # key -> request
    for op, arch, reshape, block_keep in requests:
        spec = op.sparsity.bind((op.K, op.N))
        tile_k, tile_n = reshape.tile or (arch.macro.rows, arch.macro.cols)
        key = _grid_key(op, arch, reshape, spec, tile_k, tile_n, block_keep)
        if key in out or key in cold:
            continue
        hit = cache.get(key)
        if hit is not None:
            out[key] = hit
        else:
            cold[key] = (op, arch, reshape, spec, tile_k, tile_n, block_keep)
    if not cold:
        return out

    # -- column profiles (cheap) ----------------------------------------------
    profiles: List[tuple] = []      # (key, request..., k_cols, k_base, ...)
    for key, (op, arch, reshape, spec, tile_k, tile_n, bk) in cold.items():
        k_cols, k_base, intra_fanin, misaligned = _column_profile(
            op, arch, reshape, spec, bk)
        profiles.append((key, op, arch, tile_k, tile_n,
                         k_cols, k_base, intra_fanin, misaligned))

    # -- stacked occupancy, grouped by (tile_k, tile_n, kt) --------------------
    groups: "OrderedDict[tuple, List[int]]" = OrderedDict()
    occs: Dict[int, np.ndarray] = {}
    for i, (key, op, arch, tile_k, tile_n,
            k_cols, k_base, *_rest) in enumerate(profiles):
        if not k_cols.size:
            # the vectorized kernel's empty-profile path; rare
            occs[i] = _occupancy_vectorized(k_cols, k_base, tile_k, tile_n)
            continue
        kt, _ = _tile_counts(k_cols, k_base, tile_k, tile_n)
        groups.setdefault((tile_k, tile_n, kt), []).append(i)
    for (tile_k, tile_n, kt), idxs in groups.items():
        cols = [profiles[i][5] for i in idxs]
        nts = [max(1, math.ceil(len(c) / tile_n)) for c in cols]
        offs = np.cumsum([0] + [len(c) for c in cols])
        kc = np.concatenate([c.astype(np.int64, copy=False) for c in cols])
        starts = np.concatenate(
            [np.arange(nt) * tile_n + off
             for nt, off in zip(nts, offs[:-1])])
        lo = np.arange(kt, dtype=np.int64) * tile_k
        rows = np.clip(kc[None, :] - lo[:, None], 0, tile_k)
        sums = np.add.reduceat(rows, starts, axis=1)       # exact int sums
        lens = np.diff(np.append(starts, len(kc)))
        occ_all = (sums / lens / tile_k) * (lens / tile_n)
        tile_offs = np.cumsum([0] + nts)
        for i, a, b in zip(idxs, tile_offs[:-1], tile_offs[1:]):
            occs[i] = occ_all[:, a:b]

    # -- stacked band stats across ALL cold grids ------------------------------
    # maxs/mins/sums are sub_rows-independent; the per-grid finish below
    # applies each request's own macro.sub_rows, replaying
    # _band_stats_vectorized's expressions elementwise (bit-identical).
    band_cols: List[np.ndarray] = []
    band_nts: List[int] = []
    for key, op, arch, tile_k, tile_n, k_cols, k_base, *_rest in profiles:
        kc = k_cols if len(k_cols) else np.array([op.K])
        band_cols.append(kc.astype(np.int64, copy=False))
        band_nts.append(max(1, math.ceil(len(k_cols) / tile_n)))
    b_offs = np.cumsum([0] + [len(c) for c in band_cols])
    b_kc = np.concatenate(band_cols)
    b_starts_per = []
    for (key, op, arch, tile_k, tile_n, k_cols, *_r), nt, off in zip(
            profiles, band_nts, b_offs[:-1]):
        b_starts_per.append(np.arange(nt) * tile_n + off)
    b_starts = np.concatenate(b_starts_per)
    maxs_all = np.maximum.reduceat(b_kc, b_starts)
    mins_all = np.minimum.reduceat(b_kc, b_starts)
    sums_all = np.add.reduceat(b_kc, b_starts)
    lens_all = np.diff(np.append(b_starts, len(b_kc)))
    t_offs = np.cumsum([0] + band_nts)

    # -- assemble, seed memos, publish ------------------------------------------
    for i, (key, op, arch, tile_k, tile_n,
            k_cols, k_base, intra_fanin, misaligned) in enumerate(profiles):
        occ = occs[i]
        k_cols.setflags(write=False)
        occ.setflags(write=False)
        grid = TileGrid(K=op.K, N=op.N, k_eff=k_cols, n_eff=len(k_cols),
                        tile_k=tile_k, tile_n=tile_n, occupancy=occ,
                        intra_fanin=intra_fanin, misaligned=misaligned)
        a, b = t_offs[i], t_offs[i + 1]
        maxs, mins = maxs_all[a:b], mins_all[a:b]
        sums, lens = sums_all[a:b], lens_all[a:b]
        sel = maxs > 0
        sub_rows = arch.macro.sub_rows
        bands = -(-maxs[sel].astype(np.int64) // sub_rows)
        tile_rows = sums[sel] / np.maximum(lens[sel], 1)
        row_demand = float(sum(tile_rows.tolist()))
        stats = (int(bands.sum()), int(sel.sum()), row_demand,
                 bool(np.any(mins != maxs)))
        grid.__dict__["_band_stats_memo"] = {sub_rows: stats}
        cache.put(key, grid)
        out[key] = grid
    return out


def spatial_mapping(arch: CIMArch, *, rearrange: Optional[str] = None,
                    slice_size: int = 0) -> MappingSpec:
    """Unroll weight tiles across the macro organisation (SP in §VII-C)."""
    return MappingSpec(
        reshape=ReshapeSpec(rearrange=rearrange, slice_size=slice_size),
        strategy="spatial",
    )


def duplicate_mapping(arch: CIMArch, *, rearrange: Optional[str] = None,
                      slice_size: int = 0) -> MappingSpec:
    """Duplicate weights across one org axis; macros split input vectors
    (DP in §VII-C)."""
    return MappingSpec(
        reshape=ReshapeSpec(rearrange=rearrange, slice_size=slice_size),
        strategy="duplicate",
    )


def default_mapping(arch: CIMArch, strategy: str = "spatial",
                    **kw) -> MappingSpec:
    if strategy == "spatial":
        return spatial_mapping(arch, **kw)
    if strategy == "duplicate":
        return duplicate_mapping(arch, **kw)
    raise ValueError(f"unknown mapping strategy {strategy!r}")
