"""FlexBlock sparsity abstraction (copy of ``repro.core.flexblock``,
paper §III): the specs that pruning and the cost model both take.

* :class:`FullBlock` — entire ``m×n`` blocks are zeroed (Def. III.2).
* :class:`IntraBlock` — within each ``m×1`` block, ``phi`` elements
  survive, arranged per a binary pattern from a pattern set (Def. III.3).
* :class:`FlexBlockSpec` — an ordered composition of at most two
  patterns: IntraBlock (fine) + FullBlock (coarse), the coarse block an
  integral multiple of the fine one (§III-D).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "FullBlock",
    "IntraBlock",
    "FlexBlockSpec",
    "dense_spec",
    "row_wise",
    "row_block",
    "column_wise",
    "channel_wise",
    "column_block",
    "hybrid",
    "TABLE_II_PATTERNS",
]


def _check_block_dims(m: int, n: int) -> None:
    if m <= 0 or n <= 0:
        raise ValueError(f"block dims must be positive, got ({m}, {n})")
    if m * n <= 1:
        raise ValueError(f"block must contain >1 element, got ({m}, {n})")


def _check_ratio(r: float) -> None:
    if not (0.0 < r < 1.0):
        raise ValueError(f"sparsity ratio must be in (0, 1), got {r}")


@dataclasses.dataclass(frozen=True)
class FullBlock:
    """FullBlock sparsity pattern (Def. III.2).

    ``m``/``n`` may be ``-1``, meaning the full extent of that matrix
    dimension (resolved by :meth:`bind`).
    """

    m: int
    n: int
    ratio: float

    def __post_init__(self):
        if self.m != -1 and self.n != -1:
            _check_block_dims(self.m, self.n)
        _check_ratio(self.ratio)

    def bind(self, shape: Tuple[int, int]) -> "FullBlock":
        """Resolve ``-1`` sentinels against a concrete matrix shape."""
        m = shape[0] if self.m == -1 else self.m
        n = shape[1] if self.n == -1 else self.n
        return FullBlock(m, n, self.ratio)

    @property
    def kind(self) -> str:
        return "full"

    def grid(self, shape: Tuple[int, int]) -> Tuple[int, int]:
        """Number of blocks along each dim (matrix padded up if ragged)."""
        b = self.bind(shape)
        return (math.ceil(shape[0] / b.m), math.ceil(shape[1] / b.n))

    def nonzero_blocks(self, shape: Tuple[int, int]) -> int:
        """Φ = ⌊(1-r)·(M/m)·(N/n)⌋ (Def. III.2)."""
        gm, gn = self.grid(shape)
        return int(math.floor((1.0 - self.ratio) * gm * gn))


@dataclasses.dataclass(frozen=True)
class IntraBlock:
    """IntraBlock sparsity pattern (Def. III.3).

    ``pattern_set`` is an optional tuple of binary masks (each of shape
    ``(m, n)`` flattened to a tuple of 0/1 ints).  When ``None`` it
    defaults to *all* patterns with exactly ``phi`` non-zeros, which makes
    per-block pattern selection equivalent to magnitude top-k.
    """

    m: int
    n: int
    ratio: float
    pattern_set: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __post_init__(self):
        _check_block_dims(self.m, self.n)
        _check_ratio(self.ratio)
        if self.n != 1:
            raise ValueError(
                "IntraBlock patterns must be column-wise one-dimensional "
                f"blocks (n == 1) for uniform compressed shapes, got n={self.n}")
        if self.phi < 1:
            raise ValueError(
                f"IntraBlock({self.m},{self.n}) at ratio {self.ratio} would "
                "keep zero elements per block")
        if self.pattern_set is not None:
            for p in self.pattern_set:
                if len(p) != self.m * self.n:
                    raise ValueError("pattern mask size must equal m*n")
                if sum(p) != self.phi:
                    raise ValueError(
                        f"pattern {p} keeps {sum(p)} elements, expected {self.phi}")

    @property
    def kind(self) -> str:
        return "intra"

    @property
    def phi(self) -> int:
        """Non-zero elements per block: φ = ⌊(1-r)·m·n⌋."""
        return int(math.floor((1.0 - self.ratio) * self.m * self.n))

    def bind(self, shape: Tuple[int, int]) -> "IntraBlock":
        return self

    def default_patterns(self) -> Tuple[Tuple[int, ...], ...]:
        """All C(m·n, φ) binary masks keeping exactly φ elements."""
        size = self.m * self.n
        return tuple(tuple(1 if i in keep else 0 for i in range(size))
                     for keep in itertools.combinations(range(size), self.phi))

    def patterns(self) -> Tuple[Tuple[int, ...], ...]:
        return self.pattern_set if self.pattern_set is not None else self.default_patterns()

    def patterns_array(self) -> np.ndarray:
        """Pattern set as a dense (P, m, n) uint8 array."""
        pats = self.patterns()
        return np.asarray(pats, dtype=np.uint8).reshape(len(pats), self.m, self.n)


@dataclasses.dataclass(frozen=True)
class FlexBlockSpec:
    """Ordered composition of at most two patterns (fine → coarse)."""

    patterns: Tuple[object, ...] = ()
    name: str = ""

    def __post_init__(self):
        if len(self.patterns) > 2:
            raise ValueError(
                "FlexBlock composition is limited to two patterns (§III-D)")
        kinds = [p.kind for p in self.patterns]
        if len(self.patterns) == 2:
            if kinds != ["intra", "full"]:
                raise ValueError(
                    "two-pattern composition must be IntraBlock (fine) + "
                    f"FullBlock (coarse), got {kinds}")
            fine, coarse = self.patterns
            if coarse.m != -1 and coarse.m % fine.m != 0:
                raise ValueError(
                    f"coarse block rows ({coarse.m}) must be an integral "
                    f"multiple of fine block rows ({fine.m})")
            if coarse.n != -1 and coarse.n % fine.n != 0:
                raise ValueError(
                    f"coarse block cols ({coarse.n}) must be an integral "
                    f"multiple of fine block cols ({fine.n})")

    @property
    def is_dense(self) -> bool:
        return not self.patterns

    @property
    def intra(self) -> Optional[IntraBlock]:
        for p in self.patterns:
            if p.kind == "intra":
                return p
        return None

    @property
    def full(self) -> Optional[FullBlock]:
        for p in self.patterns:
            if p.kind == "full":
                return p
        return None

    def bind(self, shape: Tuple[int, int]) -> "FlexBlockSpec":
        return FlexBlockSpec(tuple(p.bind(shape) for p in self.patterns), self.name)

    def validate_for(self, shape: Tuple[int, int]) -> None:
        """Check the spec is applicable to a concrete matrix shape."""
        M, N = shape
        for p in self.patterns:
            b = p.bind(shape)
            if b.m > M or b.n > N:
                raise ValueError(
                    f"block ({b.m},{b.n}) exceeds matrix shape {shape}")

    def overall_density(self, shape: Tuple[int, int]) -> float:
        """Expected fraction of surviving weights."""
        d = 1.0
        for p in self.patterns:
            b = p.bind(shape)
            if b.kind == "full":
                gm, gn = b.grid(shape)
                d *= b.nonzero_blocks(shape) / float(gm * gn)
            else:
                d *= b.phi / float(b.m * b.n)
        return d

    def describe(self) -> str:
        if self.is_dense:
            return "dense"
        parts = []
        for p in self.patterns:
            tag = "Intra" if p.kind == "intra" else "Full"
            parts.append(f"{tag}({p.m},{p.n})@{p.ratio:g}")
        return " + ".join(parts)

    # -- index storage overhead (Eq. 8) -------------------------------------
    def index_storage_bits(
        self, shape: Tuple[int, int], *, block_index_bits: Optional[int] = None,
        elem_index_bits: Optional[int] = None,
    ) -> int:
        """S_idx = N_nz_blocks × S_block + Σ_i N_nz(B_i) × S_elem  (Eq. 8).

        Block indices are stored in the finest-grained pattern; element
        indices only for IntraBlock blocks.
        """
        M, N = shape
        full, intra = self.full, self.intra
        if self.is_dense:
            return 0
        if full is not None:
            f = full.bind(shape)
            gm, gn = f.grid(shape)
            n_blocks_total = gm * gn
            n_nz_blocks = f.nonzero_blocks(shape)
            per_block_elems = f.m * f.n
        else:
            # IntraBlock only: every block is "non-zero" at the block level.
            gm, gn = math.ceil(M / intra.m), math.ceil(N / intra.n)
            n_blocks_total = gm * gn
            n_nz_blocks = n_blocks_total
            per_block_elems = intra.m * intra.n
        s_block = (
            block_index_bits
            if block_index_bits is not None
            else max(1, math.ceil(math.log2(max(2, n_blocks_total))))
        )
        bits = n_nz_blocks * s_block
        if intra is not None:
            # element index addresses a position inside the intra block
            s_elem = (
                elem_index_bits
                if elem_index_bits is not None
                else max(1, math.ceil(math.log2(max(2, intra.m * intra.n))))
            )
            if full is not None:
                n_intra_blocks = n_nz_blocks * (per_block_elems // (intra.m * intra.n))
            else:
                n_intra_blocks = n_nz_blocks
            bits += n_intra_blocks * intra.phi * s_elem
        return int(bits)


# ---------------------------------------------------------------------------
# Named constructors for the paper's Table II patterns.
# ---------------------------------------------------------------------------

def dense_spec() -> FlexBlockSpec:
    return FlexBlockSpec((), name="dense")


def row_wise(ratio: float) -> FlexBlockSpec:
    """Row-wise: FullBlock(1, N)."""
    return FlexBlockSpec((FullBlock(1, -1, ratio),), name="row-wise")


def row_block(ratio: float, width: int = 16) -> FlexBlockSpec:
    """Row-block: FullBlock(1, width) (Table II uses width=16)."""
    return FlexBlockSpec((FullBlock(1, width, ratio),), name=f"row-block{width}")


def column_wise(ratio: float) -> FlexBlockSpec:
    """Column (filter)-wise: FullBlock(M, 1)."""
    return FlexBlockSpec((FullBlock(-1, 1, ratio),), name="column-wise")


def channel_wise(ratio: float, c_in: int) -> FlexBlockSpec:
    """Channel-wise: FullBlock(C_in, 1) on a channel-innermost flattening."""
    return FlexBlockSpec((FullBlock(c_in, 1, ratio),), name="channel-wise")


def column_block(ratio: float, height: int = 16) -> FlexBlockSpec:
    """Column-block: FullBlock(height, 1) (Table II uses height=16)."""
    return FlexBlockSpec((FullBlock(height, 1, ratio),), name=f"column-block{height}")


def hybrid(
    intra_m: int,
    full_n: int,
    overall_ratio: float,
    *,
    full_m: Optional[int] = None,
) -> FlexBlockSpec:
    """Hybrid N:M + FullBlock pattern, e.g. ``1:2 + row-block`` =
    IntraBlock(2,1)@0.5 + FullBlock(2,16)@r_fb.

    The IntraBlock ratio is fixed so exactly one element per column block
    survives (φ=1, §VII-A); the FullBlock ratio is derived to hit
    ``overall_ratio``:  (1-r_overall) = (1/m)·(1-r_fb).
    """
    intra_ratio = (intra_m - 1) / intra_m  # keep exactly one of m
    intra_density = 1.0 / intra_m
    target_density = 1.0 - overall_ratio
    fb_density = target_density / intra_density
    if not (0.0 < fb_density < 1.0):
        raise ValueError(
            f"overall ratio {overall_ratio} unreachable with 1:{intra_m} intra "
            f"(intra alone gives density {intra_density})"
        )
    fb_ratio = 1.0 - fb_density
    fm = intra_m if full_m is None else full_m
    name = f"1:{intra_m}+" + ("row-wise" if full_n == -1 else f"row-block{full_n}")
    return FlexBlockSpec(
        (IntraBlock(intra_m, 1, intra_ratio), FullBlock(fm, full_n, fb_ratio)),
        name=name,
    )


def TABLE_II_PATTERNS(ratio: float, *, M: int = 0, N: int = 0, c_in: int = 16):
    """The eight patterns of Table II at a given overall sparsity ratio."""
    pats = {
        "row-wise": row_wise(ratio),
        "row-block": row_block(ratio, 16),
        "column-wise": column_wise(ratio),
        "channel-wise": channel_wise(ratio, c_in),
        "column-block": column_block(ratio, 16),
    }
    # Hybrids only exist where overall ratio exceeds the intra-only ratio.
    try:
        pats["1:2+row-block"] = hybrid(2, 16, ratio)
    except ValueError:
        pass
    try:
        pats["1:2+row-wise"] = hybrid(2, -1, ratio)
    except ValueError:
        pass
    try:
        pats["1:4+row-block"] = hybrid(4, 16, ratio)
    except ValueError:
        pass
    return pats
