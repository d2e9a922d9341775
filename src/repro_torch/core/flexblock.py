"""FlexBlock sparsity specs (copy of the spec classes of
``repro.core.flexblock``, paper §III).

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

__all__ = ["FullBlock", "IntraBlock", "FlexBlockSpec"]


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
