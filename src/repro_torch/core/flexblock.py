"""FlexBlock sparsity specs (copy of the FullBlock part of
``repro.core.flexblock``, paper §III).

* :class:`FullBlock` — entire ``m×n`` blocks are zeroed (Def. III.2).
* :class:`FlexBlockSpec` — an ordered composition of at most two
  patterns.
* :class:`IntraBlock` — not ported yet: constructing one raises
  ``NotImplementedError``, so no spec of the port can hold it.
"""
from __future__ import annotations

import dataclasses
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


class IntraBlock:
    """IntraBlock sparsity (Def. III.3): not ported yet."""

    kind = "intra"

    def __init__(self, m: int, n: int, ratio: float, pattern_set=None):
        raise NotImplementedError(
            "IntraBlock pruning and execution are not ported to repro_torch "
            "yet; use FullBlock")


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
        if len(self.patterns) == 2 and kinds != ["intra", "full"]:
            raise ValueError(
                "two-pattern composition must be IntraBlock (fine) + "
                f"FullBlock (coarse), got {kinds}")

    @property
    def is_dense(self) -> bool:
        return not self.patterns

    @property
    def intra(self):
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
