"""Post-processing for sweep rows: Pareto frontiers and top-k tables.

Copy of ``repro.explore.pareto``: the port never imports the JAX package.

Rows are the plain dicts the engine emits (CSV-ready).  The frontier is
computed over any subset of numeric columns; by default the three axes
the paper's exploration use-cases trade off — latency, energy, and index
storage (§VII-B/C).

Two surfaces share the dominance semantics:

* :func:`pareto_front` / :func:`top_k` — one-shot over a materialised
  row list (small sweeps, tests, CLI output).
* :class:`ParetoFront` / :class:`StreamingTopK` — incremental
  maintenance for million-point runs that never hold all rows in
  memory.  Feeding the same rows in the same order produces exactly the
  one-shot results.

NaN semantics: a row with a NaN objective value is **excluded** from the
frontier — NaN compares false against everything, so it can neither
dominate nor be dominated, and keeping such rows would grow the front
with points that carry no trade-off information.  ``inf`` participates
normally (it is simply the worst value on its axis).  Rows missing an
objective column (or carrying ``None``) are likewise excluded.
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["pareto_front", "top_k", "ParetoFront", "StreamingTopK",
           "DEFAULT_OBJECTIVES"]

# (column, direction): direction 'min' or 'max'
DEFAULT_OBJECTIVES: Tuple[Tuple[str, str], ...] = (
    ("latency_ms", "min"),
    ("energy_uj", "min"),
    ("index_kib", "min"),
)


def _vector(row: Dict, objectives: Sequence[Tuple[str, str]]
            ) -> Optional[List[float]]:
    """Objective vector in canonical minimisation form, or ``None`` if
    the row is unusable (missing/None/NaN objective)."""
    v = []
    for col, direction in objectives:
        x = row.get(col)
        if x is None:
            return None
        x = float(x)
        if math.isnan(x):
            return None
        v.append(x if direction == "min" else -x)
    return v


def _dominates(a: List[float], b: List[float]) -> bool:
    """True iff ``a`` is no worse than ``b`` everywhere and better somewhere."""
    return all(x <= y for x, y in zip(a, b)) and any(x < y for x, y in zip(a, b))


def pareto_front(
    rows: Sequence[Dict],
    objectives: Sequence[Tuple[str, str]] = DEFAULT_OBJECTIVES,
) -> List[Dict]:
    """Non-dominated subset of ``rows``, preserving input order.

    Rows missing an objective column — or carrying ``None``/NaN there —
    are excluded from the frontier (e.g. derived "finding" rows mixed
    into benchmark output, failed degraded-mode points).  Duplicate
    objective vectors all survive (none strictly dominates the other).
    """
    scored = []
    for i, r in enumerate(rows):
        v = _vector(r, objectives)
        if v is not None:
            scored.append((i, v))
    front = []
    for i, vi in scored:
        if not any(_dominates(vj, vi) for j, vj in scored if j != i):
            front.append(rows[i])
    return front


def top_k(
    rows: Sequence[Dict],
    metric: str,
    k: int = 5,
    *,
    direction: str = "min",
) -> List[Dict]:
    """The ``k`` best rows by one metric ('min' = lower is better).

    Rows whose metric is missing, ``None``, or NaN are excluded — NaN
    would otherwise land at a sort-implementation-defined position.
    """
    usable = [r for r in rows if metric in r and r[metric] is not None
              and not math.isnan(float(r[metric]))]
    return sorted(usable, key=lambda r: float(r[metric]),
                  reverse=(direction == "max"))[:k]


class ParetoFront:
    """Incremental Pareto front: O(front) per added row, O(front) memory.

    Feeding every row of a sweep (in any order) leaves exactly the rows
    :func:`pareto_front` would return; in *input* order the survivors
    come out in input order too, so the equivalence is list-equality.
    Correctness is dominance transitivity: a row evicted by ``r`` stays
    dominated by whatever later evicts ``r``, so discarding dominated
    rows immediately never loses a final survivor.
    """

    def __init__(self, objectives: Sequence[Tuple[str, str]]
                 = DEFAULT_OBJECTIVES):
        self.objectives = tuple(objectives)
        self._rows: List[Dict] = []
        self._vecs: List[List[float]] = []
        self.seen = 0            # usable rows offered (excl. NaN/missing)
        self.skipped = 0         # rows excluded as unusable

    def add(self, row: Dict) -> bool:
        """Offer one row; returns True if it (currently) survives."""
        v = _vector(row, self.objectives)
        if v is None:
            self.skipped += 1
            return False
        self.seen += 1
        for u in self._vecs:
            if _dominates(u, v):
                return False
        keep_r, keep_v = [], []
        for r, u in zip(self._rows, self._vecs):
            if not _dominates(v, u):
                keep_r.append(r)
                keep_v.append(u)
        keep_r.append(row)
        keep_v.append(v)
        self._rows, self._vecs = keep_r, keep_v
        return True

    def extend(self, rows: Sequence[Dict]) -> None:
        for row in rows:
            self.add(row)

    def front(self) -> List[Dict]:
        """The current non-dominated set, in arrival order."""
        return list(self._rows)

    def __len__(self) -> int:
        return len(self._rows)


class StreamingTopK:
    """Incremental top-k by one metric: a bounded heap over the stream.

    Matches :func:`top_k` exactly — including its stable-sort tie
    order — by keying entries ``(value, arrival_index)``: among equal
    values the earliest row wins, which is precisely what a stable sort
    over the stream produces.
    """

    def __init__(self, metric: str, k: int = 5, *, direction: str = "min"):
        if direction not in ("min", "max"):
            raise ValueError(f"direction {direction!r} is not 'min'/'max'")
        self.metric = metric
        self.k = max(0, int(k))
        self.direction = direction
        # heap of (sort_key, row) where sort_key orders WORST-first so
        # heappushpop evicts the worst; idx breaks value ties without
        # ever comparing row dicts
        self._heap: List[Tuple[Tuple[float, float], int, Dict]] = []
        self._idx = 0

    def add(self, row: Dict) -> None:
        x = row.get(self.metric)
        if x is None:
            return
        val = float(x)
        if math.isnan(val):
            return
        i = self._idx
        self._idx += 1
        if self.direction == "min":
            entry = ((-val, -i), i, row)     # root = largest val/latest
        else:
            entry = ((val, -i), i, row)      # root = smallest val/latest
        if self.k == 0:
            return
        if len(self._heap) < self.k:
            heapq.heappush(self._heap, entry)
        else:
            heapq.heappushpop(self._heap, entry)

    def extend(self, rows: Sequence[Dict]) -> None:
        for row in rows:
            self.add(row)

    def best(self) -> List[Dict]:
        """The current top-k rows, best first (= :func:`top_k` order).

        Value ties break on arrival index ascending in BOTH directions —
        ``top_k``'s stable sort keeps arrival order among equals whether
        or not it reverses."""
        sign = -1.0 if self.direction == "max" else 1.0
        return [row for _key, i, row in
                sorted(self._heap,
                       key=lambda e: (sign * float(e[2][self.metric]),
                                      e[1]))]

    def __len__(self) -> int:
        return len(self._heap)
