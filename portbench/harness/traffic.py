"""The one traffic generator: a closed loop's request stream from a mix
file's parameters and a seed.

A mix file (``portbench/traffic/<name>.json``) gives the number of
clients (each sends its next request as soon as its last one is done),
the engine's ``slots`` and ``max_len``, and the distributions of prompt
and output lengths.  The lengths form a fixed pool of ``pool`` (prompt,
output) pairs, taken at evenly spaced quantiles of each distribution and
paired by a fixed shuffle; the stream is the pool again and again, each
pass in a fixed order, and the clients take its requests in turn as they
free.  So every seed serves the same sizes in the same order (with the
order drawn per seed, which long prompts came together in a window moved
the TTFT tail between seeds far more than between two runs of one seed);
the seed draws every prompt's token ids, as it draws the weights.

A loop that starts with every client's first request at once would
finish those requests together; so that completions come staggered from
the start, as in a loop that has run for a while, the first wave (one
request a client) asks for (c + 1) / clients of its drawn output length,
c being the request's place in the wave.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import Iterator, List, Tuple

import numpy as np

__all__ = ["Mix", "RequestSpec", "load_mix", "length_pool", "stream"]


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    clients: int
    slots: int
    max_len: int
    prompt_len: dict
    output_len: dict
    pool: int
    warmup_completions: int
    check_tokens: int
    check_requests: int
    order_seed: int = 1


@dataclasses.dataclass
class RequestSpec:
    index: int
    prompt: np.ndarray          # (S,) int32 token ids
    new_tokens: int


def load_mix(path: Path) -> Mix:
    raw = json.loads(Path(path).read_text())
    return Mix(name=Path(path).stem, clients=int(raw["clients"]), slots=int(raw["slots"]),
               max_len=int(raw["max_len"]), prompt_len=raw["prompt_len"],
               output_len=raw["output_len"], pool=int(raw["pool"]),
               warmup_completions=int(raw["warmup_completions"]),
               check_tokens=int(raw["check"]["tokens"]),
               check_requests=int(raw["check"]["max_requests"]),
               order_seed=int(raw.get("order_seed", 1)))


def _quantiles(dist: dict, n: int) -> List[int]:
    """``n`` lengths at the quantiles (i + 1/2) / n of ``dist``, clipped to
    its [min, max] and rounded: ``lognormal`` (median, sigma) or
    ``uniform`` (integers from min to max)."""
    lo, hi = int(dist["min"]), int(dist["max"])
    qs = [(i + 0.5) / n for i in range(n)]
    if dist["dist"] == "lognormal":
        z = NormalDist()
        vals = [math.exp(math.log(dist["median"]) + dist["sigma"] * z.inv_cdf(q)) for q in qs]
    elif dist["dist"] == "uniform":
        vals = [lo + q * (hi - lo + 1) - 0.5 for q in qs]
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return [min(hi, max(lo, int(round(v)))) for v in vals]


def length_pool(mix: Mix) -> List[Tuple[int, int]]:
    """The fixed (prompt, output) length pairs of every seed."""
    prompts = _quantiles(mix.prompt_len, mix.pool)
    outputs = _quantiles(mix.output_len, mix.pool)
    pairing = np.random.default_rng(0).permutation(mix.pool)
    return [(prompts[i], outputs[int(j)]) for i, j in enumerate(pairing)]


def stream(mix: Mix, seed: int, vocab: int) -> Iterator[RequestSpec]:
    """The requests in the order the clients take them, the first wave's
    outputs staggered: sizes and order fixed, token ids from ``seed``."""
    pool = length_pool(mix)
    order = np.random.default_rng(mix.order_seed)
    rng = np.random.default_rng([int(seed) % 2**64, 0x7261])
    index = 0
    while True:
        for i in order.permutation(len(pool)):
            s, n = pool[int(i)]
            ids = rng.integers(0, vocab, size=s, dtype=np.int64).astype(np.int32)
            if index < mix.clients:
                n = max(1, math.ceil(n * (index + 1) / mix.clients))
            yield RequestSpec(index, ids, n)
            index += 1
