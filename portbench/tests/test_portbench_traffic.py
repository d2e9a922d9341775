"""The traffic generator: every seed serves the same sizes in its own
order, ids from the seed, the first wave staggered."""
from __future__ import annotations

import collections
import itertools
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import traffic

MIXES = sorted((Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_sizes_and_order_are_the_same_for_every_seed(path):
    mix = traffic.load_mix(path)
    pool = traffic.length_pool(mix)
    assert len(pool) == mix.pool
    for s, n in pool:
        assert mix.prompt_len["min"] <= s <= mix.prompt_len["max"]
        assert mix.output_len["min"] <= n <= mix.output_len["max"]
        assert s + n < mix.max_len
    seqs, ids = [], []
    for seed in (1, 2**31 + 7):
        reqs = list(itertools.islice(traffic.stream(mix, seed, 1000), 3 * mix.pool))
        # past the first wave, each pass over the pool serves it whole
        later = reqs[mix.pool:2 * mix.pool] if mix.clients <= mix.pool else []
        if later:
            got = collections.Counter((len(r.prompt), r.new_tokens) for r in later)
            assert got == collections.Counter(pool)
        seqs.append([(len(r.prompt), r.new_tokens) for r in reqs])
        ids.append(reqs[0].prompt)
        assert all(0 <= r.prompt.min() and r.prompt.max() < 1000 for r in reqs)
    assert seqs[0] == seqs[1] and not np.array_equal(ids[0], ids[1])
    # a pass's order is not the pool's own
    assert seqs[0][mix.pool:2 * mix.pool] != pool


def test_first_wave_is_staggered_and_seeds_repeat():
    mix = traffic.load_mix(MIXES[0])
    a = list(itertools.islice(traffic.stream(mix, 5, 100), mix.clients + 2))
    b = list(itertools.islice(traffic.stream(mix, 5, 100), mix.clients + 2))
    assert all(np.array_equal(x.prompt, y.prompt) and x.new_tokens == y.new_tokens
               for x, y in zip(a, b))
    for i, r in enumerate(a[:mix.clients]):
        assert 1 <= r.new_tokens <= mix.output_len["max"] * (i + 1) / mix.clients + 1


def test_quantiles_of_the_distributions():
    lo = traffic._quantiles({"dist": "lognormal", "median": 4096, "sigma": 0.5, "min": 2048,
                             "max": 8192}, 64)
    assert lo == sorted(lo) and lo[0] == 2048 and lo[-1] == 8192
    assert abs(np.median(lo) - 4096) < 150
    un = traffic._quantiles({"dist": "uniform", "min": 8, "max": 32}, 25)
    assert un == list(range(8, 33))


def test_a_mix_names_the_order_of_its_sizes():
    mix = traffic.load_mix(MIXES[0])
    assert mix.order_seed == 1
    other = traffic.Mix(**{**mix.__dict__, "order_seed": 2})
    a = [r.prompt.size for r in itertools.islice(traffic.stream(mix, 5, 1000), 2 * mix.pool)]
    b = [r.prompt.size for r in itertools.islice(traffic.stream(other, 5, 1000), 2 * mix.pool)]
    assert a != b and sorted(a[mix.pool:]) == sorted(b[mix.pool:])
