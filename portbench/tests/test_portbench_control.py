"""The control: the reference in float8 e4m3, put in the program's place,
reads wider gaps than the program over the same prompts and tokens; on
the card, at a cell's own size (``gpu``: skips without one)."""
from __future__ import annotations

import time

import pytest
import torch
from _tiny import ROOT, tiny_cell

from portbench.control import readings


def test_control_reads_wider_than_the_program_at_a_toy_size():
    cell = tiny_cell(check_tokens=10**6, check_requests=10**6)
    out = readings(cell, 21, 1.5, True, device="cpu", t_start=time.perf_counter())
    assert out["tokens"] > 100
    assert out["control_mean_gap"] > 3 * out["mean_gap"]
    assert out["control_max_gap"] > out["max_gap"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["qwen3-4b-intrablock.longdoc",
                                  "qwen3-4b-intrablock.session-decode",
                                  "qwen3-moe-30b-a3b-fullblock.longdoc"])
def test_control_fails_the_limit_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.harness.cell import find_cell
    c = find_cell(ROOT, cell)
    out = readings(c, 2**31 + 99, 40.0, True, t_start=time.perf_counter())
    for name, limit in c.config["check"].items():
        key = name.split("_")[0] + "_gap"           # max_gap, mean_gap
        assert out[key] <= limit < out["control_" + key], name


@pytest.mark.gpu
def test_lost_cache_writes_fail_the_limit_at_the_session_size():
    """decode_step's new k/v never landing (``faults.unchanged_cache``)
    fails the widest-gap limit in the cell whose work is decode over the
    cache.  It does on most seeds, not all (one seed of five read 0.061), and a
    check refuses on any one run that is not correct: so the test asks it
    of one seed in three.  Longdoc and the single stream decode too few
    tokens after their 2k-8k-token prompts for it to show there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.harness.cell import find_cell
    c = find_cell(ROOT, "qwen3-4b-intrablock.session-decode")
    gaps = [readings(c, 2**31 + s, 40.0, False, t_start=time.perf_counter(),
                     fault="unchanged_cache")["max_gap"] for s in (131, 132, 133)]
    assert max(gaps) > c.config["check"]["max_logit_gap"], gaps
