"""The harness against the plain reference at a toy size, on the CPU:
a whole run (set-up, the closed loop, the metrics, the check) comes out
correct, and comes out not correct under each fault a served cell can
have, planted in the program underneath the timed path."""
from __future__ import annotations

import time

import pytest
import torch
from _tiny import tiny_cell

from portbench.harness import faults
from portbench.harness.cell import run_cell

CELLS = ["qwen3-4b-intrablock.longdoc", "qwen3-4b-intrablock.session-decode",
         "qwen3-moe-30b-a3b-fullblock.longdoc"]


def _run(cell, seed, trace=False, seconds=1.5):
    return run_cell(cell, seed, seconds, trace, t_start=time.perf_counter(), device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct_against_the_reference(name):
    cell = tiny_cell(name)
    res = _run(cell, 2**31 + 11)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    for m in res["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("name", [CELLS[0], CELLS[2]])
def test_traced_run_reports_span_metrics_and_stays_correct(name):
    res = _run(tiny_cell(name), 5, trace=True, seconds=2.5)
    assert res["correct"], res["check"]
    got = {n.split(".")[0] for n in res["metrics"]}
    assert {"prune_s", "prefill_ms_per_ktok", "decode_step_ms", "decode_issue_share"} <= got
    assert "breakdown" in res and res["device"]["window_s"] > 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_fault_is_not_correct(fault, name):
    cell = tiny_cell(name, check_tokens=10**6, check_requests=10**6)
    if fault == "half_batch" and cell.mix.slots == 1:
        pytest.skip("a one-slot cell has no half batch to leave out")
    # the cell's own toy mix; every request the window finished is compared
    undo = faults.plant(fault)
    try:
        res = _run(cell, 7)
    finally:
        undo()
    assert not res["correct"], res["check"]
    assert any(res["check"][n]["value"] > res["check"][n]["limit"]
               for n in ("max_logit_gap", "mean_logit_gap") if n in res["check"])


def test_run_py_refuses_without_a_card(tmp_path):
    import subprocess
    import sys
    from _tiny import ROOT
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                        "qwen3-4b-intrablock.longdoc", "--seed", "3", "--seconds", "1"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
