"""``BENCHMARK.json`` against the rules the benchmark keeps, and every
name in it against the file the harness finds it by: a configuration's
file, a mix's file, a metric's reader, a roofline's kernel-work file."""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest

from portbench.harness.rundata import kernel_of, reader

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)
    n_runs = 2 + 14 * 24
    assert n_runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]) and e["name"] not in seen, e["name"]
            seen.add(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        if kernel_of(m["name"]):
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_and_reports_enough(w):
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (ROOT / cfg["file"]).is_file() and cfg["file"].startswith("portbench/")
    assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
    per_layer = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer
    reported = {m["name"] for m in e2e}
    for m in e2e + per_layer:
        assert callable(reader(m["name"]).read)
        if m in per_layer:
            assert m["moves"] in reported, (m["name"], w["name"])
        kernel = kernel_of(m["name"])
        if kernel:
            work = importlib.import_module(f"portbench.work.{kernel}")
            assert callable(work.work) and callable(work.describe) and work.OP


def test_configs_state_what_they_run():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert importlib.import_module(f"portbench.reference.{cfg['reference']}")
        assert cfg["check"] and set(cfg["check"]) <= {"max_logit_gap", "mean_logit_gap"}
        assert all(v > 0 for v in cfg["check"].values())
        pub, arch = cfg["published"], cfg["arch"]
        assert (arch["d_model"], arch["n_layers"], arch["n_heads"], arch["n_kv_heads"],
                arch["vocab_size"]) == (pub["hidden_size"], pub["num_hidden_layers"],
                                        pub["num_attention_heads"],
                                        pub["num_key_value_heads"], pub["vocab_size"])
