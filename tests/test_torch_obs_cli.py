"""PyTorch port, the observability and calibration CLIs:
``python -m repro_torch.obs`` (timeline, energy, report, check) and
``python -m repro_torch.calibrate`` (collect, fit, show, diff) ≡ the
reference's ``repro.obs`` / ``repro.calibrate`` CLIs, with the same
arguments, each run from a directory of its own: equal standard output and
byte-equal CSV, JSON and Chrome-trace files.  Beside them the sweep
telemetry the port's explore CLI records with ``--obs`` (heartbeats, the
``runs.jsonl`` manifest, its workers' spans), which both packages' ``obs
report`` read alike, and the port's ``collect --kernels`` on the CPU (only
when asked: with no card and no ``--device`` it fails).
"""
import importlib
import json
from pathlib import Path

import pytest

from _explore_cases import run_cli

LEDGER = Path(__file__).resolve().parent / "fixtures" / "calibration_ledger.jsonl"
PKGS = ("repro", "repro_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _both(module: str, argv, tmp_path, capsys, monkeypatch):
    """``argv`` through each package's ``module`` main: pkg → (rc, out, files)."""
    return {pkg: run_cli(_mod(pkg, module).main, argv, tmp_path / pkg, capsys, monkeypatch)
            for pkg in PKGS}


@pytest.fixture(scope="module")
def report_file(tmp_path_factory):
    """A resident-scheduled CostReport JSON of resnet18 at 80% row-block
    sparsity, written by the reference (both packages read it)."""
    from repro.core import TABLE_II_PATTERNS, default_mapping, resnet18, usecase_arch
    from repro.core.costmodel import simulate
    from repro.core.schedule import SchedulePolicy

    arch = usecase_arch(8)
    wl = resnet18(32).set_sparsity(TABLE_II_PATTERNS(0.8, c_in=16)["row-block"])
    rep = simulate(arch, wl, default_mapping(arch),
                   schedule=SchedulePolicy(policy="resident", invocations=4))
    path = tmp_path_factory.mktemp("report") / "report.json"
    path.write_text(rep.to_json())
    return path


OBS_CASES = {
    "energy": ("energy", "--model", "resnet18", "--csv", "e.csv", "--json", "e.json"),
    "energy-ratio": ("energy", "--model", "vgg16", "--ratio", "0.8", "--pattern", "row-wise",
                     "--macros", "4", "--policy", "monolithic", "--csv", "e.csv"),
    "energy-report": ("energy", "--report", "REPORT", "--csv", "e.csv", "--json", "e.json"),
    "timeline": ("timeline", "--model", "resnet18", "--policy", "partitioned", "--out", "t.json"),
    "timeline-monolithic": ("timeline", "--model", "resnet18", "--policy", "monolithic",
                            "--ratio", "0.7", "--out", "t.json"),
    "timeline-resident": ("timeline", "--model", "resnet50", "--policy", "resident",
                          "--invocations", "8", "--macros", "4"),
    "timeline-report": ("timeline", "--report", "REPORT", "--out", "t.json"),
}


@pytest.mark.parametrize("case", list(OBS_CASES))
def test_obs_cli_matches_reference(case, report_file, tmp_path, capsys, monkeypatch):
    argv = [str(report_file) if a == "REPORT" else a for a in OBS_CASES[case]]
    got = _both("obs.__main__", argv, tmp_path, capsys, monkeypatch)
    (rc_r, out_r, files_r), (rc_t, out_t, files_t) = got["repro"], got["repro_torch"]
    assert rc_r == rc_t == 0
    assert out_t == out_r and out_t
    assert files_t == files_r and files_t
    for name in files_t:
        if name.endswith("json") and case.startswith("timeline"):
            check = _both("obs.__main__", ("check", name), tmp_path, capsys, monkeypatch)
            assert check["repro_torch"][:2] == check["repro"][:2]
            assert check["repro_torch"][0] == 0 and "loadable Chrome trace" in check["repro"][1]


def test_obs_check_refuses_a_broken_trace_as_the_reference(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X", "name": "op", "ts": -1.0}]}))
    errs = {}
    for pkg in PKGS:
        assert _mod(pkg, "obs.__main__").main(["check", str(bad)]) == 1
        errs[pkg] = capsys.readouterr().err
    assert errs["repro_torch"] == errs["repro"] and "FAIL" in errs["repro"]


def test_energy_rows_sum_to_the_report(report_file):
    from repro_torch.core.report import CostReport
    from repro_torch.obs import component_rows

    rep = CostReport.from_dict(json.loads(report_file.read_text()))
    rows = component_rows(rep)
    total = sum(r["energy_pj"] for r in rows) / 1e6
    assert abs(total - rep.total_energy_uj) <= 1e-9 * rep.total_energy_uj
    assert abs(sum(r["share"] for r in rows) - 1.0) <= 1e-12


def test_port_sweep_telemetry_read_by_both_reports(tmp_path, capsys, monkeypatch):
    """``explore --obs-dir``: the port's run manifest, its heartbeats and
    its workers' spans (the fork server's workers take the parent's
    ``REPRO_OBS_DIR``), read by both packages' ``obs report``."""
    import repro_torch.obs as TO
    from repro_torch.explore.__main__ import main

    try:
        rc, out, _ = run_cli(main, ("sparsity", "--model", "resnet18", "--ratios", "0.8",
                                    "--workers", "2", "--obs-dir", "obs", "--csv", "rows.csv"),
                             tmp_path, capsys, monkeypatch)
    finally:
        TO.disable()
    assert rc == 0
    trace = tmp_path / "obs"
    runs = list(TO.core.iter_runs(trace))
    assert len(runs) == 1 and runs[0]["evaluated"] == 9 and runs[0]["workers"] == 2
    assert TO.read_manifest(trace)["cli"] == "repro_torch.explore"
    spans = TO.read_events(trace, "explore.evaluate_job")
    assert len(spans) == 9 and len({s["pid"] for s in spans}) >= 1
    assert all(s["pid"] != TO.read_manifest(trace)["pid"] for s in spans)
    beats = TO.read_events(trace, "explore.run.heartbeat")
    assert beats and beats[-1]["attrs"]["done"] == beats[-1]["attrs"]["total"] == 9
    energy = (trace / "energy_components.csv").read_text().splitlines()
    assert energy[0].startswith("pattern,ratio,workload,arch,mapping,component")
    reports = {pkg: run_cli(_mod(pkg, "obs.__main__").main, ("report", str(trace)),
                            tmp_path, capsys, monkeypatch)[:2] for pkg in PKGS}
    assert reports["repro_torch"] == reports["repro"]
    assert "sweep runs (1):" in reports["repro"][1]
    assert "last heartbeat: 9/9" in reports["repro"][1]


def test_heartbeat_and_run_manifest_equal_reference(tmp_path):
    """``heartbeat`` is the shared no-op when off; on, the port's beats,
    ``append_jsonl`` records and ``iter_runs`` read back as the reference's."""
    got = {}
    for pkg in PKGS:
        O = _mod(pkg, "obs")
        assert O.heartbeat("x", total=3) is O.core._NULL
        O.heartbeat("x", total=3).tick(1)
        with O.enabled(tmp_path / pkg) as obs:
            hb = O.heartbeat("loop", total=3, min_interval_s=3600.0)
            for done in (1, 2, 3):
                hb.tick(done, stage="s")
            obs.append_jsonl("runs.jsonl", {"requested": 3, "evaluated": 3})
            obs.append_jsonl("runs.jsonl", {"requested": 1, "evaluated": 0})
        beats = [{k: v for k, v in r["attrs"].items()
                  if k not in ("elapsed_s", "points_per_s", "eta_s")}
                 for r in O.read_events(tmp_path / pkg, "loop.heartbeat")]
        got[pkg] = (beats, list(O.core.iter_runs(tmp_path / pkg)))
        assert list(O.core.iter_runs(tmp_path / "none")) == []
    assert got["repro_torch"] == got["repro"]
    assert [b["done"] for b in got["repro"][0]] == [1, 3]     # the first and the final tick


# ---------------------------------------------------------------------------
# python -m repro_torch.calibrate
# ---------------------------------------------------------------------------

CAL_CASES = {
    "fit": ("fit", "--ledger", str(LEDGER), "--name", "fixture-fit", "--out", "p.json",
            "--profiles-dir", "profiles"),
    "fit-device-numpy": ("fit", "--ledger", str(LEDGER), "--ledger", str(LEDGER), "--device",
                         "h100-label", "--solver", "numpy", "--out", "p.json"),
    "collect-ledger": ("collect", "--ledger", str(LEDGER), "--out", "s.jsonl", "--fresh"),
    "show-default": ("show", "default"),
    "show-default-json": ("show", "default", "--json", "--check"),
    "diff-default": ("diff", "default", "default"),
}


@pytest.mark.parametrize("case", list(CAL_CASES))
def test_calibrate_cli_matches_reference(case, tmp_path, capsys, monkeypatch):
    got = _both("calibrate.__main__", CAL_CASES[case], tmp_path, capsys, monkeypatch)
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][0] == 0 and got["repro"][1]


def test_calibrate_show_diff_of_a_fit_match_reference(tmp_path, capsys, monkeypatch):
    for pkg in PKGS:
        main = _mod(pkg, "calibrate.__main__").main
        assert run_cli(main, CAL_CASES["fit"], tmp_path / pkg, capsys, monkeypatch)[0] == 0
    for argv in (("show", "p.json", "--check"), ("show", "p.json", "--json"),
                 ("diff", "p.json", "default"), ("diff", "p.json", "p.json")):
        got = _both("calibrate.__main__", argv, tmp_path, capsys, monkeypatch)
        assert got["repro_torch"][:2] == got["repro"][:2] and got["repro"][0] == 0
    assert "identical physical content" in got["repro"][1]


@pytest.mark.parametrize("argv", [("collect", "--out", "s.jsonl"),
                                  ("fit", "--ledger", "UNTIMED"),
                                  ("show", "nope.json")], ids=lambda a: a[0])
def test_calibrate_cli_fails_as_the_reference(argv, tmp_path, capsys, monkeypatch):
    untimed = tmp_path / "untimed.jsonl"
    untimed.write_text(json.dumps({"arch": "a", "flops": 1e9, "bytes_accessed": 1e6,
                                   "collective_bytes": {}}) + "\n")
    argv = [str(untimed) if a == "UNTIMED" else a for a in argv]
    got = _both("calibrate.__main__", argv, tmp_path, capsys, monkeypatch)
    assert got["repro_torch"][:2] == got["repro"][:2] and got["repro"][0] == 1


def test_collect_kernels_on_the_cpu_when_asked(tmp_path, capsys, monkeypatch):
    from repro_torch.calibrate.__main__ import main
    from repro_torch.calibrate.harvest import read_samples

    rc, out, _ = run_cli(main, ("collect", "--kernels", "--device", "cpu", "--impl", "ref",
                                "--sizes", "64", "--repeats", "1", "--out", "s.jsonl", "--fresh"),
                         tmp_path, capsys, monkeypatch)
    assert rc == 0
    assert out == "wrote 4 sample(s) to s.jsonl (attention×1, intrablock×1, matmul×2)\n"
    samples = read_samples(tmp_path / "s.jsonl")
    assert [s.op_class for s in samples] == ["attention", "matmul", "matmul", "intrablock"]
    for s in samples:
        meta = dict(s.meta)
        assert meta["impl"] == "ref" and meta["device"] == "cpu:cpu" and s.time_s > 0


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_collect_kernels_without_a_card_fails(impl, tmp_path, capsys, monkeypatch):
    """No ``--device`` means the card: with none present the CLI says so
    and exits non-zero, timing nothing on the host."""
    import torch
    from repro_torch.calibrate.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with monkeypatch.context() as m:
        m.chdir(tmp_path)
        rc = main(["collect", "--kernels", "--impl", impl, "--sizes", "64", "--repeats", "1",
                   "--out", "s.jsonl"])
    err = capsys.readouterr().err
    assert rc == 2 and "calibrate: " in err and "CUDA device" in err
    assert not (tmp_path / "s.jsonl").exists()
