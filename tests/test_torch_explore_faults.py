"""PyTorch port, exploration plane under faults: ``repro_torch.explore``'s
fault plans, crash-safe store, journal, retries, timeouts and pool
respawns ≡ the reference's ``repro.explore``.

A sweep run under a crash, exception, hang or corrupt-write plan writes a
CSV byte for byte equal to the fault-free run's, in both packages (the
port's workers fork from a fork server, the reference's from the caller).
``--resume`` then evaluates nothing, ``--check-store`` passes on a sound
store, both packages find the same planted corruption, and the port reads
and resumes a run directory the reference wrote: their keys and store
schema are one.
"""
import importlib
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from _explore_cases import mask_stdout, run_cli

ROOT = Path(__file__).resolve().parent.parent
PKGS = ("repro", "repro_torch")
SWEEP = ("sparsity", "--model", "resnet18", "--ratios", "0.7,0.8")
ENGINE = re.compile(r"engine: .*?(\d+) evaluated")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _main(pkg: str):
    return _mod(pkg, "explore.__main__").main


def _faults(pkg: str):
    return _mod(pkg, "explore.faults")


def _evaluated(out: str) -> int:
    m = ENGINE.search(out)
    assert m, f"no engine line in:\n{out}"
    return int(m.group(1))


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    for pkg in PKGS:
        _faults(pkg).uninstall()


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """Each package's fault-free run: (CSV bytes, journaled keys)."""
    from repro.explore import KeyJournal
    out = {}
    for pkg in PKGS:
        d = tmp_path_factory.mktemp(f"clean-{pkg}")
        with pytest.MonkeyPatch.context() as m:
            m.chdir(d)
            assert _main(pkg)([*SWEEP, "--workers", "1", "--run-dir", "rd",
                               "--csv", "rows.csv"]) == 0
        out[pkg] = ((d / "rows.csv").read_bytes(), KeyJournal(d / "rd" / "journal.txt").keys())
    assert out["repro_torch"] == out["repro"]
    return out["repro"]


# ---------------------------------------------------------------------------
# The plan grammar
# ---------------------------------------------------------------------------

SPECS = ["seed=3,crash=0.2,exc=0.25,times=1", "seed=1,hang=1.0,hang_s=2,match=ab12,times=inf",
         "corrupt=0.5", "seed=9,exc=1.0,times=3,hang=0.1,hang_s=0.5"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_and_selection_equal_reference(spec, clean):
    ref, port = (_faults(pkg).parse_fault_spec(spec) for pkg in PKGS)
    assert port.spec() == ref.spec()
    assert _faults("repro_torch").parse_fault_spec(port.spec()) == port
    keys = sorted(clean[1])
    assert _faults("repro_torch").FAULT_KINDS == _faults("repro").FAULT_KINDS
    for kind in _faults("repro_torch").FAULT_KINDS:
        for attempt in (0, 1, 5):
            assert [port.should(kind, k, attempt) for k in keys] == \
                   [ref.should(kind, k, attempt) for k in keys]
    payload = b"x" * 300
    assert _faults("repro_torch").corrupt_payload(keys[0], payload) == payload   # none installed


@pytest.mark.parametrize("bad", ["crash", "crash=2", "nope=1", "seed=x", "times=-1"])
def test_malformed_fault_specs_refused_as_the_reference(bad):
    for pkg in PKGS:
        with pytest.raises(ValueError):
            _faults(pkg).parse_fault_spec(bad)


# ---------------------------------------------------------------------------
# Sweeps under faults
# ---------------------------------------------------------------------------

def _seed_selecting(pkg, kind, keys, rate, want):
    """A seed whose plan selects between 1 and ``want`` of ``keys``."""
    for seed in range(500):
        n = sum(_faults(pkg).FaultPlan(**{"seed": seed, kind: rate}).selected(kind, k)
                for k in keys)
        if 1 <= n <= want:
            return seed
    raise AssertionError(f"no seed selects 1..{want} keys for {kind}")


def _plan(kind: str, keys) -> tuple:
    """(plan spec, extra CLI flags) of one fault kind."""
    if kind == "crash-exc":          # the recipe of the verify notes
        return "seed=3,crash=0.2,exc=0.25,times=1", ("--timeout", "60")
    if kind == "crash":
        return f"seed={_seed_selecting('repro', 'crash', keys, 0.3, 3)},crash=0.3,times=1", ()
    if kind == "exc":
        return f"seed={_seed_selecting('repro', 'exc', keys, 0.3, 4)},exc=0.3,times=1", ()
    # hang: a hung dispatch is cut at the 1 s timeout, its worker killed
    # and the pool respawned; the retry does not hang
    seed = _seed_selecting("repro", "hang", keys, 0.15, 2)
    return f"seed={seed},hang=0.15,hang_s=2,times=1", ("--timeout", "1")


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("kind", ["crash-exc", "crash", "exc", "hang"])
def test_faulted_sweep_csv_equals_fault_free(kind, pkg, clean, tmp_path, capsys, monkeypatch):
    rows0, keys = clean
    spec, extra = _plan(kind, keys)
    _faults(pkg).install(spec)
    argv = (*SWEEP, "--workers", "2", "--run-dir", "rd", "--backoff", "0.01", *extra,
            "--csv", "rows.csv")
    rc, out, files = run_cli(_main(pkg), argv, tmp_path, capsys, monkeypatch)
    _faults(pkg).uninstall()
    assert rc == 0
    assert files["rows.csv"] == rows0
    retried = int(re.search(r"(\d+) retried", out).group(1))
    assert retried >= 1 and " 0 failed" in out
    if kind == "hang":
        assert int(re.search(r"(\d+) timed out", out).group(1)) >= 1
    assert _evaluated(run_cli(_main(pkg), ("--resume", "rd"), tmp_path, capsys,
                              monkeypatch)[1]) == 0
    rc, out, _ = run_cli(_main(pkg), ("--check-store", "rd"), tmp_path, capsys, monkeypatch)
    assert rc == 0 and "store check: ok" in out


def test_corrupt_writes_found_and_healed_as_the_reference(clean, tmp_path, capsys, monkeypatch):
    """A ``corrupt`` plan garbles store writes: the sweep's rows are
    unharmed, the audit finds the same damage in both packages, and a
    resume re-evaluates exactly the damaged points."""
    rows0, keys = clean
    seed = _seed_selecting("repro", "corrupt", keys, 0.3, 5)
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        _faults(pkg).install(f"seed={seed},corrupt=0.3,times=1")
        rc, _, files = run_cli(_main(pkg), (*SWEEP, "--workers", "1", "--run-dir", "rd",
                                            "--csv", "rows.csv"), d, capsys, monkeypatch)
        _faults(pkg).uninstall()
        assert rc == 0 and files["rows.csv"] == rows0
        rc, audit, _ = run_cli(_main(pkg), ("--check-store", "rd"), d, capsys, monkeypatch)
        assert rc == 1
        _, resumed, files = run_cli(_main(pkg), ("--resume", "rd"), d, capsys, monkeypatch)
        rc, healed, _ = run_cli(_main(pkg), ("--check-store", "rd"), d, capsys, monkeypatch)
        assert rc == 0 and files["rows.csv"] == rows0
        got[pkg] = (audit, _evaluated(resumed), healed)
    assert got["repro_torch"] == got["repro"]
    assert 1 <= got["repro"][1] <= 5 and f"{got['repro'][1]} corrupt" in got["repro"][0]


def _garble(store, key):
    con = store._connect()
    with con:
        con.execute("INSERT OR REPLACE INTO results VALUES (?, ?)", (key, b"\x00torn"))


def test_planted_corruption_found_as_the_reference(tmp_path, capsys, monkeypatch):
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        assert run_cli(_main(pkg), (*SWEEP, "--workers", "1", "--run-dir", "rd"), d, capsys,
                       monkeypatch)[0] == 0
        store = _mod(pkg, "explore.cache").ResultStore(d / "rd")
        assert store.backend == "sqlite"
        _garble(store, sorted(store.keys())[0])
        store.close()
        rc, audit, _ = run_cli(_main(pkg), ("--check-store", "rd"), d, capsys, monkeypatch)
        assert rc == 1 and "1 corrupt" in audit
        _, resumed, _ = run_cli(_main(pkg), ("--resume", "rd"), d, capsys, monkeypatch)
        rc, healed, _ = run_cli(_main(pkg), ("--check-store", "rd"), d, capsys, monkeypatch)
        assert rc == 0
        got[pkg] = (audit, _evaluated(resumed), healed)
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][1] == 1


def test_port_resumes_a_run_directory_the_reference_wrote(clean, tmp_path, capsys, monkeypatch):
    """Equal keys, equal store schema: the port audits the reference's
    store and replays its run, evaluating nothing."""
    rc, _, files = run_cli(_main("repro"), (*SWEEP, "--workers", "1", "--run-dir", "rd",
                                            "--csv", "rows.csv"), tmp_path, capsys, monkeypatch)
    assert rc == 0
    rc, audit, _ = run_cli(_main("repro_torch"), ("--check-store", "rd"), tmp_path, capsys,
                           monkeypatch)
    assert rc == 0 and "store check: ok" in audit
    rc, out, files2 = run_cli(_main("repro_torch"), ("--resume", "rd"), tmp_path, capsys,
                              monkeypatch)
    assert rc == 0 and _evaluated(out) == 0
    assert files2["rows.csv"] == files["rows.csv"] == clean[0]


def test_poison_job_strict_and_degrade_as_the_reference(clean, tmp_path, capsys, monkeypatch):
    rows0, keys = clean
    victim = sorted(keys)[0]
    got = {}
    for pkg in PKGS:
        out = {}
        for mode in ("strict", "degrade"):
            _faults(pkg).install(_faults(pkg).FaultPlan(crash=1.0, times=float("inf"),
                                                        match=victim[:16]))
            argv = (*SWEEP, "--workers", "2", "--backoff", "0.01", "--run-dir", f"rd-{mode}",
                    "--csv", f"{mode}.csv", *(("--degrade",) if mode == "degrade" else ()))
            rc, stdout, files = run_cli(_main(pkg), argv, tmp_path / pkg, capsys, monkeypatch)
            _faults(pkg).uninstall()
            out[mode] = (rc, files.get(f"{mode}.csv"), mask_stdout(stdout).split("engine: ")[0])
        got[pkg] = out
    assert got["repro_torch"] == got["repro"]
    strict, degrade = got["repro"]["strict"], got["repro"]["degrade"]
    assert strict[0] == 3 and strict[1] is None
    assert degrade[0] == 0 and b"True" in degrade[1] and degrade[1] != rows0


def test_sigkilled_port_sweep_resumes_only_the_missing(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.explore`` killed mid-sweep (its fork server
    and workers with it): the store holds every journaled key, and a
    resume evaluates only the points the kill left."""
    from repro_torch.explore import KeyJournal, ResultStore

    run_dir = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_FAULTS="seed=1,hang=1.0,hang_s=0.3,times=1000000")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.explore", *SWEEP, "--workers",
                             "2", "--run-dir", str(run_dir)], env=env, cwd=tmp_path,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                            start_new_session=True)
    journal = KeyJournal(run_dir / "journal.txt")
    deadline = time.monotonic() + 60
    try:
        while len(journal.keys()) < 3:
            assert proc.poll() is None, "the sweep finished before the kill"
            assert time.monotonic() < deadline, "no progress before the kill"
            time.sleep(0.05)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    store = ResultStore(run_dir)
    journaled = journal.keys()
    assert store.self_check().ok and journaled <= store.keys()
    store.close()
    rc, out, _ = run_cli(_main("repro_torch"), ("--resume", str(run_dir)), tmp_path, capsys,
                         monkeypatch)
    total = len(KeyJournal(run_dir / "journal.txt").keys())
    assert rc == 0 and total > len(journaled)
    assert _evaluated(out) == total - len(journaled)
