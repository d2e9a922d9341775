"""PyTorch port, exploration plane: ``repro_torch.explore`` (sweeps,
search, Pareto, batched runner, cache, CLI) and ``repro_torch.core``'s
sweep wrappers ≡ the reference's ``repro.explore`` / ``repro.core``.

Each CLI case runs ``python -m repro.explore`` and
``python -m repro_torch.explore``'s ``main`` with the same arguments, each
from a directory of its own: the CSV and JSON they write are byte for byte
equal (the JSON's ``wall_s``/``workers`` masked), and so is their standard
output once the ``engine:`` line's wall time and worker count are masked.
Content keys, ``CACHE_SCHEMA`` and the default profile's hash are equal,
so the two packages share result stores.  The traced path: the port's
capture of qwen3-4b, lowered by the reference's own ``repro.trace``, swept
by the reference's ``sparsity_sweep``, gives the rows the port's
``explore lm --workload traced:qwen3-4b`` gives.
"""
import copy
import importlib
import json
from pathlib import Path

import numpy as np
import pytest

from _explore_cases import mask_json, mask_stdout, run_cli

ROOT = Path(__file__).resolve().parent.parent


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(scope="module")
def mains():
    return {pkg: _mod(pkg, "explore.__main__").main for pkg in ("repro", "repro_torch")}


OUT = ("--csv", "rows.csv", "--json", "rows.json")
LM = ("lm", "--config", "qwen3-4b", "--seq-len", "16", "--ratios", "0.8", "--workers", "1")
SCALE = ("scale", "--points", "2000", "--workers", "1")

# the lm cases follow one another: each package's process-wide tile-grid
# memo, warmed by the first, serves the rest
CLI_CASES = {
    "sparsity": ("sparsity", "--model", "resnet18", "--ratios", "0.7,0.8", "--workers", "2",
                 "--pareto", "--top-k", "3", *OUT),
    "sparsity-schedule-all": ("sparsity", "--model", "resnet18", "--ratios", "0.8",
                              "--workers", "1", "--schedule", "all", "--invocations", "4",
                              "--pareto", *OUT),
    "sparsity-profile-default": ("sparsity", "--model", "resnet18", "--ratios", "0.8",
                                 "--workers", "1", "--profile", "default", "--diff-analytic",
                                 *OUT),
    "sparsity-batch": ("sparsity", "--model", "resnet18", "--ratios", "0.7,0.8", "--workers", "2",
                       "--batch", "--schedule", "monolithic,partitioned", *OUT),
    "mapping": ("mapping", "--model", "vgg16", "--rearrange", "none,slice", "--workers", "1",
                "--pareto", "--top-k", "2", *OUT),
    "lm": (*LM, "--top-k", "3", "--pareto", *OUT),
    "lm-profile-schedule": (*LM, "--profile", "default", "--diff-analytic", "--schedule",
                            "monolithic,resident", "--invocations", "16", "--top-k", "3", *OUT),
    "lm-schedule-all": (*LM, "--schedule", "all", *OUT),
    "scale": (*SCALE, *OUT),
    "scale-batch": (*SCALE, "--batch", *OUT),
    "scale-batch-workers": ("scale", "--points", "2000", "--workers", "2", "--batch", "64",
                            "--chunk", "500", *OUT),
    "scale-exhaustive-budget": (*SCALE, "--search", "exhaustive", "--budget", "200", "--seed", "0",
                                *OUT),
    "scale-halving": (*SCALE, "--search", "halving", "--budget", "200", "--seed", "0", *OUT),
    # evolve writes no CSV, and the reference's raises on --json: below
    "scale-evolve": (*SCALE, "--search", "evolve", "--budget", "200", "--seed", "0", "--top-k", "8"),
    "scale-evolve-seed": (*SCALE, "--search", "evolve", "--budget", "200", "--seed", "7",
                          "--batch"),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_matches_reference(case, mains, tmp_path, capsys, monkeypatch):
    got = {pkg: run_cli(mains[pkg], CLI_CASES[case], tmp_path / pkg, capsys, monkeypatch)
           for pkg in mains}
    (rc_r, out_r, files_r), (rc_t, out_t, files_t) = got["repro"], got["repro_torch"]
    assert rc_r == rc_t == 0
    assert "engine: " in out_t
    assert mask_stdout(out_t) == mask_stdout(out_r)
    assert files_t.keys() == files_r.keys()
    if "--csv" in CLI_CASES[case]:
        assert files_t["rows.csv"] == files_r["rows.csv"]
        assert files_t["rows.csv"].count(b"\n") > 1
        assert mask_json(files_t["rows.json"].decode()) == mask_json(files_r["rows.json"].decode())


def test_evolve_json_holds_the_reference_search(mains, tmp_path, capsys, monkeypatch):
    """The reference's ``scale --search evolve --json`` raises on a numpy
    integer in its rows; the port writes the JSON, whose front and top-k
    are the reference's search of the same space, seed and budget."""
    from repro.core import usecase_arch
    from repro.explore import SearchPolicy, SweepRunner, run_search
    from repro.explore.__main__ import _scale_space

    argv = (*SCALE, "--search", "evolve", "--budget", "200", "--seed", "0", "--json", "s.json")
    with pytest.raises(TypeError, match="int64"):
        run_cli(mains["repro"], argv, tmp_path / "repro", capsys, monkeypatch)
    rc, _, files = run_cli(mains["repro_torch"], argv, tmp_path / "port", capsys, monkeypatch)
    assert rc == 0
    got = json.loads(files["s.json"])
    want = run_search(_scale_space(2000, usecase_arch(4)),
                      SearchPolicy(kind="evolve", budget=200, seed=0),
                      runner=SweepRunner(workers=1))
    assert got["points"] == want.points == 200
    assert got["front"] == json.loads(json.dumps(want.front_rows, default=int))
    assert got["topk"] == json.loads(json.dumps(want.topk_rows, default=int))


@pytest.mark.parametrize("argv", [("sparsity", "--ratios", "1.5"), ("scale", "--profile", "default"),
                                  ("sparsity", "--search", "halving"), ("mapping", "--orgs", "4by4"),
                                  ("lm", "--workload", "traced"), ("sparsity", "--diff-analytic"),
                                  ("sparsity", "--schedule", "nope"), ()],
                         ids=lambda a: " ".join(a) or "no-sweep")
def test_cli_refuses_what_the_reference_refuses(argv, mains, capsys):
    codes = {}
    for pkg, main in mains.items():
        with pytest.raises(SystemExit) as e:
            main(list(argv))
        codes[pkg] = e.value.code
        err = capsys.readouterr().err
        assert "error:" in err and f"python -m {pkg}.explore" in err
    assert codes["repro_torch"] == codes["repro"] == 2


# ---------------------------------------------------------------------------
# Keys, schemas and the default profile
# ---------------------------------------------------------------------------

def _jobs(pkg: str, traced_graph: dict) -> dict:
    """The same jobs, built from one package's own classes."""
    core = _mod(pkg, "core")
    job_mod = _mod(pkg, "explore.job")
    profile = _mod(pkg, "calibrate.profile").default_profile()
    Job = job_mod.ExploreJob
    arch = core.usecase_arch(4)
    mapping = core.default_mapping(arch)
    wl = core.resnet18(32).set_sparsity(core.TABLE_II_PATTERNS(0.8, c_in=16)["row-block"])
    first = next(iter(wl.nodes))
    jobs = {
        "analytic": Job.simulate(arch, wl, mapping),
        "calibrated": Job.simulate(arch, wl, mapping, profile=profile),
        "dense": Job.dense(arch, wl, mapping),
        "dense-calibrated": Job.dense(arch, wl, mapping, profile=profile),
        "default-schedule": Job.simulate(arch, wl, mapping, schedule=core.SchedulePolicy()),
        "input-sparsity": Job.simulate(arch, wl, mapping, input_sparsity={first: 0.25}),
        "masks": Job.simulate(arch, wl, mapping,
                              masks={first: np.arange(12, dtype=np.int8).reshape(3, 4) % 2 == 0}),
        "duplicate-mapping": Job.simulate(arch, wl, core.default_mapping(arch, "duplicate")),
        "lm": Job.simulate(core.usecase_arch(16),
                           core.lm_workload(_mod(pkg, "configs").get_config("qwen3-4b"),
                                            seq_len=16).set_sparsity(core.hybrid(2, 16, 0.8)),
                           core.default_mapping(core.usecase_arch(16))),
    }
    for pol in core.POLICIES:
        jobs[f"schedule-{pol}"] = Job.simulate(
            arch, wl, mapping, schedule=core.SchedulePolicy(policy=pol, invocations=4))
    if pkg == "repro":
        ir, lower = _mod(pkg, "trace.ir"), _mod(pkg, "trace.lower")
        traced = lower.lower_graph(ir.TraceGraph.from_dict(traced_graph))
    else:
        traced = _mod(pkg, "trace").traced_workload("qwen3-4b", seq_len=16)
    jobs["traced"] = Job.simulate(core.usecase_arch(16), traced,
                                  core.default_mapping(core.usecase_arch(16)))
    return jobs


@pytest.fixture(scope="module")
def traced_graph():
    """The port's capture of qwen3-4b (seq 16), as the JSON the
    reference's ``TraceGraph.from_dict`` reads."""
    from repro_torch.configs import get_config
    from repro_torch.trace import trace_model
    return json.loads(json.dumps(trace_model(get_config("qwen3-4b"), seq_len=16).to_dict()))


@pytest.fixture(scope="module")
def both_jobs(traced_graph):
    return {pkg: _jobs(pkg, traced_graph) for pkg in ("repro", "repro_torch")}


JOB_NAMES = ["analytic", "calibrated", "dense", "dense-calibrated", "default-schedule",
             "input-sparsity", "masks", "duplicate-mapping", "lm", "traced",
             "schedule-monolithic", "schedule-partitioned", "schedule-resident"]


@pytest.mark.parametrize("name", JOB_NAMES)
def test_content_key_equals_reference(name, both_jobs):
    ref, port = both_jobs["repro"][name], both_jobs["repro_torch"][name]
    assert port.key == ref.key
    from repro.explore.batch import job_keys as ref_keys
    from repro_torch.explore.batch import job_keys as port_keys
    assert port_keys(port) == ref_keys(ref)
    port_jobs = both_jobs["repro_torch"]
    # the explicit default schedule keys as no schedule; every other job apart
    assert port_jobs["default-schedule"].key == port_jobs["analytic"].key
    assert len({j.key for j in port_jobs.values()}) == len(JOB_NAMES) - 1


def test_schemas_and_default_profile_equal_reference():
    from repro.calibrate.profile import default_profile as ref_default
    from repro.explore import CACHE_SCHEMA, STORE_SCHEMA
    from repro_torch.calibrate.profile import default_profile, resolve_profile
    from repro_torch.explore import CACHE_SCHEMA as T_CACHE, STORE_SCHEMA as T_STORE
    assert (T_CACHE, T_STORE) == (CACHE_SCHEMA, STORE_SCHEMA)
    assert default_profile().content_hash() == ref_default().content_hash()
    assert resolve_profile("default").to_dict() == ref_default().to_dict()


def test_traced_sweep_equals_reference_sweep_of_the_same_graph(traced_graph, mains, tmp_path,
                                                               capsys, monkeypatch):
    """The port's ``lm --workload traced:qwen3-4b`` ≡ the reference's
    ``sparsity_sweep`` over the port's graph lowered by the reference."""
    from repro.core import TABLE_II_PATTERNS, usecase_arch
    from repro.explore import sparsity_sweep
    from repro.trace.ir import TraceGraph
    from repro.trace.lower import lower_graph

    wl = lower_graph(TraceGraph.from_dict(traced_graph))
    want = sparsity_sweep(usecase_arch(16), lambda: copy.deepcopy(wl), {}, ratios=[0.8],
                          workers=1, pattern_factory=lambda r: TABLE_II_PATTERNS(r, c_in=16))
    rc, out, files = run_cli(mains["repro_torch"],
                             (*LM, "--workload", "traced:qwen3-4b", "--json", "rows.json"),
                             tmp_path, capsys, monkeypatch)
    assert rc == 0
    assert f"traced workload 'traced-qwen3-4b-forward': {len(wl)} ops, " \
           f"digest {wl.source_digest[:16]}" in out
    rows = json.loads(files["rows.json"])["rows"]
    assert rows == json.loads(json.dumps(want.rows))
    assert len(rows) == len(TABLE_II_PATTERNS(0.8, c_in=16))
    assert all(r["workload"] == "traced-qwen3-4b-forward" for r in rows)


# ---------------------------------------------------------------------------
# The core.explorer wrappers
# ---------------------------------------------------------------------------

def _wrapper_rows(pkg: str, which: str):
    core = _mod(pkg, "core")
    if which == "sweep_sparsity":
        return core.sweep_sparsity(core.usecase_arch(4), lambda: core.resnet18(32), {},
                                   ratios=(0.7, 0.9),
                                   pattern_factory=lambda r: core.TABLE_II_PATTERNS(r, c_in=16))
    if which == "sweep_sparsity-schedule":
        return core.sweep_sparsity(core.usecase_arch(4), lambda: core.resnet18(32),
                                   core.TABLE_II_PATTERNS(0.8, c_in=16), ratios=(0.8,),
                                   schedule=core.SchedulePolicy(policy="partitioned"))
    arch_fn = lambda org: core.usecase_arch(org[0] * org[1], org)  # noqa: E731
    if which == "sweep_mappings":
        return core.sweep_mappings(arch_fn, lambda: core.vgg16(32), core.hybrid(2, 16, 0.8),
                                   rearrange=(None, "pad"))
    return core.sweep_orgs(arch_fn, lambda: core.resnet18(32), core.hybrid(2, 16, 0.8),
                           orgs=((4, 4), (2, 8)), strategy="duplicate")


@pytest.mark.parametrize("which", ["sweep_sparsity", "sweep_sparsity-schedule", "sweep_mappings",
                                   "sweep_orgs"])
def test_explorer_wrappers_equal_reference(which):
    port = _wrapper_rows("repro_torch", which)
    assert port and port == _wrapper_rows("repro", which)


def test_core_exports_the_wrappers_as_the_reference():
    import repro.core as ref
    import repro_torch.core as port
    wrappers = {"sweep_mappings", "sweep_orgs", "sweep_sparsity"}
    assert wrappers <= set(port.__all__) and wrappers <= set(ref.__all__)
    assert port.__all__ == ref.__all__


def test_explore_exports_equal_reference():
    import repro.explore as ref
    import repro_torch.explore as port
    assert port.__all__ == ref.__all__


def test_import_boundary_covers_the_exploration_plane():
    """tests/test_torch_kernels.py walks every file of the port; the
    exploration plane's are among them."""
    port = ROOT / "src" / "repro_torch"
    covered = {str(p.relative_to(port)) for p in port.rglob("*.py")}
    assert {f"explore/{m}.py" for m in ("__init__", "__main__", "batch", "cache", "faults", "job",
                                        "pareto", "runner", "search", "sweeps")} <= covered
    assert {"core/explorer.py", "obs/energy.py", "obs/timeline.py", "obs/__main__.py",
            "calibrate/__main__.py"} <= covered
