"""The port's static-analysis package (``repro_torch.analysis``) held to the
reference's (``repro.analysis``), and the port's torch-free host plane.

* The port's tree is clean under the four passes, also on an interpreter
  where torch, triton and jax raise ``ImportError``.
* The CLI (``--list``, exit codes) and the rendering equal the
  reference's.
* Seeded mutations on a tmp copy of ``src/<package>``: the port's import
  boundary (torch/triton roots, the package root, parent-package edges),
  and the reference's cache-key and determinism mutations run on both
  packages with equal codes (plus torch's global generator for the port).
* ``ModelPlanePass`` covers the reference's workloads and the port's own
  trace fixtures.
* A torch-blocked subprocess imports every module of the host plane and
  runs an exploration sweep whose CSV equals the reference's.
* ``core``'s pruning and quantisation exports equal the reference's.

The reference's analysis, core and explore packages never import jax,
so they are imported as the JAX package's own tests import them.
"""
from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKGS = ("repro", "repro_torch")
PASSES = {"import-boundary", "cache-key", "model-plane", "determinism"}
HOST_PLANE = ("core", "explore", "trace", "configs", "calibrate", "analysis", "obs")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.analysis.{name}")


def _codes(diags, *, errors_only: bool = True):
    return sorted({d.code for d in diags
                   if not d.suppressed
                   and (not errors_only or d.severity == "error")})


def _tree(tmp_path: Path, pkg: str = "repro_torch") -> Path:
    """A throwaway copy of ``src/<pkg>`` to inject defects into."""
    root = tmp_path / "tree"
    shutil.copytree(REPO / "src" / pkg, root / "src" / pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _run(pass_name: str, root: Path, pkg: str = "repro_torch"):
    fw = _mod(pkg, "framework")
    return fw.get_pass(pass_name).run(fw.PassContext(root=root))


def _write(root: Path, rel: str, text: str, pkg: str = "repro_torch") -> None:
    p = root / "src" / pkg / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)


def _append(root: Path, rel: str, text: str, pkg: str = "repro_torch") -> None:
    p = root / "src" / pkg / rel
    p.write_text(p.read_text() + text)


def _sub(root: Path, rel: str, old: str, new: str, pkg: str = "repro_torch") -> None:
    p = root / "src" / pkg / rel
    text = p.read_text()
    assert old in text, f"mutation anchor {old!r} missing from {pkg}/{rel}"
    p.write_text(text.replace(old, new))


def _shadowed_env(tmp_path: Path) -> dict:
    """The environment of a subprocess in which ``import torch``,
    ``import triton`` and ``import jax`` raise ``ImportError``."""
    shadow = tmp_path / "shadow"
    shadow.mkdir(exist_ok=True)
    for name in ("torch", "triton", "jax"):
        (shadow / f"{name}.py").write_text(f"raise ImportError('no {name} here')\n")
    return dict(os.environ, PYTHONPATH=f"{shadow}{os.pathsep}{REPO / 'src'}")


# ---------------------------------------------------------------------------
# the port's tree is clean; the CLI is the reference's
# ---------------------------------------------------------------------------

def test_port_tree_is_clean_under_all_passes():
    from repro_torch.analysis import run_passes
    diags = [d for d in run_passes(None, root=REPO) if not d.suppressed]
    assert not [d for d in diags if d.severity in ("error", "warning")], \
        [f"{d.code} {d.location}: {d.message}" for d in diags]


def test_cli_all_json_exits_zero(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "analysis.json"
    rc = main(["--all", "--format", "json", "--out", str(out)])
    printed = capsys.readouterr().out
    payload = json.loads(printed)
    assert rc == 0 and payload["ok"] is True
    assert payload["counts"]["error"] == 0
    assert set(payload["passes"]) == PASSES and len(payload["passes"]) == 4
    assert out.read_text() == printed


def test_cli_runs_with_torch_triton_and_jax_shadowed(tmp_path):
    """The whole checker runs on an interpreter with none of the three."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--all", "--format", "json"],
        env=_shadowed_env(tmp_path), capture_output=True, text=True, cwd=str(tmp_path),
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["counts"]["error"] == 0 and set(payload["passes"]) == PASSES


def test_cli_list_equals_reference(capsys):
    """Same passes in the same order with the same codes; the
    descriptions name each package's own plane."""
    lines = {}
    for pkg in PKGS:
        assert _mod(pkg, "__main__").main(["--list"]) == 0
        lines[pkg] = capsys.readouterr().out.splitlines()
    ref, port = lines["repro"], lines["repro_torch"]
    assert len(ref) == len(port) == 8
    assert ref[0::2] == port[0::2]
    assert all(line.startswith("    ") and line.strip() for line in port[1::2])


@pytest.mark.parametrize("argv", [["--pass", "nonsense"],
                                  ["--all", "--pass", "cache-key"]],
                         ids=["unknown-pass", "pass-and-all"])
@pytest.mark.parametrize("pkg", PKGS)
def test_cli_usage_errors_exit_2(pkg, argv):
    with pytest.raises(SystemExit) as ei:
        _mod(pkg, "__main__").main(argv)
    assert ei.value.code == 2


def _diagnostics(pkg: str):
    D = _mod(pkg, "diagnostics").Diagnostic
    return [
        D(code="CIM402", severity="error", message="wall-clock read time.time()",
          pass_name="determinism", file="src/x/core/a.py", line=3, hint="use perf_counter"),
        D(code="CIM101", severity="error", message="eager import",
          pass_name="import-boundary", file="src/x/core/b.py", line=2),
        D(code="CIM304", severity="warning", message="isolated op",
          pass_name="model-plane", obj="lm:x[mars].nodes['a']"),
        D(code="CIM307", severity="note", message="index footprint",
          pass_name="model-plane", obj="w"),
        D(code="CIM403", severity="error", message="salted hash",
          pass_name="determinism", file="src/x/core/b.py", line=6),
    ]


def test_rendering_and_suppression_equal_reference():
    sources = {"src/x/core/a.py": ["import time", "", "t = time.time()"],
               "src/x/core/b.py": ["# header", "import torch  # ciminus: ignore[CIM101]",
                                   "", "", "# ciminus: ignore[CIM403,CIM402]", "h = hash(1)"]}
    rendered = {}
    for pkg in PKGS:
        dg = _mod(pkg, "diagnostics")
        diags = dg.apply_suppressions(_diagnostics(pkg), sources)
        rendered[pkg] = (
            [d.suppressed for d in diags],
            dg.render_text(diags), dg.render_text(diags, show_suppressed=True),
            dg.render_json(diags, passes=["determinism", "import-boundary", "model-plane"]),
            [dg.suppressed_codes(line) for lines in sources.values() for line in lines])
    assert rendered["repro_torch"] == rendered["repro"]
    assert rendered["repro_torch"][0] == [False, True, False, False, True]


# ---------------------------------------------------------------------------
# pass 1: the port's import boundary (seeded mutations)
# ---------------------------------------------------------------------------

def test_boundary_clean_tree_has_no_findings(tmp_path):
    assert _run("import-boundary", _tree(tmp_path)) == []


@pytest.mark.parametrize("root_mod", ["torch", "triton"])
def test_boundary_catches_eager_forbidden_root(tmp_path, root_mod):
    root = _tree(tmp_path)
    _append(root, "core/flexblock.py", f"\nimport {root_mod}\n")
    diags = _run("import-boundary", root)
    assert _codes(diags) == ["CIM101", "CIM102"]
    cim101 = [d for d in diags if d.code == "CIM101"]
    assert len(cim101) == 1 and cim101[0].file.endswith("core/flexblock.py")
    # the taint reaches the package's own __init__ (``from .flexblock
    # import ...`` resolves inside the package) and every eager importer
    cim102 = {d.file for d in diags if d.code == "CIM102"}
    assert "src/repro_torch/core/__init__.py" in cim102
    assert "src/repro_torch/core/workload.py" in cim102


def test_boundary_catches_transitive_torch_reach(tmp_path):
    root = _tree(tmp_path)
    _append(root, "explore/job.py", "\nfrom ..models import layers\n")
    diags = _run("import-boundary", root)
    assert "CIM102" in _codes(diags)
    assert any(d.code == "CIM102" and d.file.endswith("explore/job.py")
               and "repro_torch.models.layers" in d.message for d in diags)


def test_boundary_catches_plane_crossing_without_torch(tmp_path):
    root = _tree(tmp_path)
    # kernels/hook.py imports no torch: crossing into it is still a
    # layering violation
    _append(root, "core/workload.py", "\nfrom ..kernels import hook\n")
    diags = _run("import-boundary", root)
    assert _codes(diags) == ["CIM103"]
    assert {d.file for d in diags} == {"src/repro_torch/core/workload.py"}


def test_boundary_reports_the_package_root_once(tmp_path):
    """``import torch`` back at ``repro_torch/__init__.py``: one CIM101
    there, not a CIM102 at every module beneath it."""
    root = _tree(tmp_path)
    _sub(root, "__init__.py", "if TYPE_CHECKING:\n    import torch\n", "import torch\n")
    diags = _run("import-boundary", root)
    assert [(d.code, d.file) for d in diags] == [("CIM101", "src/repro_torch/__init__.py")]


def test_boundary_follows_parent_edges_into_the_execution_plane(tmp_path):
    """Importing a torch-free module runs its package's ``__init__``
    first: under an execution-plane package that imports torch, the
    import reaches torch (CIM102, not the CIM103 of a torch-free edge)."""
    root = _tree(tmp_path)
    _write(root, "data/_plain.py", "X = 1\n")
    _append(root, "data/__init__.py", "\nimport torch\n")
    _append(root, "core/workload.py", "\nfrom ..data._plain import X\n")
    diags = _run("import-boundary", root)
    assert _codes(diags) == ["CIM102"]
    site = [d for d in diags if d.file == "src/repro_torch/core/workload.py"]
    assert len(site) == 1 and "repro_torch.data._plain" in site[0].message


def test_boundary_reports_a_protected_parent_at_its_init(tmp_path):
    """A torch-free module under a protected package whose ``__init__``
    imports torch: the breach is reported at that ``__init__``, once."""
    root = _tree(tmp_path)
    _write(root, "obs/_gpu/__init__.py", "import torch\n")
    _write(root, "obs/_gpu/plain.py", "X = 1\n")
    _append(root, "obs/core.py", "\nimport repro_torch.obs._gpu.plain\n")
    diags = _run("import-boundary", root)
    assert [(d.code, d.file) for d in diags] == [
        ("CIM101", "src/repro_torch/obs/_gpu/__init__.py")]


def test_boundary_allows_lazy_and_type_checking_imports(tmp_path):
    root = _tree(tmp_path)
    _append(root, "core/flexblock.py", (
        "\nfrom typing import TYPE_CHECKING\n"
        "if TYPE_CHECKING:\n    import torch\n    from ..models import layers\n"
        "def _lazy_site():\n    import torch.nn.functional as F\n"
        "    import triton\n    from ..kernels import ops\n    return F, triton, ops\n"))
    assert _run("import-boundary", root) == []


def test_boundary_suppression_marker(tmp_path):
    root = _tree(tmp_path)
    _append(root, "core/flexblock.py", "\nimport torch  # ciminus: ignore[*] -- test waiver\n")
    run_passes = _mod("repro_torch", "framework").run_passes
    diags = run_passes(["import-boundary"], root=root)
    assert [d for d in diags if d.code == "CIM101"]
    assert all(d.suppressed for d in diags if d.code == "CIM101")


# ---------------------------------------------------------------------------
# pass 2: cache-key mutations, both packages
# ---------------------------------------------------------------------------

_KIND_LINE = "kind: str                                   # 'simulate' | 'dense'"


def _new_simulate_kwarg(kwarg):
    return lambda root, pkg: _sub(root, "core/costmodel.py", "def simulate(",
                                  f"def simulate(*, {kwarg}):\n    pass\n"
                                  "def _old_simulate(", pkg)


def _new_job_field(field):
    return lambda root, pkg: _sub(root, "explore/job.py", _KIND_LINE,
                                  _KIND_LINE + f"\n    {field}", pkg)


CACHEKEY_MUTATIONS = {
    "new-simulate-kwarg": (_new_simulate_kwarg("_rounding_mode: str = 'even'"),
                           "CIM201", "_rounding_mode"),
    "unforwarded-job-field": (lambda root, pkg: _sub(root, "explore/runner.py",
                                                     "profile=job.profile,", "profile=None,", pkg),
                              "CIM202", "'profile'"),
    "hand-listed-canonical": (lambda root, pkg: _sub(root, "explore/job.py",
                                                     "_sorted_field_names(type(obj))",
                                                     "('arch', 'workload')", pkg),
                              "CIM203", None),
    "schema-bump-without-history": (lambda root, pkg: _sub(root, "explore/job.py",
                                                           "CACHE_SCHEMA = 5", "CACHE_SCHEMA = 6",
                                                           pkg),
                                    "CIM204", None),
    "anchor-moved": (lambda root, pkg: _sub(root, "explore/runner.py", "def evaluate_job(",
                                            "def eval_job_v2(", pkg),
                     "CIM200", None),
    "obs-named-job-field": (_new_job_field("obs_tag: str = 'x'"), "CIM205", "obs_tag"),
    "obs-named-simulate-param": (_new_simulate_kwarg("obs_sink=None"), "CIM205", None),
    "obs-import-in-job": (lambda root, pkg: _append(root, "explore/job.py",
                                                    "\nfrom .. import obs  # noqa\n", pkg),
                          "CIM205", "obs"),
    "fault-named-job-field": (_new_job_field("retry_budget: int = 2"), "CIM206", "retry_budget"),
    "fault-named-simulate-param": (_new_simulate_kwarg("timeout_s=None"), "CIM206", "timeout_s"),
    "faults-import-in-job": (lambda root, pkg: _append(root, "explore/job.py",
                                                       "\nfrom . import faults  # noqa\n", pkg),
                             "CIM206", "faults"),
    "batch-named-job-field": (_new_job_field("batch_size: int = 0"), "CIM207", "batch_size"),
    "search-named-simulate-param": (_new_simulate_kwarg("search_budget=None"), "CIM207",
                                    "search_budget"),
    "batch-import-in-job": (lambda root, pkg: _append(root, "explore/job.py",
                                                      "\nfrom . import batch  # noqa\n", pkg),
                            "CIM207", "batch"),
    "search-import-in-job": (lambda root, pkg: _append(root, "explore/job.py",
                                                       "\nfrom .search import SearchPolicy  # noqa\n",
                                                       pkg),
                             "CIM207", None),
}


def test_cachekey_clean_trees_have_no_findings(tmp_path):
    for pkg in PKGS:
        assert _run("cache-key", _tree(tmp_path / pkg, pkg), pkg) == []


@pytest.mark.parametrize("name", sorted(CACHEKEY_MUTATIONS))
def test_cachekey_mutation_codes_equal_reference(tmp_path, name):
    mutate, code, needle = CACHEKEY_MUTATIONS[name]
    codes = {}
    for pkg in PKGS:
        root = _tree(tmp_path / pkg, pkg)
        mutate(root, pkg)
        diags = _run("cache-key", root, pkg)
        codes[pkg] = _codes(diags)
        assert code in codes[pkg]
        if needle is not None:
            assert any(needle in d.message for d in diags)
    assert codes["repro_torch"] == codes["repro"]


# ---------------------------------------------------------------------------
# pass 4: determinism mutations, both packages (+ torch's generator)
# ---------------------------------------------------------------------------

DETERMINISM_SNIPPETS = [
    ("x = np.random.rand(3)", ["CIM401"]),
    ("g = np.random.default_rng()", ["CIM401"]),
    ("import random\nr = random.random()", ["CIM401"]),
    ("import time\nt = time.time()", ["CIM402"]),
    ("h = hash((1, 2))", ["CIM403"]),
    ("import os\nfiles = os.listdir('.')", ["CIM404"]),
    ("g = np.random.default_rng(42)", []),
    ("import time\nt = time.perf_counter()", []),
    ("import os\nfiles = sorted(os.listdir('.'))", []),
]


def _mutant(snippet: str) -> str:
    body = "\n".join("    " + line for line in snippet.splitlines())
    return f"\ndef _mutant():\n{body}\n"


def test_determinism_clean_trees_have_no_findings(tmp_path):
    for pkg in PKGS:
        assert _run("determinism", _tree(tmp_path / pkg, pkg), pkg) == []


@pytest.mark.parametrize("snippet,want", DETERMINISM_SNIPPETS,
                         ids=[s.splitlines()[-1] for s, _ in DETERMINISM_SNIPPETS])
def test_determinism_codes_equal_reference(tmp_path, snippet, want):
    codes = {}
    for pkg in PKGS:
        root = _tree(tmp_path / pkg, pkg)
        _append(root, "core/flexblock.py", _mutant(snippet), pkg)
        codes[pkg] = _codes(_run("determinism", root, pkg))
    assert codes["repro"] == codes["repro_torch"] == want


@pytest.mark.parametrize("snippet,want", [
    ("import torch\nx = torch.randn(3)", ["CIM401"]),
    ("import torch\nx = torch.rand_like(torch.zeros(3))", ["CIM401"]),
    ("import torch\nx = torch.randint(0, 4, (3,))", ["CIM401"]),
    ("import torch\nx = torch.randperm(5)", ["CIM401"]),
    ("import torch\nx = torch.bernoulli(torch.full((3,), 0.5))", ["CIM401"]),
    ("import torch\ntorch.manual_seed(0)", ["CIM401"]),
    ("import torch\ntorch.seed()", ["CIM401"]),
    ("import torch as T\nx = T.normal(0.0, 1.0, (3,))", ["CIM401"]),
    ("import torch\ng = torch.Generator().manual_seed(0)\nx = torch.randn(3, generator=g)", []),
    ("import torch\ng = torch.Generator()\nx = torch.multinomial(torch.ones(3), 2, generator=g)",
     []),
    ("import torch\nx = torch.zeros(3)", []),
])
def test_determinism_torch_global_generator(tmp_path, snippet, want):
    root = _tree(tmp_path)
    _append(root, "core/flexblock.py", _mutant(snippet))
    assert _codes(_run("determinism", root)) == want


@pytest.mark.parametrize("pkg", PKGS)
def test_determinism_wall_clock_waived_inside_obs_only(tmp_path, pkg):
    root = _tree(tmp_path, pkg)
    mutant = _mutant("import time\nt = time.time()")
    _append(root, "obs/core.py", mutant, pkg)
    assert _run("determinism", root, pkg) == []
    _append(root, "obs/core.py", _mutant("h = hash((1, 2))"), pkg)
    assert _codes(_run("determinism", root, pkg)) == ["CIM403"]
    _append(root, "core/flexblock.py", mutant, pkg)
    assert _codes(_run("determinism", root, pkg)) == ["CIM402", "CIM403"]


# ---------------------------------------------------------------------------
# pass 3: the model-plane corpus
# ---------------------------------------------------------------------------

def _modelplane(pkg: str, monkeypatch):
    """(workload names the pass validated, its diagnostics)."""
    mp = _mod(pkg, "modelplane_pass")
    names = set()
    real = mp.validate

    def spy(workload, arch=None, mapping=None, *, prefix="workload"):
        names.add(prefix.split("[")[0])
        return real(workload, arch, mapping, prefix=prefix)

    monkeypatch.setattr(mp, "validate", spy)
    diags = mp.ModelPlanePass().run(_mod(pkg, "framework").PassContext(root=REPO))
    return names, diags


def test_modelplane_pass_covers_reference_workloads_and_port_fixtures(monkeypatch):
    ref_names, _ = _modelplane("repro", monkeypatch)
    port_names, diags = _modelplane("repro_torch", monkeypatch)
    port_fixtures = {f"trace_torch:{p.stem}"
                     for p in (REPO / "tests" / "fixtures" / "trace_torch").glob("*.json")}
    assert len(port_fixtures) == 5
    assert port_names == ref_names | port_fixtures
    assert {n for n in ref_names if n.startswith("trace:")}
    assert diags == [], [f"{d.code} {d.location}: {d.message}" for d in diags]


# ---------------------------------------------------------------------------
# the host plane imports and sweeps without torch
# ---------------------------------------------------------------------------

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
names = ["repro_torch"]
for sub in {HOST_PLANE!r}:
    pkg = importlib.import_module("repro_torch." + sub)
    names.append(pkg.__name__)
    names += [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "triton", "jax"))
print(len(names), loaded)
"""


def test_host_plane_imports_with_torch_blocked(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_shadowed_env(tmp_path),
                          capture_output=True, text=True, cwd=str(tmp_path), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n, loaded = proc.stdout.split(" ", 1)
    assert int(n) > 50 and loaded.strip() == "[]"


def test_sweep_cli_with_torch_blocked_equals_reference(tmp_path):
    env = _shadowed_env(tmp_path)
    csv = {}
    for pkg in PKGS:
        work = tmp_path / pkg
        work.mkdir()
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.explore", "sparsity", "--model", "resnet18",
             "--ratios", "0.8", "--workers", "2", "--csv", "out.csv"],
            env=env, capture_output=True, text=True, cwd=str(work), timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        csv[pkg] = (work / "out.csv").read_bytes()
    assert csv["repro_torch"] == csv["repro"] and csv["repro"].count(b"\n") > 1


# ---------------------------------------------------------------------------
# exports, and core's pruning / quantisation against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["core", "analysis", "analysis.diagnostics",
                                    "analysis.framework", "analysis.cachekey_pass",
                                    "analysis.determinism_pass", "analysis.modelplane_pass",
                                    "core.pruning", "core.input_sparsity"])
def test_exports_equal_reference(module):
    ref = importlib.import_module(f"repro.{module}").__all__
    port = importlib.import_module(f"repro_torch.{module}").__all__
    if module == "core.pruning":
        # the port's tensor pruning keeps its block-grid helpers public
        assert set(ref) - {"CRITERIA"} <= set(port)
    elif module == "core.input_sparsity":
        assert set(ref) <= set(port)
    else:
        assert port == ref


def test_imports_pass_exports_the_reference_names_and_the_root():
    ref = _mod("repro", "imports_pass").__all__
    port = _mod("repro_torch", "imports_pass")
    assert set(port.__all__) == set(ref) | {"PROTECTED_MODULES"}
    assert port.PROTECTED_MODULES == ("repro_torch",)
    assert port.FORBIDDEN_ROOTS == ("torch", "triton")
    assert port.PROTECTED_PREFIXES == tuple(
        p.replace("repro.", "repro_torch.") for p in _mod("repro", "imports_pass").PROTECTED_PREFIXES)


def _table_ii():
    from repro.core import TABLE_II_PATTERNS
    return sorted(TABLE_II_PATTERNS(0.75, c_in=16))


@pytest.mark.parametrize("align_cols", [False, True])
@pytest.mark.parametrize("pattern", _table_ii())
def test_prune_matrix_equals_reference(pattern, align_cols):
    import repro.core as R
    import repro_torch.core as T
    w = np.random.default_rng(7).standard_normal((96, 64)).astype(np.float32)
    ref = R.prune_matrix(w, R.TABLE_II_PATTERNS(0.75, c_in=16)[pattern],
                         align_cols=align_cols)
    port = T.prune_matrix(torch.from_numpy(w), T.TABLE_II_PATTERNS(0.75, c_in=16)[pattern],
                          align_cols=align_cols)
    assert isinstance(port, T.pruning.PruningResult)
    assert port.mask.dtype == torch.bool
    np.testing.assert_array_equal(port.mask.numpy(), ref.mask.astype(bool))
    assert port.density == ref.density
    assert repr(port.spec) == repr(ref.spec)
    if ref.block_keep is None:
        assert port.block_keep is None
    else:
        np.testing.assert_array_equal(port.block_keep.numpy(), ref.block_keep)
    np.testing.assert_array_equal(port.apply(torch.from_numpy(w)).numpy(), ref.apply(w))
    wb = torch.from_numpy(w).to(torch.bfloat16)
    applied = port.apply(wb)
    assert applied.dtype == torch.bfloat16 and applied.device == wb.device
    assert torch.equal(applied, wb * torch.from_numpy(ref.mask).to(torch.bfloat16))


def test_prune_matrix_dense_spec_equals_reference():
    import repro.core as R
    import repro_torch.core as T
    w = np.random.default_rng(3).standard_normal((32, 48)).astype(np.float32)
    ref = R.prune_matrix(w, R.dense_spec())
    port = T.prune_matrix(torch.from_numpy(w), T.dense_spec())
    assert port.block_keep is None and ref.block_keep is None
    assert port.density == ref.density == 1.0
    assert bool(port.mask.all())


@pytest.mark.parametrize("scale", [None, 0.05])
@pytest.mark.parametrize("shape", [(4, 37), (128,), (2, 3, 16)])
def test_quantize_int8_equals_reference(shape, scale):
    import repro.core as R
    import repro_torch.core as T
    x = (np.random.default_rng(11).standard_normal(shape) * 3).astype(np.float32)
    ref = R.quantize_int8(x, per_tensor_scale=scale)
    port = T.quantize_int8(torch.from_numpy(x), per_tensor_scale=scale)
    assert port.dtype == torch.int8
    np.testing.assert_array_equal(port.numpy(), ref)
