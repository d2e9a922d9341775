"""PyTorch port, model-plane pre-flight and observability: the port's
copies of ``repro.analysis``'s ``validate`` / ``preflight`` and of
``repro.obs``'s core ≡ the reference's, and ``ServeEngine`` runs the
pre-flight at construction and records the same ``serve.step`` counters
as the reference engine.

The execution plane of the reference comes through tests/_jax_reference.py
(its engine, and the ``repro.obs`` copy that engine records into).
``repro.analysis`` is jax-free, so it is imported as the JAX package's
own tests/test_analysis.py imports it; the workloads, specs, archs and
mappings it checks are built by each package from its own classes.
"""
import dataclasses
import importlib
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _jax_reference
from repro_torch import analysis as TA
from repro_torch import obs as TO
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import flexblock as TF
from repro_torch.core import mapping as TM
from repro_torch.core import presets as TP
from repro_torch.core import workload as TW
from repro_torch.serve import engine as TE


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


@pytest.fixture(scope="module")
def RA():
    """The reference's jax-free ``repro.analysis``."""
    return importlib.import_module("repro.analysis")


def _port():
    return TW, TF, TP, TM


def _ref(R):
    return R.workload, R.flexblock, R.presets, R.mapping


def _splice(w, key, node):
    w.nodes[key] = node      # bypass add(): the hazard validate() targets


def _ill_formed(case: str, mods):
    """(workload, arch, mapping) of one ill-formed input, built from one
    package's classes (as tests/test_analysis.py builds them)."""
    W, F, P, M = mods
    w = W.Workload("t")
    arch = mapping = None
    if case == "dangling_edge":
        w.fc("a", 16, 16)
        _splice(w, "b", W.OpNode(name="b", kind="add", inputs=("ghost",), elements=4))
    elif case == "name_mismatch_and_cycle":
        w.fc("a", 16, 16)
        _splice(w, "b", W.OpNode(name="zzz", kind="fc", K=4, N=4, V=1))
        _splice(w, "c", W.OpNode(name="c", kind="fc", inputs=("d",), K=4, N=4, V=1))
        _splice(w, "d", W.OpNode(name="d", kind="fc", inputs=("c",), K=4, N=4, V=1))
    elif case == "isolated":
        w.fc("a", 16, 16)
        w.fc("b", 16, 16, inputs=("a",))
        w.fc("loner", 8, 8)
    elif case == "bad_dims":
        _splice(w, "a", W.OpNode(name="a", kind="conv", K=0, N=-3, V=1))
    elif case == "sparsity":
        w.fc("a", 16, 16)
        w.nodes["a"].sparsity = F.row_block(0.5, width=10 ** 6)
    elif case == "index_capacity":
        arch = P.PRESET_ARCHS["mars"]()
        tiny = dataclasses.replace(arch.mem("index_mem"), capacity_bytes=1)
        arch = arch.replace(memory_units={**arch.memory_units, "index_mem": tiny})
        w.fc("a", 4096, 4096)
        w.nodes["a"].sparsity = F.row_block(0.5, width=16)
    elif case == "arch_contract":
        arch = P.PRESET_ARCHS["mars"]()
        arch = arch.replace(compute_units={k: v for k, v in arch.compute_units.items()
                                           if k != "adder_tree"})
        w.fc("a", 16, 16)
    elif case == "mapping_contract":
        w.fc("a", 16, 16)
        mapping = M.MappingSpec(reshape=M.ReshapeSpec(rearrange="slice", slice_size=0),
                                strategy="bogus")
    return w, arch, mapping


def _lm(mods, cfg, spec_kind: str):
    """``lm_workload`` of a ported config, with a FlexBlock spec set, on
    ``usecase_arch(4, input_sparsity=True)`` with its default mapping."""
    W, F, P, M = mods
    spec = F.FlexBlockSpec((F.FullBlock(128, 128, 0.5),) if spec_kind == "FullBlock"
                           else (F.IntraBlock(4, 1, 0.5),))
    wl = W.lm_workload(cfg, seq_len=64, batch=4).set_sparsity(spec)
    arch = P.usecase_arch(4, input_sparsity=True)
    return wl, arch, M.default_mapping(arch, "duplicate")


def _summary(diags):
    return [(d.code, d.severity, d.message, d.obj, d.hint) for d in diags]


ILL_FORMED = ["dangling_edge", "name_mismatch_and_cycle", "isolated", "bad_dims", "sparsity",
              "index_capacity", "arch_contract", "mapping_contract"]


@pytest.mark.parametrize("case", ILL_FORMED)
def test_validate_matches_reference_on_ill_formed_inputs(R, RA, case):
    got = TA.validate(*_ill_formed(case, _port()))
    want = RA.validate(*_ill_formed(case, _ref(R)))
    assert _summary(got) == _summary(want)
    assert got, case                     # every case has a finding


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-4b", "gemma-7b", "gemma2-9b"])
@pytest.mark.parametrize("spec_kind", ["FullBlock", "IntraBlock", None])
def test_validate_matches_reference_on_lm_workloads(R, RA, arch, spec_kind):
    assert arch in list_archs()
    cfg, jcfg = get_config(arch), R.configs.get_config(arch)
    if spec_kind is None:
        got = TA.validate(TW.lm_workload(cfg, seq_len=1024, batch=4))
        want = RA.validate(R.workload.lm_workload(jcfg, seq_len=1024, batch=4))
    else:
        got = TA.validate(*_lm(_port(), cfg, spec_kind))
        want = RA.validate(*_lm(_ref(R), jcfg, spec_kind))
    assert _summary(got) == _summary(want)
    if spec_kind is None:
        assert got == []


def test_preflight_strict_raises_like_reference(R, RA):
    w_port, _, _ = _ill_formed("dangling_edge", _port())
    w_ref, _, _ = _ill_formed("dangling_edge", _ref(R))
    with pytest.raises(TA.AnalysisError) as got:
        TA.preflight(w_port, strict=True, where="port-strict")
    with pytest.raises(RA.AnalysisError) as want:
        RA.preflight(w_ref, strict=True, where="port-strict")
    assert str(got.value) == str(want.value)
    assert "CIM301" in str(got.value)


def test_preflight_warns_once_like_reference(R, RA):
    """strict=False warns once per (where, workload, codes) and returns the
    diagnostics; the message is the reference's."""
    msgs = []
    for pkg, mods in ((TA, _port()), (RA, _ref(R))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(3):
                diags = pkg.preflight(_ill_formed("bad_dims", mods)[0], strict=False,
                                      where="port-warn-once")
        assert [d.code for d in diags] == ["CIM305", "CIM305"]      # K and N
        assert [w.category for w in caught] == [RuntimeWarning]
        msgs.append(str(caught[0].message))
    assert msgs[0] == msgs[1] and "CIM305" in msgs[0]
    # a clean workload neither warns nor raises
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert TA.preflight(TW.lm_workload(get_config("gemma2-9b"), seq_len=64), strict=True) \
            == []


def test_preflight_switch_off_returns_nothing(monkeypatch):
    monkeypatch.setenv("REPRO_ANALYSIS_PREFLIGHT", "0")
    assert TA.preflight(_ill_formed("dangling_edge", _port())[0], strict=True) == []


# ---------------------------------------------------------------------------
# obs core
# ---------------------------------------------------------------------------

def _records(read_events, d):
    return [{k: v for k, v in r.items() if k not in ("t", "pid", "dur_s", "id", "parent")}
            for r in read_events(d)]


def test_obs_records_equal_reference(R, tmp_path):
    """The same spans, counters and events give the same records (times
    and pids aside, and the span ids and parents that only the port's
    records carry), and nothing is written while disabled."""
    def drive(obs):
        obs.counter("c", 3, a=1)
        with obs.span("s", x="y") as sp:
            sp.set(z=2)
        obs.event("e", k=[1, 2])
        obs.counter("plain")

    out = []
    for obs, name in ((R.engine.obs, "ref"), (TO, "port")):
        drive(obs)                                  # disabled: a no-op
        with obs.enabled(tmp_path / name, run_id=f"run-{name}") as o:
            assert obs.is_enabled() and o.run_id == f"run-{name}"
            drive(obs)
        assert not obs.is_enabled()
        manifest = obs.read_manifest(tmp_path / name)
        assert manifest["run_id"] == f"run-{name}" and manifest["obs_schema"] == obs.OBS_SCHEMA
        out.append(_records(obs.read_events, tmp_path / name))
    assert out[0] == out[1]
    assert [r["type"] for r in out[1]] == ["counter", "span", "event", "counter"]
    (port_span,) = TO.read_events(tmp_path / "port", name="s")
    assert isinstance(port_span["id"], int) and port_span["parent"] is None


def test_obs_span_records_its_error(tmp_path):
    with TO.enabled(tmp_path):
        with pytest.raises(KeyError):
            with TO.span("boom"):
                raise KeyError("x")
    (rec,) = TO.read_events(tmp_path, name="boom")
    assert rec["error"] == "KeyError" and rec["dur_s"] >= 0


# ---------------------------------------------------------------------------
# ServeEngine: pre-flight, serve.step counters, greedy=
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model(R):
    jcfg = R.configs.get_config("gemma2-9b").reduced()
    pj = R.transformer.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg)), pj, \
        params_from_jax(jax.tree.map(np.asarray, pj), "cpu")


def _serve(engine, req_cls, prompts, n_new):
    reqs = [req_cls(prompt=p, max_new_tokens=n_new) for p in prompts]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return reqs


def test_serve_step_counters_equal_reference(R, model, tmp_path):
    """One ``serve.step`` counter per step, with the same value (active
    slots), queue depth and completions, in the same order."""
    jcfg, cfg, pj, pt = model
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 40, 3, 9, 12)]
    lens = (4, 6, 3, 5, 2)
    seqs, outputs = [], []
    for name, obs, engine, req_cls in (
            ("ref", R.engine.obs, R.engine.ServeEngine(jcfg, pj, slots=2, max_len=64),
             R.engine.Request),
            ("port", TO, TE.ServeEngine(cfg, pt, slots=2, max_len=64, device="cpu"),
             TE.Request)):
        with obs.enabled(tmp_path / name):
            reqs = [req_cls(prompt=p, max_new_tokens=n) for p, n in zip(prompts, lens)]
            for r in reqs:
                engine.submit(r)
            engine.run()
        recs = obs.read_events(tmp_path / name, name="serve.step")
        seqs.append([(r["value"], r["attrs"]) for r in recs])
        outputs.append([r.output for r in reqs])
    assert seqs[0] == seqs[1]
    assert outputs[0] == outputs[1]
    assert sum(a["completed"] for _, a in seqs[1]) == len(prompts)
    assert [v for v, _ in seqs[1]][0] == 2 and seqs[1][0][1]["queue_depth"] == 3


def test_engine_runs_preflight_at_construction(R, model, monkeypatch):
    """The engine hands lm_workload(cfg, seq_len=max_len, batch=slots) to
    the warn-only pre-flight, as the reference engine does."""
    _, cfg, _, pt = model
    seen = []
    monkeypatch.setattr(TE, "preflight", lambda wl, **kw: seen.append((wl, kw)) or [])
    TE.ServeEngine(cfg, pt, slots=3, max_len=40, device="cpu")
    ((wl, kw),) = seen
    assert kw == {"strict": False, "where": "serve.engine"}
    want = R.workload.lm_workload(R.configs.get_config("gemma2-9b").reduced(), seq_len=40,
                                  batch=3)
    assert wl.name == want.name and list(wl.nodes) == list(want.nodes)
    assert [(n.K, n.N, n.V) for n in wl.nodes.values()] == \
        [(n.K, n.N, n.V) for n in want.nodes.values()]


def test_engine_preflight_warns_on_an_ill_formed_config(R, model):
    """A config whose workload fails validation warns once at construction,
    with the reference engine's message, and the engine is still built
    (warn-only)."""
    jcfg, cfg, pj, pt = model
    msgs = []
    for make in (lambda: R.engine.ServeEngine(dataclasses.replace(jcfg, vocab_size=0), pj,
                                              slots=1, max_len=16),
                 lambda: TE.ServeEngine(dataclasses.replace(cfg, vocab_size=0), pt, slots=1,
                                        max_len=16, device="cpu")):
        with pytest.warns(RuntimeWarning, match="CIM305") as caught:
            engine = make()
        assert engine.greedy is True
        msgs.append([str(w.message) for w in caught if w.category is RuntimeWarning])
    assert msgs[0] == msgs[1] and len(msgs[1]) == 1
    assert msgs[1][0].startswith("serve.engine: workload 'lm-gemma2-9b-smoke' failed")


@pytest.mark.parametrize("greedy", [True, False])
def test_engine_accepts_greedy_like_reference(R, model, greedy):
    """``greedy=`` is accepted and stored, as the reference stores it;
    decoding stays argmax in both packages."""
    jcfg, cfg, pj, pt = model
    prompts = [np.arange(7, dtype=np.int32)]
    rj = _serve(R.engine.ServeEngine(jcfg, pj, slots=1, max_len=32, greedy=greedy),
                R.engine.Request, prompts, 4)
    engine = TE.ServeEngine(cfg, pt, slots=1, max_len=32, greedy=greedy, device="cpu")
    rt = _serve(engine, TE.Request, prompts, 4)
    assert engine.greedy is greedy
    assert [r.output for r in rt] == [r.output for r in rj]


def test_no_observer_no_trace_files(model, tmp_path, monkeypatch):
    """With no observer enabled the engine writes nothing."""
    _, cfg, _, pt = model
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REPRO_OBS", raising=False)
    monkeypatch.delenv("REPRO_OBS_DIR", raising=False)
    TO.disable()
    _serve(TE.ServeEngine(cfg, pt, slots=1, max_len=32, device="cpu"), TE.Request,
           [np.arange(5, dtype=np.int32)], 3)
    assert list(tmp_path.iterdir()) == []
