"""PyTorch port, cost model: the port's copies of the CIMinus modeling
plane (``repro_torch.core`` cost model, ``repro_torch.calibrate`` profile
and fit, ``sparsity.apply.cim_cost_of_model``) ≡ the JAX package's.

The cost model is host-side numpy in both packages, so every check here
is exact: ``==`` on ``CostReport.to_dict()``, on ``compare``'s dict and
on the profiles' ``to_dict()`` / ``content_hash()``.  The reference is
loaded only through ``_jax_reference``.
"""
import dataclasses
import itertools
from pathlib import Path

import numpy as np
import pytest

import _jax_reference
from repro_torch.calibrate import fit as TF
from repro_torch.calibrate import profile as TPR
from repro_torch.calibrate.harvest import from_ledger
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import costmodel as TC
from repro_torch.core import flexblock as TFB
from repro_torch.core import mapping as TM
from repro_torch.core import presets as TPS
from repro_torch.core import workload as TW
from repro_torch.core.schedule import SchedulePolicy
from repro_torch.sparsity.apply import cim_cost_of_model

FIXTURE_LEDGER = Path(__file__).parent / "fixtures" / "calibration_ledger.jsonl"
WORKLOADS = ("resnet18", "resnet50", "vgg16", "mobilenet_v2")
PATTERNS = tuple(TFB.TABLE_II_PATTERNS(0.8))
SCHEDULES = (None, "partitioned", "resident")
PROFILES = (None, "default", "fitted")
# the ops lm_workload gives a measured input-sparsity ratio in chip_smoke.py
RATIO_OPS = ("attn_q", "attn_k", "attn_v", "mlp_up", "mlp_down")
REF = _jax_reference.load()


@pytest.fixture(scope="module")
def R():
    return REF


@pytest.fixture(scope="module")
def fitted(R):
    """The fixture ledger's profile, fitted by each package from its own
    harvest of the file."""
    ours = TF.fit_profile(from_ledger(FIXTURE_LEDGER).samples, name="fixture-fit")
    theirs = R.fit.fit_profile(R.harvest.from_ledger(FIXTURE_LEDGER).samples, name="fixture-fit")
    return ours, theirs


def _spec(mod, spec):
    """The same FlexBlock spec built from ``mod``'s classes."""
    pats = tuple(getattr(mod, type(p).__name__)(*dataclasses.astuple(p)) for p in spec.patterns)
    return mod.FlexBlockSpec(pats, spec.name)


def _ratios(seed=0):
    rng = np.random.default_rng(seed)
    return {k: float(rng.uniform(0.05, 0.6)) for k in RATIO_OPS}


def _config(R, name):
    jcfg = R.configs.get_config(name)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


# ---------------------------------------------------------------------------
# cim_cost_of_model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,spec", [
    ("qwen3-4b", TFB.FlexBlockSpec((TFB.IntraBlock(4, 1, 0.5),))),
    ("llama3-8b", TFB.FlexBlockSpec((TFB.FullBlock(128, 128, 0.5),))),
], ids=["qwen3-4b-intra", "llama3-8b-full"])
@pytest.mark.parametrize("measured", [False, True], ids=["no-ratios", "ratios"])
def test_cim_cost_of_model_full_width_equals_reference(R, name, spec, measured):
    jcfg, cfg = _config(R, name)
    ratios = _ratios() if measured else None
    ours = cim_cost_of_model(cfg, TPS.usecase_arch(4, input_sparsity=True), spec,
                             seq_len=512, input_sparsity=ratios)
    theirs = R.apply.cim_cost_of_model(jcfg, R.presets.usecase_arch(4, input_sparsity=True),
                                       _spec(R.flexblock, spec), seq_len=512,
                                       input_sparsity=ratios)
    assert ours[0].to_dict() == theirs[0].to_dict()
    assert ours[1] == theirs[1]
    assert ours[0].latency_cycles > 0 and np.isfinite(ours[0].total_energy_uj)
    assert {o.name for o in ours[0].op_costs} >= set(RATIO_OPS)


def test_measured_ratios_only_remove_cycles():
    cfg = get_config("qwen3-4b")
    arch, spec = TPS.usecase_arch(4, input_sparsity=True), TFB.FlexBlockSpec(
        (TFB.IntraBlock(4, 1, 0.5),))
    plain, _ = cim_cost_of_model(cfg, arch, spec, seq_len=512)
    skipped, _ = cim_cost_of_model(cfg, arch, spec, seq_len=512, input_sparsity=_ratios())
    assert skipped.latency_cycles < plain.latency_cycles
    by_name = {o.name: o.latency_cycles for o in plain.op_costs}
    for o in skipped.op_costs:
        if o.name in RATIO_OPS:
            assert o.latency_cycles < by_name[o.name], o.name
        else:
            assert o.latency_cycles == by_name[o.name], o.name


@pytest.mark.parametrize("name", sorted(REF.configs.list_archs()))
def test_cim_cost_of_model_every_config_equals_reference(R, name):
    jcfg, cfg = _config(R, name)
    ours = cim_cost_of_model(cfg, TPS.usecase_arch(4, input_sparsity=True),
                             TFB.hybrid(2, 16, 0.8), seq_len=32)
    theirs = R.apply.cim_cost_of_model(jcfg, R.presets.usecase_arch(4, input_sparsity=True),
                                       R.flexblock.hybrid(2, 16, 0.8), seq_len=32)
    assert ours[0].to_dict() == theirs[0].to_dict()
    assert ours[1] == theirs[1]


def test_cim_cost_round_trip(R):
    """The reference's own ``test_cim_cost_round_trip`` case, in the port."""
    jcfg, cfg = _config(R, "qwen3-4b")
    rep, cmp = cim_cost_of_model(cfg, TPS.usecase_arch(16), TFB.hybrid(2, 16, 0.8), seq_len=32)
    assert rep.latency_cycles > 0
    assert cmp["speedup"] >= 1.0
    assert cmp["energy_saving"] > 1.0
    theirs = R.apply.cim_cost_of_model(jcfg, R.presets.usecase_arch(16),
                                       R.flexblock.hybrid(2, 16, 0.8), seq_len=32)
    assert rep.to_dict() == theirs[0].to_dict() and cmp == theirs[1]


# ---------------------------------------------------------------------------
# simulate / dense_baseline over the paper's workloads
# ---------------------------------------------------------------------------

def _profile(which, fitted, theirs: bool):
    if which is None:
        return None
    if which == "default":
        return (REF.profile if theirs else TPR).default_profile()
    return fitted[1] if theirs else fitted[0]


def _simulate_cases():
    """Every workload x pattern x mapping x preset arch x schedule, and
    the profile in turn: (arch + schedule) mod 3 picks it, so for each
    workload, pattern and mapping every arch and every schedule meets all
    three profiles.  (The full cross with profiles, 2304 cases, takes
    about 50 s on a CPU.)"""
    archs = sorted(TPS.PRESET_ARCHS)
    for w, p, m, (ai, a), (si, s) in itertools.product(
            WORKLOADS, PATTERNS, ("duplicate", "spatial"), enumerate(archs),
            enumerate(SCHEDULES)):
        prof = PROFILES[(ai + si) % len(PROFILES)]
        yield pytest.param(w, p, m, a, s, prof, id=f"{w}-{p}-{m}-{a}-sched_{s}-profile_{prof}")


@pytest.mark.parametrize("workload,pattern,strategy,arch,schedule,profile", _simulate_cases())
def test_simulate_equals_reference(R, fitted, workload, pattern, strategy, arch, schedule,
                                   profile):
    ours_wl = getattr(TW, workload)().set_sparsity(TFB.TABLE_II_PATTERNS(0.8)[pattern])
    theirs_wl = getattr(R.workload, workload)().set_sparsity(
        R.flexblock.TABLE_II_PATTERNS(0.8)[pattern])
    ours_arch, theirs_arch = TPS.PRESET_ARCHS[arch](), R.presets.PRESET_ARCHS[arch]()
    ours_sched = None if schedule is None else SchedulePolicy(schedule)
    theirs_sched = None if schedule is None else R.costmodel.SchedulePolicy(schedule)
    ours = TC.simulate(ours_arch, ours_wl, TM.default_mapping(ours_arch, strategy),
                       profile=_profile(profile, fitted, False), schedule=ours_sched)
    theirs = R.costmodel.simulate(theirs_arch, theirs_wl,
                                  R.mapping.default_mapping(theirs_arch, strategy),
                                  profile=_profile(profile, fitted, True), schedule=theirs_sched)
    assert ours.to_dict() == theirs.to_dict()


@pytest.mark.parametrize("workload", WORKLOADS)
def test_dense_baseline_and_reference_simulator_equal_reference(R, fitted, workload):
    for arch, strategy in itertools.product(("mars", "usecase16"), ("duplicate", "spatial")):
        ours_arch, theirs_arch = TPS.PRESET_ARCHS[arch](), R.presets.PRESET_ARCHS[arch]()
        ours_wl = getattr(TW, workload)().set_sparsity(TFB.hybrid(2, 16, 0.8))
        theirs_wl = getattr(R.workload, workload)().set_sparsity(R.flexblock.hybrid(2, 16, 0.8))
        om, tm = TM.default_mapping(ours_arch, strategy), R.mapping.default_mapping(
            theirs_arch, strategy)
        od = TC.dense_baseline(ours_arch, ours_wl, om, profile=fitted[0])
        td = R.costmodel.dense_baseline(theirs_arch, theirs_wl, tm, profile=fitted[1])
        assert od.to_dict() == td.to_dict()
        osr = TC.simulate_reference(ours_arch, ours_wl, om)
        tsr = R.costmodel.simulate_reference(theirs_arch, theirs_wl, tm)
        assert osr.to_dict() == tsr.to_dict()
        assert TC.compare(osr, od) == R.costmodel.compare(tsr, td)


def test_core_package_reexports_the_reference_names(R):
    import repro_torch.core as core
    assert set(core.__all__) <= set(R.core.__all__)
    for name in core.__all__:
        assert type(getattr(core, name)).__name__ == type(getattr(R.core, name)).__name__, name
    assert core.simulate is TC.simulate and core.lm_workload is TW.lm_workload


# ---------------------------------------------------------------------------
# calibration profiles
# ---------------------------------------------------------------------------

def test_default_profile_equals_reference(R):
    ours, theirs = TPR.default_profile(), R.profile.default_profile()
    assert ours.to_dict() == theirs.to_dict()
    assert ours.content_hash() == theirs.content_hash()
    assert ours.is_analytic_default()
    assert TPR.resolve_profile(None) == TPR.resolve_profile("default") == ours


@pytest.mark.parametrize("solver", ["numpy", "auto"], ids=["pgd", "auto"])
def test_fit_profile_equals_reference(R, solver):
    ours_h, theirs_h = from_ledger(FIXTURE_LEDGER), R.harvest.from_ledger(FIXTURE_LEDGER)
    assert (ours_h.skipped_untimed, ours_h.skipped_malformed) == \
        (theirs_h.skipped_untimed, theirs_h.skipped_malformed)
    ours = TF.fit_profile(ours_h.samples, name="fixture", solver=solver)
    theirs = R.fit.fit_profile(theirs_h.samples, name="fixture", solver=solver)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.content_hash() == theirs.content_hash()
    assert ours.content_hash() != TPR.default_profile().content_hash()


def test_profile_save_addressed_round_trips(tmp_path, fitted):
    prof = fitted[0]
    path = prof.save_addressed(tmp_path)
    assert path.name == f"fixture-fit-{prof.content_hash()[:12]}.json"
    assert TPR.CalibrationProfile.load(path) == prof
    with pytest.raises(TPR.ProfileError):
        TPR.CalibrationProfile.from_dict(dict(prof.to_dict(), peak_flops=-1.0))


def test_unit_efficiency_profile_reproduces_the_analytic_report(fitted):
    """The docstring's contract that chip_smoke.py checks on the card's
    profile: all-1.0 efficiencies give the profile-less report, and a
    fitted profile divides each op's latency by its class's efficiency."""
    cfg = get_config("qwen3-4b")
    arch = TPS.usecase_arch(4, input_sparsity=True)
    wl = TW.lm_workload(cfg, seq_len=512).set_sparsity(
        TFB.FlexBlockSpec((TFB.IntraBlock(4, 1, 0.5),)))
    mapping = TM.default_mapping(arch, "duplicate")
    plain = TC.simulate(arch, wl, mapping, input_sparsity=_ratios())
    unit = dataclasses.replace(fitted[0], efficiency={k: 1.0 for k in fitted[0].efficiency})
    assert TC.simulate(arch, wl, mapping, input_sparsity=_ratios(),
                       profile=unit).to_dict() == plain.to_dict()
    scaled = TC.simulate(arch, wl, mapping, input_sparsity=_ratios(), profile=fitted[0])
    for a, b in zip(scaled.op_costs, plain.op_costs):
        eff = fitted[0].efficiency_for(TC.op_class(wl.nodes[a.name]))
        assert a.latency_cycles == pytest.approx(b.latency_cycles / eff, rel=1e-12)
