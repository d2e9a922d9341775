"""PyTorch port, the modeling plane's front end: ``repro_torch.trace`` ≡ the
reference's ``repro.trace``.

The reference's live capture does not run on the installed jax (its
``_convert_jaxpr`` reads ``jax.core.Literal``, and its ``source="model"``
stops at ``runtime/compat.py``), so the port is held against what needs no
jax to capture: the committed golden graphs ``tests/fixtures/trace/*.json``
(the JAX package's output of record, pinned by digest in
tests/test_trace.py), the reference's jax-free ``repro.trace.{ir,lower,
diff}`` and ``__main__`` and its numpy ``repro.core.workload``
(``lm_workload``, ``MODEL_BUILDERS``), imported directly as
tests/test_trace.py imports them.

(a) the copies: ``TraceGraph`` gives the reference's digest and canonical
JSON; ``lower_graph`` equals the reference's node by node (fold on and
off); ``summarize`` / ``diff_workloads`` / ``diff_table`` are equal; the
chain properties of tests/test_trace.py (hypothesis, skipped without it)
and the same checks on a fixed grid.  (b) the port's live capture of the
golden set lowers node by node as the reference lowers the committed
graphs, so every ``summarize()`` field, the per-kind element totals and
the pinned elementwise surpluses are reproduced.  (c) every config's
forward and prefill at (S 8, B 1) and (S 16, B 2), and vgg16 / resnet18 /
resnet50, equal the reference's hand DAGs in MVM macs, MVM weights and
total weights; every decode lowers, sorts and simulates.  (d) digests are
equal across processes; the port's golden set is pinned by digest prefix.
(e) ``source="model"``: llama3-8b forward at S 8 within (0.9, 1.2) of the
hand DAG's macs and equal in MVM weights, flash as two matmuls over the
real lengths; every config's three steps lower; every other kernel, and a
compressed model, raises under a capture; with no capture open the
entry points give what the loop before ``_scan`` gave, bit for bit, with
the same ops counted.  (f) the CLI prints what the reference's prints.
(g) the dry-run's ``--emit-trace``.  Every comparison is exact.
"""
import collections
import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from _hypothesis_shim import given, settings, st

import repro.trace.__main__ as RM
from repro.configs import get_config as ref_config
from repro.core import workload as RW
from repro.trace import diff as RD
from repro.trace import ir as RI
from repro.trace import lower as RL

from repro_torch import analysis as TA
from repro_torch.configs import get_config, list_archs
from repro_torch.core import SchedulePolicy, default_mapping, simulate, usecase_arch
from repro_torch.core import workload as TW
from repro_torch.core.schedule import POLICIES
from repro_torch.kernels import ops
from repro_torch.launch import counting, dryrun
from repro_torch.models import transformer as TT
from repro_torch.models.layers import IntraBlockLinear
from repro_torch.trace import TRACE_STEPS, trace_model, traced_cnn, traced_workload
from repro_torch.trace import diff as TD
from repro_torch.trace import ir as TI
from repro_torch.trace import lower as TL
import repro_torch.trace.__main__ as TM

C = importlib.import_module("repro_torch.trace.capture")

ROOT = Path(__file__).resolve().parent.parent
REF_DIR = ROOT / "tests" / "fixtures" / "trace"
PORT_DIR = ROOT / "tests" / "fixtures" / "trace_torch"
GOLDEN = {TM.fixture_name(*f): f for f in TM.FIXTURES}
DIFFABLE = sorted(n for n in GOLDEN if "decode" not in n)

# digest prefixes of the port's golden graphs (python -m repro_torch.trace
# fixture): the capture's content key, pinned as tests/test_trace.py pins
# the reference's
PORT_DIGESTS = {
    "lm_llama3-8b_forward.json": "7b852d9a2e62ba4b",
    "lm_llama3-8b_prefill.json": "409d28b26b0e3900",
    "lm_llama3-8b_decode.json": "bcd7a1268d7fe682",
    "lm_dbrx-132b_forward.json": "b4bc8de0bdfc8109",
    "cnn_resnet18_32.json": "b04cae84d3f83f9b",
}


def _nodes(w):
    return [(n.name, n.kind, n.K, n.N, n.V, n.c_in, tuple(n.kernel), n.elements, n.weights,
             tuple(n.inputs), n.prunable) for n in w.nodes.values()]


def _kind_elements(w):
    c = collections.Counter()
    for n in w.other_ops():
        c[n.kind] += n.elements
    return dict(c)


def _ref_hand(meta):
    if "config" in meta:
        return RW.lm_workload(ref_config(meta["config"]), seq_len=int(meta["seq_len"]),
                              batch=int(meta["batch"]))
    return RW.MODEL_BUILDERS[meta["model"]](int(meta["img"]), int(meta["num_classes"]))


def _port_hand(meta):
    if "config" in meta:
        return TW.lm_workload(get_config(meta["config"]), seq_len=int(meta["seq_len"]),
                              batch=int(meta["batch"]))
    return TW.MODEL_BUILDERS[meta["model"]](int(meta["img"]), int(meta["num_classes"]))


def test_the_golden_sets_are_committed_and_the_boundary_covers_trace():
    assert sorted(os.listdir(REF_DIR)) == sorted(GOLDEN)
    assert sorted(os.listdir(PORT_DIR)) == sorted(GOLDEN)
    port = ROOT / "src" / "repro_torch" / "trace"
    assert {p.name for p in port.glob("*.py")} == {
        "__init__.py", "__main__.py", "capture.py", "diff.py", "ir.py", "lower.py",
        "reference.py"}


# ---------------------------------------------------------------------------
# (a) the copies of ir / lower / diff
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_ir_copy_gives_the_reference_digest(name, tmp_path):
    ours, theirs = TI.TraceGraph.load(REF_DIR / name), RI.TraceGraph.load(REF_DIR / name)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.digest() == theirs.digest()
    assert ours.n_eqns() == theirs.n_eqns() and repr(ours) == repr(theirs)
    assert TI.TraceGraph.from_dict(ours.to_dict()).digest() == ours.digest()
    ours.save(tmp_path / "ours.json")
    theirs.save(tmp_path / "theirs.json")
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "theirs.json").read_bytes()


@pytest.mark.parametrize("fold", (True, False))
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_lower_copy_equals_reference_node_by_node(name, fold):
    ours = TL.lower_graph(TI.TraceGraph.load(REF_DIR / name), fold=fold)
    theirs = RL.lower_graph(RI.TraceGraph.load(REF_DIR / name), fold=fold)
    assert (ours.name, ours.source_digest) == (theirs.name, theirs.source_digest)
    assert _nodes(ours) == _nodes(theirs)


@pytest.mark.parametrize("name", DIFFABLE)
def test_diff_copy_equals_reference(name):
    meta = RI.TraceGraph.load(REF_DIR / name).meta
    ours = TL.lower_graph(TI.TraceGraph.load(REF_DIR / name))
    theirs = RL.lower_graph(RI.TraceGraph.load(REF_DIR / name))
    assert TD.summarize(ours) == RD.summarize(theirs)
    assert TD.diff_workloads(ours, _port_hand(meta)) == RD.diff_workloads(theirs, _ref_hand(meta))
    assert TD.diff_table(ours, _port_hand(meta)) == RD.diff_table(theirs, _ref_hand(meta))


_EW_PRIMS = ("exp", "tanh", "logistic", "neg", "sqrt", "abs")


def _chain_graph(n_layers, d, seq, ew_tail):
    """tests/test_trace.py's weight chain, built from the port's IR:
    x(1,seq,d) through n_layers of dot_general(·, w_i(d,d)), each followed
    by ``ew_tail`` unary elementwise ops."""
    vars_ = {"x": TI.TraceVar((1, seq, d), "float32")}
    weights, eqns, invars = {}, [], ["x"]
    cur = "x"
    for i in range(n_layers):
        wv = f"w{i}"
        vars_[wv] = TI.TraceVar((d, d), "float32")
        weights[wv] = f"layer{i}/w"
        invars.append(wv)
        out = f"y{i}"
        vars_[out] = TI.TraceVar((1, seq, d), "float32")
        eqns.append(TI.TraceEqn("dot_general", [cur, wv], [out], params={
            "dimension_numbers": [[[2], [0]], [[], []]]}))
        cur = out
        for j, prim in enumerate(ew_tail):
            nxt = f"e{i}_{j}"
            vars_[nxt] = TI.TraceVar((1, seq, d), "float32")
            eqns.append(TI.TraceEqn(prim, [cur], [nxt]))
            cur = nxt
    return TI.TraceGraph(name="prop-chain", invars=invars, outvars=[cur], vars=vars_,
                         eqns=eqns, weights=weights)


def _check_chain_closed_form(n_layers, d, seq, ew_tail):
    g = _chain_graph(n_layers, d, seq, tuple(ew_tail))
    w = TL.lower_graph(g)
    assert w.total_macs() == n_layers * d * d * seq
    assert w.total_weights() == n_layers * d * d
    assert sorted(w.topo_order()) == sorted(w.nodes)
    unfolded = TL.lower_graph(_chain_graph(n_layers, d, seq, tuple(ew_tail)), fold=False)
    assert (sum(n.elements for n in w.other_ops())
            == sum(n.elements for n in unfolded.other_ops())
            == n_layers * len(ew_tail) * seq * d)
    assert len(w.other_ops()) <= len(unfolded.other_ops())
    for fold in (True, False):
        ref = RL.lower_graph(RI.TraceGraph.from_dict(g.to_dict()), fold=fold)
        assert _nodes(TL.lower_graph(g, fold=fold)) == _nodes(ref)


def _check_chain_simulates(n_layers, d, seq, ew_tail):
    arch = usecase_arch(4)
    mapping = default_mapping(arch, "spatial")
    for pol in POLICIES:
        w = TL.lower_graph(_chain_graph(n_layers, d, seq, tuple(ew_tail)))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            rep = simulate(arch, w, mapping, schedule=SchedulePolicy(pol))
        assert rep.latency_cycles >= 0 and rep.total_energy_uj >= 0
        for oc in rep.op_costs:
            assert oc.latency_cycles >= 0 and oc.macs >= 0


@given(n_layers=st.integers(1, 4), d=st.integers(4, 48), seq=st.integers(1, 16),
       ew_tail=st.lists(st.sampled_from(_EW_PRIMS), max_size=4))
@settings(max_examples=40, deadline=None)
def test_random_chain_lowers_to_closed_form(n_layers, d, seq, ew_tail):
    _check_chain_closed_form(n_layers, d, seq, ew_tail)


@given(n_layers=st.integers(1, 3), d=st.integers(4, 32), seq=st.integers(1, 8),
       ew_tail=st.lists(st.sampled_from(_EW_PRIMS), max_size=2))
@settings(max_examples=12, deadline=None)
def test_random_chain_simulates_under_every_policy(n_layers, d, seq, ew_tail):
    _check_chain_simulates(n_layers, d, seq, ew_tail)


def _grid(n, seed, layers, dmax, smax, tail):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(1, layers + 1)), int(rng.integers(4, dmax + 1)),
             int(rng.integers(1, smax + 1)),
             [str(p) for p in rng.choice(_EW_PRIMS, size=int(rng.integers(0, tail + 1)))])
            for _ in range(n)]


# the same properties on a fixed grid (numpy seed 0), so they run without hypothesis
@pytest.mark.parametrize("case", _grid(12, 0, 4, 48, 16, 4), ids=str)
def test_chain_lowers_to_closed_form_on_a_fixed_grid(case):
    _check_chain_closed_form(*case)


@pytest.mark.parametrize("case", _grid(6, 1, 3, 32, 8, 2), ids=str)
def test_chain_simulates_under_every_policy_on_a_fixed_grid(case):
    _check_chain_simulates(*case)


# ---------------------------------------------------------------------------
# (b) the live capture against the committed reference graphs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live():
    return {name: TM.fixture_graph(*f) for name, f in GOLDEN.items()}


@pytest.mark.parametrize("fold", (True, False))
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_capture_lowers_as_the_committed_reference_graph(live, name, fold):
    ours = TL.lower_graph(live[name], fold=fold)
    theirs = RL.lower_graph(RI.TraceGraph.load(REF_DIR / name), fold=fold)
    assert _nodes(ours) == _nodes(theirs)
    assert TD.summarize(ours) == RD.summarize(theirs)
    assert _kind_elements(ours) == _kind_elements(theirs)


@pytest.mark.parametrize("name, macs, surplus", [
    ("lm_llama3-8b_forward.json", 60_054_044_672, 13_459_520),
    ("lm_dbrx-132b_forward.json", 286_852_644_864, 55_711_488),
    ("cnn_resnet18_32.json", 555_468_800, 492_032),
])
def test_capture_reproduces_the_pinned_surpluses(live, name, macs, surplus):
    d = TD.diff_workloads(TL.lower_graph(live[name]), _port_hand(live[name].meta))
    assert d["mvm_match"] and d["total_weights_equal"], d
    assert d["traced"]["mvm_macs"] == macs
    assert d["elementwise_surplus"] == surplus


# ---------------------------------------------------------------------------
# (c) the capture against the reference's hand DAGs
# ---------------------------------------------------------------------------

def _mvm_fields(ours, theirs):
    t, h = TD.summarize(ours), RD.summarize(theirs)
    return ({k: t[k] for k in ("mvm_macs", "mvm_weights", "total_weights")},
            {k: h[k] for k in ("mvm_macs", "mvm_weights", "total_weights")})


@pytest.mark.parametrize("shape", [(8, 1), (16, 2)], ids=lambda s: f"S{s[0]}B{s[1]}")
@pytest.mark.parametrize("step", ["forward", "prefill"])
@pytest.mark.parametrize("arch", list_archs())
def test_capture_matches_the_reference_hand_dag(arch, step, shape):
    S, B = shape
    ours = traced_workload(arch, step=step, seq_len=S, batch=B)
    t, h = _mvm_fields(ours, RW.lm_workload(ref_config(arch), seq_len=S, batch=B))
    assert t == h


@pytest.mark.parametrize("model", ["vgg16", "resnet18", "resnet50"])
def test_cnn_capture_matches_the_reference_builders(model):
    ours, theirs = traced_cnn(model, 32, 100), RW.MODEL_BUILDERS[model](32, 100)
    t, h = _mvm_fields(ours, theirs)
    assert t == h
    if model == "vgg16":          # the straight-line VGG folds perfectly
        assert TD.summarize(ours)["elementwise"] == RD.summarize(theirs)["elementwise"]


@pytest.mark.parametrize("arch", list_archs())
def test_decode_capture_lowers_orders_and_simulates(arch):
    w = traced_workload(arch, step="decode", seq_len=8, batch=1)
    assert sorted(w.topo_order()) == sorted(w.nodes) and w.levels()
    s = TD.summarize(w)
    assert s["n_mvm"] > 0 and s["mvm_macs"] > 0
    arch16 = usecase_arch(16)
    mapping = default_mapping(arch16, "spatial")
    for pol in POLICIES:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            rep = simulate(arch16, traced_workload(arch, step="decode", seq_len=8, batch=1),
                           mapping, schedule=SchedulePolicy(pol))
        assert rep.latency_cycles > 0 and rep.total_energy_uj > 0


# ---------------------------------------------------------------------------
# (d) determinism and the port's golden set
# ---------------------------------------------------------------------------

_DIGESTS = """
import json
from repro_torch.configs import get_config
from repro_torch.trace import trace_model
from repro_torch.trace.__main__ import FIXTURES, fixture_graph
out = [fixture_graph(*f).digest() for f in FIXTURES]
out.append(trace_model(get_config("llama3-8b"), step="forward", seq_len=8,
                       source="model").digest())
print(json.dumps(out))
"""


def test_digests_are_equal_across_processes(live):
    runs = []
    for seed in ("0", "1"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED=seed)
        p = subprocess.run([sys.executable, "-c", _DIGESTS], env=env, capture_output=True,
                           text=True, timeout=240, check=True)
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    assert runs[0] == runs[1]
    assert runs[0][:-1] == [live[TM.fixture_name(*f)].digest() for f in TM.FIXTURES]


@pytest.mark.parametrize("name", sorted(PORT_DIGESTS))
def test_port_golden_graph_is_pinned_and_reproduced(live, name):
    g = TI.TraceGraph.load(PORT_DIR / name)
    assert g.digest().startswith(PORT_DIGESTS[name])
    assert live[name].digest() == g.digest()
    assert _nodes(TL.lower_graph(g)) == _nodes(RL.lower_graph(RI.TraceGraph.load(REF_DIR / name)))


def test_fixture_command_writes_the_committed_port_graphs(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        assert TM.main(["fixture", "--out", str(tmp_path)]) == 0
    for name in GOLDEN:
        assert (tmp_path / name).read_bytes() == (PORT_DIR / name).read_bytes()


# ---------------------------------------------------------------------------
# (e) the port's own model
# ---------------------------------------------------------------------------

def test_model_source_llama3_8b_forward_against_the_hand_dag():
    cfg = get_config("llama3-8b")
    g = trace_model(cfg, step="forward", seq_len=8, batch=1, source="model")
    w = TL.lower_graph(g)
    TA.preflight(w, strict=True, where="test")
    hand = RW.lm_workload(ref_config("llama3-8b"), seq_len=8, batch=1)
    assert 0.9 < w.total_macs() / hand.total_macs() < 1.2
    assert TD.summarize(w)["mvm_weights"] == RD.summarize(hand)["mvm_weights"]
    scans = [e for e in g.eqns if e.prim == "scan"]      # the layer loop is one scan
    assert len(scans) == 1 and scans[0].params["length"] == cfg.n_layers
    # flash (the port pads q/k/v to 128 rows) as two matmuls over the 8 real rows
    hd, Hq, L, S = cfg.resolved_head_dim, cfg.n_heads, cfg.n_layers, 8
    mm = sorted((n.K, n.N, n.V) for n in w.nodes.values() if n.kind == "matmul")
    assert mm == sorted([(hd, S, Hq * S * L), (S, hd, Hq * S * L)])


@pytest.mark.parametrize("step", TRACE_STEPS)
@pytest.mark.parametrize("arch", list_archs())
def test_model_source_lowers_for_every_config(arch, step):
    g = trace_model(get_config(arch), step=step, seq_len=8, batch=1, source="model")
    w = TL.lower_graph(g)
    TA.preflight(w, strict=True, where="test")
    assert w.total_macs() > 0 and sorted(w.topo_order()) == sorted(w.nodes)
    assert [e.prim for e in g.eqns].count("scan") >= 1


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


REFUSED = {
    "block_sparse_matmul": lambda: (_meta((4, 256)), _meta((2, 1, 128, 128)),
                                    _meta((2, 1), torch.int32)),
    "intrablock_gather_matmul": lambda: (_meta((4, 256)), _meta((128, 64)),
                                         _meta((128,), torch.int32)),
    "block_importance": lambda: (_meta((256, 256)), 128, 128),
    "bitserial_zero_profile": lambda: (_meta((8, 64), torch.int8), 32),
    "quantized_zero_profile": lambda: (_meta((8, 64)), 32),
}


@pytest.mark.parametrize("op", sorted(REFUSED))
def test_other_kernels_raise_under_a_capture_naming_the_op(op):
    with pytest.raises(C.CaptureError, match=op):
        C.capture(lambda *a: getattr(ops, op)(*a), *REFUSED[op](), param_argnums=())


def test_a_compressed_model_raises_under_a_capture():
    cfg = get_config("qwen3-4b").reduced()
    params = dryrun.param_struct(cfg)
    wq = params["layers"]["wq"]                                  # (L, d, Hq, hd)
    L, d = wq.shape[:2]
    params["layers"]["wq"] = IntraBlockLinear(
        _meta((L, d // 2, wq.shape[2] * wq.shape[3]), wq.dtype), _meta((L, d // 2), torch.int32),
        d, wq.shape[2:], _checked=True)
    with pytest.raises(C.CaptureError, match="compressed weight"):
        C.capture(lambda p, t: TT.forward(p, t, cfg), params, _meta((1, 8), torch.int32))


def test_scan_records_one_body_with_its_closure():
    def fn(w, x, bias):
        def body(c, wl):
            return c @ wl + bias, c.sum(-1)
        return C.scan(body, x, w)

    w, x, bias = torch.randn(3, 4, 4), torch.randn(2, 4), torch.randn(4)
    carry, ys = fn(w, x, bias)                         # eagerly: the loop
    c = x
    for l in range(3):
        c = c @ w[l] + bias
    assert torch.equal(carry, c) and ys.shape == (3, 2)
    g = C.capture(fn, w, x, bias, param_argnums=(0,))
    (scan,) = [e for e in g.eqns if e.prim == "scan"]
    assert scan.params["length"] == 3
    assert (scan.params["num_consts"], scan.params["num_carry"]) == (1, 1)
    assert g.vars[scan.outvars[1]].shape == (3, 2)
    (fc,) = TL.lower_graph(g).mvm_ops()
    assert (fc.K, fc.N, fc.V, fc.weights) == (4, 4, 2 * 3, 16)   # one layer's slice


# the entry points' layer loop as it was before ``_scan`` (no tap, no remat)

def _old_run(params, tokens, cfg, keep_cache, prefix_embed=None, enc_embed=None):
    x = params["embed"][tokens]
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(device=x.device, dtype=x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    prefix = 0 if prefix_embed is None else prefix_embed.shape[1]
    caches, ck = {}, None
    if cfg.enc_dec:
        e = enc_embed.to(device=x.device, dtype=x.dtype)
        epos = torch.arange(e.shape[1], device=e.device)[None]
        for lp in TT._layers(params["enc_layers"], cfg.enc_layers):
            h = TT.rms_norm(e, lp["ln1"], cfg.norm_eps)
            y, _ = TT.attention_block(h, lp, cfg, positions=epos, causal=False)
            e = e + y
            e = e + TT.mlp_block(TT.rms_norm(e, lp["ln2"], cfg.norm_eps), lp, cfg)
        e = TT.rms_norm(e, params["enc_final_norm"], cfg.norm_eps)
        ck = torch.stack([TT.project(e, w) for w in params["enc_cross"]["wk"].unbind(0)])
        cv = torch.stack([TT.project(e, w) for w in params["enc_cross"]["wv"].unbind(0)])
        ck, cv = ck.to(e.dtype), cv.to(e.dtype)
        if keep_cache:
            caches["cross_k"], caches["cross_v"] = ck, cv
    layers = TT._layers(params["layers"], cfg.n_layers)
    if ck is not None:
        crosses = [dict(c, k=k, v=v) for c, k, v in
                   zip(TT._layers(params["dec_cross"], cfg.n_layers), ck.unbind(0), cv.unbind(0))]
    for l, window in enumerate(TT._windows(cfg)):
        x, new = TT._decoder_layer(x, layers[l], cfg, positions=positions, window=window,
                                   prefix=prefix, cross=None if ck is None else crosses[l])
        if keep_cache:
            for key, t in new.items():
                caches.setdefault(key, []).append(t)
    return x, caches


def _old_forward(params, tokens, cfg, **kw):
    return TT._unembed(params, _old_run(params, tokens, cfg, False, **kw)[0], cfg)


def _old_prefill(params, tokens, cfg, **kw):
    x, caches = _old_run(params, tokens, cfg, True, **kw)
    cache = {"pos": torch.full((), x.shape[1], dtype=torch.int32, device=x.device)}
    cache.update({k: ts if torch.is_tensor(ts) else torch.stack(ts) for k, ts in caches.items()})
    return TT._unembed(params, x[:, -1:], cfg), cache


def _old_decode_step(params, tokens, cfg, cache):
    x = params["embed"][tokens[:, None] if tokens.dim() == 1 else tokens]
    pos = torch.as_tensor(cache["pos"], device=x.device)
    positions = (pos if pos.dim() == 0 else pos[:, None]).expand(x.shape[0], 1)
    keys = [k for k in ("k", "v", "ssm", "conv") if k in cache]
    for l, window in enumerate(TT._windows(cfg)):
        dc = params.get("dec_cross")
        cross = ({"k": cache["cross_k"][l], "v": cache["cross_v"][l], "wq": dc["wq"][l],
                  "wo": dc["wo"][l], "ln": dc["ln"][l]} if cfg.enc_dec else None)
        x, _ = TT._decoder_layer(x, TT._layer(params["layers"], l), cfg, positions=positions,
                                 window=window, cache={k: cache[k][l] for k in keys},
                                 cache_len=pos, cross=cross)
    return TT._unembed(params, x, cfg)[:, 0], dict(cache, pos=pos + 1)


_LOOP_ARCHS = ("llama3-8b", "gemma2-9b", "qwen3-moe-30b-a3b", "mamba2-130m", "hymba-1.5b",
               "whisper-medium", "paligemma-3b")


def _extras(cfg, B, device, dtype):
    g = torch.Generator().manual_seed(1)
    extra = {}
    if cfg.enc_dec:
        extra["enc_embed"] = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=g)
    if cfg.prefix_len:
        extra["prefix_embed"] = torch.randn((B, cfg.prefix_len, cfg.d_model), generator=g)
    return {k: v.to(device=device, dtype=dtype) for k, v in extra.items()}


def _equal_trees(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("arch", _LOOP_ARCHS)
def test_scan_outside_a_capture_is_the_loop_it_replaced(arch):
    """Bit-equal outputs (f32, CPU) and the same ops, launches included,
    counted on ``meta``, for forward, prefill and a decode step."""
    cfg = get_config(arch).reduced()
    params = TT.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tokens = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)),
                          dtype=torch.long)
    extra = _extras(cfg, 2, "cpu", torch.float32)
    with torch.no_grad():
        assert torch.equal(TT.forward(params, tokens, cfg, **extra),
                           _old_forward(params, tokens, cfg, **extra))
        new, old = TT.prefill(params, tokens, cfg, **extra), _old_prefill(params, tokens, cfg,
                                                                          **extra)
        assert _equal_trees(new[0], old[0]) and _equal_trees(new[1], old[1])
        cache = TT.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
        caches = ({k: v.clone() for k, v in cache.items()},
                  {k: v.clone() for k, v in cache.items()})
        step = tokens[:, 0]
        a = TT.decode_step(params, step, cfg, caches[0])
        b = _old_decode_step(params, step, cfg, caches[1])
        assert torch.equal(a[0], b[0]) and _equal_trees(a[1], b[1])

    meta = dryrun.param_struct(cfg)
    mtok = torch.empty((2, 12), dtype=torch.int32, device="meta")
    mextra = _extras(cfg, 2, "meta", torch.bfloat16)
    mcache = TT.init_cache(cfg, 2, 16, device="meta")
    mstep = torch.empty((2,), dtype=torch.int32, device="meta")
    for new, old in ((lambda: TT.forward(meta, mtok, cfg, **mextra),
                      lambda: _old_forward(meta, mtok, cfg, **mextra)),
                     (lambda: TT.prefill(meta, mtok, cfg, **mextra),
                      lambda: _old_prefill(meta, mtok, cfg, **mextra)),
                     (lambda: TT.decode_step(meta, mstep, cfg, mcache),
                      lambda: _old_decode_step(meta, mstep, cfg, mcache))):
        counts = []
        for fn in (new, old):
            with torch.no_grad(), counting.count() as c:
                fn()
            counts.append((c.oplog, c.flops_by_kind, c.bytes_accessed))
        assert counts[0] == counts[1]


# ---------------------------------------------------------------------------
# (f) the CLI
# ---------------------------------------------------------------------------

def _run_main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("name", DIFFABLE)
def test_cli_diff_prints_what_the_reference_prints(name):
    argv = ["diff", "--graph", str(REF_DIR / name)]
    ours = _run_main(TM.main, argv)
    assert ours == _run_main(RM.main, argv)
    assert ours[0] == 0 and "MVM differential: PASS" in ours[1]


def test_cli_lower_simulate_prints_what_the_reference_prints():
    argv = ["lower", "--graph", str(REF_DIR / "lm_llama3-8b_decode.json"), "--simulate"]
    ours = _run_main(TM.main, argv)
    assert ours == _run_main(RM.main, argv) and ours[0] == 0


def test_cli_diff_on_a_decode_graph_errors_as_the_reference(capsys):
    argv = ["diff", "--graph", str(REF_DIR / "lm_llama3-8b_decode.json")]
    errs = []
    for main in (TM.main, RM.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1].split(": error: ")[1])
    assert errs[0] == errs[1] and "no hand-DAG sibling" in errs[0]


def test_cli_runs_as_a_module():
    argv = ["diff", "--graph", str(REF_DIR / "lm_dbrx-132b_forward.json")]
    p = subprocess.run([sys.executable, "-m", "repro_torch.trace", *argv], capture_output=True,
                       text=True, timeout=240, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert (p.returncode, p.stdout) == _run_main(RM.main, argv)


# ---------------------------------------------------------------------------
# (g) the dry-run's --emit-trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell, batch", [("prefill_32k", None), ("decode_32k", 8)])
def test_dryrun_emit_trace(tmp_path, cell, batch):
    out = tmp_path / "d.jsonl"
    argv = ["--arch", "qwen3-4b", "--cell", cell, "--emit-trace", "--out", str(out)]
    with contextlib.redirect_stdout(io.StringIO()):
        assert dryrun.main(argv + (["--batch", str(batch)] if batch else [])) == 0
    rec = json.loads(out.read_text().splitlines()[-1])
    assert "error" not in rec
    assert Path(rec["trace_path"]) == tmp_path / "trace" / f"qwen3-4b_{cell}.json"
    g = TI.TraceGraph.load(rec["trace_path"])
    assert g.digest() == rec["trace_digest"]
    assert (g.meta["batch"], g.meta["seq_len"]) == (rec["global_batch"], rec["seq_len"])
    w = TL.lower_graph(g)
    s = TD.summarize(w)
    assert (rec["trace_ops"], rec["trace_mvm_macs"], rec["trace_mvm_weights"]) == \
        (len(w), s["mvm_macs"], s["mvm_weights"])
    if cell == "prefill_32k":
        hand = RW.lm_workload(ref_config("qwen3-4b"), seq_len=rec["seq_len"],
                              batch=rec["global_batch"])
        assert rec["trace_mvm_macs"] == hand.total_macs()
        assert rec["trace_mvm_weights"] == RD.summarize(hand)["mvm_weights"]
    else:
        assert rec["global_batch"] == batch and g.meta["step"] == "decode"
