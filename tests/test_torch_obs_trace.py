"""PyTorch port, the serving trace: the in-memory observer of
``repro_torch.obs``, span ids and parents, the request id, the engine's
decode attributes, the spans' mirror into a running torch profiler and the
clock anchor, on a reduced qwen3-moe-30b-a3b (engine, model and MoE spans
in one run).  No JAX: the reference has no such trace.  The one ``gpu``
test counts the host syncs of a decode step with the observer on and off.
"""
import dataclasses
import json
import os
import time
import warnings

import numpy as np
import pytest
import torch

import repro_torch.obs as TO
from repro_torch.configs import get_config
from repro_torch.launch import counting, dryrun
from repro_torch.models import spans as TS
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.trace.capture import capture

CFG = get_config("qwen3-moe-30b-a3b").reduced()


@pytest.fixture(scope="module")
def params():
    return TT.init_params(CFG, 0, dtype=torch.float32, device="cpu")


@pytest.fixture(autouse=True)
def _observer_off():
    TO.disable()
    yield
    TO.disable()


def _serve(params, lens=(5, 9, 4), n_new=3, slots=2, max_len=64, seed=0):
    """Serve prompts of ``lens`` tokens; returns (engine, requests)."""
    rng = np.random.default_rng(seed)
    eng = TE.ServeEngine(CFG, params, slots=slots, max_len=max_len, device="cpu")
    reqs = [TE.Request(prompt=rng.integers(0, CFG.vocab_size, n).astype(np.int32),
                       max_new_tokens=n_new) for n in lens]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, reqs


def _traced(params, **kw):
    """:func:`_serve` under an in-memory observer; returns (records, requests)."""
    o = TO.enable(in_memory=True)
    _, reqs = _serve(params, **kw)
    TO.disable()
    return o.records, reqs


def _drive():
    TO.counter("c", 3, a=1)
    with TO.span("outer", x="y") as sp:
        with TO.span("inner"):
            TO.event("e", k=[1, 2])
        sp.set(z=2)
    with pytest.raises(KeyError):
        with TO.span("boom"):
            raise KeyError("x")
    TO.counter("plain")


def _canonical(records):
    """Records with times and pids dropped and span ids renumbered in the
    order the spans began."""
    order = {r["id"]: i for i, r in enumerate(sorted(
        (r for r in records if r["type"] == "span"), key=lambda r: r["t"]))}
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in ("t", "dur_s", "pid")}
        if r["type"] == "span":
            r["id"] = order[r["id"]]
            r["parent"] = order.get(r["parent"])
        out.append(r)
    return out


def _lines(d):
    return [json.loads(line) for p in sorted(d.glob("events-*.jsonl"))
            for line in p.read_text().splitlines()]


def test_in_memory_observer_writes_at_close_what_file_mode_writes(tmp_path):
    with TO.enabled(tmp_path / "file"):
        _drive()
    o = TO.enable(tmp_path / "memory", in_memory=True)
    _drive()
    assert list((tmp_path / "memory").glob("events-*.jsonl")) == []
    assert len(o.records) == 6 and all("pid" not in r for r in o.records)
    TO.disable()
    file_recs, mem_recs = _lines(tmp_path / "file"), _lines(tmp_path / "memory")
    assert _canonical(mem_recs) == _canonical(file_recs)
    assert [r["name"] for r in mem_recs] == ["c", "e", "inner", "outer", "boom", "plain"]
    assert mem_recs[4]["error"] == "KeyError"
    o.close()                                       # a second close writes nothing more
    assert len(_lines(tmp_path / "memory")) == 6


def test_in_memory_observer_without_a_directory_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REPRO_OBS_DIR", raising=False)
    o = TO.enable(in_memory=True)
    assert o.dir is None and "REPRO_OBS_DIR" not in os.environ
    _drive()
    TO.disable()
    assert len(o.records) == 6 and list(tmp_path.iterdir()) == []


def test_span_parents_nest_engine_model_and_moe(params):
    recs, _ = _traced(params)
    spans = {r["id"]: r for r in recs if r["type"] == "span"}

    def chain(r):
        names = []
        while r is not None:
            names.append(r["name"])
            r = spans.get(r["parent"])
        return names

    by_name = {}
    for r in spans.values():
        by_name.setdefault(r["name"], []).append(r)
    for r in by_name["moe.dispatch"]:
        want = ["moe.dispatch", "model.moe"]
        assert chain(r)[:2] == want
        assert chain(r)[2:] in (["model.decode_step", "engine.decode", "engine.step"],
                                ["model.prefill", "engine.prefill", "engine.fill",
                                 "engine.step"])
    assert {chain(r)[1] for r in by_name["model.attention"]} == {"model.decode_step",
                                                               "model.prefill"}
    for name in ("engine.fill", "engine.decode", "engine.read", "engine.bookkeeping"):
        assert all(chain(r) == [name, "engine.step"] for r in by_name[name])
    assert all(r["parent"] is None for r in by_name["engine.step"])
    n_decode = len(by_name["model.decode_step"])
    for name in ("model.attention", "model.moe", "moe.dispatch", "moe.experts", "moe.combine"):
        assert len(by_name[name]) == CFG.n_layers * (n_decode + len(by_name["model.prefill"]))
    assert len({r["id"] for r in recs if r["type"] == "span"}) == len(spans)
    # a child lies inside its parent on the clock
    for r in spans.values():
        p = spans.get(r["parent"])
        if p is not None:
            assert p["t"] <= r["t"] and r["t"] + r["dur_s"] <= p["t"] + p["dur_s"]


def test_one_rid_across_submit_prefill_and_done(params):
    recs, reqs = _traced(params, lens=(5, 9, 4, 7))
    rids = [r.rid for r in reqs]
    assert len(set(rids)) == 4 and all(isinstance(x, int) for x in rids)

    def of(name):
        return {r["attrs"]["rid"]: r["attrs"] for r in recs if r["name"] == name}

    submit, prefill, done = of("engine.submit"), of("engine.prefill"), of("engine.done")
    assert set(submit) == set(prefill) == set(done) == set(rids)
    for req in reqs:
        assert submit[req.rid]["prompt_len"] == prefill[req.rid]["prompt_len"] == len(req.prompt)
        assert done[req.rid] == {"rid": req.rid, "tokens": len(req.output),
                                 "reason": "max_tokens"}
    assert sorted(a["slot"] for a in prefill.values()) == [0, 0, 1, 1]


def test_decode_filled_and_attended_equal_the_engines_slot_positions(params, monkeypatch):
    seen = []
    eng_ref = {}
    real = TE.decode_step

    def spy(*args, **kwargs):
        e = eng_ref["engine"]
        active = [s for s in range(e.slots) if e.slot_req[s] is not None]
        seen.append((len(active), int(sum(e.slot_pos[s] for s in active)),
                     e.slots * e.max_len))
        return real(*args, **kwargs)

    monkeypatch.setattr(TE, "decode_step", spy)
    init = TE.ServeEngine.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        eng_ref["engine"] = self

    monkeypatch.setattr(TE.ServeEngine, "__init__", keep)
    recs, _ = _traced(params, lens=(5, 17, 4), n_new=4, slots=2, max_len=48)
    got = [(r["attrs"]["active"], r["attrs"]["filled"], r["attrs"]["attended"])
           for r in recs if r["name"] == "engine.decode"]
    assert got == seen and len(got) >= 4
    assert all(a == 2 * 48 for _, _, a in got) and any(n == 1 for n, _, _ in got)


def test_greedy_outputs_identical_with_the_observer_on_and_off(params):
    _, off = _serve(params, lens=(6, 11, 3), n_new=5)
    recs, on = _traced(params, lens=(6, 11, 3), n_new=5)
    assert recs and [r.output for r in on] == [r.output for r in off]


def test_observer_off_leaves_no_record(params, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REPRO_OBS_DIR", raising=False)
    monkeypatch.delenv("REPRO_OBS", raising=False)
    opened = []
    monkeypatch.setattr(TS, "record_function", lambda name: opened.append(name))
    assert TO.get_observer() is None
    assert TO.span("engine.step") is TO.core._NULL
    _, reqs = _serve(params)
    assert all(r.done for r in reqs) and all(r.rid is not None for r in reqs)
    assert TO.core._OPEN == [] and opened == [] and list(tmp_path.iterdir()) == []


def _ranges(prof):
    """{name: [(start_ns, end_ns)]} of the program's ranges in a profile."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().split(".")[0] in ("engine", "model", "moe"):
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def test_spans_mirror_into_a_running_profiler_with_their_names_and_nesting(params):
    from torch.profiler import ProfilerActivity, profile

    o = TO.enable(in_memory=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(params, lens=(5, 9), n_new=2)
    TO.disable()
    ranges = _ranges(prof)
    spans = [r for r in o.records if r["type"] == "span"]
    names = {r["name"] for r in spans}
    assert set(ranges) == names and "moe.experts" in names
    # the i-th span of a name is the i-th range of that name
    placed = {}
    for name in names:
        mine = sorted((r for r in spans if r["name"] == name), key=lambda r: r["t"])
        assert len(mine) == len(ranges[name])
        placed.update({r["id"]: rng for r, rng in zip(mine, ranges[name])})
    for r in spans:
        if r["parent"] is not None:
            (s, e), (ps, pe) = placed[r["id"]], placed[r["parent"]]
            assert ps <= s and e <= pe


def test_no_range_opens_without_a_profiler(params, monkeypatch):
    opened = []
    real = TS.record_function
    monkeypatch.setattr(TS, "record_function", lambda name: opened.append(name) or real(name))
    recs, _ = _traced(params, lens=(4,), n_new=2)
    assert recs and opened == []


def test_spans_record_nothing_under_a_trace_capture():
    cfg = get_config("qwen3-4b").reduced()
    o = TO.enable(in_memory=True)
    capture(lambda p, t: TT.forward(p, t, cfg), TT.param_struct(cfg, torch.float32),
            torch.empty((1, 8), dtype=torch.int32, device="meta"))
    with TS.span("after"):
        pass
    TO.disable()
    assert [r["name"] for r in o.records] == ["after"] and TO.core._OPEN == []


@pytest.mark.parametrize("entry", ["prefill", "decode_step"])
def test_spans_launch_no_op(entry):
    """The same ops, counted on ``meta``, with the observer on as off: a
    span's work is the host's alone."""
    meta = dryrun.param_struct(CFG)
    tok = torch.empty((2, 12), dtype=torch.int32, device="meta")
    cache = TT.init_cache(CFG, 2, 16, device="meta")
    fn = {"prefill": lambda: TT.prefill(meta, tok, CFG),
          "decode_step": lambda: TT.decode_step(meta, tok[:, 0], CFG, cache)}[entry]
    counts = []
    for on in (False, True):
        o = TO.enable(in_memory=True) if on else None
        with torch.no_grad(), counting.count() as c:
            fn()
        TO.disable()
        counts.append((c.oplog, c.flops_by_kind, c.bytes_accessed))
    assert counts[0] == counts[1]
    assert any(r["name"] == "moe.experts" for r in o.records)


def test_the_anchor_places_a_span_inside_a_perf_counter_bracket():
    o = TO.enable(in_memory=True)
    p0 = time.perf_counter()
    with TO.span("bracketed"):
        time.sleep(0.002)
    p1 = time.perf_counter()
    TO.disable()
    (rec,) = o.records
    start = o.perf_counter_of(rec["t"])
    assert p0 <= start and start + rec["dur_s"] <= p1 and rec["dur_s"] >= 0.002
    assert abs(o.perf_counter_of(o.anchor[0]) - o.anchor[1]) < 1e-9


def test_span_stack_unwinds_after_an_error():
    o = TO.enable(in_memory=True)
    with pytest.raises(ValueError):
        with TO.span("a"):
            with TO.span("b"):
                raise ValueError
    with TO.span("c"):
        pass
    TO.disable()
    b, a, c = o.records
    assert b["parent"] == a["id"] and a["parent"] is None and c["parent"] is None
    assert a["error"] == b["error"] == "ValueError" and TO.core._OPEN == []


def _sync_warnings(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.gpu
def test_spans_add_no_host_sync():
    """A decode step of the reduced MoE, and an engine step, make as many
    host syncs with the in-memory observer on as with it off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(CFG, head_dim=64)       # a head dim the flash kernel takes
    p = TT.init_params(cfg, 0, dtype=torch.bfloat16, device="cuda")
    cache = TT.init_cache(cfg, 2, 32, dtype=torch.bfloat16, device="cuda")
    cache["pos"] = torch.tensor([3, 7], device="cuda")
    tokens = torch.tensor([1, 2], device="cuda")
    eng = TE.ServeEngine(cfg, p, slots=2, max_len=32, dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(0)
    for n in (5, 9):
        eng.submit(TE.Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                              max_new_tokens=8))
    eng.step()
    _sync_warnings(lambda: torch.zeros(2, device="cuda").tolist())    # the mode's first use
    counts = {}
    for on in (False, True, False):
        o = TO.enable(in_memory=True) if on else None
        decode = _sync_warnings(lambda: TT.decode_step(p, tokens, cfg, cache))
        step = _sync_warnings(eng.step)
        TO.disable()
        counts.setdefault(on, []).append((decode, step))
        if on:
            assert any(r["name"] == "moe.experts" for r in o.records)
    assert counts[True][0] == counts[False][0] == counts[False][1]
    assert counts[True][0][1] >= 1          # the engine's read of the next tokens
