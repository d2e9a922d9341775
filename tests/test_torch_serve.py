"""PyTorch port, serving: the engine's greedy outputs ≡ the JAX package's
``ServeEngine`` on the same weights, and admission bound, deadlines and
metrics behave the same.

Weights come from the reference's init (f32) and cross to the port
through ``params_from_jax``; prompts are drawn with numpy from a seed.
The pruned-and-compressed case runs the port on the compressed layout
against the reference on masked-dense weights.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _jax_reference
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.flexblock import FlexBlockSpec, FullBlock
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.sparsity.apply import compress_params, prune_params

KEYS = ("wq", "wk", "wv", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


@pytest.fixture(scope="module")
def model(R):
    jcfg = R.configs.get_config("llama3-8b").reduced()
    pj = R.transformer.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg)), pj, \
        params_from_jax(jax.tree.map(np.asarray, pj), "cpu")


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve(engine, req_cls, prompts, n_new):
    reqs = [req_cls(prompt=p, max_new_tokens=n_new) for p in prompts]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return reqs


@pytest.mark.parametrize("slots,lens,n_new", [
    (2, (5, 9, 3), 6),            # more requests than slots
    (2, (3, 17), 5),              # heterogeneous positions
    (1, (6,), 4),
])
def test_greedy_outputs_equal_reference(R, model, slots, lens, n_new):
    jcfg, cfg, pj, pt = model
    prompts = _prompts(sum(lens), lens, cfg.vocab_size)
    rj = _serve(R.engine.ServeEngine(jcfg, pj, slots=slots, max_len=48), R.engine.Request,
                prompts, n_new)
    engine = ServeEngine(cfg, pt, slots=slots, max_len=48, device="cpu")
    rt = _serve(engine, Request, prompts, n_new)
    for a, b in zip(rt, rj):
        assert a.done and len(a.output) == n_new
        assert a.output == b.output
    assert engine.last_stats["requests_completed"] == len(lens)
    assert engine.last_stats["tokens_generated"] == len(lens) * n_new


def test_pruned_compressed_serving_equals_reference(R, model):
    jcfg, cfg, pj, pt = model
    ppj, _ = R.apply.prune_params(
        pj, R.flexblock.FlexBlockSpec((R.flexblock.FullBlock(16, 16, 0.5),)), keys=KEYS)
    ppt, mt = prune_params(pt, FlexBlockSpec((FullBlock(16, 16, 0.5),)), keys=KEYS,
                           device="cpu")
    cp = compress_params(ppt, mt, 16, 16)
    prompts = _prompts(21, (7, 12, 4), cfg.vocab_size)
    rj = _serve(R.engine.ServeEngine(jcfg, ppj, slots=2, max_len=48), R.engine.Request,
                prompts, 5)
    rt = _serve(ServeEngine(cfg, cp, slots=2, max_len=48, device="cpu"), Request, prompts, 5)
    assert [r.output for r in rt] == [r.output for r in rj]


def test_queue_full_matches_reference(R, model):
    jcfg, cfg, pj, pt = model
    prompts = _prompts(7, (4, 4, 4), cfg.vocab_size)
    outcomes = []
    for eng_cls, req_cls, params, kw in [(R.engine.ServeEngine, R.engine.Request, pj, {}),
                                         (ServeEngine, Request, pt, {"device": "cpu"})]:
        engine = eng_cls(jcfg if eng_cls is R.engine.ServeEngine else cfg, params, slots=1,
                         max_len=48, max_queue=2, **kw)
        reqs = [req_cls(prompt=p, max_new_tokens=3) for p in prompts]
        admitted = [engine.submit(r) for r in reqs]
        depth = engine.metrics.queue_depth
        engine.run()
        snap = engine.stats_snapshot()
        outcomes.append((admitted, depth, [r.reject_reason for r in reqs],
                         [r.output for r in reqs], [r.done for r in reqs],
                         snap["failures"], snap["requests"]))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0] == [True, True, False] and outcomes[1][2][2] == "queue_full"


def test_deadlines_match_reference(R, model):
    jcfg, cfg, pj, pt = model
    p_ok, p_late, p_cut = _prompts(8, (4, 4, 4), cfg.vocab_size)
    outcomes = []
    for eng_cls, req_cls, params, c, kw in [(R.engine.ServeEngine, R.engine.Request, pj, jcfg, {}),
                                            (ServeEngine, Request, pt, cfg, {"device": "cpu"})]:
        engine = eng_cls(c, params, slots=1, max_len=48, **kw)
        ok = req_cls(prompt=p_ok, max_new_tokens=3)
        late = req_cls(prompt=p_late, max_new_tokens=3, deadline_s=0.0)
        engine.submit(ok)
        engine.submit(late)
        engine.run()
        cut = req_cls(prompt=p_cut, max_new_tokens=20, deadline_s=5.0)
        engine.submit(cut)
        engine.step()                        # prefill + first decode step
        cut.submit_t -= 10.0                 # the deadline lapses mid-decode
        engine.step()
        engine.run()
        outcomes.append(([(r.done, r.reject_reason, r.output) for r in (ok, late, cut)],
                         engine.stats_snapshot()["failures"],
                         engine.stats_snapshot()["requests"]))
    assert outcomes[0] == outcomes[1]
    (ok, late, cut), failures, _ = outcomes[1]
    assert ok[0] and late == (False, "deadline", []) and cut[1] == "deadline" and len(cut[2]) == 3
    assert failures == {"rejected": 0, "expired": 2}


def test_metrics_accumulate_across_runs(model):
    _, cfg, _, pt = model
    engine = ServeEngine(cfg, pt, slots=2, max_len=48, device="cpu")
    _serve(engine, Request, _prompts(3, (4, 4, 4), cfg.vocab_size), 4)
    first = dict(engine.last_stats)
    _serve(engine, Request, _prompts(4, (4, 4), cfg.vocab_size), 3)
    snap = engine.stats_snapshot()
    assert first["tokens_generated"] == 12 and engine.last_stats["tokens_generated"] == 6
    assert snap["requests"] == {"submitted": 5, "completed": 5, "queue_depth": 0}
    assert snap["steps"] == first["steps"] + engine.last_stats["steps"]
    assert snap["ttft_s"]["count"] == 5 and snap["tokens_per_s"] > 0
    assert "serve.requests submitted=5 completed=5" in engine.stats_text()


def test_prompt_too_long_raises(model):
    _, cfg, _, pt = model
    engine = ServeEngine(cfg, pt, slots=1, max_len=8, device="cpu")
    engine.submit(Request(prompt=np.zeros(8, np.int32)))
    with pytest.raises(ValueError, match="max_len"):
        engine.run()


def test_engine_without_device_raises_on_cpu_host(monkeypatch, model):
    _, cfg, _, pt = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, pt, slots=1, max_len=16)
