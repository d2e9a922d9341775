"""PyTorch port, prefix-LM: paligemma-3b ≡ the JAX package on the same
numpy-made inputs.

The reduced config (2 layers, MQA, tied embeddings, a prefix of 8 stub
patch embeddings) holds the prefix term of the attention mask (against
the reference's generic and tiled paths), the entry points with a prefix
and decode after it, pruned execution, and the engine serving text
alone, as the reference's engine serves it.  Tolerances are those of
tests/test_torch_models.py: 2e-5 on a layer, 2e-4 on logits.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _jax_reference
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.layers import IntraBlockLinear
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.sparsity import apply as TA

LOGIT_TOL = 2e-4
LAYER_TOL = 2e-5
KEYS = ("wq", "wk", "wv", "w_gate", "w_up", "w_down")
ARCH = "paligemma-3b"


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def np_params(R, jcfg, seed: int):
    """Reference-layout weights from numpy (norm scales 0.1), tied."""
    rng = np.random.default_rng(seed)
    d, L = jcfg.d_model, jcfg.n_layers

    def draw(shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    layers = {}
    for name, shp in sorted(R.transformer._layer_shapes(jcfg).items()):
        if name.startswith(("ln", "post_ln")) or name.endswith("_norm"):
            layers[name] = draw((L,) + shp, 0.1)
        else:
            fan_in = d if name in ("wq", "wk", "wv") else math.prod(shp[:-1])
            layers[name] = draw((L,) + shp, 1.0 / math.sqrt(fan_in))
    assert jcfg.tie_embeddings
    return {"embed": draw((jcfg.vocab_size, d), 1.0 / math.sqrt(d)),
            "final_norm": draw((d,), 0.1), "layers": layers}


def both(tree):
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu")


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


@pytest.fixture(scope="module")
def model(R):
    jcfg = R.configs.get_config(ARCH).reduced()
    pj, pt = both(np_params(R, jcfg, 0))
    return jcfg, port_cfg(jcfg), pj, pt


def patches(cfg, B: int, seed: int) -> np.ndarray:
    """Stub prefix (B, prefix_len, d), std 1/sqrt(d) as the chip run draws it."""
    return (np.random.default_rng(seed).normal(size=(B, cfg.prefix_len, cfg.d_model))
            / math.sqrt(cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# Config and init
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference(R):
    jcfg = R.configs.get_config(ARCH)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(ARCH).reduced()) == dataclasses.asdict(jcfg.reduced())
    cfg = get_config(ARCH)
    assert (cfg.prefix_len, cfg.n_kv_heads, cfg.head_dim, cfg.tie_embeddings) == \
        (256, 1, 256, True)
    assert cfg.reduced().prefix_len == 8


def test_init_leaf_shapes_match_reference(R, model):
    jcfg, cfg, _, _ = model
    p = TT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    ref = jax.eval_shape(lambda: R.transformer.init_params(jcfg, jax.random.PRNGKey(0),
                                                           dtype=jnp.float32))
    assert jax.tree.map(lambda a: tuple(a.shape), ref) == \
        jax.tree.map(lambda t: tuple(t.shape), p)
    assert "lm_head" not in p


# ---------------------------------------------------------------------------
# The prefix term of the mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # S, prefix, causal, window, chunk: the reference's path
    (40, 8, True, None, 1024),     # generic scan (S <= chunk)
    (40, 8, True, None, 16),       # statically tiled: 3 q tiles, the prefix in tile 0
    (40, 20, True, None, 16),      # tiled, the prefix across two kv tiles
    (40, 8, False, None, 16),      # no causal term: no prefix term either
    (40, 8, True, 12, 1024),       # with a window, generic scan
])
def test_chunked_attention_prefix_matches_reference(R, case):
    S, prefix, causal, window, chunk = case
    rng = np.random.default_rng(1)
    B, Hq, Hkv, hd = 2, 4, 1, 16
    q = rng.normal(size=(B, S, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, prefix=prefix, chunk=chunk)
    want = R.layers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = TL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               **kw)
    close(got, want, LAYER_TOL)
    plain = TL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 **dict(kw, prefix=0))
    if causal:
        assert (plain - got).abs().max() > 1e-2
    else:
        assert torch.equal(plain, got)


def test_prefix_changes_exactly_the_rows_before_its_last():
    """Row i < P - 1 sees keys up to P - 1 with the prefix and up to i
    without; row P - 1 sees keys 0..P-1 either way, and so does every later
    row (with the same bits)."""
    rng = np.random.default_rng(2)
    P, S = 8, 30
    q, k, v = (torch.from_numpy(rng.normal(size=(1, S, h, 16)).astype(np.float32))
               for h in (4, 1, 1))
    a = TL.chunked_attention(q, k, v, prefix=P)
    b = TL.chunked_attention(q, k, v, prefix=0)
    differ = (a != b).flatten(2).any(dim=2)[0]
    assert differ.tolist() == [True] * (P - 1) + [False] * (S - P + 1)


def test_attention_block_with_prefix_matches_reference_and_skips_flash(R, model, monkeypatch):
    """Layer 0 with a prefix: the reference's attention_block on the same
    input, and the route is chunked_attention (the flash contract has no
    prefix-LM), chosen before any launch; without a prefix it is flash."""
    jcfg, cfg, pj, pt = model
    calls = []
    real = TL.ops.flash_attention
    monkeypatch.setattr(TL.ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rng = np.random.default_rng(3)
    B, S = 2, 20
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    lpj = {k: v[0] for k, v in pj["layers"].items()}
    lpt = {k: v[0] for k, v in pt["layers"].items()}
    yj, _ = R.layers.attention_block(jnp.asarray(x), lpj, jcfg, positions=jnp.asarray(pos),
                                     prefix=8)
    yt, _ = TL.attention_block(torch.from_numpy(x), lpt, cfg, positions=torch.from_numpy(pos),
                               prefix=8)
    close(yt, yj, LAYER_TOL)
    assert calls == []
    TL.attention_block(torch.from_numpy(x), lpt, cfg, positions=torch.from_numpy(pos))
    assert calls == [1]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def test_forward_prefill_decode_match_reference(R, model):
    """With a prefix of 8: forward's logits over all P + S positions,
    prefill's last logits, k/v and ``pos`` (P + S), and two decode steps
    (a scalar position, then per-slot positions) on caches with headroom."""
    jcfg, cfg, pj, pt = model
    rng = np.random.default_rng(4)
    B, S, pad = 2, 9, 4
    P = cfg.prefix_len
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 2)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    pre = patches(cfg, B, 5)
    pjx, ptx = jnp.asarray(pre), torch.from_numpy(pre)

    lt = TT.forward(pt, tt, cfg, prefix_embed=ptx)
    assert tuple(lt.shape) == (B, P + S + 2, cfg.vocab_size)
    close(lt, R.transformer.forward(pj, jnp.asarray(toks), jcfg, prefix_embed=pjx), LOGIT_TOL)

    lj, cj = R.transformer.prefill(pj, jnp.asarray(toks[:, :S]), jcfg, prefix_embed=pjx)
    lt, ct = TT.prefill(pt, tt[:, :S], cfg, prefix_embed=ptx)
    close(lt, lj, LOGIT_TOL)
    close(ct["k"], cj["k"], LAYER_TOL)
    close(ct["v"], cj["v"], LAYER_TOL)
    assert int(ct["pos"]) == int(cj["pos"]) == P + S

    cj = dict(cj, **{k: jnp.pad(cj[k], ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))
                     for k in ("k", "v")})
    ct = dict(ct, **{k: torch.nn.functional.pad(ct[k], (0, 0, 0, 0, 0, pad))
                     for k in ("k", "v")})
    for step, posv in enumerate((None, np.array([P + S + 1, P + S], np.int32))):
        if posv is not None:
            cj, ct = dict(cj, pos=jnp.asarray(posv)), dict(ct, pos=torch.from_numpy(posv))
        nxt = toks[:, S + step]
        dj, cj = R.transformer.decode_step(pj, jnp.asarray(nxt), jcfg, cj)
        dt, ct = TT.decode_step(pt, torch.from_numpy(nxt).long(), cfg, ct)
        close(dt, dj, LOGIT_TOL)
        close(ct["k"], cj["k"], LAYER_TOL)


def test_decode_after_prefix_prefill_equals_forward(model):
    """decode_step has no prefix term: every decode query sits at a
    position >= P, where the causal mask already shows the whole prefix.
    Teacher-forced decode after a prefill with a prefix ≡ forward with the
    same prefix at those positions; a decode step that wrongly gave the
    prefix's own rows the decode query's view would not reach this."""
    _, cfg, _, pt = model
    rng = np.random.default_rng(6)
    B, S, n = 2, 7, 5
    P = cfg.prefix_len
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S + n))).long()
    pre = torch.from_numpy(patches(cfg, B, 7))
    full = TT.forward(pt, toks, cfg, prefix_embed=pre)
    _, cache = TT.prefill(pt, toks[:, :S], cfg, prefix_embed=pre)
    for key in ("k", "v"):
        cache[key] = torch.nn.functional.pad(cache[key], (0, 0, 0, 0, 0, n))
    for t in range(S, S + n):
        step, cache = TT.decode_step(pt, toks[:, t], cfg, cache)
        torch.testing.assert_close(step, full[:, P + t], atol=1e-4, rtol=0)
    # the prefix mattered: without it the same tokens decode otherwise
    plain = TT.forward(pt, toks, cfg)
    assert (plain[:, S:] - full[:, P + S:]).abs().max() > 1e-2


# ---------------------------------------------------------------------------
# Pruned execution and serving
# ---------------------------------------------------------------------------

def _prune_both(R, pj, pt):
    ppj, mj = R.apply.prune_params(
        pj, R.flexblock.FlexBlockSpec((R.flexblock.IntraBlock(4, 1, 0.5),)), keys=KEYS,
        align_cols=True)
    ppt, mt = TA.prune_params(pt, FlexBlockSpec((IntraBlock(4, 1, 0.5),)), keys=KEYS,
                              align_cols=True, device="cpu")
    for key in KEYS:
        np.testing.assert_array_equal(mt["layers"][key].numpy(),
                                      np.asarray(mj["layers"][key]).astype(bool))
    return ppj, TA.compress_params(ppt, mt, m=4)


def test_prune_compress_forward_with_prefix_matches_reference(R, model):
    jcfg, cfg, pj, pt = model
    ppj, cp = _prune_both(R, pj, pt)
    assert all(isinstance(cp["layers"][k], IntraBlockLinear) for k in KEYS)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    pre = patches(cfg, 2, 9)
    close(TT.forward(cp, torch.from_numpy(toks).long(), cfg,
                     prefix_embed=torch.from_numpy(pre)),
          R.transformer.forward(ppj, jnp.asarray(toks), jcfg, prefix_embed=jnp.asarray(pre)),
          LOGIT_TOL)
    lj, _ = R.transformer.prefill(ppj, jnp.asarray(toks), jcfg, prefix_embed=jnp.asarray(pre))
    lt, _ = TT.prefill(cp, torch.from_numpy(toks).long(), cfg,
                       prefix_embed=torch.from_numpy(pre))
    close(lt, lj, LOGIT_TOL)


def test_engine_serves_text_alone_as_the_reference(R, model):
    """Neither engine takes a prefix: both serve paligemma's decoder on
    text prompts, pruned and compressed, with the same greedy tokens."""
    jcfg, cfg, pj, pt = model
    ppj, cp = _prune_both(R, pj, pt)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (30, 9, 21)]

    def serve(engine, req_cls):
        reqs = [req_cls(prompt=p, max_new_tokens=5) for p in prompts]
        for r in reqs:
            engine.submit(r)
        engine.run()
        return reqs

    with R.active():
        rj = serve(R.engine.ServeEngine(jcfg, ppj, slots=2, max_len=48), R.engine.Request)
    rt = serve(ServeEngine(cfg, cp, slots=2, max_len=48, device="cpu"), Request)
    assert all(r.done and len(r.output) == 5 for r in rt)
    assert [r.output for r in rt] == [r.output for r in rj]
