"""PyTorch port, encoder-decoder: whisper-medium ≡ the JAX package on the
same numpy-made inputs.

The reduced config (2 decoder and 2 encoder layers, 16 frames) holds the
encoder stack, the cross k/v, the decoder's cross-attention step and the
entry points to the reference; decode runs on caches with headroom and on
the cache ``prefill`` returns.  The reference's init draws ``enc_cross``
wk and wv from one key, so they are equal there; here every weight is its
own numpy draw, so a swap of cross k and v would show.  Tolerances are
those of tests/test_torch_models.py: 2e-5 on a layer, 2e-4 on logits.
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
from repro_torch.core.flexblock import FlexBlockSpec, FullBlock
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.layers import BlockSparseLinear
from repro_torch.sparsity import apply as TA

LOGIT_TOL = 2e-4
LAYER_TOL = 2e-5
KEYS = ("wq", "wk", "wv", "w_up", "w_down")      # non-gated: no w_gate
ARCH = "whisper-medium"


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def np_params(R, jcfg, seed: int):
    """Reference-layout weights from numpy, the encoder's and the cross
    weights included: normal with the init's stds (norm scales 0.1, so
    ``1 + scale`` is exercised), ``enc_cross`` wk and wv drawn apart."""
    rng = np.random.default_rng(seed)
    d, L = jcfg.d_model, jcfg.n_layers
    hd, Hq, Hkv = jcfg.resolved_head_dim, jcfg.n_heads, jcfg.n_kv_heads

    def draw(shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    def stacked(shapes, n):
        out = {}
        for name, shp in sorted(shapes.items()):
            if name.startswith(("ln", "post_ln")) or name.endswith("_norm"):
                out[name] = draw((n,) + shp, 0.1)
            else:
                fan_in = d if name in ("wq", "wk", "wv") else math.prod(shp[:-1])
                out[name] = draw((n,) + shp, 1.0 / math.sqrt(fan_in))
        return out

    std = 1.0 / math.sqrt(d)
    return {"embed": draw((jcfg.vocab_size, d), std), "final_norm": draw((d,), 0.1),
            "lm_head": draw((d, jcfg.vocab_size), std),
            "layers": stacked(R.transformer._layer_shapes(jcfg), L),
            "enc_layers": stacked(R.transformer._layer_shapes(jcfg, encoder=True),
                                  jcfg.enc_layers),
            "enc_final_norm": draw((d,), 0.1),
            "enc_cross": {"wk": draw((L, d, Hkv, hd), std), "wv": draw((L, d, Hkv, hd), std)},
            "dec_cross": {"wq": draw((L, d, Hq, hd), std), "wo": draw((L, Hq, hd, d), std),
                          "ln": draw((L, d), 0.1)}}


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


def frames(cfg, B: int, Se: int, seed: int) -> np.ndarray:
    """Stub encoder input (B, Se, d), std 1/sqrt(d) as the chip run draws it."""
    return (np.random.default_rng(seed).normal(size=(B, Se, cfg.d_model))
            / math.sqrt(cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# Config and init
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference(R):
    jcfg = R.configs.get_config(ARCH)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(ARCH).reduced()) == dataclasses.asdict(jcfg.reduced())
    cfg = get_config(ARCH)
    assert (cfg.enc_dec, cfg.enc_layers, cfg.enc_seq, cfg.gated_mlp) == (True, 24, 1500, False)


@pytest.mark.parametrize("encoder", [False, True])
def test_layer_shapes_match_reference(R, encoder):
    jcfg = R.configs.get_config(ARCH)
    assert TT._layer_shapes(port_cfg(jcfg), encoder=encoder) == \
        R.transformer._layer_shapes(jcfg, encoder=encoder)


def test_init_leaf_shapes_match_reference_and_cross_wk_wv_differ(R, model):
    """Every leaf of the port's init has the reference init's shape
    (``jax.eval_shape``), with the reference's stds; the reference's
    ``enc_cross`` wk and wv come from one key and are equal, the port's
    are drawn apart."""
    jcfg, cfg, _, _ = model
    p = TT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    ref = jax.eval_shape(lambda: R.transformer.init_params(jcfg, jax.random.PRNGKey(0),
                                                           dtype=jnp.float32))
    assert jax.tree.map(lambda a: tuple(a.shape), ref) == \
        jax.tree.map(lambda t: tuple(t.shape), p)
    assert not torch.equal(p["enc_cross"]["wk"], p["enc_cross"]["wv"])
    assert not p["dec_cross"]["ln"].any() and not p["enc_final_norm"].any()
    big = TT.init_params(dataclasses.replace(cfg, d_model=256, n_layers=4, enc_layers=4), 1,
                         dtype=torch.float32, device="cpu")
    for leaf in (big["enc_cross"]["wk"], big["dec_cross"]["wo"]):
        assert abs(float(leaf.std()) * 16 - 1.0) < 0.05
    rj = R.transformer.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    assert np.array_equal(np.asarray(rj["enc_cross"]["wk"]), np.asarray(rj["enc_cross"]["wv"]))


# ---------------------------------------------------------------------------
# Encoder, cross k/v, the cross-attention step
# ---------------------------------------------------------------------------

def test_encoder_stack_matches_reference(R, model):
    jcfg, cfg, pj, pt = model
    x = frames(cfg, 2, jcfg.enc_seq, 1)
    want = R.transformer._encoder_stack(pj, jnp.asarray(x), jcfg)
    got = TT._encoder_stack(pt, torch.from_numpy(x), cfg)
    close(got, want, LAYER_TOL)


def test_encoder_is_bidirectional(model):
    """Frame 0 of encoder layer 0's output moves when the last frame does."""
    _, cfg, _, pt = model
    x = torch.from_numpy(frames(cfg, 1, 16, 2))
    one = dict(pt, enc_layers={k: v[:1] for k, v in pt["enc_layers"].items()})
    cfg1 = dataclasses.replace(cfg, enc_layers=1)
    a = TT._encoder_stack(one, x, cfg1)
    x2 = x.clone()
    x2[:, -1] += 1.0
    b = TT._encoder_stack(one, x2, cfg1)
    assert (a[:, 0] - b[:, 0]).abs().max() > 1e-4


def test_cross_kv_matches_reference(R, model):
    jcfg, cfg, pj, pt = model
    enc = frames(cfg, 2, 16, 3)
    kj, vj = R.transformer._cross_kv(pj, jnp.asarray(enc), jcfg)
    kt, vt = TT._cross_kv(pt, torch.from_numpy(enc), cfg)
    assert tuple(kt.shape) == kj.shape == (cfg.n_layers, 2, 16, cfg.n_kv_heads, 16)
    close(kt, kj, LAYER_TOL)
    close(vt, vj, LAYER_TOL)
    assert (kt - vt).abs().max() > 0.1


@pytest.mark.parametrize("Se", [16, 600])
def test_decoder_layer_with_cross_step_matches_reference(R, model, Se):
    """Layer 0 with its cross-attention step; 600 frames take two chunks of
    512, the second padded, as the published 1500 frames take three."""
    jcfg, cfg, pj, pt = model
    rng = np.random.default_rng(4)
    B, S = 2, 9
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(B, Se, cfg.n_kv_heads, 16)).astype(np.float32)
    cv = rng.normal(size=(B, Se, cfg.n_kv_heads, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    cj = {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
          **{k: v[0] for k, v in pj["dec_cross"].items()}}
    ct = {"k": torch.from_numpy(ck), "v": torch.from_numpy(cv),
          **{k: v[0] for k, v in pt["dec_cross"].items()}}
    yj, _ = R.transformer._decoder_layer(
        jnp.asarray(x), {k: v[0] for k, v in pj["layers"].items()}, jcfg,
        positions=jnp.asarray(pos), is_global=jnp.asarray(True), mode="train", cross_slice=cj)
    yt, _ = TT._decoder_layer(torch.from_numpy(x), {k: v[0] for k, v in pt["layers"].items()},
                              cfg, positions=torch.from_numpy(pos), cross=ct)
    close(yt, yj, LAYER_TOL)
    # the step reaches the output: swapping k and v moves it
    swapped = dict(ct, k=ct["v"], v=ct["k"])
    ys, _ = TT._decoder_layer(torch.from_numpy(x), {k: v[0] for k, v in pt["layers"].items()},
                              cfg, positions=torch.from_numpy(pos), cross=swapped)
    assert (ys - yt).abs().max() > 1e-2


def test_encoder_and_cross_attention_take_chunked_attention_not_flash(model, monkeypatch):
    """Only the decoder's causal self-attention reaches the flash op (one
    launch per decoder layer); the encoder's bidirectional attention and
    the cross-attention run chunked_attention."""
    _, cfg, _, pt = model
    flash, chunked = [], []
    real_flash, real_chunked = TL.ops.flash_attention, TL.chunked_attention
    monkeypatch.setattr(TL.ops, "flash_attention",
                        lambda *a, **kw: flash.append(a[0].shape) or real_flash(*a, **kw))

    def spy(q, k, v, **kw):
        chunked.append((k.shape[1], kw.get("causal", True), kw.get("chunk", 1024)))
        return real_chunked(q, k, v, **kw)

    monkeypatch.setattr(TL, "chunked_attention", spy)
    monkeypatch.setattr(TT, "chunked_attention", spy)
    TT.forward(pt, torch.arange(10).reshape(1, 10), cfg,
               enc_embed=torch.from_numpy(frames(cfg, 1, 16, 5)))
    assert len(flash) == cfg.n_layers
    assert chunked == [(16, False, 1024)] * cfg.enc_layers + [(16, False, 512)] * cfg.n_layers


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def test_forward_prefill_decode_match_reference(R, model):
    jcfg, cfg, pj, pt = model
    rng = np.random.default_rng(6)
    B, S, pad = 2, 11, 4
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 2)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    enc = frames(cfg, B, jcfg.enc_seq, 7)
    ej, et = jnp.asarray(enc), torch.from_numpy(enc)

    close(TT.forward(pt, tt, cfg, enc_embed=et),
          R.transformer.forward(pj, jnp.asarray(toks), jcfg, enc_embed=ej), LOGIT_TOL)

    lj, cj = R.transformer.prefill(pj, jnp.asarray(toks[:, :S]), jcfg, enc_embed=ej)
    lt, ct = TT.prefill(pt, tt[:, :S], cfg, enc_embed=et)
    close(lt, lj, LOGIT_TOL)
    assert set(ct) == set(cj) == {"pos", "k", "v", "cross_k", "cross_v"}
    for key in ("k", "v", "cross_k", "cross_v"):
        close(ct[key], cj[key], LAYER_TOL)
    assert int(ct["pos"]) == int(cj["pos"]) == S

    # headroom, then a scalar step and a per-slot step (row 1 one slot back)
    cj = dict(cj, **{k: jnp.pad(cj[k], ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))
                     for k in ("k", "v")})
    ct = dict(ct, **{k: torch.nn.functional.pad(ct[k], (0, 0, 0, 0, 0, pad))
                     for k in ("k", "v")})
    for step, posv in enumerate((None, np.array([S + 1, S], np.int32))):
        if posv is not None:
            cj, ct = dict(cj, pos=jnp.asarray(posv)), dict(ct, pos=torch.from_numpy(posv))
        nxt = toks[:, S + step]
        dj, cj = R.transformer.decode_step(pj, jnp.asarray(nxt), jcfg, cj)
        dt, ct = TT.decode_step(pt, torch.from_numpy(nxt).long(), cfg, ct)
        close(dt, dj, LOGIT_TOL)
        close(ct["k"], cj["k"], LAYER_TOL)
    assert ct["pos"].tolist() == [S + 2, S + 1]


def test_decode_after_prefill_equals_forward(model):
    """Teacher-forced decode on a cache with headroom ≡ forward's logits at
    the same positions; the cross k/v in the cache are read, not rebuilt."""
    _, cfg, _, pt = model
    rng = np.random.default_rng(8)
    B, S, n = 2, 10, 4
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S + n))).long()
    enc = torch.from_numpy(frames(cfg, B, 16, 9))
    full = TT.forward(pt, toks, cfg, enc_embed=enc)
    _, cache = TT.prefill(pt, toks[:, :S], cfg, enc_embed=enc)
    pool = TT.init_cache(cfg, B, S + n, torch.float32, enc_seq=16, device="cpu")
    for key in ("k", "v"):
        pool[key][:, :, :S] = cache[key]
    for key in ("cross_k", "cross_v"):
        pool[key].copy_(cache[key])
    pool["pos"] = cache["pos"]
    for t in range(S, S + n):
        step, pool = TT.decode_step(pt, toks[:, t], cfg, pool)
        torch.testing.assert_close(step, full[:, t], atol=1e-4, rtol=0)
    # the cross cache matters: swapped, the same step moves
    pool = dict(pool, pos=torch.tensor(S + n - 1), cross_k=pool["cross_v"],
                cross_v=pool["cross_k"])
    step, _ = TT.decode_step(pt, toks[:, S + n - 1], cfg, pool)
    assert (step - full[:, S + n - 1]).abs().max() > 1e-2


def test_init_cache_matches_reference(R, model):
    jcfg, cfg, _, _ = model
    for enc_seq in (0, 40):
        cj = R.transformer.init_cache(jcfg, 3, 20, jnp.float32, enc_seq=enc_seq)
        ct = TT.init_cache(cfg, 3, 20, torch.float32, enc_seq=enc_seq, device="cpu")
        assert {k: tuple(v.shape) for k, v in ct.items()} == \
            {k: v.shape for k, v in cj.items()}
        assert not any(v.any() for v in ct.values())


def test_entry_points_need_enc_embed(R, model):
    """Without ``enc_embed`` the port's forward and prefill raise
    ValueError; the reference's forward does too, its prefill fails with an
    AttributeError on the missing array."""
    jcfg, cfg, pj, pt = model
    toks = np.arange(6, dtype=np.int32).reshape(1, 6)
    for fn in (TT.forward, TT.prefill):
        with pytest.raises(ValueError, match="enc_embed"):
            fn(pt, torch.from_numpy(toks).long(), cfg)
    with pytest.raises(ValueError):
        R.transformer.forward(pj, jnp.asarray(toks), jcfg)
    with pytest.raises(AttributeError):
        R.transformer.prefill(pj, jnp.asarray(toks), jcfg)


# ---------------------------------------------------------------------------
# Pruned execution
# ---------------------------------------------------------------------------

def test_prune_compress_forward_matches_reference(R, model):
    """FullBlock(16, 16, 0.5) on the decoder's five projections (the
    reference's prune_params walks ``layers`` only, so the encoder and the
    cross weights stay dense in both): the masks equal the reference's,
    each projection compresses, and the compressed forward, prefill and a
    decode step equal the reference's on its masked model."""
    jcfg, cfg, pj, pt = model
    spec_j = R.flexblock.FlexBlockSpec((R.flexblock.FullBlock(16, 16, 0.5),))
    ppj, mj = R.apply.prune_params(pj, spec_j, keys=KEYS)
    ppt, mt = TA.prune_params(pt, FlexBlockSpec((FullBlock(16, 16, 0.5),)), keys=KEYS,
                              device="cpu")
    assert set(mj) == set(mt) == {"layers"}
    for key in KEYS:
        np.testing.assert_array_equal(mt["layers"][key].numpy(),
                                      np.asarray(mj["layers"][key]).astype(bool))
    cp = TA.compress_params(ppt, mt, 16, 16)
    assert all(isinstance(cp["layers"][k], BlockSparseLinear) for k in KEYS)
    assert cp["enc_layers"] is pt["enc_layers"] and cp["enc_cross"] is pt["enc_cross"]
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    enc = frames(cfg, 2, 16, 11)
    close(TT.forward(cp, torch.from_numpy(toks).long(), cfg, enc_embed=torch.from_numpy(enc)),
          R.transformer.forward(ppj, jnp.asarray(toks), jcfg, enc_embed=jnp.asarray(enc)),
          LOGIT_TOL)
    lj, cj = R.transformer.prefill(ppj, jnp.asarray(toks[:, :11]), jcfg,
                                   enc_embed=jnp.asarray(enc))
    lt, ct = TT.prefill(cp, torch.from_numpy(toks[:, :11]).long(), cfg,
                        enc_embed=torch.from_numpy(enc))
    close(lt, lj, LOGIT_TOL)
    cj = dict(cj, **{k: jnp.pad(cj[k], ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))
                     for k in ("k", "v")})
    ct = dict(ct, **{k: torch.nn.functional.pad(ct[k], (0, 0, 0, 0, 0, 1))
                     for k in ("k", "v")})
    dj, _ = R.transformer.decode_step(ppj, jnp.asarray(toks[:, 11]), jcfg, cj)
    dt, _ = TT.decode_step(cp, torch.from_numpy(toks[:, 11]).long(), cfg, ct)
    close(dt, dj, LOGIT_TOL)
