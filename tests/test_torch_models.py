"""PyTorch port, dense decoder: layers and entry points ≡ the JAX package
on the same numpy-made weights, decode ≡ forward, and the device rules.

Weights and inputs are drawn with numpy from a seed (norm scales too, so
``1 + scale`` is exercised) and handed to both packages in f32.  Logits
are held to 2e-4: both sides compute in f32 but sum in other orders.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _jax_reference
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

LOGIT_TOL = 2e-4
LAYER_TOL = 2e-5


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def np_params(R, jcfg, seed: int):
    """Reference-layout weights from numpy: normal with the init's stds."""
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
    p = {"embed": draw((jcfg.vocab_size, d), 1.0 / math.sqrt(d)),
         "final_norm": draw((d,), 0.1), "layers": layers}
    if not jcfg.tie_embeddings:
        p["lm_head"] = draw((d, jcfg.vocab_size), 1.0 / math.sqrt(d))
    return p


def both(tree):
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu")


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


@pytest.fixture(scope="module")
def llama(R):
    jcfg = R.configs.get_config("llama3-8b").reduced()
    pj, pt = both(np_params(R, jcfg, 0))
    return jcfg, port_cfg(jcfg), pj, pt


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference(R):
    """llama3-8b's copy equals the reference's; the port's registry holds
    exactly the reference's archs, and an unknown name still raises."""
    jcfg = R.configs.get_config("llama3-8b")
    assert dataclasses.asdict(get_config("llama3-8b")) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config("llama3-8b").reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert sorted(list_archs()) == sorted(R.configs.list_archs())
    with pytest.raises(KeyError):
        get_config("whisper-large")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match(R):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
          R.layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), 1e-6)
    close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0),
          R.layers.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0), 1e-5)


@pytest.mark.parametrize("case", [
    # Sq, Skv, q_offset, kv_len, window, causal, chunk
    (1, 24, [5, 17], None, None, True, 24),        # decode over the whole cache
    (1, 24, [5, 17], None, 4, True, 24),           # sliding window
    (7, 40, 3, [20, 40], 8, True, 16),             # scalar offset, (B,) kv_len, padding
    (6, 32, 0, None, None, False, 16),             # bidirectional
])
def test_chunked_attention_generic_path_matches(R, case):
    Sq, Skv, q_offset, kv_len, window, causal, chunk = case
    rng = np.random.default_rng(2)
    B, Hq, Hkv, hd = 2, 4, 2, 16
    q = rng.normal(size=(B, Sq, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32)

    def arg(a, mod):
        return a if a is None or isinstance(a, int) else mod.asarray(np.asarray(a, np.int32))

    want = R.layers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=arg(window, jnp), q_offset=arg(q_offset, jnp), kv_len=arg(kv_len, jnp),
        chunk=chunk)
    got = TL.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        window=arg(window, torch), q_offset=arg(q_offset, torch), kv_len=arg(kv_len, torch),
        chunk=chunk)
    close(got, want, LAYER_TOL)


def test_attention_and_mlp_blocks_match(R, llama):
    jcfg, cfg, pj, pt = llama
    rng = np.random.default_rng(3)
    B, S, Smax = 2, 9, 16
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    lpj = {k: v[0] for k, v in pj["layers"].items()}
    lpt = {k: v[0] for k, v in pt["layers"].items()}
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    yj, (kj, vj) = R.layers.attention_block(jnp.asarray(x), lpj, jcfg, positions=jnp.asarray(pos))
    yt, (kt, vt) = TL.attention_block(torch.from_numpy(x), lpt, cfg,
                                      positions=torch.from_numpy(pos))
    close(yt, yj, LAYER_TOL)
    close(kt, kj, LAYER_TOL)
    close(vt, vj, LAYER_TOL)
    close(TL.mlp_block(torch.from_numpy(x), lpt, cfg), R.layers.mlp_block(jnp.asarray(x), lpj, jcfg),
          LAYER_TOL)

    # decode: one token per row at its own cache position, cache written in place
    Kc = rng.normal(size=(B, Smax, cfg.n_kv_heads, 16)).astype(np.float32)
    Vc = rng.normal(size=(B, Smax, cfg.n_kv_heads, 16)).astype(np.float32)
    x1 = x[:, :1]
    cl = np.array([4, 11], np.int32)
    yj, (Kj, Vj) = R.layers.attention_block(
        jnp.asarray(x1), lpj, jcfg, positions=jnp.asarray(cl[:, None]),
        cache_kv=(jnp.asarray(Kc), jnp.asarray(Vc)), cache_len=jnp.asarray(cl))
    Kt, Vt = torch.from_numpy(Kc.copy()), torch.from_numpy(Vc.copy())
    yt, (Kt2, Vt2) = TL.attention_block(
        torch.from_numpy(x1), lpt, cfg, positions=torch.from_numpy(cl[:, None]),
        cache_kv=(Kt, Vt), cache_len=torch.from_numpy(cl))
    assert Kt2 is Kt
    close(yt, yj, LAYER_TOL)
    close(Kt, Kj, LAYER_TOL)
    close(Vt, Vj, LAYER_TOL)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-4b", "gemma-7b"])
def test_forward_prefill_decode_match_reference(R, arch):
    jcfg = R.configs.get_config(arch).reduced()
    cfg = port_cfg(jcfg)
    pj, pt = both(np_params(R, jcfg, 4))
    rng = np.random.default_rng(5)
    B, S, pad = 2, 13, 4
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    tt = torch.from_numpy(toks).long()

    close(TT.forward(pt, tt, cfg), R.transformer.forward(pj, jnp.asarray(toks), jcfg), LOGIT_TOL)

    lj, cj = R.transformer.prefill(pj, jnp.asarray(toks[:, :S]), jcfg)
    lt, ct = TT.prefill(pt, tt[:, :S], cfg)
    close(lt, lj, LOGIT_TOL)
    close(ct["k"], cj["k"], LAYER_TOL)
    assert int(ct["pos"]) == int(cj["pos"]) == S

    # per-row positions: row 1 decodes one slot earlier than row 0
    posv = np.array([S, S - 1], np.int32)
    cj = {"pos": jnp.asarray(posv),
          "k": jnp.pad(cj["k"], ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0))),
          "v": jnp.pad(cj["v"], ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))}
    ct = {"pos": torch.from_numpy(posv),
          "k": torch.nn.functional.pad(ct["k"], (0, 0, 0, 0, 0, pad)),
          "v": torch.nn.functional.pad(ct["v"], (0, 0, 0, 0, 0, pad))}
    nxt = toks[:, S]
    dj, cj2 = R.transformer.decode_step(pj, jnp.asarray(nxt), jcfg, cj)
    dt, ct2 = TT.decode_step(pt, torch.from_numpy(nxt).long(), cfg, ct)
    close(dt, dj, LOGIT_TOL)
    close(ct2["k"], cj2["k"], LAYER_TOL)
    assert ct2["pos"].tolist() == (posv + 1).tolist()


def test_decode_matches_forward(R, llama):
    _, cfg, _, pt = llama
    rng = np.random.default_rng(6)
    B, S = 2, 12
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S + 1))).long()
    full = TT.forward(pt, toks, cfg)
    _, cache = TT.prefill(pt, toks[:, :S], cfg)
    for key in ("k", "v"):
        cache[key] = torch.nn.functional.pad(cache[key], (0, 0, 0, 0, 0, 4))
    step, _ = TT.decode_step(pt, toks[:, S], cfg, cache)
    torch.testing.assert_close(step, full[:, S], atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["llama3-8b", "hymba-1.5b"])
def test_decode_on_the_cache_prefill_returned_matches_reference(R, arch):
    """``prefill`` returns k/v exactly S long, so the next ``decode_step``
    writes past the end.  The reference clamps a scalar write's start
    (``dynamic_update_slice``: the last slot is overwritten) and drops a
    per-slot write past the end (JAX's scatter); the port does the same,
    in place and without reading the position back.  Two steps on the
    returned cache: a scalar position, then per-slot positions with slot 1
    past the end.  Logits, k/v (and the SSM state) and ``pos`` against
    the reference's."""
    jcfg = R.configs.get_config(arch).reduced()
    cfg = port_cfg(jcfg)
    pj, pt = both(np_params(R, jcfg, 9))
    rng = np.random.default_rng(10)
    B, S = 2, 8
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 2)).astype(np.int32)
    _, cj = R.transformer.prefill(pj, jnp.asarray(toks[:, :S]), jcfg)
    _, ct = TT.prefill(pt, torch.from_numpy(toks[:, :S]).long(), cfg)
    assert ct["k"].shape[2] == S and int(ct["pos"]) == S
    k_before = ct["k"].clone()

    # scalar position S: past the end of an S-long cache
    dj, cj = R.transformer.decode_step(pj, jnp.asarray(toks[:, S]), jcfg, cj)
    dt, ct = TT.decode_step(pt, torch.from_numpy(toks[:, S]).long(), cfg, ct)
    close(dt, dj, LOGIT_TOL)
    for key in ("k", "v", "ssm"):
        if key in cj:
            close(ct[key], cj[key], LAYER_TOL)
    assert int(ct["pos"]) == int(cj["pos"]) == S + 1
    # the planted case: the write lands (the last slot), where an empty
    # slice past the end would leave the cache as prefill returned it
    assert not torch.equal(ct["k"][:, :, S - 1], k_before[:, :, S - 1])
    assert torch.equal(ct["k"][:, :, :S - 1], k_before[:, :, :S - 1])

    # per-slot positions: slot 0 inside the cache, slot 1 past its end
    posv = np.array([S - 3, S + 1], np.int32)
    cj = dict(cj, pos=jnp.asarray(posv))
    ct = dict(ct, pos=torch.from_numpy(posv))
    k_mid = ct["k"].clone()
    dj, cj = R.transformer.decode_step(pj, jnp.asarray(toks[:, S + 1]), jcfg, cj)
    dt, ct = TT.decode_step(pt, torch.from_numpy(toks[:, S + 1]).long(), cfg, ct)
    close(dt, dj, LOGIT_TOL)
    for key in ("k", "v", "ssm"):
        if key in cj:
            close(ct[key], cj[key], LAYER_TOL)
    assert ct["pos"].tolist() == np.asarray(cj["pos"]).tolist() == (posv + 1).tolist()
    assert torch.equal(ct["k"][:, 1], k_mid[:, 1])          # slot 1's write dropped
    assert not torch.equal(ct["k"][:, 0, S - 3], k_mid[:, 0, S - 3])


def test_cache_write_has_no_host_read_back():
    """The scalar write runs on a position tensor without ``int()``: a
    position whose ``__int__`` raises still writes, clamped."""
    class NoInt(torch.Tensor):
        def __int__(self):
            raise AssertionError("read back to the host")

        def __index__(self):
            raise AssertionError("read back to the host")

    buf = torch.zeros(2, 4, 1, 2)
    TL.write_cache(buf, torch.ones(2, 1, 1, 2), torch.tensor(9).as_subclass(NoInt))
    assert buf[:, :, 0, 0].tolist() == [[0, 0, 0, 1], [0, 0, 0, 1]]
    buf.zero_()
    TL.write_cache(buf, torch.ones(2, 1, 1, 2), torch.tensor([1, 4]))
    assert buf[:, :, 0, 0].tolist() == [[0, 1, 0, 0], [0, 0, 0, 0]]


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma-7b"])
def test_bf16_unembed_gives_f32_products_as_reference(R, arch):
    """bf16 weights still give f32 logits, not bf16-rounded ones."""
    jcfg = R.configs.get_config(arch).reduced()
    cfg = port_cfg(jcfg)
    tree = np_params(R, jcfg, 7)
    pj, pt = both({k: tree[k].astype(jnp.bfloat16)
                   for k in ("embed", "final_norm", "lm_head") if k in tree})
    x = np.random.default_rng(8).normal(size=(2, 3, cfg.d_model)).astype(jnp.bfloat16)
    xt = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    got = TT._unembed(pt, xt, cfg)
    want = torch.from_numpy(np.array(R.transformer._unembed(pj, jnp.asarray(x), jcfg)))
    assert got.dtype == torch.float32
    close(got, want, 1e-5)
    # logits rounded to bf16 before the softcap miss the reference by far more
    w = pt["embed"].T if cfg.tie_embeddings else pt["lm_head"]
    rounded = (TL.rms_norm(xt, pt["final_norm"], cfg.norm_eps) @ w).float()
    if cfg.logit_softcap > 0:
        rounded = cfg.logit_softcap * torch.tanh(rounded / cfg.logit_softcap)
    assert (rounded - want).abs().max() > 1e-3


def test_bf16_forward_stays_near_f32(llama):
    _, cfg, _, pt = llama
    pb = {"layers": {k: v.to(torch.bfloat16) for k, v in pt["layers"].items()},
          **{k: v.to(torch.bfloat16) for k, v in pt.items() if k != "layers"}}
    toks = torch.arange(20).reshape(2, 10)
    lf, lb = TT.forward(pt, toks, cfg), TT.forward(pb, toks, cfg)
    assert lb.dtype == torch.float32 and torch.isfinite(lb).all()
    assert (lb - lf).abs().max() < 0.1 * lf.abs().max()


# ---------------------------------------------------------------------------
# Init, conversion, device rules
# ---------------------------------------------------------------------------

def test_init_params_layout_and_distributions(R, llama):
    jcfg, cfg, _, _ = llama
    ref_p = R.transformer.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    p = TT.init_params(cfg, 3, dtype=torch.float32, device="cpu")
    assert set(p) == set(ref_p) and set(p["layers"]) == set(ref_p["layers"])
    for k, v in ref_p["layers"].items():
        assert tuple(p["layers"][k].shape) == v.shape
    assert not p["layers"]["ln1"].any() and not p["final_norm"].any()
    wd = p["layers"]["w_down"]
    assert abs(float(wd.std()) * math.sqrt(cfg.d_ff) - 1.0) < 0.05
    assert abs(float(p["layers"]["wo"].std()) * math.sqrt(cfg.n_heads * 16) - 1.0) < 0.05
    again = TT.init_params(cfg, 3, dtype=torch.float32, device="cpu")
    assert torch.equal(again["layers"]["wq"], p["layers"]["wq"])
    other = TT.init_params(cfg, 4, dtype=torch.float32, device="cpu")
    assert not torch.equal(other["layers"]["wq"], p["layers"]["wq"])


def test_params_from_jax_keeps_bf16_bits(R, llama):
    jcfg = llama[0]
    pj = R.transformer.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    host = jax.tree.map(np.asarray, pj)
    pt = params_from_jax(host, "cpu")
    w = pt["layers"]["wq"]
    assert w.dtype == torch.bfloat16
    assert w.view(torch.int16).numpy().tobytes() == host["layers"]["wq"].view(np.int16).tobytes()
    masks = params_from_jax({"layers": {"wq": np.ones((2, 3), np.uint8), "ln1": None}}, "cpu")
    assert masks["layers"]["ln1"] is None and masks["layers"]["wq"].dtype == torch.uint8


@pytest.mark.parametrize("arch", ["whisper-medium"])
def test_other_families_raise(R, arch):
    """The encoder-decoder is ported now (its init gives the reference's
    encoder and cross leaves); a family outside those the port covers
    still raises, and so does an encoder-decoder flag on a decoder
    family."""
    cfg = port_cfg(R.configs.get_config(arch).reduced())
    p = TT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    assert {"enc_layers", "enc_final_norm", "enc_cross", "dec_cross"} <= set(p)
    for bad in (dataclasses.replace(cfg, family="video"),
                dataclasses.replace(cfg, family="dense"),
                dataclasses.replace(cfg, attention="none")):
        with pytest.raises(NotImplementedError):
            TT.init_params(bad, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_check_supported_admits_ssm(R, arch):
    """The SSM and hybrid families are ported: init gives the reference's
    leaves, SSM leaves included, and no attention leaf without attention."""
    jcfg = R.configs.get_config(arch).reduced()
    cfg = port_cfg(jcfg)
    TT._check_supported(cfg)
    p = TT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    ref = jax.eval_shape(lambda: R.transformer.init_params(jcfg, jax.random.PRNGKey(0),
                                                           dtype=jnp.float32))
    assert {k: tuple(v.shape) for k, v in p["layers"].items()} == \
        {k: v.shape for k, v in ref["layers"].items()}
    assert {"w_in", "w_out", "conv_w", "dt_bias", "A_log", "D_skip"} <= set(p["layers"])
    assert ("wq" in p["layers"]) == (cfg.attention != "none")


def test_entry_points_raise_without_a_device_on_a_cpu_host(monkeypatch, llama):
    cfg = llama[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_cache(cfg, 2, 16)
