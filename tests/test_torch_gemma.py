"""PyTorch port, gemma family: gemma-7b (global attention, head dim 256,
MHA) and gemma2-9b (alternating local/global attention, attention and
final-logit softcaps, post-norms) ≡ the JAX package on the same
numpy-made inputs.

Reduced configs (2 layers, window 32) hold the layers, the entry points
past the window and the pruned serving path to the reference; one-layer
configs at the published widths hold pruning, compression and conversion
at gemma's shapes (head dim 256, ``wq`` 3584 → 16 × 256 on gemma2).  The
softcaps are checked where they bite: inputs are scaled until the raw
scores and logits exceed the caps, and each such test asserts that they do.
Tolerances are those of tests/test_torch_models.py: 2e-5 on a layer, 2e-4
on logits (both sides compute in f32 but sum in other orders).
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
from repro_torch.core.flexblock import FlexBlockSpec, FullBlock, IntraBlock
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.layers import BlockSparseLinear, IntraBlockLinear
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.sparsity import apply as TA

LOGIT_TOL = 2e-4
LAYER_TOL = 2e-5
KEYS = ("wq", "wk", "wv", "w_gate", "w_up", "w_down")
GEMMA = ("gemma-7b", "gemma2-9b")


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def np_params(R, jcfg, seed: int, *, qk_scale: float = 1.0, embed_scale: float = 1.0):
    """Reference-layout weights from numpy (as tests/test_torch_models.py
    draws them); ``qk_scale`` multiplies wq and wk and ``embed_scale`` the
    (tied) embedding, to push scores and logits past the caps.  The norms
    take out the embedding's scale inside the stack, so logits grow with it
    while the stack's rounding does not."""
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
    for name in ("wq", "wk"):
        layers[name] *= np.float32(qk_scale)
    p = {"embed": draw((jcfg.vocab_size, d), embed_scale / math.sqrt(d)),
         "final_norm": draw((d,), 0.1), "layers": layers}
    if not jcfg.tie_embeddings:
        p["lm_head"] = draw((d, jcfg.vocab_size), 1.0 / math.sqrt(d))
    return p


def both(tree):
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu")


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


def uncapped(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, attn_softcap=0.0, logit_softcap=0.0)


# ---------------------------------------------------------------------------
# Configs and layer flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GEMMA)
def test_config_copy_matches_reference(R, arch):
    jcfg = R.configs.get_config(arch)
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(arch).reduced()) == dataclasses.asdict(jcfg.reduced())


@pytest.mark.parametrize("arch", GEMMA + ("llama3-8b", "hymba-1.5b"))
def test_layer_flags_and_windows_match_reference(R, arch):
    """The port's Python flags equal the reference's traced ones, and each
    layer's window is None exactly where the reference passes its
    all-true stand-in (or no window at all)."""
    jcfg = R.configs.get_config(arch)
    flags = TT.layer_flags(port_cfg(jcfg))
    assert isinstance(flags, tuple) and all(type(f) is bool for f in flags)
    assert flags == tuple(bool(f) for f in np.asarray(R.transformer.layer_flags(jcfg)))
    windows = TT._windows(port_cfg(jcfg))
    if jcfg.attention == "global":
        assert windows == (None,) * jcfg.n_layers
    else:
        assert windows == tuple(None if f else jcfg.window for f in flags)
        assert set(windows) - {None} == {jcfg.window}
    if arch == "gemma2-9b":
        assert windows[:2] == (4096, None) and windows.count(None) == 21


@pytest.mark.parametrize("arch", ["whisper-medium", "paligemma-3b"])
def test_check_supported_still_raises(R, arch):
    """The encoder-decoder and the prefix-LM, which this test once saw
    refused, are admitted and initialise with the reference's leaf shapes
    (every leaf, the encoder's and the cross weights included); the same
    config under a family the port does not cover still raises."""
    jcfg = R.configs.get_config(arch).reduced()
    cfg = port_cfg(jcfg)
    TT._check_supported(cfg)
    p = TT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    ref = jax.eval_shape(lambda: R.transformer.init_params(jcfg, jax.random.PRNGKey(0),
                                                           dtype=jnp.float32))
    assert jax.tree.map(lambda a: tuple(a.shape), ref) == \
        jax.tree.map(lambda t: tuple(t.shape), p)
    for bad in (dataclasses.replace(cfg, family="video"),
                dataclasses.replace(cfg, attention="sliding")):
        with pytest.raises(NotImplementedError):
            TT._check_supported(bad)
        with pytest.raises(NotImplementedError):
            TT.init_params(bad, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_check_supported_admits_ssm(R, arch):
    """The families this test once refused: SSM (no attention, no MLP) and
    hybrid (sliding window) now initialise with the reference's leaves,
    and the window of every hymba layer is its config's."""
    jcfg = R.configs.get_config(arch).reduced()
    cfg = port_cfg(jcfg)
    TT._check_supported(cfg)
    p = TT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    ref = jax.eval_shape(lambda: R.transformer.init_params(jcfg, jax.random.PRNGKey(0),
                                                           dtype=jnp.float32))
    assert set(p["layers"]) == set(ref["layers"])
    assert all(tuple(p["layers"][k].shape) == v.shape for k, v in ref["layers"].items())
    assert ("ln2" in p["layers"]) == (cfg.d_ff > 0)
    if cfg.attention == "sliding":
        assert TT._windows(cfg) == (cfg.window,) * cfg.n_layers


@pytest.mark.parametrize("arch", GEMMA)
def test_check_supported_admits_gemma(R, arch):
    cfg = port_cfg(R.configs.get_config(arch).reduced())
    TT._check_supported(cfg)
    p = TT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    ref = R.transformer.init_params(R.configs.get_config(arch).reduced(),
                                    jax.random.PRNGKey(0), dtype=jnp.float32)
    assert set(p["layers"]) == set(ref["layers"])
    assert all(tuple(p["layers"][k].shape) == v.shape for k, v in ref["layers"].items())


# ---------------------------------------------------------------------------
# Softcap and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap_matches_reference(R, cap):
    x = (np.random.default_rng(1).normal(size=(3, 257)) * 80).astype(np.float32)
    got = TL.softcap(torch.from_numpy(x), cap)
    close(got, R.layers.softcap(jnp.asarray(x), cap), LAYER_TOL)
    if cap:
        assert np.abs(x).max() > 2 * cap and float(got.abs().max()) <= cap
    else:
        assert torch.equal(got, torch.from_numpy(x))


@pytest.mark.parametrize("case", [
    # Sq, Skv, q_offset, kv_len, window, cap, chunk
    (80, 80, 0, None, 32, 50.0, 1024),         # gemma2 local-layer prefill past the window
    (80, 80, 0, None, 32, 50.0, 32),           # the same over 3 chunks, tail padded
    (80, 80, 0, None, None, 50.0, 1024),       # global layer: cap, no window
    (80, 80, 0, None, 32, 0.0, 1024),          # window, no cap
    (1, 96, [40, 90], None, 32, 50.0, 96),     # decode: per-row offsets, one past the window
    (5, 60, 41, [50, 60], 32, 50.0, 16),       # scalar offset, (B,) kv_len
])
def test_chunked_attention_window_and_cap_match_reference(R, case):
    Sq, Skv, q_offset, kv_len, window, cap, chunk = case
    rng = np.random.default_rng(2)
    B, Hq, Hkv, hd = 2, 4, 2, 16
    q = rng.normal(size=(B, Sq, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32)
    if cap:
        q *= np.float32(30.0)                   # raw scores far past the cap
        scores = np.einsum("bqhd,bkhd->bhqk", q[:, :, ::2], k) / math.sqrt(hd)
        assert np.abs(scores).max() > 2 * cap

    def arg(a, mod):
        return a if a is None or isinstance(a, int) else mod.asarray(np.asarray(a, np.int32))

    kw = dict(causal=True, chunk=chunk, attn_cap=cap)
    want = R.layers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=arg(window, jnp),
        q_offset=arg(q_offset, jnp), kv_len=arg(kv_len, jnp), **kw)
    got = TL.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), window=arg(window, torch),
        q_offset=arg(q_offset, torch), kv_len=arg(kv_len, torch), **kw)
    close(got, want, LAYER_TOL)
    # the cap and the window each change the result here
    if cap:
        nocap = TL.chunked_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            window=arg(window, torch), q_offset=arg(q_offset, torch),
            kv_len=arg(kv_len, torch), causal=True, chunk=chunk)
        assert (nocap - got).abs().max() > 1e-2


def test_window_changes_only_rows_past_it():
    """Rows before the window see every earlier key, so the windowed call
    equals the global one there bit for bit; past it they differ."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 80, 4, 16)).astype(np.float32))
               for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    win = TL.chunked_attention(q, k, v, window=32, attn_cap=50.0)
    glob = TL.chunked_attention(q, k, v, window=None, attn_cap=50.0)
    assert torch.equal(win[:, :32], glob[:, :32])
    assert (win[:, 32:] - glob[:, 32:]).abs().amax(dim=(0, 2, 3)).min() > 0


@pytest.mark.parametrize("arch", GEMMA)
def test_attention_block_prefill_and_decode_match_reference(R, arch):
    """Layer 0 of each model (gemma2: a local layer, window 32) in prefill
    past the window and in decode at per-row positions, one past it."""
    jcfg = R.configs.get_config(arch).reduced()
    cfg = port_cfg(jcfg)
    pj, pt = both(np_params(R, jcfg, 0, qk_scale=6.0))
    lpj = {k: v[0] for k, v in pj["layers"].items()}
    lpt = {k: v[0] for k, v in pt["layers"].items()}
    window = TT._windows(cfg)[0]
    jwin = None if window is None else jnp.where(False, R.transformer._BIG_WINDOW, window)
    rng = np.random.default_rng(4)
    B, S, Smax = 2, 70, 96
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    yj, (kj, _) = R.layers.attention_block(jnp.asarray(x), lpj, jcfg,
                                           positions=jnp.asarray(pos), window=jwin)
    yt, (kt, _) = TL.attention_block(torch.from_numpy(x), lpt, cfg,
                                     positions=torch.from_numpy(pos), window=window)
    close(yt, yj, LAYER_TOL)
    close(kt, kj, LAYER_TOL)

    Kc = rng.normal(size=(B, Smax, cfg.n_kv_heads, 16)).astype(np.float32)
    Vc = rng.normal(size=(B, Smax, cfg.n_kv_heads, 16)).astype(np.float32)
    cl = np.array([33, 90], np.int32)
    yj, (Kj, _) = R.layers.attention_block(
        jnp.asarray(x[:, :1]), lpj, jcfg, positions=jnp.asarray(cl[:, None]), window=jwin,
        cache_kv=(jnp.asarray(Kc), jnp.asarray(Vc)), cache_len=jnp.asarray(cl))
    yt, (Kt, _) = TL.attention_block(
        torch.from_numpy(x[:, :1]), lpt, cfg, positions=torch.from_numpy(cl[:, None]),
        window=window, cache_kv=(torch.from_numpy(Kc.copy()), torch.from_numpy(Vc.copy())),
        cache_len=torch.from_numpy(cl))
    close(yt, yj, LAYER_TOL)
    close(Kt, Kj, LAYER_TOL)


def test_softcapped_prefill_takes_chunked_attention_not_flash(monkeypatch):
    """The route is chosen from cfg: gemma2 (attn_softcap 50) never reaches
    the flash op, gemma-7b (no softcap) always does."""
    calls = []
    real = TL.ops.flash_attention
    monkeypatch.setattr(TL.ops, "flash_attention",
                        lambda *a, **kw: calls.append(kw.get("window")) or real(*a, **kw))
    toks = torch.arange(40).reshape(1, 40)
    for arch, want in (("gemma2-9b", []), ("gemma-7b", [None, None])):
        cfg = get_config(arch).reduced()
        calls.clear()
        TT.forward(TT.init_params(cfg, 0, dtype=torch.float32, device="cpu"), toks, cfg)
        assert calls == want, arch


# ---------------------------------------------------------------------------
# Entry points past the window, with the caps reached
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reached", ["below_caps", "attn_cap", "logit_cap"])
def test_gemma2_forward_prefill_decode_past_the_window_match_reference(R, reached):
    """Each softcap where it bites: ``attn_cap`` scales wq/wk until layer
    0's raw scores pass twice the attention cap, ``logit_cap`` scales the
    tied embedding until the raw logits pass twice the final-logit cap.
    (Not both at once: XLA's tanh and torch's differ in their last bits at
    the cap's scale, and saturated scores then carry that past LOGIT_TOL.)"""
    jcfg = R.configs.get_config("gemma2-9b").reduced()
    cfg = port_cfg(jcfg)
    scale = {"below_caps": {}, "attn_cap": {"qk_scale": 6.0},
             "logit_cap": {"embed_scale": 10.0}}[reached]
    # k scales with wk: its absolute tolerance too
    k_tol = LAYER_TOL * scale.get("qk_scale", 1.0)
    pj, pt = both(np_params(R, jcfg, 5, **scale))
    rng = np.random.default_rng(6)
    B, S, pad = 2, 80, 4
    assert S > 2 * cfg.window
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    tt = torch.from_numpy(toks).long()

    got = TT.forward(pt, tt, cfg)
    close(got, R.transformer.forward(pj, jnp.asarray(toks), jcfg), LOGIT_TOL)
    # layer 0's raw scores, as attention_block makes them
    h = TL.rms_norm(pt["embed"][tt], pt["layers"]["ln1"][0])
    positions = torch.arange(S + 1).expand(B, S + 1)
    q, k = (TL.rope(torch.einsum("bsd,dhk->bshk", h, pt["layers"][w][0]), positions,
                    cfg.rope_theta) for w in ("wq", "wk"))
    scores = torch.einsum("bqhd,bkhd->bhqk", q[:, :, ::2], k) / math.sqrt(16)
    raw = TT.forward(pt, tt, uncapped(cfg))
    attn_uncapped = TT.forward(pt, tt, dataclasses.replace(cfg, attn_softcap=0.0))
    assert (scores.abs().max() > 2 * cfg.attn_softcap) == (reached == "attn_cap")
    assert (raw.abs().max() > 2 * cfg.logit_softcap) == (reached == "logit_cap")
    assert got.abs().max() <= cfg.logit_softcap
    if reached == "attn_cap":
        assert (attn_uncapped - got).abs().max() > 1e-2

    lj, cj = R.transformer.prefill(pj, jnp.asarray(toks[:, :S]), jcfg)
    lt, ct = TT.prefill(pt, tt[:, :S], cfg)
    close(lt, lj, LOGIT_TOL)
    close(ct["k"], cj["k"], k_tol)

    # per-row positions past the window: row 1 decodes one slot earlier
    posv = np.array([S, S - 1], np.int32)
    cj = {"pos": jnp.asarray(posv),
          "k": jnp.pad(cj["k"], ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0))),
          "v": jnp.pad(cj["v"], ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))}
    ct = {"pos": torch.from_numpy(posv),
          "k": torch.nn.functional.pad(ct["k"], (0, 0, 0, 0, 0, pad)),
          "v": torch.nn.functional.pad(ct["v"], (0, 0, 0, 0, 0, pad))}
    for step in range(2):
        nxt = toks[:, S] if step == 0 else np.array(jnp.argmax(dj, -1), np.int32)
        dj, cj = R.transformer.decode_step(pj, jnp.asarray(nxt), jcfg, cj)
        dt, ct = TT.decode_step(pt, torch.from_numpy(nxt).long(), cfg, ct)
        close(dt, dj, LOGIT_TOL)
        close(ct["k"], cj["k"], k_tol)
    assert ct["pos"].tolist() == (posv + 2).tolist()


def test_gemma2_decode_matches_forward_past_the_window():
    cfg = get_config("gemma2-9b").reduced()
    p = TT.init_params(cfg, 1, dtype=torch.float32, device="cpu")
    for name in ("ln1", "ln2", "post_ln1", "post_ln2"):
        p["layers"][name] = torch.randn(p["layers"][name].shape,
                                        generator=torch.Generator().manual_seed(2)) * 0.1
    toks = torch.randint(0, cfg.vocab_size, (2, 75), generator=torch.Generator().manual_seed(3))
    full = TT.forward(p, toks, cfg)
    _, cache = TT.prefill(p, toks[:, :70], cfg)
    for key in ("k", "v"):
        cache[key] = torch.nn.functional.pad(cache[key], (0, 0, 0, 0, 0, 8))
    for t in range(70, 75):
        step, cache = TT.decode_step(p, toks[:, t], cfg, cache)
        torch.testing.assert_close(step, full[:, t], atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# Pruned serving, and pruning at gemma's published shapes
# ---------------------------------------------------------------------------

SPECS = {"gemma-7b": "IntraBlock", "gemma2-9b": "FullBlock"}


def _prune_both(R, jcfg, pj, pt, kind, block):
    if kind == "IntraBlock":
        ppj, mj = R.apply.prune_params(
            pj, R.flexblock.FlexBlockSpec((R.flexblock.IntraBlock(4, 1, 0.5),)), keys=KEYS,
            align_cols=True)
        ppt, mt = TA.prune_params(pt, FlexBlockSpec((IntraBlock(4, 1, 0.5),)), keys=KEYS,
                                  align_cols=True, device="cpu")
        return ppj, mj, ppt, mt, TA.compress_params(ppt, mt, m=4)
    ppj, mj = R.apply.prune_params(
        pj, R.flexblock.FlexBlockSpec((R.flexblock.FullBlock(block, block, 0.5),)), keys=KEYS)
    ppt, mt = TA.prune_params(pt, FlexBlockSpec((FullBlock(block, block, 0.5),)), keys=KEYS,
                              device="cpu")
    return ppj, mj, ppt, mt, TA.compress_params(ppt, mt, block, block)


@pytest.mark.parametrize("arch", GEMMA)
def test_pruned_serving_equals_reference(R, arch):
    """prune + compress + ServeEngine greedy outputs ≡ the reference
    engine on its masked model; gemma2's prompts and decode run past the
    window."""
    jcfg = R.configs.get_config(arch).reduced()
    cfg = port_cfg(jcfg)
    pj = R.transformer.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(7)
    for k in ("ln1", "ln2", "post_ln1", "post_ln2"):
        if k in pj["layers"]:
            pj["layers"][k] = jnp.asarray(rng.normal(size=pj["layers"][k].shape) * 0.1,
                                          jnp.float32)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    ppj, mj, _, mt, cp = _prune_both(R, jcfg, pj, pt, SPECS[arch], 16)
    lin = IntraBlockLinear if SPECS[arch] == "IntraBlock" else BlockSparseLinear
    for key in KEYS:
        np.testing.assert_array_equal(mt["layers"][key].numpy(),
                                      np.asarray(mj["layers"][key]).astype(bool))
        assert isinstance(cp["layers"][key], lin)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (40, 12, 50)]

    def serve(engine, req_cls):
        reqs = [req_cls(prompt=p, max_new_tokens=6) for p in prompts]
        for r in reqs:
            engine.submit(r)
        engine.run()
        return reqs

    rj = serve(R.engine.ServeEngine(jcfg, ppj, slots=2, max_len=64), R.engine.Request)
    rt = serve(ServeEngine(cfg, cp, slots=2, max_len=64, device="cpu"), Request)
    assert all(r.done and len(r.output) == 6 for r in rt)
    assert [r.output for r in rt] == [r.output for r in rj]


@pytest.mark.parametrize("arch", GEMMA)
def test_prune_compress_convert_at_published_shapes(R, arch):
    """One layer at the published widths (head dim 256; gemma2's wq is
    (3584, 16, 256): 4096 wide on a 3584 residual), with d_ff and vocab
    cut: params_from_jax keeps every leaf (post_ln1/post_ln2 included) bit
    for bit in bf16, the masks equal the reference's in f32, each
    projection compresses, and the compressed forward equals the
    reference's masked forward."""
    jcfg = dataclasses.replace(R.configs.get_config(arch), n_layers=1, d_ff=512,
                               vocab_size=512)
    cfg = port_cfg(jcfg)
    hb = jax.tree.map(np.asarray, R.transformer.init_params(jcfg, jax.random.PRNGKey(1),
                                                            dtype=jnp.bfloat16))
    tb = params_from_jax(hb, "cpu")
    for k, v in hb["layers"].items():
        assert tb["layers"][k].dtype == torch.bfloat16
        assert tb["layers"][k].view(torch.int16).numpy().tobytes() == v.view(np.int16).tobytes()
    assert ("post_ln1" in tb["layers"]) == cfg.post_norms
    del hb, tb

    pj = R.transformer.init_params(jcfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    assert tuple(pt["layers"]["wq"].shape) == (1, cfg.d_model, 16, 256)
    ppj, mj, _, mt, cp = _prune_both(R, jcfg, pj, pt, SPECS[arch], 128)
    for key in KEYS:
        np.testing.assert_array_equal(mt["layers"][key].numpy(),
                                      np.asarray(mj["layers"][key]).astype(bool))
    for name in ("ln1", "post_ln1", "post_ln2", "wo"):
        if name in pt["layers"]:
            assert mt["layers"][name] is None
    wq = cp["layers"]["wq"]
    assert wq.in_features == cfg.d_model and wq.out_shape == (16, 256)
    if SPECS[arch] == "IntraBlock":
        assert tuple(wq.w_comp.shape) == (1, cfg.d_model // 2, 4096)
    else:
        assert tuple(wq.idx.shape[:2]) == (1, 4096 // 128)
    toks = np.random.default_rng(8).integers(0, 512, size=(1, 6)).astype(np.int32)
    close(TT.forward(cp, torch.from_numpy(toks).long(), cfg),
          R.transformer.forward(ppj, jnp.asarray(toks), jcfg), LOGIT_TOL)
