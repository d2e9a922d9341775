"""PyTorch port, SSM family: the Mamba-2 SSD mixer (mamba2-130m) and
hymba's hybrid layer (sliding-window attention beside the SSM mixer,
each branch normed) ≡ the JAX package on the same numpy-made inputs.

Every reference call that reaches the model stack or the engine runs
inside ``R.active()`` (tests/_jax_reference.py).  The reference's mixer
and entry points are compiled whole with ``jax.jit`` (:func:`jitted`), as
the JAX package runs them when it serves: one compilation each instead of
one per eager op.  A decode cache is
built with ``init_cache(..., max_len)`` and each prefill merged into its
slot, as ``ServeEngine`` does: the cache ``prefill`` returns has no
headroom, and the reference's ``dynamic_update_slice`` would clamp a
write past its end.

Tolerances.  f32: 2e-5 on a layer, 2e-4 on logits, as in
tests/test_torch_models.py (both sides compute in f32 but sum in other
orders; the chunk cumsum of the reference is a parallel prefix scan).  A
state of the SSM, and the output of the bare SSD (which sums up to a
whole chunk of terms, |y| up to 8 here), are held to 2e-5 of their
largest magnitude.  bf16: both
sides round the masked scores, the chunk weights and the carried states
to bf16 from f32 values that differ in their last bits, so an element can
land one bf16 ulp apart (2^-8 relative), and the roundings of the
output add up to three more half-ulps: BF16_TOL = 2^-6 of the largest
|output|, four bf16 ulps, as tests/test_torch_moe.py holds its blocks.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _jax_reference
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.flexblock import FlexBlockSpec, FullBlock, IntraBlock
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.layers import IntraBlockLinear
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.sparsity import apply as TA

LOGIT_TOL = 2e-4
LAYER_TOL = 2e-5
STATE_RTOL = 2e-5       # of the state's largest |value|
BF16_TOL = 2.0 ** -6    # of the largest |output|: 4 bf16 ulps
SSM = ("mamba2-130m", "hymba-1.5b")
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def reduced(R, arch, **changes):
    jcfg = dataclasses.replace(R.configs.get_config(arch).reduced(), **changes)
    return jcfg, port_cfg(jcfg)


def np_params(R, jcfg, seed: int):
    """Reference-layout weights from numpy: matrices normal with the
    init's std (conv_w: fan_in 4), norm scales std 0.1, and the SSM's
    dynamics drawn around the init's constants (dt_bias and A_log std
    0.5, D_skip 0.5 + std 0.1), so that every term of the mixer shows."""
    rng = np.random.default_rng(seed)
    d, L = jcfg.d_model, jcfg.n_layers

    def draw(shape, std, mean=0.0):
        return (mean + rng.normal(size=shape) * std).astype(np.float32)

    layers = {}
    for name, shp in sorted(R.transformer._layer_shapes(jcfg).items()):
        if name.startswith(("ln", "post_ln")) or name.endswith("_norm"):
            layers[name] = draw((L,) + shp, 0.1)
        elif name in ("dt_bias", "A_log"):
            layers[name] = draw((L,) + shp, 0.5)
        elif name == "D_skip":
            layers[name] = draw((L,) + shp, 0.1, 0.5)
        else:
            fan_in = d if name in ("wq", "wk", "wv") else math.prod(shp[:-1])
            layers[name] = draw((L,) + shp, 1.0 / math.sqrt(fan_in))
    p = {"embed": draw((jcfg.vocab_size, d), 1.0 / math.sqrt(d)),
         "final_norm": draw((d,), 0.1), "layers": layers}
    if not jcfg.tie_embeddings:
        p["lm_head"] = draw((d, jcfg.vocab_size), 1.0 / math.sqrt(d))
    return p


def to_both(a: np.ndarray, dtype: str = "f32"):
    """The same numpy array for both packages, rounded to ``dtype`` alike."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def both(tree, dtype: str = "f32"):
    jd, td = DTYPES[dtype]
    return (jax.tree.map(lambda a: jnp.asarray(a).astype(jd), tree),
            jax.tree.map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(td), tree))


def f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=0)


def close_scaled(got, want, dtype, f32_tol=LAYER_TOL):
    """f32: ``f32_tol``; bf16: BF16_TOL of the largest |want|."""
    tol = f32_tol if dtype == "f32" else BF16_TOL * float(np.abs(f32(want)).max())
    close(got, want, tol)


def close_state(got, want, dtype):
    scale = float(np.abs(f32(want)).max())
    close(got, want, (STATE_RTOL if dtype == "f32" else BF16_TOL) * scale)


def layer0(tree):
    return {k: v[0] for k, v in tree["layers"].items()}


def jitted(fn, jcfg):
    """The reference function ``fn`` with its config bound, under ``jax.jit``."""
    return jax.jit(functools.partial(fn, cfg=jcfg))


# ---------------------------------------------------------------------------
# Configs, support, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM)
def test_config_copy_matches_reference(R, arch):
    jcfg = R.configs.get_config(arch)
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(arch).reduced()) == dataclasses.asdict(jcfg.reduced())


@pytest.mark.parametrize("arch", SSM)
@pytest.mark.parametrize("reduce", [True, False], ids=["reduced", "published"])
def test_init_params_leaves_and_constants_match_reference(R, arch, reduce):
    """Leaf names and shapes equal the reference's; norms, A_log and
    dt_bias are zero and D_skip 0.5 in both; at the published shapes (one
    layer, the vocab cut) each random leaf has the init's std
    1/sqrt(fan_in) (conv_w: 1/2) within 5%, over 6144 draws or more."""
    jcfg = R.configs.get_config(arch)
    jcfg = jcfg.reduced() if reduce else dataclasses.replace(jcfg, n_layers=1, vocab_size=512)
    cfg = port_cfg(jcfg)
    pt = TT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    shapes = jax.eval_shape(lambda: R.transformer.init_params(jcfg, jax.random.PRNGKey(0),
                                                              dtype=jnp.float32))
    assert set(pt["layers"]) == set(shapes["layers"])
    assert {k: tuple(v.shape) for k, v in pt["layers"].items()} == \
        {k: v.shape for k, v in shapes["layers"].items()}
    assert set(pt) == set(shapes)
    if reduce:
        pj = jax.jit(functools.partial(R.transformer.init_params, jcfg, dtype=jnp.float32))(
            jax.random.PRNGKey(0))
        consts = [k for k in pj["layers"] if k in ("A_log", "dt_bias", "D_skip")
                  or k.startswith("ln") or k.endswith("_norm")]
        for k in consts:
            np.testing.assert_array_equal(pt["layers"][k].numpy(), np.asarray(pj["layers"][k]))
        assert float(pt["layers"]["D_skip"].max()) == float(pt["layers"]["D_skip"].min()) == 0.5
        return
    for k, shp in TT._layer_shapes(cfg).items():
        if len(shp) < 2:
            continue
        fan_in = cfg.d_model if k in ("wq", "wk", "wv") else math.prod(shp[:-1])
        std = float(pt["layers"][k].std())
        assert abs(std * math.sqrt(fan_in) - 1.0) < 0.05, (k, std)


@pytest.mark.parametrize("arch", SSM)
def test_check_supported_admits_ssm_and_keeps_refusing_the_rest(R, arch):
    cfg = port_cfg(R.configs.get_config(arch).reduced())
    TT._check_supported(cfg)
    for bad in (dataclasses.replace(cfg, attention="global"),
                dataclasses.replace(cfg, ssm_state=0),
                dataclasses.replace(cfg, enc_dec=True),
                dataclasses.replace(cfg, prefix_len=8)):
        with pytest.raises(NotImplementedError):
            TT._check_supported(bad)


@pytest.mark.parametrize("arch", SSM)
def test_cache_layout_matches_reference(R, arch):
    jcfg, cfg = reduced(R, arch)
    cj = R.transformer.init_cache(jcfg, 3, 40, dtype=jnp.float32)
    ct = TT.init_cache(cfg, 3, 40, dtype=torch.float32, device="cpu")
    assert set(ct) == set(cj)
    for k in cj:
        assert tuple(ct[k].shape) == cj[k].shape
    assert ct["ssm"].dtype == torch.float32 and ct["conv"].dtype == torch.float32
    assert ("k" in ct) == (cfg.attention != "none")


# ---------------------------------------------------------------------------
# SSD and the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,Q", [(16, 16), (64, 16), (96, 32)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_chunked_matches_reference(R, S, Q, dtype):
    rng = np.random.default_rng(S + Q)
    B, H, Pd, N = 2, 3, 8, 16
    xh = rng.normal(size=(B, S, H, Pd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,)) * 0.5).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32) * 0.5
    Cm = rng.normal(size=(B, S, N)).astype(np.float32) * 0.5
    (xj, xt), (bj, bt), (cj, ct) = (to_both(a, dtype) for a in (xh, Bm, Cm))
    (dj, dtt), (aj, at) = to_both(dt), to_both(A)
    yj, hj = jax.jit(R.layers._ssd_chunked, static_argnums=5)(xj, dj, aj, bj, cj, Q)
    yt, ht = TL._ssd_chunked(xt, dtt, at, bt, ct, Q)
    assert yt.dtype == DTYPES[dtype][1] and ht.dtype == torch.float32
    assert tuple(ht.shape) == hj.shape == (B, H, Pd, N)
    close_state(yt, yj, dtype)
    close_state(ht, hj, dtype)


def _mixer_inputs(R, jcfg, dtype, seed, S, B=2):
    pj, pt = both(np_params(R, jcfg, seed), dtype)
    x = np.random.default_rng(seed + 100).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    xj, xt = to_both(x, dtype)
    return layer0(pj), layer0(pt), xj, xt


@pytest.mark.parametrize("arch", SSM)
@pytest.mark.parametrize("S", [1, 40])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssm_block_prefill_matches_reference(R, arch, S, dtype):
    """Chunk 16: S = 40 pads the last of three chunks (the padded dt is 0,
    so the final state is exact), 1 pads one; the conv state is the last 3
    rows of xs, zero-padded for S < 3."""
    jcfg, cfg = reduced(R, arch, ssm_chunk=16)
    lpj, lpt, xj, xt = _mixer_inputs(R, jcfg, dtype, 1, S)
    yj, hj, cj = jitted(R.layers.ssm_block, jcfg)(xj, lpj)
    yt, ht, ct = TL.ssm_block(xt, lpt, cfg)
    assert yt.dtype == xt.dtype and ht.dtype == torch.float32
    assert tuple(ct.shape) == cj.shape == (2, 3, cfg.ssm_inner())
    close_scaled(yt, yj, dtype)
    close_state(ht, hj, dtype)
    close_scaled(ct, cj, dtype)


@pytest.mark.parametrize("arch", SSM)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssm_block_decode_step_matches_reference(R, arch, dtype):
    """One token from a given SSM state and conv state: y, the new state
    and the new conv state (the last 3 of [conv state, xs]).  In bf16 the
    port rounds y to bf16 before w_out (see ``ssm_block``): within
    BF16_TOL all the same."""
    jcfg, cfg = reduced(R, arch)
    lpj, lpt, xj, xt = _mixer_inputs(R, jcfg, dtype, 2, 1)
    rng = np.random.default_rng(3)
    H, din, N = cfg.ssm_heads, cfg.ssm_inner(), cfg.ssm_state
    state = rng.normal(size=(2, H, din // H, N)).astype(np.float32)
    conv = rng.normal(size=(2, 3, din)).astype(np.float32)
    (sj, st), (cvj, cvt) = to_both(state), to_both(conv, dtype)
    yj, hj, cj = jitted(R.layers.ssm_block, jcfg)(xj, lpj, state=sj, conv_state=cvj)
    yt, ht, ct = TL.ssm_block(xt, lpt, cfg, state=st, conv_state=cvt)
    close_scaled(yt, yj, dtype)
    close_state(ht, hj, dtype)
    close_scaled(ct, cj, dtype)
    torch.testing.assert_close(ct[:, :2], cvt[:, 1:], atol=0, rtol=0)


def test_ssm_block_softplus_has_no_threshold(R):
    """dt = log(1 + e^x) for every input, as jax.nn.softplus: dt_bias 20-30
    puts dt_raw + dt_bias past F.softplus's switch to x at 20."""
    jcfg, cfg = reduced(R, "mamba2-130m", ssm_chunk=16)
    lpj, lpt, xj, xt = _mixer_inputs(R, jcfg, "f32", 4, 24)
    big = np.linspace(20.0, 30.0, cfg.ssm_heads).astype(np.float32)
    lpj["dt_bias"], lpt["dt_bias"] = to_both(big)
    yj, hj, _ = jitted(R.layers.ssm_block, jcfg)(xj, lpj)
    yt, ht, _ = TL.ssm_block(xt, lpt, cfg)
    close_scaled(yt, yj, "f32", LAYER_TOL * float(np.abs(f32(yj)).max()))
    close_state(ht, hj, "f32")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _merge(cache, pc, s: int, S: int, xp):
    """Slot ``s`` of a pool cache takes a batch-1 prefill cache, as
    ServeEngine merges it (k/v rows [0, S), the SSM and conv states)."""
    out = dict(cache)
    for key in ("k", "v"):
        if key in cache:
            if xp is jnp:
                out[key] = cache[key].at[:, s, :S].set(pc[key][:, 0])
            else:
                out[key][:, s, :S] = pc[key][:, 0]
    for key in ("ssm", "conv"):
        if xp is jnp:
            out[key] = cache[key].at[:, s].set(pc[key][:, 0])
        else:
            out[key][:, s] = pc[key][:, 0]
    return out


@pytest.mark.parametrize("arch", SSM)
def test_forward_prefill_decode_match_reference(R, arch):
    """forward over 70 tokens (hymba's window is 32: prompts and decode run
    past it); prefill of two prompts (70 and 45 tokens) merged into slots
    0 and 1 of a 3-slot cache with headroom, slot 2 idle at position 0;
    then 3 decode steps at per-slot positions, logits and every cache
    entry held to the reference; last, the port's decode after prefill
    equals the port's forward."""
    jcfg, cfg = reduced(R, arch)
    pj, pt = both(np_params(R, jcfg, 5))
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 73)).astype(np.int32)
    lens = (70, 45)
    assert cfg.attention == "none" or lens[0] > 2 * cfg.window
    with R.active():
        fj = jitted(R.transformer.forward, jcfg)(pj, jnp.asarray(toks))
    ft = TT.forward(pt, torch.from_numpy(toks).long(), cfg)
    close(ft, fj, LOGIT_TOL)

    Smax = 80
    cj = R.transformer.init_cache(jcfg, 3, Smax, dtype=jnp.float32)
    ct = TT.init_cache(cfg, 3, Smax, dtype=torch.float32, device="cpu")
    ref_prefill = jitted(R.transformer.prefill, jcfg)
    ref_decode = jitted(R.transformer.decode_step, jcfg)
    for s, S in enumerate(lens):
        with R.active():
            lj, pcj = ref_prefill(pj, jnp.asarray(toks[s:s + 1, :S]))
        lt, pct = TT.prefill(pt, torch.from_numpy(toks[s:s + 1, :S]).long(), cfg)
        close(lt, lj, LOGIT_TOL)
        assert set(pct) == set(pcj)
        for key in pcj:
            if key != "pos":
                close_state(pct[key], pcj[key], "f32")
        cj, ct = _merge(cj, pcj, s, S, jnp), _merge(ct, pct, s, S, torch)
    posv = np.array([lens[0], lens[1], 0], np.int32)
    cj["pos"], ct["pos"] = jnp.asarray(posv), torch.from_numpy(posv.astype(np.int64))
    nxt = np.array([toks[0, lens[0]], toks[1, lens[1]], 7], np.int32)
    for step in range(3):
        with R.active():
            dj, cj = ref_decode(pj, jnp.asarray(nxt), cache=cj)
        dt, ct = TT.decode_step(pt, torch.from_numpy(nxt).long(), cfg, ct)
        close(dt, dj, LOGIT_TOL)
        for key in cj:
            if key != "pos":
                close_state(ct[key], cj[key], "f32")
        close(dt[0], ft[0, lens[0] + step], LOGIT_TOL)
        close(dt[1], ft[1, lens[1] + step], LOGIT_TOL)
        if step < 2:
            nxt = np.array([toks[0, lens[0] + step + 1], toks[1, lens[1] + step + 1],
                            int(np.argmax(f32(dj[2])))], np.int32)
    assert ct["pos"].tolist() == (posv + 3).tolist()


@pytest.mark.parametrize("arch", SSM)
def test_decode_after_prefill_equals_forward(arch):
    """The recurrent path (prefill, then one decode step per token) gives
    the chunked path's logits: prompts of 37 tokens (3 chunks of 16, the
    last ragged) decoded to 60."""
    cfg = dataclasses.replace(get_config(arch).reduced(), ssm_chunk=16)
    p = TT.init_params(cfg, 1, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(2)
    for k, v in p["layers"].items():
        if k.startswith("ln") or k.endswith("_norm") or k in ("A_log", "dt_bias"):
            p["layers"][k] = torch.randn(v.shape, generator=g) * 0.3
    toks = torch.randint(0, cfg.vocab_size, (2, 60), generator=g)
    full = TT.forward(p, toks, cfg)
    cache = TT.init_cache(cfg, 2, 64, dtype=torch.float32, device="cpu")
    _, pc = TT.prefill(p, toks[:, :37], cfg)
    for key in pc:
        if key in ("k", "v"):
            cache[key][:, :, :37] = pc[key]
        elif key != "pos":
            cache[key].copy_(pc[key])
    cache["pos"] = pc["pos"]
    for t in range(37, 60):
        step, cache = TT.decode_step(p, toks[:, t], cfg, cache)
        torch.testing.assert_close(step, full[:, t], atol=LOGIT_TOL, rtol=0)


def test_activation_tap_refuses_ssm_configs():
    cfg = get_config("mamba2-130m").reduced()
    p = TT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="tap"):
        TT._run(p, torch.zeros((1, 4), dtype=torch.long), cfg, "auto", False,
                tap=lambda l, kind, a: None)


# ---------------------------------------------------------------------------
# Serving, pruning and compression
# ---------------------------------------------------------------------------

def _serve(engine, req_cls, prompts, n_new=6):
    reqs = [req_cls(prompt=p, max_new_tokens=n_new) for p in prompts]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return reqs


def _prune_intra_both(R, pj, pt, keys):
    ppj, mj = R.apply.prune_params(
        pj, R.flexblock.FlexBlockSpec((R.flexblock.IntraBlock(4, 1, 0.5),)), keys=keys,
        align_cols=True)
    ppt, mt = TA.prune_params(pt, FlexBlockSpec((IntraBlock(4, 1, 0.5),)), keys=keys,
                              align_cols=True, device="cpu")
    return ppj, mj, TA.compress_params(ppt, mt, m=4), mt


@pytest.mark.parametrize("arch", SSM)
def test_pruned_serving_with_refilled_slots_equals_reference(R, arch):
    """Five requests on two slots: every slot is refilled, so a new
    request's prefill must replace the SSM and conv states its slot's last
    request left.  prune (row-aligned IntraBlock, every prunable key) +
    compress + ServeEngine greedy tokens ≡ the reference engine on its
    masked model, in f32; hymba's longest prompt passes its window."""
    jcfg, cfg = reduced(R, arch)
    pj, pt = both(np_params(R, jcfg, 7))
    ppj, mj, cp, mt = _prune_intra_both(R, pj, pt, TA.PRUNABLE_KEYS)
    assert isinstance(cp["layers"]["w_in"], IntraBlockLinear)
    assert isinstance(cp["layers"]["w_out"], IntraBlockLinear)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (40, 12, 50, 3, 21)]
    with R.active():
        rj = _serve(R.engine.ServeEngine(jcfg, ppj, slots=2, max_len=64), R.engine.Request,
                    prompts)
    engine = ServeEngine(cfg, cp, slots=2, max_len=64, device="cpu")
    rt = _serve(engine, Request, prompts)
    assert all(r.done and len(r.output) == 6 for r in rt)
    assert [r.output for r in rt] == [r.output for r in rj]
    assert ("k" in engine.cache) == (cfg.attention != "none")


@pytest.mark.parametrize("arch", SSM)
def test_prune_compress_forward_match_reference(R, arch):
    """Row-aligned IntraBlock(4, 1, 0.5) on every prunable key: masks equal
    the reference's; w_in/w_out (and hymba's wq/wk/wv and MLP) compress to
    IntraBlockLinear, wo stays masked-dense, conv_w, A_log, dt_bias and
    D_skip are untouched; the compressed forward equals the reference's
    masked forward."""
    jcfg, cfg = reduced(R, arch)
    pj, pt = both(np_params(R, jcfg, 9))
    ppj, mj, cp, mt = _prune_intra_both(R, pj, pt, TA.PRUNABLE_KEYS)
    pruned = [k for k in pt["layers"] if k in TA.PRUNABLE_KEYS]
    assert {"w_in", "w_out"} <= set(pruned)
    for key in pt["layers"]:
        if key in pruned:
            np.testing.assert_array_equal(mt["layers"][key].numpy(),
                                          np.asarray(mj["layers"][key]).astype(bool))
        else:
            assert mt["layers"][key] is None and mj["layers"][key] is None
            assert cp["layers"][key] is pt["layers"][key]
    for key in pruned:
        assert isinstance(cp["layers"][key], IntraBlockLinear) == (key != "wo"), key
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    with R.active():
        want = jitted(R.transformer.forward, jcfg)(ppj, jnp.asarray(toks))
    close(TT.forward(cp, torch.from_numpy(toks).long(), cfg), want, LOGIT_TOL)


@pytest.mark.parametrize("arch", SSM)
def test_fullblock_masks_match_reference_and_do_not_compress(R, arch):
    """FullBlock(16, 16, 0.5): w_in (64, 296) does not tile by 16, so the
    masks (the reference pads its block losses, as the port does) equal
    the reference's, and compress_params refuses them."""
    jcfg, cfg = reduced(R, arch)
    pj, pt = both(np_params(R, jcfg, 11))
    keys = ("w_in", "w_out")
    _, mj = R.apply.prune_params(
        pj, R.flexblock.FlexBlockSpec((R.flexblock.FullBlock(16, 16, 0.5),)), keys=keys)
    ppt, mt = TA.prune_params(pt, FlexBlockSpec((FullBlock(16, 16, 0.5),)), keys=keys,
                              device="cpu")
    for key in keys:
        np.testing.assert_array_equal(mt["layers"][key].numpy(),
                                      np.asarray(mj["layers"][key]).astype(bool))
    assert pt["layers"]["w_in"].shape[-1] % 16
    with pytest.raises(ValueError, match="w_in.*does not tile"):
        TA.compress_params(ppt, mt, 16, 16)


@pytest.mark.parametrize("arch", SSM)
def test_published_ssm_projections_prune_and_compress(R, arch):
    """One layer's w_in/w_out at the published widths (mamba2 (768, 3352)
    and (1536, 768); hymba (1600, 6482) and (3200, 1600)): the row-aligned
    IntraBlock masks equal the reference's and compress to (K/2, N); the
    compressed mixer equals the reference's masked one on a short input;
    FullBlock(128, 128) masks cannot be compressed (N does not tile)."""
    jcfg = dataclasses.replace(R.configs.get_config(arch), n_layers=1, vocab_size=512)
    cfg = port_cfg(jcfg)
    din, N, H = cfg.ssm_inner(), cfg.ssm_state, cfg.ssm_heads
    rng = np.random.default_rng(12)
    shapes = TT._layer_shapes(cfg)
    layers = {k: (rng.normal(size=(1,) + shapes[k]) / math.sqrt(math.prod(shapes[k][:-1])))
              .astype(np.float32) for k in ("w_in", "w_out", "conv_w")}
    layers.update({"dt_bias": np.zeros((1, H), np.float32), "A_log": np.zeros((1, H), np.float32),
                   "D_skip": np.full((1, H), 0.5, np.float32)})
    pj, pt = both({"layers": layers})
    keys = ("w_in", "w_out")
    ppj, mj, cp, mt = _prune_intra_both(R, pj, pt, keys)
    for key in keys:
        np.testing.assert_array_equal(mt["layers"][key].numpy(),
                                      np.asarray(mj["layers"][key]).astype(bool))
    K = {"w_in": cfg.d_model, "w_out": din}
    width = {"w_in": 2 * din + 2 * N + H, "w_out": cfg.d_model}
    for key in keys:
        assert tuple(cp["layers"][key].w_comp.shape) == (1, K[key] // 2, width[key])
    x = rng.normal(size=(1, 5, cfg.d_model)).astype(np.float32)
    yj, hj, _ = jitted(R.layers.ssm_block, jcfg)(jnp.asarray(x), layer0(ppj))
    yt, ht, _ = TL.ssm_block(torch.from_numpy(x), TT._layer(cp["layers"], 0), cfg)
    close(yt, yj, LAYER_TOL)
    close_state(ht, hj, "f32")
    _, mfull = TA.prune_params(pt, FlexBlockSpec((FullBlock(128, 128, 0.5),)), keys=keys,
                               device="cpu")
    with pytest.raises(ValueError, match="does not tile"):
        TA.compress_params(pt, mfull, 128, 128)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_padded_row_stride_w_in_matches_contiguous_layout_and_reference(R, dtype):
    """hymba-1.5b reduced with state 17: w_in (64, 298), N % 8 = 2, so a
    row of its w_comp is no multiple of 16 bytes and compress_params
    stores it as a (L, Kc, 298) view of zero-padded rows (stride 304 in
    bf16, 300 in f32).  The forward through that view equals the same
    weights stored contiguously (bitwise: the plain gather-matmul reads
    the same values); in f32 also the reference's masked forward, to
    LOGIT_TOL (in bf16 the two models drift apart over the layers' SSM
    roundings whatever the layout, so a layer-wide bound says nothing of
    the stride)."""
    jcfg, cfg = reduced(R, "hymba-1.5b", ssm_state=17)
    pj, pt = both(np_params(R, jcfg, 13), dtype)
    ppj, _, cp, _ = _prune_intra_both(R, pj, pt, TA.PRUNABLE_KEYS)
    w = cp["layers"]["w_in"]
    L, Kc, N = w.w_comp.shape
    per = 16 // w.w_comp.element_size()
    ldw = -(-N // per) * per
    assert N % 8 and ldw > N and w.w_comp.stride() == (Kc * ldw, ldw, 1)
    padded = w.w_comp.as_strided((L, Kc, ldw), (Kc * ldw, ldw, 1))
    assert not padded[..., N:].any()
    assert w.layer(1).w_comp.stride() == (ldw, 1)
    flat = dict(cp, layers=dict(cp["layers"], w_in=IntraBlockLinear(
        w.w_comp.contiguous(), w.row_idx, w.in_features, w.out_shape)))
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, size=(2, 40)).astype(np.int32)).long()
    got = TT.forward(cp, toks, cfg)
    assert torch.equal(got, TT.forward(flat, toks, cfg))
    if dtype == "f32":
        with R.active():
            want = jitted(R.transformer.forward, jcfg)(ppj, jnp.asarray(toks.numpy()))
        close(got, want, LOGIT_TOL)
