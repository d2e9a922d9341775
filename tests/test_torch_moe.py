"""PyTorch port, MoE family: qwen3-moe-30b-a3b (qk_norm) and dbrx-132b
(top-k routing over experts with capacity drops) ≡ the JAX package on
the same numpy-made inputs.

The reference's ``moe_block`` imports ``distributed.sharding`` when it
runs, so every reference call that reaches it (``moe_block``,
``forward``, ``prefill``, ``decode_step``, the reference ``ServeEngine``,
whose jitted decode traces it on first call) runs inside ``R.active()``
(tests/_jax_reference.py).

The reduced configs are dropless (``capacity_factor`` 4.0: no expert can
be given more slots than it has), so every case also runs at
``capacity_factor`` 1.0, where slots are dropped, and asserts which of
the two it saw.  Tolerances in f32 are those of tests/test_torch_models.py:
2e-5 on a layer, 2e-4 on logits (both sides compute in f32 but sum in
other orders).  In bf16 a block's output is held to BF16_TOL of its
largest magnitude: both sides round the expert chain (gate, up, GELU,
product, down, weighting, the K-term sum) to bf16, but XLA may keep
excess precision inside a fusion where torch rounds each op, so an
element of h = gelu(g)·u can differ by an ulp (2^-8 relative), which
the down projection spreads over the output at the output's scale, and
the roundings after it add up to three more half-ulps: 2^-6, four bf16
ulps of the largest |output|.  Dispatch (capacity, keep, destinations,
the dispatched rows) is exact in both dtypes, and served tokens are
equal.
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
from repro_torch.models.layers import COMPRESSED, BlockSparseLinear, IntraBlockLinear
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.sparsity import apply as TA

LOGIT_TOL = 2e-4
LAYER_TOL = 2e-5
BF16_TOL = 2.0 ** -6     # of the block's largest |output|: 4 bf16 ulps
MOE = ("qwen3-moe-30b-a3b", "dbrx-132b")
CAPACITY = (None, 1.0)   # the reduced config's dropless 4.0, and 1.0 (drops)
EXPERT_KEYS = ("w_gate", "w_up", "w_down")
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def reduced(R, arch, capacity):
    jcfg = R.configs.get_config(arch).reduced()
    if capacity is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity)
    return jcfg, port_cfg(jcfg)


def np_params(R, jcfg, seed: int):
    """Reference-layout weights from numpy, norm scales of std 0.1.  Each
    expert gets the std of a dense MLP of its own shape (1/sqrt(d) for
    w_gate/w_up, 1/sqrt(ff) for w_down), other weights the init's: the
    reference's init counts E in an expert leaf's fan_in (E·d), which
    leaves the MoE block's output ~E^-1.5 of a dense MLP's, too small for
    the logit checks to see it."""
    rng = np.random.default_rng(seed)
    d, L = jcfg.d_model, jcfg.n_layers

    def draw(shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    layers = {}
    for name, shp in sorted(R.transformer._layer_shapes(jcfg).items()):
        if name.startswith(("ln", "post_ln")) or name.endswith("_norm"):
            layers[name] = draw((L,) + shp, 0.1)
        else:
            fan_in = (d if name in ("wq", "wk", "wv") else
                      shp[1] if name in EXPERT_KEYS else math.prod(shp[:-1]))
            layers[name] = draw((L,) + shp, 1.0 / math.sqrt(fan_in))
    p = {"embed": draw((jcfg.vocab_size, d), 1.0 / math.sqrt(d)),
         "final_norm": draw((d,), 0.1), "layers": layers}
    if not jcfg.tie_embeddings:
        p["lm_head"] = draw((d, jcfg.vocab_size), 1.0 / math.sqrt(d))
    return p


def both(tree, dtype: str = "f32"):
    """The same numpy tree for both packages, rounded to ``dtype`` alike
    (round to nearest even on both sides)."""
    jd, td = DTYPES[dtype]
    pj = jax.tree.map(lambda a: jnp.asarray(a).astype(jd), tree)
    return pj, params_from_jax(tree, "cpu") if dtype == "f32" else \
        jax.tree.map(lambda a: torch.from_numpy(a).to(td), tree)


def f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=0)


def close_block(got, want, dtype):
    tol = LAYER_TOL if dtype == "f32" else BF16_TOL * float(np.abs(f32(want)).max())
    close(got, want, tol)


def layer0(tree):
    return {k: v[0] for k, v in tree["layers"].items()}


def block_inputs(R, jcfg, dtype, seed=0, shape=(4, 16)):
    """Layer 0's weights and a (B, S, d) input, for both packages."""
    pj, pt = both(np_params(R, jcfg, seed), dtype)
    x = np.random.default_rng(seed + 100).normal(size=shape + (jcfg.d_model,)).astype(np.float32)
    jd, td = DTYPES[dtype]
    return layer0(pj), layer0(pt), jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def expect_drops(cfg, keep) -> None:
    """Drops at capacity_factor 1.0, none in the dropless reduced config."""
    dropped = int((~np.asarray(keep.numpy() if torch.is_tensor(keep) else keep)).sum())
    if cfg.capacity_factor == 1.0:
        assert dropped > 0
    else:
        assert dropped == 0


# ---------------------------------------------------------------------------
# Configs, init, conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_config_copy_matches_reference(R, arch):
    jcfg = R.configs.get_config(arch)
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(arch).reduced()) == dataclasses.asdict(jcfg.reduced())


@pytest.mark.parametrize("arch", MOE)
def test_moe_now_initialises_on_the_cpu(R, arch):
    """What tests/test_torch_models.py and tests/test_torch_gemma.py held
    to raise while MoE was unported: the reduced config passes
    ``_check_supported`` and initialises with the reference's leaves and
    shapes, an expert leaf at std 1/sqrt(E·d)."""
    jcfg, cfg = reduced(R, arch, None)
    TT._check_supported(cfg)
    p = TT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    ref = R.transformer.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    assert set(p["layers"]) == set(ref["layers"]) >= {"w_router", *EXPERT_KEYS}
    assert all(tuple(p["layers"][k].shape) == v.shape for k, v in ref["layers"].items())
    E, d = cfg.n_experts, cfg.d_model
    assert abs(float(p["layers"]["w_up"].std()) * math.sqrt(E * d) - 1.0) < 0.05
    assert abs(float(p["layers"]["w_router"].std()) * math.sqrt(d) - 1.0) < 0.1


@pytest.mark.parametrize("arch", MOE)
def test_params_from_jax_keeps_expert_and_router_bits(R, arch):
    jcfg, _ = reduced(R, arch, None)
    host = jax.tree.map(np.asarray, R.transformer.init_params(jcfg, jax.random.PRNGKey(1),
                                                              dtype=jnp.bfloat16))
    pt = params_from_jax(host, "cpu")
    for k in ("w_router", *EXPERT_KEYS):
        w = pt["layers"][k]
        assert w.dtype == torch.bfloat16 and tuple(w.shape) == host["layers"][k].shape
        assert w.view(torch.int16).numpy().tobytes() == \
            host["layers"][k].view(np.int16).tobytes()


# ---------------------------------------------------------------------------
# The block and its parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("arch", MOE)
def test_dispatch_matches_reference(R, arch, capacity, dtype):
    """Capacity, top_p, keep, destinations and the dispatched (E, C, D)
    rows: exact in f32 and bf16, but for top_p in f32, whose K-term sum
    runs in another order (two f32 ulps at 1, 2.4e-7)."""
    jcfg, cfg = reduced(R, arch, capacity)
    lj, lt, xj, xt = block_inputs(R, jcfg, dtype)
    jd, td = DTYPES[dtype]
    args = (cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    T = xt.shape[0] * xt.shape[1]
    ebj, pj, kj, dj, tj, Cj = R.layers._moe_dispatch(xj.reshape(T, -1), lj["w_router"], *args, jd)
    ebt, pt, kt, dt, tt, Ct = TL._moe_dispatch(xt.reshape(T, -1), lt["w_router"], *args, td)
    assert Ct == Cj == max(1, math.ceil(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(f32(ebt), f32(ebj))
    close(pt, pj, 2.4e-7 if dtype == "f32" else 0.0)
    expect_drops(cfg, kt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("arch", MOE)
def test_combine_matches_reference(R, arch, capacity, dtype):
    """The combine on the same dispatch and the same expert outputs: a
    dropped slot's weight is lost, and each token's K terms are summed in
    k order, rounding after each add as the reference's scatter-add."""
    jcfg, cfg = reduced(R, arch, capacity)
    lj, _, xj, _ = block_inputs(R, jcfg, dtype)
    jd, td = DTYPES[dtype]
    T, D = xj.shape[0] * xj.shape[1], cfg.d_model
    eb, top_p, keep, dest, tok_idx, C = R.layers._moe_dispatch(
        xj.reshape(T, D), lj["w_router"], cfg.n_experts, cfg.top_k, cfg.capacity_factor, jd)
    eo = np.random.default_rng(9).normal(size=(cfg.n_experts, C, D)).astype(np.float32)
    want = R.layers._moe_combine(jnp.asarray(eo).astype(jd), top_p, keep, dest, tok_idx, T, D,
                                 jd)
    got = TL._moe_combine(torch.from_numpy(eo).to(td), torch.from_numpy(f32(top_p)).to(td),
                          torch.from_numpy(np.array(keep)),
                          torch.from_numpy(np.array(dest)).long(),
                          torch.from_numpy(np.array(tok_idx)).long(), T, D, td)
    assert got.dtype == td
    close(got, want, 1e-6 if dtype == "f32" else 0.0)
    expect_drops(cfg, keep)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_reference(R, arch, capacity, dtype):
    jcfg, cfg = reduced(R, arch, capacity)
    lj, lt, xj, xt = block_inputs(R, jcfg, dtype)
    with R.active():
        want = R.layers.moe_block(xj, lj, jcfg)
    got = TL.moe_block(xt, lt, cfg)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    close_block(got, want, dtype)
    T = xt.shape[0] * xt.shape[1]
    keep = TL._moe_dispatch(xt.reshape(T, -1), lt["w_router"], cfg.n_experts, cfg.top_k,
                            cfg.capacity_factor, xt.dtype)[2]
    expect_drops(cfg, keep)


@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("arch", MOE)
def test_planted_ties_pick_the_lower_experts_as_the_reference(R, arch, capacity):
    """A zero router gives every expert probability 1/E: jax.lax.top_k
    keeps experts 0..K-1 for every token, and so must the port; the
    block then equals the reference's."""
    jcfg, cfg = reduced(R, arch, capacity)
    lj, lt, xj, xt = block_inputs(R, jcfg, "f32")
    lj = dict(lj, w_router=jnp.zeros_like(lj["w_router"]))
    lt = dict(lt, w_router=torch.zeros_like(lt["w_router"]))
    T, K = xt.shape[0] * xt.shape[1], cfg.top_k
    top_p, top_e = TL._moe_route(xt.reshape(T, -1), lt["w_router"], K, torch.float32)
    assert top_e.tolist() == [list(range(K))] * T
    torch.testing.assert_close(top_p, torch.full((T, K), 1.0 / K), atol=1e-7, rtol=0)
    _, ref_e = jax.lax.top_k(jnp.full((T, cfg.n_experts), 1.0 / cfg.n_experts), K)
    assert top_e.tolist() == np.asarray(ref_e).tolist()
    with R.active():
        want = R.layers.moe_block(xj, lj, jcfg)
    close(TL.moe_block(xt, lt, cfg), want, LAYER_TOL)
    # every token picks the same K experts: with T > C all but C are dropped
    keep = TL._moe_dispatch(xt.reshape(T, -1), lt["w_router"], cfg.n_experts, K,
                            cfg.capacity_factor, torch.float32)[2]
    expect_drops(cfg, keep)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def record_routes(module, monkeypatch, calls: list) -> None:
    """Each call of ``module._moe_dispatch`` appends the (T, K) expert of
    every (token, k) slot it kept, -1 where it dropped the slot: all a
    token's MoE output depends on but its weights."""
    dispatch = module._moe_dispatch

    def recording(xt, w_router, E, K, *args):
        out = dispatch(xt, w_router, E, K, *args)
        keep, dest, C = (np.asarray(a) for a in (out[2], out[3], out[5]))
        calls.append(np.where(keep, dest // C, -1).reshape(-1, K))
        return out

    monkeypatch.setattr(module, "_moe_dispatch", recording)


def differ(routes_t, routes_j, L: int) -> np.ndarray:
    """Per token of a group of L dispatches (one per layer): whether its
    route differs between the packages in any layer."""
    assert len(routes_t) == len(routes_j) == L
    return np.stack([(a != b).any(axis=1) for a, b in zip(routes_t, routes_j)]).any(axis=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("arch", MOE)
def test_forward_prefill_decode_match_reference(R, arch, capacity, dtype, monkeypatch):
    """forward and prefill of 4 prompts, then 3 decode steps of 4 slots of
    which slot 2 is idle: it keeps its stale token and position, as the
    engine decodes every slot, and still takes capacity from the others.

    Both packages' routes are recorded per layer (the reference's through
    its eager scan under ``jax.disable_jit``).  In f32 every route is
    equal and every logit within LOGIT_TOL.  In bf16 a last-bit
    difference of a router input (attention and norms round in other
    places) can move a token whose K-th and (K+1)-th probabilities nearly
    tie, or who keeps a capacity slot: such a token, the later positions
    of its row (causal attention carries the difference on) and, in
    decode, its slot from then on are left out; the rest is held to
    BF16_TOL of the largest |logit|; at least 3/4 of the tokens of each
    group of dispatches must route alike and at least a third of the logit
    rows must be compared, so that the check is not empty (a flip early in
    a row leaves out the rest of it)."""
    jcfg, cfg = reduced(R, arch, capacity)
    pj, pt = both(np_params(R, jcfg, 4), dtype)
    rng = np.random.default_rng(5)
    B, S, steps, L = 4, 9, 3, cfg.n_layers
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + steps)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    rt, rj = [], []
    record_routes(TL, monkeypatch, rt)
    record_routes(R.layers, monkeypatch, rj)
    agree, rows, compared = [], 0, 0

    def route_diff():
        d = differ(rt[-L:], rj[-L:], L)
        agree.append(1.0 - d.mean())
        if dtype == "f32":
            assert not d.any()
        return d

    def check(got, want, ok):
        nonlocal rows, compared
        got, want = f32(got), f32(want)
        tol = LOGIT_TOL if dtype == "f32" else BF16_TOL * float(np.abs(want).max())
        np.testing.assert_allclose(got[ok], want[ok], atol=tol, rtol=0)
        rows += ok.size
        compared += int(ok.sum())

    def untainted(d):
        """(B, S) positions no route difference can reach: before the first
        differing token of their row."""
        first = np.where(d.reshape(B, S).any(1), d.reshape(B, S).argmax(1), S)
        return np.arange(S)[None, :] < first[:, None]

    with R.active(), jax.disable_jit():
        want = R.transformer.forward(pj, jnp.asarray(toks[:, :S]), jcfg)
        got = TT.forward(pt, tt[:, :S], cfg)
        check(got, want, untainted(route_diff()))
        lj, cj = R.transformer.prefill(pj, jnp.asarray(toks[:, :S]), jcfg)
        lt, ct = TT.prefill(pt, tt[:, :S], cfg)
        ok = untainted(route_diff())
        check(lt[:, 0], lj[:, 0], ok[:, -1])
        for key in ("k", "v"):
            close_block(ct[key][:, ok], cj[key][:, ok], dtype)
        tainted = ~ok[:, -1]
        cj = {"pos": jnp.full((B,), S, jnp.int32),
              "k": jnp.pad(cj["k"], ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0))),
              "v": jnp.pad(cj["v"], ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0)))}
        ct = {"pos": torch.full((B,), S, dtype=torch.int64),
              "k": torch.nn.functional.pad(ct["k"], (0, 0, 0, 0, 0, steps)),
              "v": torch.nn.functional.pad(ct["v"], (0, 0, 0, 0, 0, steps))}
        pos = np.full(B, S)
        for t in range(steps):
            nxt = toks[:, S + t].copy()
            nxt[2] = toks[2, S - 1]                       # the idle slot's stale token
            pos[2] = S - 1
            cj["pos"], ct["pos"] = jnp.asarray(pos, jnp.int32), torch.from_numpy(pos.copy())
            dj, cj = R.transformer.decode_step(pj, jnp.asarray(nxt), jcfg, cj)
            dt, ct = TT.decode_step(pt, torch.from_numpy(nxt).long(), cfg, ct)
            tainted |= route_diff()
            check(dt, dj, ~tainted)
            close_block(ct["k"][:, ~tainted], cj["k"][:, ~tainted], dtype)
            pos += 1
    assert len(rt) == len(rj) == (2 + steps) * L
    assert min(agree) >= 0.75 and compared >= rows / 3, (agree, compared, rows)
    expect_drops(cfg, np.concatenate(rt) >= 0)


@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward_when_dropless(R, arch, capacity):
    """With no drop, a token's MoE output depends on that token alone, so
    decoding token by token equals the forward; at capacity 1.0 the
    forward's 36 tokens compete for capacity the decode's 4 never meet,
    and the two differ."""
    _, cfg = reduced(R, arch, capacity)
    _, pt = both(np_params(R, R.configs.get_config(arch).reduced(), 6))
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (4, 10))).long()
    full = TT.forward(pt, toks, cfg)
    _, cache = TT.prefill(pt, toks[:, :9], cfg)
    for key in ("k", "v"):
        cache[key] = torch.nn.functional.pad(cache[key], (0, 0, 0, 0, 0, 2))
    step, _ = TT.decode_step(pt, toks[:, 9], cfg, cache)
    if capacity is None:
        torch.testing.assert_close(step, full[:, 9], atol=1e-4, rtol=0)
    else:
        assert (step - full[:, 9]).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# Pruning and serving
# ---------------------------------------------------------------------------

SPECS = {"FullBlock": ((FullBlock, (4, 16, 0.5)), {}),
         "IntraBlock": ((IntraBlock, (4, 1, 0.5)), {"align_cols": True})}


def _prune_both(R, pj, pt, kind):
    (cls, args), kw = SPECS[kind]
    ppj, mj = R.apply.prune_params(
        pj, R.flexblock.FlexBlockSpec((getattr(R.flexblock, kind)(*args),)), **kw)
    ppt, mt = TA.prune_params(pt, FlexBlockSpec((cls(*args),)), device="cpu", **kw)
    cp = TA.compress_params(ppt, mt, m=args[0]) if kind == "IntraBlock" else \
        TA.compress_params(ppt, mt, *args[:2])
    return ppj, mj, ppt, mt, cp


@pytest.mark.parametrize("kind", SPECS)
@pytest.mark.parametrize("arch", MOE)
def test_prune_compress_forward_matches_reference(R, arch, kind):
    """The default keys pruned as the reference prunes them (an expert
    leaf masked in its (E, d·ff) view, so a block spans all experts), then
    compressed: wq/wk/wv become compressed modules and the expert leaves
    stay the masked dense weights, on which forward equals the reference's
    masked forward."""
    jcfg, cfg = reduced(R, arch, None)
    pj, pt = both(np_params(R, jcfg, 7))
    ppj, mj, ppt, mt, cp = _prune_both(R, pj, pt, kind)
    for key, m in mj["layers"].items():
        if m is None:
            assert mt["layers"][key] is None
        else:
            np.testing.assert_array_equal(mt["layers"][key].numpy(), np.asarray(m).astype(bool))
    lin = IntraBlockLinear if kind == "IntraBlock" else BlockSparseLinear
    assert all(isinstance(cp["layers"][k], lin) for k in ("wq", "wk", "wv"))
    for key in (*EXPERT_KEYS, "wo"):
        assert not isinstance(cp["layers"][key], COMPRESSED)
        assert cp["layers"][key] is ppt["layers"][key]
        assert not bool(mt["layers"][key].all())
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    with R.active():
        want = R.transformer.forward(ppj, jnp.asarray(toks), jcfg)
    close(TT.forward(cp, torch.from_numpy(toks).long(), cfg), want, LOGIT_TOL)


def test_expert_masks_stay_on_the_host_and_the_input_is_untouched(R):
    """prune_params builds each leaf anew one layer at a time; the masks of
    leaves with no compressed layout (wo, the experts) are host tensors,
    and the input leaves are left as they were."""
    jcfg, cfg = reduced(R, "qwen3-moe-30b-a3b", None)
    _, pt = both(np_params(R, jcfg, 3))
    src = {"layers": {k: v.clone() for k, v in pt["layers"].items()}}
    out, masks = TA.prune_params(src, FlexBlockSpec((FullBlock(4, 16, 0.5),)),
                                 keys=("wq", "w_up", "wo"), device="cpu")
    for k in ("wq", "w_up", "wo"):
        assert torch.equal(src["layers"][k], pt["layers"][k])
        assert out["layers"][k] is not src["layers"][k]
        assert torch.equal(out["layers"][k], src["layers"][k] * masks["layers"][k])
        assert masks["layers"][k].dtype == torch.bool and masks["layers"][k].device.type == "cpu"
    assert out["layers"]["w_gate"] is src["layers"]["w_gate"]
    assert [TA._has_compressed_layout(k, pt["layers"][k]) for k in ("wq", "w_up", "wo")] == \
        [True, False, False]


@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("arch", MOE)
def test_pruned_serving_equals_reference(R, arch, capacity, monkeypatch):
    """prune + compress + ServeEngine (4 slots, 5 requests of other
    lengths, so slots idle and refill) greedy outputs ≡ the reference
    engine on its masked model, with the drops asserted."""
    jcfg, cfg = reduced(R, arch, capacity)
    pj, pt = both(np_params(R, jcfg, 11))
    ppj, _, _, _, cp = _prune_both(R, pj, pt, "FullBlock")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (21, 5, 13, 30, 8)]
    routes = []
    record_routes(TL, monkeypatch, routes)

    def serve(engine, req_cls):
        reqs = [req_cls(prompt=p, max_new_tokens=n) for p, n in zip(prompts, (6, 9, 4, 5, 7))]
        for r in reqs:
            engine.submit(r)
        engine.run()
        return reqs

    with R.active():
        rj = serve(R.engine.ServeEngine(jcfg, ppj, slots=4, max_len=48), R.engine.Request)
    rt = serve(ServeEngine(cfg, cp, slots=4, max_len=48, device="cpu"), Request)
    assert all(r.done for r in rt)
    assert [len(r.output) for r in rt] == [6, 9, 4, 5, 7]
    assert [r.output for r in rt] == [r.output for r in rj]
    expect_drops(cfg, np.concatenate(routes) >= 0)


def test_reference_calls_leave_sys_modules_as_found(R):
    """R.active() puts back the loader's own module objects (the
    sharding module that layers holds, the compat stand-in) for the
    block, and leaves no repro entry behind."""
    import sys

    before = {n: m for n, m in sys.modules.items() if n == "repro" or n.startswith("repro.")}
    jcfg, _ = reduced(R, "dbrx-132b", None)
    lj, _, xj, _ = block_inputs(R, jcfg, "f32")
    with R.active():
        R.layers.moe_block(xj, lj, jcfg)
        sharding = sys.modules["repro.distributed.sharding"]
        assert sys.modules["repro.models.layers"] is R.layers
        assert sys.modules["repro.runtime.compat"] is R.layers.compat
    after = {n: m for n, m in sys.modules.items() if n == "repro" or n.startswith("repro.")}
    assert after == before
    with R.active():
        assert sys.modules["repro.distributed.sharding"] is sharding


@pytest.mark.parametrize("arch", MOE)
def test_engine_preflight_does_not_warn_on_moe(arch):
    """ServeEngine's warn-only pre-flight lowers the config with
    lm_workload, which has an MoE branch (router, experts at top_k): at
    the full config and at the smoke engine's shape it finds nothing."""
    import warnings

    from repro_torch.analysis import preflight
    from repro_torch.core.workload import lm_workload

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert preflight(lm_workload(get_config(arch), seq_len=1024, batch=4), strict=False,
                         where="serve.engine") == []
        cfg = get_config(arch).reduced()
        ServeEngine(cfg, TT.init_params(cfg, 0, dtype=torch.float32, device="cpu"), slots=4,
                    max_len=64, device="cpu")
