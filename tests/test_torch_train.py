"""PyTorch port, training: the data pipeline, AdamW, gradient compression,
the train step, checkpoints and the trainer ≡ the JAX package on the same
numpy-made inputs (qwen3-4b and llama3-8b at ``.reduced()``, f32 unless a
case says bf16), and the attention route under autograd.

Tolerances: batches, checkpoints and int8 codes bit for bit; schedule and
one AdamW step on a pytree 1e-6 relative (1 bf16 ulp for bf16 params);
train steps as tests/_train_cases.py states them (1e-5 of a leaf's
largest entry, params conditioned on |g|); trainer loss logs 1e-4
relative over 4 steps (each step's AdamW update carries the previous
step's last-bit differences).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _jax_reference
from _train_cases import (assert_step_matches, np_batch, np_masks, np_params, pairs,
                          port_step, ref_step)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.flexblock import FlexBlockSpec, FullBlock, IntraBlock
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.distributed import compress as TC
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.sparsity.apply import prune_params
from repro_torch.train import checkpoint as TCK
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves, leaves_with_paths

ARCH = "qwen3-4b"
KEYS = ("wq", "wk", "wv", "w_gate", "w_up", "w_down")
LR = 1e-2


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

def test_pipeline_batches_equal_reference_bit_for_bit(R):
    for kw in ({"vocab_size": 512, "seq_len": 16, "global_batch": 4, "seed": 3},
               {"vocab_size": 151936, "seq_len": 64, "global_batch": 2, "seed": 0}):
        ours = TokenPipeline(PipelineConfig(**kw), start_step=2)
        theirs = R.pipeline.TokenPipeline(R.pipeline.PipelineConfig(**kw), start_step=2)
        for _ in range(4):
            a, b = ours.next_batch(), theirs.next_batch()
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        assert ours.state() == theirs.state()


def test_pipeline_state_and_host_sharding():
    cfg = PipelineConfig(vocab_size=100, seq_len=8, global_batch=4, seed=1)
    p1, p2 = TokenPipeline(cfg), TokenPipeline(cfg)
    np.testing.assert_array_equal(p1.next_batch()["tokens"], p2.next_batch()["tokens"])
    state = p1.state()
    nxt = p1.next_batch()
    np.testing.assert_array_equal(TokenPipeline.from_state(cfg, state).next_batch()["tokens"],
                                  nxt["tokens"])
    b0 = TokenPipeline(PipelineConfig(100, 8, 4, seed=1, host_id=0, n_hosts=2)).next_batch()
    b1 = TokenPipeline(PipelineConfig(100, 8, 4, seed=1, host_id=1, n_hosts=2)).next_batch()
    assert b0["tokens"].shape == (2, 8)
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    with pytest.raises(ValueError, match="seed mismatch"):
        TokenPipeline.from_state(cfg, {"step": 1, "seed": 2})
    with pytest.raises(ValueError, match="divide"):
        TokenPipeline(PipelineConfig(100, 8, 3, n_hosts=2))


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 2, 5, 7, 10, 30])
def test_schedule_matches_reference(R, step):
    kw = dict(lr=3e-4, warmup_steps=3, total_steps=10, min_lr_ratio=0.1)
    got = float(TO._schedule(TO.AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32)))
    want = float(R.optimizer._schedule(R.optimizer.AdamWConfig(**kw), jnp.int32(step)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("clip_norm", [1.0, 1e3, 0.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference_over_5_steps(R, clip_norm, dtype):
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "nested": {"b": (7,), "c": (2, 2, 4)}, "s": ()}
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def draw(shp, scale):
        return (rng.normal(size=shp) * scale).astype(np.float32)

    def tree(fn, t=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in t.items()}

    jp = tree(lambda s: jnp.asarray(draw(s, 1.0)).astype(jdt))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jo, to = R.optimizer.adamw_init(jp), TO.adamw_init(tp)
    kw = dict(lr=0.05, warmup_steps=2, total_steps=5, clip_norm=clip_norm)
    jc, tc = R.optimizer.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    for i in range(5):
        g = tree(lambda s: draw(s, 3.0 if i % 2 else 0.1))
        jp, jo, jm = R.optimizer.adamw_update(jax.tree.map(jnp.asarray, g), jo, jp, jc)
        tp, to, tm = TO.adamw_update(params_from_jax(g, "cpu"), to, tp, tc)
        assert int(to["step"]) == int(jo["step"]) == i + 1 and to["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k]))
        for name in ("m", "v"):
            for path, want, got in pairs(jax.tree.map(np.asarray, jo[name]), to[name]):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)
        for path, want, got in pairs(jax.tree.map(np.asarray, jp), tp):
            assert str(got.dtype) == f"torch.{dtype}"
            want = np.asarray(want, np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-7)
            else:   # a last-bit f32 difference may round to the neighbouring bf16
                assert (np.abs(_np(got) - want) <= np.abs(want) * 2.0 ** -8 + 1e-30).all()


def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([2.0, -3.0])}
    opt = TO.adamw_init(params)
    cfg = TO.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, clip_norm=0.0)
    for _ in range(60):
        params, opt, _ = TO.adamw_update({"w": 2 * params["w"]}, opt, params, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_adamw_chunks_a_large_leaf_as_a_whole(monkeypatch):
    """The update and the norm take a leaf in slices; the result is the
    whole-leaf math."""
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.normal(size=(9, 70)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(9, 70)).astype(np.float32))
    cfg = TO.AdamWConfig(lr=0.1, warmup_steps=0)
    whole = TO.adamw_update({"w": g}, TO.adamw_init({"w": p.clone()}), {"w": p.clone()}, cfg)
    monkeypatch.setattr(TO, "_CHUNK", 150)
    assert len(TO._chunks(p)) == 5
    sliced = TO.adamw_update({"w": g}, TO.adamw_init({"w": p.clone()}), {"w": p.clone()}, cfg)
    for a, b in ((whole[0]["w"], sliced[0]["w"]), (whole[1]["v"]["w"], sliced[1]["v"]["w"])):
        assert torch.equal(a, b)
    assert abs(float(whole[2]["grad_norm"]) - float(sliced[2]["grad_norm"])) <= 1e-6 * 30


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def _jax_noise(R, tree):
    """JAX's own noise per leaf: uniform - 0.5 of (nblocks, 256) for the keys
    of split(PRNGKey(0), n_leaves), in the reference's leaf order."""
    leaves = jax.tree.leaves(tree)
    keys = jax.random.split(jax.random.PRNGKey(0), len(leaves))
    out = []
    for leaf, key in zip(leaves, keys):
        n = -(-int(np.prod(leaf.shape)) // 256)
        out.append(torch.from_numpy(np.array(jax.random.uniform(key, (n, 256)) - 0.5)))
    return out


@pytest.mark.parametrize("n", [256, 333, 1000])
def test_quantize_int8_with_jax_noise_equals_reference(R, n):
    x = (np.random.default_rng(n).normal(size=(n,)) * 1e-3).astype(np.float32)
    key = jax.random.PRNGKey(0)
    q, s, shape, pad = R.compress.quantize_int8_stochastic(jnp.asarray(x), key)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, q.shape) - 0.5))
    tq, ts, tshape, tpad = TC.quantize_int8_stochastic(torch.from_numpy(x), noise=noise)
    assert (tshape, tpad) == (tuple(shape), pad) and pad == (-n) % 256
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    y = TC.dequantize_int8(tq, ts, tshape, tpad)
    assert y.shape == (n,)
    np.testing.assert_array_equal(y.numpy(), np.asarray(R.compress.dequantize_int8(q, s, shape,
                                                                                   pad)))


def test_compress_decompress_grads_with_jax_noise_equals_reference(R):
    rng = np.random.default_rng(2)
    grads = {"w": rng.normal(size=(4, 100)).astype(np.float32),
             "layers": {"b": rng.normal(size=(333,)).astype(np.float32) * 1e-2,
                        "a": rng.normal(size=(2, 300)).astype(np.float32)}}
    want = R.compress.compress_decompress_grads(jax.tree.map(jnp.asarray, grads))
    got = TC.compress_decompress_grads(params_from_jax(grads, "cpu"),
                                       noise=_jax_noise(R, grads))
    for path, w, g in pairs(jax.tree.map(np.asarray, want), got):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="draws"):
        TC.compress_decompress_grads(params_from_jax(grads, "cpu"), noise=[])


def test_compression_generator_path_bound_and_repeatable():
    x = torch.from_numpy((np.random.default_rng(0).normal(size=(333,)) * 1e-3)
                         .astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    q, s, shape, pad = TC.quantize_int8_stochastic(x, gen)
    y = TC.dequantize_int8(q, s, shape, pad)
    assert y.shape == x.shape and pad == 179
    # block-wise int8: error bounded by ~1/127 of the block max
    assert float((y - x).abs().max()) <= float(x.abs().max()) / 127 * 1.01
    grads = {"w": torch.tensor([[0.1, -0.2], [0.3, -0.4]]), "b": x.to(torch.bfloat16)}
    a, b = TC.compress_decompress_grads(grads, seed=5), TC.compress_decompress_grads(grads, seed=5)
    assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    assert a["b"].dtype == torch.bfloat16
    np.testing.assert_allclose(a["w"].numpy(), grads["w"].numpy(), atol=0.4 / 127 * 2)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _masks(R, kind: str, params):
    spec = FlexBlockSpec((FullBlock(16, 16, 0.5),) if kind == "full"
                         else (IntraBlock(4, 1, 0.5),))
    _, masks = prune_params(params_from_jax(params, "cpu"), spec, keys=KEYS,
                            align_cols=kind == "intra", device="cpu")
    return masks


@pytest.mark.parametrize("case", [
    dict(microbatches=1), dict(microbatches=2),
    dict(microbatches=1, masks="full"), dict(microbatches=2, masks="intra"),
    dict(microbatches=2, compress_grads=True),
    dict(microbatches=1, remat=True, remat_policy="minimal"),
    dict(microbatches=1, remat=True, remat_policy="dots"),
    dict(microbatches=2, remat=True, remat_policy="nothing"),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_train_step_matches_reference(R, case, monkeypatch):
    jcfg, cfg = R.configs.get_config(ARCH).reduced(), get_config(ARCH).reduced()
    params = np_params(R, jcfg, seed=0)
    batch = np_batch(cfg, B=4, S=24, seed=0)
    kw = dict(case)
    port_kw = dict(kw)
    if "masks" in kw:
        port_kw["masks"] = _masks(R, kw["masks"], params)
        kw["masks"] = np_masks(port_kw["masks"])
    if kw.get("compress_grads"):
        monkeypatch.setattr(TS, "compress_decompress_grads", functools.partial(
            TC.compress_decompress_grads, noise=_jax_noise(R, params)))
    okw = dict(lr=LR, warmup_steps=1, total_steps=10)
    ref = ref_step(R, jcfg, R.optimizer.AdamWConfig(**okw), params, batch, **kw)
    port = port_step(cfg, TO.AdamWConfig(**okw), params, batch, **port_kw)
    # compressed grads: at most 1% of moment entries one int8 level apart
    assert_step_matches(ref, port, LR, flips=0.01 if kw.get("compress_grads") else 0.0)
    if "masks" in kw:
        for name in KEYS:
            m = port_kw["masks"]["layers"][name]
            assert float(m.float().mean()) == 0.5
            assert not port[0]["layers"][name][~m].any()
            assert not ref[0]["layers"][name][~m.numpy()].any()
    want_dtype = torch.float32      # f32 params: grads f32 either way
    assert port[1]["m"]["embed"].dtype == want_dtype


def test_grads_keep_the_param_dtype_with_one_microbatch_and_f32_with_more():
    cfg = get_config(ARCH).reduced()
    params = TT.init_params(cfg, 0, dtype=torch.bfloat16, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in np_batch(cfg, 2, 8, 0).items()}
    for n, dtype in ((1, torch.bfloat16), (2, torch.float32)):
        _, grads = TS.make_train_step(cfg, TO.AdamWConfig(), microbatches=n).grads(params, batch)
        assert {g.dtype for g in leaves(grads)} == {dtype}


def test_cross_entropy_loss_matches_reference(R):
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    for mask in (None, (rng.random((2, 5)) > 0.4).astype(np.float32), np.zeros((2, 5), np.float32)):
        want = float(R.step.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                               None if mask is None else jnp.asarray(mask)))
        got = float(TS.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                          None if mask is None else torch.from_numpy(mask)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1.0)


def test_non_finite_loss_writes_nothing():
    cfg = get_config(ARCH).reduced()
    params = TT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    opt = TO.adamw_init(params)
    step = TS.make_train_step(cfg, TO.AdamWConfig())
    before = {p: t.clone() for p, t in leaves_with_paths({"p": params, "o": opt})}
    batch = {k: torch.as_tensor(v) for k, v in np_batch(cfg, 2, 8, 0).items()}
    loss, grads = step.grads(params, batch)
    _, _, met = step.apply(params, opt, loss * float("nan"), grads)
    assert not np.isfinite(float(met["loss"]))
    for p, t in leaves_with_paths({"p": params, "o": opt}):
        assert torch.equal(t, before[p]), p


# ---------------------------------------------------------------------------
# Remat and the per-layer unbinding
# ---------------------------------------------------------------------------

def _loss_and_grads(cfg, params, batch, **kw):
    return TS.make_train_step(cfg, TO.AdamWConfig(), **kw).grads(params, batch)


def test_remat_changes_no_number(R):
    cfg = get_config(ARCH).reduced()
    params = TT.init_params(cfg, 1, dtype=torch.float32, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in np_batch(cfg, 2, 24, 1).items()}
    loss0, g0 = _loss_and_grads(cfg, params, batch)
    for policy in TT.REMAT_POLICIES:
        loss, g = _loss_and_grads(cfg, params, batch, remat=True, remat_policy=policy)
        assert torch.equal(loss, loss0), policy
        for (path, a), b in zip(leaves_with_paths(g0), leaves(g)):
            assert torch.equal(a, b), (policy, path)
    with pytest.raises(KeyError):
        TT.forward(params, batch["tokens"], cfg, remat=True, remat_policy="everything")
    assert set(TT.REMAT_POLICIES) == set(R.transformer.REMAT_POLICIES)


def test_unbound_layers_give_the_grads_of_per_layer_indexing(monkeypatch):
    cfg = get_config("whisper-medium").reduced()
    params = TT.init_params(cfg, 2, dtype=torch.float32, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in np_batch(cfg, 2, 12, 2).items()}
    loss, g = _loss_and_grads(cfg, params, batch)
    monkeypatch.setattr(TT, "_layers", lambda layers, n: [TT._layer(layers, l)
                                                           for l in range(n)])
    loss_i, g_i = _loss_and_grads(cfg, params, batch)
    assert torch.equal(loss, loss_i)
    for (path, a), b in zip(leaves_with_paths(g), leaves(g_i)):
        assert torch.equal(a, b), path


def test_attention_under_grad_never_calls_flash(monkeypatch):
    cfg = get_config(ARCH).reduced()
    params = TT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    tokens = torch.as_tensor(np_batch(cfg, 1, 20, 0)["tokens"])
    calls = []
    real = TL.ops.flash_attention
    monkeypatch.setattr(TL.ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    logits = TT.forward(params, tokens, cfg)            # grad mode on, no input needs grad
    assert len(calls) == cfg.n_layers
    calls.clear()
    train = dict(params, layers={k: v.detach().requires_grad_()
                                 for k, v in params["layers"].items()})
    got = TT.forward(train, tokens, cfg)
    assert not calls
    torch.testing.assert_close(got, logits, rtol=0, atol=1e-5)
    got.sum().backward()
    assert float(train["layers"]["wq"].grad[0].norm()) > 0
    with torch.no_grad():
        TT.forward(train, tokens, cfg)
    assert len(calls) == cfg.n_layers


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_rotation_and_validation(tmp_path):
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "nested": {"b": torch.ones(4, dtype=torch.bfloat16)}}
    opt = TO.adamw_init(params)
    TCK.save_checkpoint(str(tmp_path / "r"), 7, params, opt,
                        data_state={"step": 7, "seed": 0, "host_id": 0})
    p2, o2, meta = TCK.restore_checkpoint(str(tmp_path / "r"), params, opt)
    assert meta["step"] == 7 and meta["data_state"]["step"] == 7
    assert torch.equal(p2["a"], params["a"]) and p2["nested"]["b"].dtype == torch.bfloat16
    assert o2["step"].dtype == torch.int32
    for s in (1, 2, 3, 4, 5):
        TCK.save_checkpoint(str(tmp_path / "rot"), s, {"a": torch.zeros(2)}, keep=2)
    assert TCK.list_checkpoints(str(tmp_path / "rot")) == [4, 5]
    assert TCK.latest_step(str(tmp_path / "rot")) == 5
    (tmp_path / "rot" / "step_0000000009").mkdir()          # no meta.json: incomplete
    assert TCK.latest_step(str(tmp_path / "rot")) == 5
    TCK.save_checkpoint(str(tmp_path / "v"), 1, {"a": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        TCK.restore_checkpoint(str(tmp_path / "v"), {"a": torch.zeros(3, 3)})
    with pytest.raises(KeyError, match="missing leaf"):
        TCK.restore_checkpoint(str(tmp_path / "v"), {"b": torch.zeros(2, 2)})
    with pytest.raises(FileNotFoundError):
        TCK.restore_checkpoint(str(tmp_path / "none"), params)


def _ckpt_trees(R):
    jcfg = R.configs.get_config(ARCH).reduced()
    jp = R.transformer.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    jo = R.optimizer.adamw_init(jp)
    rng = np.random.default_rng(1)
    jo["m"] = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), jo["m"])
    jo["step"] = jnp.int32(3)
    return jp, jo


def _bit_equal(jtree, ttree, dtypes):
    for path, want, got in pairs(jax.tree.map(np.asarray, jtree), ttree):
        assert str(got.dtype) in dtypes, path
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                          want.view(np.uint16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_checkpoint_written_by_the_reference_restores_in_the_port(R, tmp_path):
    jp, jo = _ckpt_trees(R)
    R.checkpoint.save_checkpoint(str(tmp_path), 3, jp, jo, data_state={"step": 3, "seed": 0})
    tp = TT.init_params(get_config(ARCH).reduced(), 9, dtype=torch.bfloat16, device="cpu")
    p, o, meta = TCK.restore_checkpoint(str(tmp_path), tp, TO.adamw_init(tp))
    assert meta["step"] == 3 and meta["data_state"] == {"step": 3, "seed": 0}
    _bit_equal(jp, p, {"torch.bfloat16"})
    _bit_equal(jo, o, {"torch.float32", "torch.int32"})


def test_checkpoint_written_by_the_port_restores_in_the_reference(R, tmp_path):
    jp, jo = _ckpt_trees(R)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    to = params_from_jax(jax.tree.map(np.asarray, jo), "cpu")
    TCK.save_checkpoint(str(tmp_path), 3, tp, to, data_state={"step": 3})
    tmpl_p = R.transformer.init_params(R.configs.get_config(ARCH).reduced(),
                                       jax.random.PRNGKey(9), dtype=jnp.bfloat16)
    p, o, meta = R.checkpoint.restore_checkpoint(str(tmp_path), tmpl_p,
                                                 R.optimizer.adamw_init(tmpl_p))
    assert meta["step"] == 3
    assert jax.tree.leaves(p)[0].dtype == jnp.bfloat16
    _bit_equal(p, tp, {"torch.bfloat16"})
    _bit_equal(o, to, {"torch.float32", "torch.int32"})


# ---------------------------------------------------------------------------
# Trainer (the reference's tests/test_train.py cases, on the port)
# ---------------------------------------------------------------------------

CFG = get_config("llama3-8b").reduced()


def _pipeline(steps=0, seq_len=16, global_batch=4):
    return TokenPipeline(PipelineConfig(vocab_size=CFG.vocab_size, seq_len=seq_len,
                                        global_batch=global_batch, seed=3), start_step=steps)


def test_trainer_loss_decreases(tmp_path):
    tcfg = TrainerConfig(steps=10, ckpt_every=5, ckpt_dir=str(tmp_path), log_every=1,
                         device="cpu")
    tr = Trainer(CFG, TO.AdamWConfig(lr=5e-3, warmup_steps=2), tcfg,
                 _pipeline(seq_len=32, global_batch=8))
    losses = [m["loss"] for m in tr.train()]
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert TCK.list_checkpoints(str(tmp_path)) == [5, 10]


def test_trainer_failure_recovery(tmp_path):
    tcfg = TrainerConfig(steps=6, ckpt_every=2, ckpt_dir=str(tmp_path), device="cpu")
    tr = Trainer(CFG, TO.AdamWConfig(lr=1e-3), tcfg, _pipeline())
    fired = {"n": 0}

    def fault_hook(step):
        if step == 4 and fired["n"] == 0:
            fired["n"] = 1
            raise RuntimeError("injected node failure")

    log = tr.train(fault_hook=fault_hook)
    assert fired["n"] == 1
    assert TCK.latest_step(str(tmp_path)) == 6
    assert [m["step"] for m in log] == [0, 1, 2, 3, 4, 5]
    # a fresh trainer resumes from the last checkpoint, data state included
    again = Trainer(CFG, TO.AdamWConfig(lr=1e-3), tcfg, _pipeline())
    assert again.start_step == 6 and again.pipeline.state()["step"] == tr.pipeline.state()["step"]
    for (path, a), b in zip(leaves_with_paths(tr.params), leaves(again.params)):
        assert torch.equal(a, b), path


def test_trainer_aborts_after_max_retries(tmp_path):
    tcfg = TrainerConfig(steps=4, ckpt_every=2, ckpt_dir=str(tmp_path), max_retries=2,
                         device="cpu")
    tr = Trainer(CFG, TO.AdamWConfig(), tcfg, _pipeline())

    def always_fail(step):
        raise ValueError("persistent failure")

    with pytest.raises(RuntimeError, match="aborting") as excinfo:
        tr.train(fault_hook=always_fail)
    assert isinstance(excinfo.value.__cause__, ValueError)
    assert "ValueError: persistent failure" in str(excinfo.value)


def test_trainer_skips_a_planted_non_finite_loss():
    tr = Trainer(CFG, TO.AdamWConfig(lr=1e-3), TrainerConfig(steps=2, device="cpu"),
                 _pipeline())
    real = tr.step_fn.loss_fn
    before = {}

    def loss_fn(params, batch, **kw):
        loss = real(params, batch, **kw)
        if tr.metrics_log:                           # the second step: plant a NaN loss
            before.update((p, t.clone()) for p, t in leaves_with_paths(
                {"p": tr.params, "o": tr.opt_state}))
            return loss * float("nan")
        return loss

    tr.step_fn.loss_fn = loss_fn
    log = tr.train()
    assert tr.skipped_nonfinite == 1 and log[1]["skipped"] == 1.0 and np.isnan(log[1]["loss"])
    after = dict(leaves_with_paths({"p": tr.params, "o": tr.opt_state}))
    assert after.keys() == before.keys() and int(tr.opt_state["step"]) == 1
    for p, t in after.items():
        assert torch.equal(t, before[p]), p


def test_trainer_loss_log_matches_reference(R):
    jcfg = R.configs.get_config("llama3-8b").reduced()
    params = np_params(R, jcfg, seed=5)
    okw = dict(lr=5e-3, warmup_steps=2, total_steps=10)
    theirs = R.trainer.Trainer(jcfg, R.optimizer.AdamWConfig(**okw),
                               R.trainer.TrainerConfig(steps=4, ckpt_dir=None),
                               R.pipeline.TokenPipeline(R.pipeline.PipelineConfig(
                                   vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4,
                                   seed=3)))
    theirs.params = jax.tree.map(jnp.asarray, params)
    theirs.opt_state = R.optimizer.adamw_init(theirs.params)
    with R.active():
        want = [m["loss"] for m in theirs.train()]
    ours = Trainer(CFG, TO.AdamWConfig(**okw), TrainerConfig(steps=4, device="cpu"),
                   _pipeline())
    ours.params = params_from_jax(params, "cpu")
    ours.opt_state = TO.adamw_init(ours.params)
    got = [m["loss"] for m in ours.train()]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
