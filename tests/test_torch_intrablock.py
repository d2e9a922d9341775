"""PyTorch port, IntraBlock path: a reduced qwen3-4b pruned with
IntraBlock(4, 1, 0.5) row-aligned by both packages, the port's compressed
model ≡ the JAX package's masked-dense one, and the §IV-B profile and
the kernel microbenchmarks ≡ the reference's.

Weights come from the reference's init (f32) and cross to the port
through ``params_from_jax``; prompts, activations and int8 samples are
drawn with numpy from a seed.  Logits are held to the ``LOGIT_TOL`` of
tests/test_torch_models.py (2e-4: both sides compute in f32 but sum in
other orders); masks, profiles and sample counts must be equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _jax_reference
from repro_torch.calibrate import harvest as TH
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import input_sparsity as TI
from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TK
from repro_torch.models import transformer as TT
from repro_torch.models.layers import IntraBlockLinear
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.sparsity import apply as TA

KEYS = ("wq", "wk", "wv", "w_gate", "w_up", "w_down")
LOGIT_TOL = 2e-4
RNG = np.random.default_rng(12)


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


@pytest.fixture(scope="module")
def qwen(R):
    """Reduced qwen3-4b pruned by both packages; the port's copy compressed."""
    jcfg = R.configs.get_config("qwen3-4b").reduced()
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    pj = R.transformer.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    # non-zero norm scales, so that qk_norm and the 1 + scale paths count
    for k in ("ln1", "ln2", "q_norm", "k_norm"):
        pj["layers"][k] = jnp.asarray(RNG.normal(size=pj["layers"][k].shape) * 0.1, jnp.float32)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    ppj, mj = R.apply.prune_params(
        pj, R.flexblock.FlexBlockSpec((R.flexblock.IntraBlock(4, 1, 0.5),)), keys=KEYS,
        align_cols=True)
    ppt, mt = TA.prune_params(pt, FlexBlockSpec((IntraBlock(4, 1, 0.5),)), keys=KEYS,
                              align_cols=True, device="cpu")
    cp = TA.compress_params(ppt, mt, m=4)
    return jcfg, cfg, ppj, mj, ppt, mt, cp


@pytest.mark.parametrize("key", KEYS)
def test_intrablock_masks_equal_reference(qwen, key):
    _, _, ppj, mj, ppt, mt, cp = qwen
    want = np.asarray(mj["layers"][key]).astype(bool)
    np.testing.assert_array_equal(mt["layers"][key].numpy(), want)
    np.testing.assert_array_equal(ppt["layers"][key].numpy(), np.asarray(ppj["layers"][key]))
    lin = cp["layers"][key]
    L, K = want.shape[:2]
    assert isinstance(lin, IntraBlockLinear) and tuple(lin.row_idx.shape) == (L, K // 2)
    assert abs(float(want.mean()) - 0.5) < 1e-12


def test_compressed_entry_points_match_reference(R, qwen):
    jcfg, cfg, ppj, _, _, _, cp = qwen
    B, S, pad = 2, 11, 3
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    tt = torch.from_numpy(toks).long()

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=LOGIT_TOL,
                                   rtol=0)

    close(TT.forward(cp, tt, cfg), R.transformer.forward(ppj, jnp.asarray(toks), jcfg))
    lj, cj = R.transformer.prefill(ppj, jnp.asarray(toks[:, :S]), jcfg)
    lt, ct = TT.prefill(cp, tt[:, :S], cfg)
    close(lt, lj)
    posv = np.array([S, S - 2], np.int32)
    cj = {"pos": jnp.asarray(posv),
          "k": jnp.pad(cj["k"], ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0))),
          "v": jnp.pad(cj["v"], ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))}
    ct = {"pos": torch.from_numpy(posv),
          "k": torch.nn.functional.pad(ct["k"], (0, 0, 0, 0, 0, pad)),
          "v": torch.nn.functional.pad(ct["v"], (0, 0, 0, 0, 0, pad))}
    dj, _ = R.transformer.decode_step(ppj, jnp.asarray(toks[:, S]), jcfg, cj)
    dt, _ = TT.decode_step(cp, torch.from_numpy(toks[:, S]).long(), cfg, ct)
    close(dt, dj)


def test_compressed_serving_equals_reference(R, qwen):
    jcfg, cfg, ppj, _, _, _, cp = qwen
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (7, 12, 4)]

    def serve(engine, req_cls):
        reqs = [req_cls(prompt=p, max_new_tokens=5) for p in prompts]
        for r in reqs:
            engine.submit(r)
        engine.run()
        return reqs

    rj = serve(R.engine.ServeEngine(jcfg, ppj, slots=2, max_len=48), R.engine.Request)
    rt = serve(ServeEngine(cfg, cp, slots=2, max_len=48, device="cpu"), Request)
    assert all(r.done and len(r.output) == 5 for r in rt)
    assert [r.output for r in rt] == [r.output for r in rj]


def test_activation_taps_see_the_pruned_projections_inputs(qwen):
    """``_run``'s tap gives each layer's wq/wk/wv, w_gate/w_up and w_down
    inputs; they equal the masked-dense model's, and feeding one back
    through its projection gives that projection's output."""
    _, cfg, _, _, ppt, _, cp = qwen
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size,
                                                                size=(2, 9))).long()
    got, dense = {}, {}
    TT._run(cp, toks, cfg, "auto", False, tap=lambda l, k, a: got.__setitem__((l, k), a))
    TT._run(ppt, toks, cfg, "auto", False, tap=lambda l, k, a: dense.__setitem__((l, k), a))
    assert sorted(got) == [(l, k) for l in range(cfg.n_layers)
                           for k in ("attn_in", "down_in", "mlp_in")]
    for key, a in got.items():
        assert a.shape[:2] == (2, 9)
        torch.testing.assert_close(a, dense[key], atol=1e-5, rtol=0)
    assert got[(1, "down_in")].shape[-1] == cfg.d_ff
    wd = cp["layers"]["w_down"].layer(0)
    h = got[(0, "down_in")].reshape(-1, cfg.d_ff)
    torch.testing.assert_close(wd(h), h @ ppt["layers"]["w_down"][0], atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# §IV-B input sparsity
# ---------------------------------------------------------------------------

def _acts(dtype):
    """Activation samples: normal, ReLU'd (exact zeros) and heavy-tailed."""
    a = {"l0/attn_in": RNG.normal(size=(3, 7, 64)),
         "l0/down_in": np.maximum(RNG.normal(size=(21, 128)), 0.0),
         "l1/mlp_in": RNG.standard_t(2, size=(40, 96)) * 0.01}
    ref = {k: np.asarray(jnp.asarray(v, dtype)) for k, v in a.items()}
    port = {k: torch.from_numpy(np.array(jnp.asarray(v, dtype).astype(jnp.float32)))
            .to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
            for k, v in a.items()}
    return ref, port


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("group_rows,n_bits", [(32, 8), (16, 8), (8, 5)])
def test_profile_activations_equal_reference(R, dtype, group_rows, n_bits):
    """Equal, not close: the int8 samples and the counts are integers.  In
    bf16 the reference widens to f32 before it divides by the scale (numpy
    promotes a bf16 array over a Python float to f32), and so does the
    port."""
    ref, port = _acts(dtype)
    want = R.input_sparsity.profile_activations(ref, group_rows, n_bits)
    got = TI.profile_activations(port, group_rows, n_bits)
    assert got == want
    for k in ref:
        q_want = R.input_sparsity.quantize_int8(ref[k])
        q_got = TI.quantize_int8(port[k])
        assert q_got.dtype == torch.int8
        np.testing.assert_array_equal(q_got.numpy(), q_want)


def emulate_fused(x: np.ndarray, scale: np.float32, g: int, n_bits: int):
    """The fused kernel's arithmetic in numpy f32: the IEEE quotient x / s
    clamped to [-128, 127], |c| + 1.5 * 2^23 (the add rounds half to even
    into the low mantissa bits), the raw bits ORed over each group of g
    (zero padding past K), masked to 8 bits, then n_bits minus the set
    bits under the mask."""
    V, K = x.shape
    G = -(-K // g)
    c = np.clip(x.astype(np.float32) / np.float32(scale), np.float32(-128), np.float32(127))
    bits = (np.abs(c) + np.float32(12582912.0)).view(np.uint32)
    padded = np.full((V, G * g), np.float32(12582912.0)).view(np.uint32)
    padded[:, :K] = bits
    group_or = np.bitwise_or.reduce(padded.reshape(V, G, g), axis=-1) & np.uint32(0xFF)
    mask = np.uint32((1 << n_bits) - 1 if n_bits < 32 else 0xFFFFFFFF)
    pop = sum(((group_or & mask) >> np.uint32(b)) & np.uint32(1) for b in range(8))
    return [int((n_bits - pop.astype(np.int64)).sum()), V * G * n_bits]


def _fused_input(case: str):
    """(37, 96) samples and the scale to give (None: from amax).  ``ties``
    puts every element on a half-integer multiple of s = 0.25 (amax =
    127 * 0.25, so the computed scale is 0.25 too); ``clamp`` gives a scale
    so small that both int8 bounds are hit."""
    if case == "ties":
        x = (RNG.integers(-127, 127, size=(37, 96)) + 0.5) * 0.25
        x[0, 0] = 127 * 0.25
        return x, None
    if case == "ties_given":
        return (RNG.integers(-127, 127, size=(37, 96)) + 0.5) * 0.25, 0.25
    x = RNG.normal(size=(37, 96))
    x[:, ::7] = 0.0
    return (x, None) if case == "normal" else (x * 2.0, 0.01)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("case", ["normal", "ties", "ties_given", "clamp"])
@pytest.mark.parametrize("g,n_bits", [(32, 8), (16, 5)])
def test_quantized_zero_profile_plain_equals_reference(R, dtype, case, g, n_bits):
    """The fused op's plain version, and an emulation of the fused kernel's
    arithmetic, count exactly what the reference's quantize_int8 and
    bit-serial count give, ties and saturation included."""
    x, scale = _fused_input(case)
    x_ref = np.asarray(jnp.asarray(x, dtype))
    x_port = torch.from_numpy(np.array(jnp.asarray(x, dtype).astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    q_ref = R.input_sparsity.quantize_int8(x_ref, per_tensor_scale=scale)
    want = np.asarray(R.kref.bitserial_zero_profile_ref(jnp.asarray(q_ref), g, n_bits)).tolist()
    got = TO.quantized_zero_profile(x_port, g, n_bits, per_tensor_scale=scale)
    assert got.dtype == torch.int32 and got.tolist() == want
    assert want[0] / want[1] == R.input_sparsity.skippable_bit_ratio(q_ref, g, n_bits)
    s = TK.quantize_scale(x_port, scale).item()
    assert emulate_fused(x_port.float().numpy(), s, g, n_bits) == want
    if case.startswith("ties"):
        frac = np.abs(x_port.float().numpy() / s) % 1     # all ties but the amax element
        assert s == 0.25 and (frac == 0.5).sum() == frac.size - (case == "ties")
    if case == "clamp":
        assert q_ref.min() == -128 and q_ref.max() == 127


def test_quantize_and_ratio_helpers_match_reference(R):
    x = RNG.normal(size=(5, 40)).astype(np.float32)
    for scale in (None, 0.01, 0.0371):
        np.testing.assert_array_equal(
            TI.quantize_int8(torch.from_numpy(x), per_tensor_scale=scale).numpy(),
            R.input_sparsity.quantize_int8(x, per_tensor_scale=scale))
    q = RNG.integers(-128, 128, size=(70,)).astype(np.int8)
    assert TI.skippable_bit_ratio(torch.from_numpy(q), 32) == \
        R.input_sparsity.skippable_bit_ratio(q, 32)
    for args in [(0.0, 32), (0.5, 8, 8, 3.0), (0.9, 128, 4)]:
        assert TI.analytic_skip_ratio(*args) == R.input_sparsity.analytic_skip_ratio(*args)


def test_capture_mlp_activations_like_reference(R, qwen):
    """The reference's helper takes any ``apply_fn`` returning (out,
    intermediates); the port's model provides one through ``_run``'s tap."""
    _, cfg, _, _, _, _, cp = qwen

    def apply_fn(params, toks):
        inter = {}
        x, _ = TT._run(params, toks, cfg, "auto", False,
                          tap=lambda l, k, a: inter.__setitem__(f"l{l}/{k}", a))
        return x, inter

    toks = torch.arange(10).reshape(1, 10)
    names = ["l0/mlp_in", "l1/down_in", "l9/none"]
    got = TI.capture_mlp_activations(apply_fn, cp, toks, names)
    _, inter = apply_fn(cp, toks)
    want = R.input_sparsity.capture_mlp_activations(
        lambda p, s: (None, {k: v.numpy() for k, v in inter.items()}), None, None, names)
    assert sorted(got) == sorted(want) == ["l0/mlp_in", "l1/down_in"]
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


# ---------------------------------------------------------------------------
# Kernel microbenchmarks
# ---------------------------------------------------------------------------

def test_microbench_samples_match_reference_and_fit(R, tmp_path):
    want = R.harvest.microbench_kernels(sizes=(64,), repeats=1)
    got = TH.microbench_kernels(device="cpu", sizes=(64,), repeats=1)

    def key(s):
        return (s.op_class, s.flops, s.bytes, dict(s.meta)["shape"])

    assert sorted(map(key, got.samples)) == sorted(map(key, want.samples))
    assert all(s.time_s > 0 and dict(s.meta)["impl"] == "ref" for s in got.samples)
    assert {dict(s.meta)["device"] for s in got.samples} == {"cpu:cpu"}
    path = TH.write_samples(got.samples, tmp_path / "samples.jsonl", append=False)
    assert TH.read_samples(path) == got.samples
    theirs = R.harvest.from_ledger(path)
    assert [s.to_record() for s in theirs.samples] == [s.to_record() for s in got.samples]
    assert theirs.skipped_untimed == theirs.skipped_malformed == 0
    prof = R.fit.fit_profile(theirs.samples, name="port-cpu")
    assert prof.device == "cpu:cpu" and set(prof.efficiency) == {"attention", "matmul",
                                                                  "intrablock"}


def test_microbench_lets_a_kernel_failure_propagate():
    """The reference drops the sample of a failing kernel; the port raises
    (here: impl="cuda" on CPU tensors)."""
    with pytest.raises(ValueError, match="CUDA"):
        TH.microbench_kernels(device="cpu", sizes=(128,), repeats=1, impl="cuda")


def test_harvest_copy_reads_ledgers_like_reference(R, tmp_path):
    path = tmp_path / "ledger.jsonl"
    path.write_text("\n".join([
        '{"op_class": "matmul", "flops": 10, "bytes": 20, "time_s": 0.5, "meta": {"a": 1}}',
        '{"kind": "decode", "flops": 1, "bytes_accessed": 2, "wall_s": 0.1, '
        '"collective_bytes": {"all_reduce": 3, "count": 9}, "arch": "x"}',
        '{"kind": "train", "flops": 1, "bytes_accessed": 2}',
        'not json', '{"op_class": "x", "time_s": -1}', '']))
    ours, theirs = TH.from_ledger(path), R.harvest.from_ledger(path)
    assert [s.to_record() for s in ours.samples] == [s.to_record() for s in theirs.samples]
    assert (ours.skipped_untimed, ours.skipped_malformed) == \
        (theirs.skipped_untimed, theirs.skipped_malformed) == (1, 2)
    merged = ours.merged(ours)
    assert len(merged.samples) == 4 and merged.skipped_malformed == 4
