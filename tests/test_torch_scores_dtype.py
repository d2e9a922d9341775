"""The score tiles' dtype of ``chunked_attention`` (``set_scores_dtype``,
the dry-run's ``--scores-bf16``) against the reference's.

* In bf16, the port's ``chunked_attention`` on bf16 inputs equals the
  reference's generic path with ``set_scores_dtype(jnp.bfloat16)`` run op
  by op (``jax.disable_jit``), within ``BF16_TOL``: each op rounds to bf16
  as the card's does.  Jitted, XLA's CPU compiler drops some of the
  roundings between fused elementwise ops (it simplifies convert pairs),
  so the reference moves by up to 2^-6 at these magnitudes; eager, the two
  agree to the bit here.  The reference tiles only where Sq = Skv > chunk
  (``repro/models/layers.py:216-217``), so its tiled path is switched off.
* In f32, the default, the output and the op log on ``meta`` equal those
  of the loop as it was before the knob (a frozen copy below), bit for bit.
* On ``meta``, the counted bytes of qwen3-4b's train_4k and decode_32k fall
  by the fall of one layer's attention call, times the calls the cell
  makes; prefill_32k (flash) does not move.

Both packages' knobs are module globals, and xdist reuses a worker: the
fixtures put both back to f32 (and the reference's tiling on) even when a
test fails.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _jax_reference
from repro_torch.configs import SHAPE_CELLS, get_config
from repro_torch.launch import counting, dryrun
from repro_torch.models import layers as TL

R = _jax_reference.load()

# one bf16 ulp at magnitude 1 (the outputs here are below 4 in magnitude)
BF16_TOL = 2.0 ** -8


@pytest.fixture
def f32_after():
    """Both packages' scores dtype back to f32, the reference's tiling on."""
    try:
        yield
    finally:
        TL.set_scores_dtype(torch.float32)
        R.layers.set_scores_dtype(jnp.float32)
        R.layers.set_tiled_attn(True)


def _set(dtype_name: str) -> None:
    TL.set_scores_dtype(getattr(torch, dtype_name))
    R.layers.set_scores_dtype(getattr(jnp, dtype_name))


def _arg(a, mod):
    return a if a is None or isinstance(a, int) else mod.asarray(np.asarray(a, np.int32))


CASES = {
    # Sq, Skv, q_offset, kv_len, window, cap, chunk
    "causal": (40, 40, 0, None, None, 0.0, 16),
    "window": (40, 40, 0, None, 16, 0.0, 16),
    "softcap": (40, 40, 0, None, 16, 50.0, 16),         # gemma2's local layer, past its cap
    "softcap-one-chunk": (40, 40, 0, None, None, 50.0, 1024),
    "decode-kv_len": (1, 48, [20, 45], [21, 46], None, 0.0, 48),
    "kv_len-scalar-offset": (5, 40, 30, [35, 40], None, 0.0, 16),
}


def _inputs(case):
    Sq, Skv, _, _, _, cap, _ = case
    rng = np.random.default_rng(2)
    B, Hq, Hkv, hd = 2, 4, 2, 16
    q = rng.normal(size=(B, Sq, Hq, hd)).astype(np.float32) * np.float32(30.0 if cap else 3.0)
    k = rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32)
    if cap:
        scores = np.einsum("bqhd,bkhd->bhqk", q[:, :, ::2], k) / math.sqrt(hd)
        assert np.abs(scores).max() > 2 * cap            # the cap bites
    return q, k, v


def _both(case, dtype_name):
    """(port, reference) outputs as f32 numpy, on bf16 inputs."""
    _, _, q_offset, kv_len, window, cap, chunk = case
    q, k, v = _inputs(case)
    _set(dtype_name)
    kw = dict(causal=True, chunk=chunk, attn_cap=cap)
    with R.active(), jax.disable_jit():
        want = R.layers.chunked_attention(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), window=_arg(window, jnp),
            q_offset=_arg(q_offset, jnp), kv_len=_arg(kv_len, jnp), **kw)
    got = TL.chunked_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), window=_arg(window, torch),
        q_offset=_arg(q_offset, torch), kv_len=_arg(kv_len, torch), **kw)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_scores_match_the_references(name, f32_after):
    R.layers.set_tiled_attn(False)
    got, want = _both(CASES[name], "bfloat16")
    assert np.abs(got - want).max() <= BF16_TOL
    # the knob moves the result past that bound: f32 scores differ
    got32, want32 = _both(CASES[name], "float32")
    assert np.abs(got32 - want32).max() <= BF16_TOL
    assert np.abs(got - got32).max() > 2 * BF16_TOL


def test_scores_dtype_context_restores_and_the_default_is_f32(f32_after):
    assert TL._SCORES_DTYPE == torch.float32
    with TL.scores_dtype(torch.bfloat16):
        assert TL._SCORES_DTYPE == torch.bfloat16
        with pytest.raises(KeyError):
            with TL.scores_dtype(torch.float16):
                raise KeyError("inside")
        assert TL._SCORES_DTYPE == torch.bfloat16
    assert TL._SCORES_DTYPE == torch.float32
    assert TL.set_scores_dtype(torch.bfloat16) == torch.float32


# ---------------------------------------------------------------------------
# The f32 default: the loop as it was, bit for bit
# ---------------------------------------------------------------------------

def _frozen_chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0, kv_len=None,
                              attn_cap=0.0, prefix=0, chunk=1024):
    """The port's ``chunked_attention`` before the scores-dtype knob, kept
    as the oracle of the f32 default."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    nchunks = max(1, math.ceil(Skv / chunk))
    pad = nchunks * chunk - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    q_idx = TL._as_batch(q_offset, B, dev)[:, None] + torch.arange(Sq, device=dev)[None, :]
    kvl = None if kv_len is None else TL._as_batch(kv_len, B, dev)
    win = None if window is None else TL._as_batch(window, B, dev)
    m = torch.full((B, Hkv, G, Sq), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, G, Sq), device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, hd), device=dev)
    for ci in range(nchunks):
        k_i = k[:, ci * chunk:(ci + 1) * chunk]
        v_i = v[:, ci * chunk:(ci + 1) * chunk]
        k_idx = ci * chunk + torch.arange(chunk, device=dev)
        ok = torch.ones((B, Sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            seen = k_idx[None, None, :] <= q_idx[:, :, None]
            if prefix > 0:
                seen |= (q_idx[:, :, None] < prefix) & (k_idx[None, None, :] < prefix)
            ok &= seen
        if win is not None:
            ok &= k_idx[None, None, :] > q_idx[:, :, None] - win[:, None, None]
        if kvl is not None:
            ok &= k_idx[None, None, :] < kvl[:, None, None]
        if pad:
            ok &= (k_idx < Skv)[None, None, :]
        bias = torch.zeros(ok.shape, device=dev).masked_fill(~ok, float("-inf"))
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_i.float()) * scale
        s = TL.softcap(s, attn_cap) + bias[:, None, None]
        m_cur = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isinf(m_cur), torch.zeros_like(m_cur), m_cur)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_i.dtype).float(), v_i.float())
        acc = acc * corr[..., None] + pv
        m = m_cur
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CASES) + ["prefix", "bidirectional"])
def test_the_f32_default_is_the_loop_it_was_bit_for_bit(name, dtype):
    case = CASES.get(name, CASES["causal"])
    _, _, q_offset, kv_len, window, cap, chunk = case
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(case))
    kw = dict(window=_arg(window, torch), q_offset=_arg(q_offset, torch),
              kv_len=_arg(kv_len, torch), attn_cap=cap, chunk=chunk,
              causal=name != "bidirectional", prefix=6 if name == "prefix" else 0)
    assert torch.equal(TL.chunked_attention(q, k, v, **kw), _frozen_chunked_attention(q, k, v, **kw))

    def on_meta(fn):
        mk = {n: (a.to("meta") if torch.is_tensor(a) else a) for n, a in kw.items()}
        args = tuple(t.to("meta") for t in (q, k, v))
        with counting.count((args, mk)) as c:
            fn(*args, **mk)
        return c

    a, b = on_meta(TL.chunked_attention), on_meta(_frozen_chunked_attention)
    assert (a.oplog, a.flops, a.bytes_accessed, a.peak_bytes) == \
        (b.oplog, b.flops, b.bytes_accessed, b.peak_bytes)


# ---------------------------------------------------------------------------
# The counted bytes of qwen3-4b's cells
# ---------------------------------------------------------------------------

def _attention_call(dtype_name, B, Sq, Skv, *, grad, chunk=1024):
    """Counted bytes of one of qwen3-4b's ``chunked_attention`` calls at the
    cell's layer shape (forward, and with ``grad`` its backward too)."""
    cfg = get_config("qwen3-4b")
    hd, Hq, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    with TL.scores_dtype(getattr(torch, dtype_name)):
        q = torch.empty(B, Sq, Hq, hd, dtype=torch.bfloat16, device="meta", requires_grad=grad)
        k = torch.empty(B, Skv, Hkv, hd, dtype=torch.bfloat16, device="meta", requires_grad=grad)
        v = torch.empty(B, Skv, Hkv, hd, dtype=torch.bfloat16, device="meta", requires_grad=grad)
        kw = {} if Sq == Skv else dict(q_offset=torch.zeros((), dtype=torch.int32, device="meta"),
                                       chunk=Skv)
        with counting.count((q, k, v)) as c, torch.set_grad_enabled(grad):
            out = TL.chunked_attention(q, k, v, **kw)
            if grad:
                torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    return c.bytes_accessed


def _cell_bytes(name, dtype_name):
    with TL.scores_dtype(getattr(torch, dtype_name)):
        c = dryrun.count_cell(get_config("qwen3-4b"), SHAPE_CELLS[name])
    return c


@pytest.fixture(scope="module")
def qwen_cells():
    return {(name, dt): _cell_bytes(name, dt)
            for name in ("train_4k", "prefill_32k", "decode_32k")
            for dt in ("float32", "bfloat16")}


def test_bf16_scores_cut_the_counted_score_traffic_of_train_and_decode(qwen_cells):
    L = get_config("qwen3-4b").n_layers
    # decode_32k: one forward call a layer over the whole cache
    B, S = SHAPE_CELLS["decode_32k"].global_batch, SHAPE_CELLS["decode_32k"].seq_len
    call = _attention_call("float32", B, 1, S, grad=False) \
        - _attention_call("bfloat16", B, 1, S, grad=False)
    fell = qwen_cells["decode_32k", "float32"].bytes_accessed \
        - qwen_cells["decode_32k", "bfloat16"].bytes_accessed
    assert call > 0 and fell == L * call
    # the score tiles are most of that call's traffic: they halve, the rest does not move
    f32 = _attention_call("float32", B, 1, S, grad=False)
    assert call > 0.25 * f32
    # train_4k under remat "minimal": per layer a forward, its recompute and the backward
    B, S = SHAPE_CELLS["train_4k"].global_batch, SHAPE_CELLS["train_4k"].seq_len
    fwd = _attention_call("float32", B, S, S, grad=False) \
        - _attention_call("bfloat16", B, S, S, grad=False)
    fwd_bwd = _attention_call("float32", B, S, S, grad=True) \
        - _attention_call("bfloat16", B, S, S, grad=True)
    fell = qwen_cells["train_4k", "float32"].bytes_accessed \
        - qwen_cells["train_4k", "bfloat16"].bytes_accessed
    assert fwd > 0 and fwd_bwd > fwd
    assert fell == L * (fwd + fwd_bwd)


def test_bf16_scores_leave_flash_and_the_flops_alone(qwen_cells):
    a, b = qwen_cells["prefill_32k", "float32"], qwen_cells["prefill_32k", "bfloat16"]
    assert a.flops_by_kind["kernel"] > 0
    assert (a.flops, a.bytes_accessed, a.peak_bytes, a.oplog) == \
        (b.flops, b.bytes_accessed, b.peak_bytes, b.oplog)
    for name in ("train_4k", "decode_32k"):
        a, b = qwen_cells[name, "float32"], qwen_cells[name, "bfloat16"]
        assert a.flops_by_kind["matmul"] == b.flops_by_kind["matmul"]
        assert b.peak_bytes <= a.peak_bytes


def test_the_cli_flag_sets_bf16_for_the_run_and_restores_f32(tmp_path, monkeypatch):
    seen = []
    real = dryrun.run_cell

    def spy(*a, **kw):
        seen.append(TL._SCORES_DTYPE)
        return real(*a, **kw)

    monkeypatch.setattr(dryrun, "run_cell", spy)
    out = tmp_path / "d.jsonl"
    base = ["--arch", "qwen3-4b", "--cell", "decode_32k", "--batch", "2", "--out", str(out)]
    assert dryrun.main(base + ["--scores-bf16"]) == 0
    assert dryrun.main(base) == 0
    assert seen == [torch.bfloat16, torch.float32]
    assert TL._SCORES_DTYPE == torch.float32
    bf16, f32 = [__import__("json").loads(l) for l in out.read_text().splitlines()]
    assert bf16["bytes_accessed"] < f32["bytes_accessed"] and bf16["flops"] == f32["flops"]
