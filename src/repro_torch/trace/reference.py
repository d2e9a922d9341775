"""Shape-faithful reference programs for the differential trace harness, in
PyTorch (the port's counterpart of ``repro.trace.reference``).

Small programs whose MVM structure mirrors the hand-built DAGs
(:func:`repro_torch.core.workload.lm_workload` and the CNN builders) op for
op: stacked per-layer weights scanned over ``n_layers``
(:func:`~.capture.scan`), top-k expert-gather MoE dispatch, GQA by
repeating K/V heads, fused gate+up MLP projections.  Captured
(:mod:`.capture`) and lowered (:mod:`.lower`), their MVM ``total_macs()``
and weights must equal the hand DAG's exactly.

They are written op for op from the equations of the reference's committed
golden graphs (``tests/fixtures/trace/*.json``), so that their lowered
elementwise volume equals the reference's too, not only their MVM volume:
``jnp.take``'s index wrap (``lt``, ``add``, ``select_n``) before the row
``gather`` of the ``embed`` parameter; ``_rms_norm`` as ``mul``,
``reduce_sum``, ``div``, ``add``, ``sqrt``, ``integer_pow(-1)`` and ``mul``;
softmax as ``reduce_max``, ``max`` with -inf, ``stop_gradient``, ``sub``,
``exp``, ``reduce_sum`` and ``div``; SiLU as ``logistic``·x; each einsum
as the ``dot_general`` jax makes of it, its operands in jax's order (the
attention context is vᵀ·Pᵀ: K = T, N = S, V = B·H·hd); maxpool as
``reduce_window_max``.

They are cost mirrors, not numerics mirrors: no causal mask, no RoPE, no
flash tiling, no MoE capacity.  The hand DAGs model none of these either,
so a disagreement is a capture or lowering fault.  They run on ``meta``
tensors in float32, as the reference's on ``ShapeDtypeStruct``\\ s.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Tuple

from .capture import scan

if TYPE_CHECKING:
    import torch

__all__ = ["reference_program", "cnn_program", "CNN_REFERENCES"]


def _sds(shape, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A ``meta`` tensor, float32 unless ``dtype`` says otherwise."""
    import torch

    return torch.empty(tuple(shape), dtype=torch.float32 if dtype is None else dtype,
                       device="meta")


# ---------------------------------------------------------------------------
# LM reference: mirrors lm_workload's per-layer block, scanned over L.
# ---------------------------------------------------------------------------

def _lm_params(cfg):
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.head_dim
    p = {"embed": _sds((cfg.vocab_size, d))}
    if cfg.attention != "none":
        p["wq"] = _sds((L, d, cfg.n_heads * hd))
        p["wk"] = _sds((L, d, cfg.n_kv_heads * hd))
        p["wv"] = _sds((L, d, cfg.n_kv_heads * hd))
        p["wo"] = _sds((L, cfg.n_heads * hd, d))
    n_up = 2 if cfg.gated_mlp else 1
    if cfg.n_experts > 1:
        p["w_router"] = _sds((L, d, cfg.n_experts))
        p["w_up"] = _sds((L, cfg.n_experts, d, cfg.d_ff * n_up))
        p["w_down"] = _sds((L, cfg.n_experts, cfg.d_ff, d))
    elif cfg.d_ff > 0:
        p["w_up"] = _sds((L, d, cfg.d_ff * n_up))
        p["w_down"] = _sds((L, cfg.d_ff, d))
    if cfg.ssm_state > 0:
        din = cfg.ssm_inner(d)
        p["w_in"] = _sds((L, d, din * 2))
        p["w_out"] = _sds((L, din, d))
    p["norm_scale"] = _sds((d,))
    p["lm_head"] = _sds((d, cfg.vocab_size))
    return p


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """jnp's wrap of a negative index: ``lt``, ``add``, ``select_n``."""
    import torch

    return torch.where(idx < 0, idx + n, idx)


def _take(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, tokens, axis=0)``: the wrap, then a row gather."""
    import torch.nn.functional as F

    return F.embedding(_wrap(tokens, table.shape[0]), table)


def _rms_norm(x, scale):
    import torch

    m = (x * x).sum(-1, keepdim=True) / x.shape[-1]
    return x * torch.reciprocal(torch.sqrt(m + 1e-6)) * scale


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(s, axis=-1)``, primitive for primitive."""
    import torch

    m = torch.maximum(torch.full((), float("-inf"), device=s.device), s.amax(-1))
    e = torch.exp(s - m[..., None].detach())
    return e / e.sum(-1, keepdim=True)


def _repeat_heads(t: torch.Tensor, G: int) -> torch.Tensor:
    """``jnp.repeat(t, G, axis=2)`` (a broadcast and a reshape)."""
    B, T, H, hd = t.shape
    return t[:, :, :, None, :].expand(B, T, H, G, hd).reshape(B, T, H * G, hd)


def _attn_block(x, lp, cfg, *, kv=None):
    """Full (unmasked) attention over ``kv`` context (defaults to self)."""
    import torch

    B, S, _ = x.shape
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ lp["wq"]).reshape(B, S, Hq, hd)
    if kv is None:
        k = (x @ lp["wk"]).reshape(B, S, Hkv, hd)
        v = (x @ lp["wv"]).reshape(B, S, Hkv, hd)
        ret = (k, v)
    else:
        k, v = kv
        ret = None
    if Hkv != Hq:
        k = _repeat_heads(k, Hq // Hkv)
        v = _repeat_heads(v, Hq // Hkv)
    scores = torch.matmul(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) * (hd ** -0.5)
    probs = _softmax(scores)                                          # (B, H, S, T)
    ctx = torch.matmul(v.permute(0, 2, 3, 1), probs.transpose(-1, -2))  # (B, H, hd, S)
    o = ctx.permute(0, 3, 1, 2).reshape(B, S, Hq * hd) @ lp["wo"]
    return x + o, ret


def _silu_gate(h, cfg):
    import torch.nn.functional as F

    if cfg.gated_mlp:
        a, b = h.split(h.shape[-1] // 2, dim=-1)
        return F.silu(a) * b
    return F.silu(h)


def _ffn_block(x, lp, cfg):
    import torch

    if cfg.n_experts > 1:
        B, S, d = x.shape
        E, K = cfg.n_experts, cfg.top_k
        gate = x @ lp["w_router"]
        top_p, top_e = torch.topk(_softmax(gate), K)
        up_sel = lp["w_up"][_wrap(top_e, E)]        # (B,S,k,d,ff·n_up) — selection
        dn_sel = lp["w_down"][_wrap(top_e, E)]      # stays a weight view (lowering)
        F_up = up_sel.shape[-1]
        # einsum("bsd,bskdf->bskf"): one dot over (b, s), N = k·ff·n_up
        h = torch.matmul(x[:, :, None, :],
                         up_sel.permute(0, 1, 3, 2, 4).reshape(B, S, d, K * F_up))
        h = _silu_gate(h.reshape(B, S, K, F_up), cfg)
        # einsum("bskf,bskfd->bskd"): one dot over (b, s, k)
        y = torch.matmul(h[..., None, :], dn_sel)[..., 0, :]
        return x + (y * top_p[..., None]).sum(2)
    h = _silu_gate(x @ lp["w_up"], cfg)
    return x + h @ lp["w_down"]


def _ssm_block(x, lp, cfg):
    """State mixing abstracted to elementwise work: the hand DAG prices
    only the in/out projections as MVMs, and so must the reference."""
    import torch
    import torch.nn.functional as F

    xp = x @ lp["w_in"]
    z, g = xp.split(xp.shape[-1] // 2, dim=-1)
    h = F.silu(z) * torch.tanh(g)
    return x + h @ lp["w_out"]


def _layer(x, lp, cfg, *, kv=None):
    ret = None
    if cfg.attention != "none":
        x, ret = _attn_block(x, lp, cfg, kv=kv)
    if cfg.n_experts > 1 or cfg.d_ff > 0:
        x = _ffn_block(x, lp, cfg)
    if cfg.ssm_state > 0:
        x = _ssm_block(x, lp, cfg)
    return x, ret


def _stacked(params, cfg):
    """The per-layer (scanned) subset of the parameter dict."""
    return {k: v for k, v in params.items() if k not in ("embed", "norm_scale", "lm_head")}


def reference_program(cfg, *, step: str, seq_len: int,
                      batch: int) -> Tuple[object, dict, tuple]:
    """(fn, meta params, meta args) for one LM step kind."""
    import torch

    params = _lm_params(cfg)
    B, S = batch, seq_len
    toks = _sds((B, S), torch.int32)

    if step == "forward":
        def fn(p, tokens):
            x = _take(p["embed"], tokens)

            def body(x, lp):
                x, _ = _layer(x, lp, cfg)
                return x, None

            x, _ = scan(body, x, _stacked(p, cfg))
            x = _rms_norm(x, p["norm_scale"])
            return x @ p["lm_head"]
        return fn, params, (toks,)

    if step == "prefill":
        def fn(p, tokens):
            x = _take(p["embed"], tokens)

            def body(x, lp):
                return _layer(x, lp, cfg)

            x, cache = scan(body, x, _stacked(p, cfg))
            x = _rms_norm(x, p["norm_scale"])
            return x @ p["lm_head"], cache
        return fn, params, (toks,)

    if step == "decode":
        tok1 = _sds((B, 1), torch.int32)
        cache = {}
        if cfg.attention != "none":
            hd, Hkv, L = cfg.head_dim, cfg.n_kv_heads, cfg.n_layers
            cache = {"k": _sds((L, B, S, Hkv, hd)), "v": _sds((L, B, S, Hkv, hd))}

        def fn(p, tokens, cache):
            x = _take(p["embed"], tokens)
            xs = _stacked(p, cfg)
            if cache:
                xs = (xs, cache["k"], cache["v"])

                def body(x, sc):
                    lp, ck, cv = sc
                    x, _ = _layer(x, lp, cfg, kv=(ck, cv))
                    return x, None
            else:
                def body(x, lp):
                    x, _ = _layer(x, lp, cfg)
                    return x, None

            x, _ = scan(body, x, xs)
            x = _rms_norm(x, p["norm_scale"])
            return x @ p["lm_head"]
        return fn, params, (tok1, cache)

    raise ValueError(f"unknown step {step!r}")


# ---------------------------------------------------------------------------
# CNN references: mirror the paper-model builders (vgg16 / resnet18/50).
# ---------------------------------------------------------------------------

def _conv2d(x, w, stride=1):
    """A "SAME" convolution (odd kernels: the output is ceil(H / stride))."""
    import torch.nn.functional as F

    return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)


def _relu(x):
    import torch.nn.functional as F

    return F.relu(x)


def _maxpool2(x):
    import torch.nn.functional as F

    return F.max_pool2d(x, 2, 2)


def _vgg16_program(img: int, num_classes: int):
    layout = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]

    params, cin, hw, i = {}, 3, img, 0
    for v in layout:
        if v == "M":
            hw //= 2
        else:
            params[f"conv{i}"] = _sds((v, cin, 3, 3))
            cin, i = v, i + 1
    flat = cin * hw * hw
    if img >= 224:
        params["fc1"] = _sds((flat, 4096))
        params["fc2"] = _sds((4096, 4096))
        params["fc3"] = _sds((4096, num_classes))
    else:
        params["fc1"] = _sds((flat, 512))
        params["fc2"] = _sds((512, num_classes))

    def fn(p, x):
        i = 0
        for v in layout:
            if v == "M":
                x = _maxpool2(x)
            else:
                x = _relu(_conv2d(x, p[f"conv{i}"]))
                i += 1
        x = x.reshape(1, -1)
        x = x @ p["fc1"]
        x = x @ p["fc2"]
        if "fc3" in p:
            x = x @ p["fc3"]
        return x

    return fn, params, (_sds((1, 3, img, img)),)


def _resnet_program(blocks, bottleneck: bool, img: int, num_classes: int):
    params = {}
    stem_k = 7 if img >= 224 else 3
    params["stem"] = _sds((64, 3, stem_k, stem_k))
    cin = 64
    for stage, (n_blocks, width) in enumerate(zip(blocks, (64, 128, 256, 512))):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            tag = f"s{stage}b{b}"
            if bottleneck:
                params[f"{tag}_c1"] = _sds((width, cin, 1, 1))
                params[f"{tag}_c2"] = _sds((width, width, 3, 3))
                params[f"{tag}_c3"] = _sds((width * 4, width, 1, 1))
                out_c = width * 4
            else:
                params[f"{tag}_c1"] = _sds((width, cin, 3, 3))
                params[f"{tag}_c2"] = _sds((width, width, 3, 3))
                out_c = width
            if stride != 1 or cin != out_c:
                params[f"{tag}_sc"] = _sds((out_c, cin, 1, 1))
            cin = out_c
    params["fc"] = _sds((cin, num_classes))

    def fn(p, x):
        x = _conv2d(x, p["stem"], 2 if img >= 224 else 1)
        if img >= 224:
            x = _maxpool2(x)
        for stage, (n_blocks, width) in enumerate(zip(blocks, (64, 128, 256, 512))):
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                tag = f"s{stage}b{b}"
                if bottleneck:
                    h = _relu(_conv2d(x, p[f"{tag}_c1"]))
                    h = _relu(_conv2d(h, p[f"{tag}_c2"], stride))
                    h = _conv2d(h, p[f"{tag}_c3"])
                else:
                    h = _relu(_conv2d(x, p[f"{tag}_c1"], stride))
                    h = _conv2d(h, p[f"{tag}_c2"])
                sc = _conv2d(x, p[f"{tag}_sc"], stride) if f"{tag}_sc" in p else x
                x = _relu(h + sc)
        x = x.sum((2, 3)) / (x.shape[2] * x.shape[3])
        return x @ p["fc"]

    return fn, params, (_sds((1, 3, img, img)),)


CNN_REFERENCES = ("vgg16", "resnet18", "resnet50")


def cnn_program(model: str, *, img: int = 32, num_classes: int = 100):
    if model == "vgg16":
        return _vgg16_program(img, num_classes)
    if model == "resnet18":
        return _resnet_program((2, 2, 2, 2), False, img, num_classes)
    if model == "resnet50":
        return _resnet_program((3, 4, 6, 3), True, img, num_classes)
    raise ValueError(f"no CNN reference for {model!r}; choose from {CNN_REFERENCES}")
