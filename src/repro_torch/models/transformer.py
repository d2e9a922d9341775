"""Dense decoder stack (port of the dense family of
``repro/models/transformer.py``).

Parameters are a plain dict laid out like the reference pytree: layer
weights stacked on a leading L axis (``wq`` (L, d, Hq, hd), ``wo``
(L, Hq, hd, d), ...), plus ``embed``, ``final_norm`` and ``lm_head``.
A pruned projection may be a compressed module
(:class:`~.layers.BlockSparseLinear` or :class:`~.layers.IntraBlockLinear`)
instead of a dense tensor.  The reference's ``lax.scan`` over layers is
a Python loop here.

Entry points:

* ``forward``     — logits over a full sequence;
* ``prefill``     — forward + the per-layer KV cache, last-token logits;
* ``decode_step`` — one token per sequence against a cache, at a scalar
  or per-sequence (B,) position.  It writes the cache in place.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from .layers import COMPRESSED, attention_block, mlp_block, rms_norm

__all__ = ["init_params", "init_cache", "forward", "prefill", "decode_step"]

Params = Dict[str, Any]
Cache = Dict[str, Any]

_VOCAB_CHUNK = 16384      # lm_head columns widened to f32 at a time


def _check_supported(cfg: ArchConfig) -> None:
    """The port covers the dense GQA decoder with global attention."""
    if (cfg.family != "dense" or cfg.n_experts > 1 or cfg.attention != "global"
            or cfg.attn_softcap > 0 or cfg.ssm_state or cfg.enc_dec or cfg.prefix_len):
        raise NotImplementedError(
            f"{cfg.name}: only the dense family with global attention and no "
            "attention softcap is ported to repro_torch")


def _layer_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    shapes = {"ln1": (d,), "ln2": (d,),
              "wq": (d, Hq, hd), "wk": (d, Hkv, hd), "wv": (d, Hkv, hd),
              "wo": (Hq, hd, d), "w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)}
    if cfg.gated_mlp:
        shapes["w_gate"] = (d, cfg.d_ff)
    if cfg.qk_norm:
        shapes.update({"q_norm": (hd,), "k_norm": (hd,)})
    if cfg.post_norms:
        shapes.update({"post_ln1": (d,), "post_ln2": (d,)})
    return shapes


def init_params(cfg: ArchConfig, seed: int = 0, *, dtype=torch.bfloat16,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random weights with the reference init's distributions.

    Norm scales are zero; a weight of per-layer shape ``shp`` is normal
    with std 1/sqrt(fan_in) (fan_in = d_model for wq/wk/wv, else the
    product of all but the last dim); embed and lm_head have std
    1/sqrt(d).  Drawn on ``device`` (default ``cuda``) from a
    ``torch.Generator`` seeded with ``seed``, one layer at a time so the
    f32 draw never holds more than one layer.
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, L = cfg.d_model, cfg.n_layers

    def normal(shape, std):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    layers = {}
    for name, shp in sorted(_layer_shapes(cfg).items()):
        if name.startswith(("ln", "post_ln")) or name.endswith("_norm"):
            layers[name] = torch.zeros((L,) + shp, dtype=dtype, device=dev)
            continue
        fan_in = d if name in ("wq", "wk", "wv") else math.prod(shp[:-1])
        std = 1.0 / math.sqrt(max(fan_in, 1))
        w = torch.empty((L,) + shp, dtype=dtype, device=dev)
        for l in range(L):
            w[l] = normal(shp, std)
        layers[name] = w
    params: Params = {
        "embed": normal((cfg.vocab_size, d), 1.0 / math.sqrt(d)),
        "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), 1.0 / math.sqrt(d))
    return params


def _layer(layers: Dict[str, Any], l: int) -> Dict[str, Any]:
    return {k: (w.layer(l) if isinstance(w, COMPRESSED) else w[l])
            for k, w in layers.items()}


def _decoder_layer(x, lp, cfg: ArchConfig, *, positions, cache_kv=None,
                   cache_len=None, impl: str = "auto", tap=None):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if tap is not None:
        tap("attn_in", h)
    mix, kv = attention_block(h, lp, cfg, positions=positions, cache_kv=cache_kv,
                              cache_len=cache_len, impl=impl)
    if cfg.post_norms:
        mix = rms_norm(mix, lp["post_ln1"], cfg.norm_eps)
    x = x + mix
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if tap is not None:
        tap("mlp_in", h)
    ff = mlp_block(h, lp, cfg, impl, tap)
    if cfg.post_norms:
        ff = rms_norm(ff, lp["post_ln2"], cfg.norm_eps)
    return x + ff, kv


def _unembed(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    # f32 logits from the stored operands, as the reference's
    # preferred_element_type=f32: both are widened exactly to f32, so no
    # logit is rounded to bf16 before the softcap or the argmax.  The
    # weight is widened one vocab chunk at a time, so no f32 copy of the
    # whole matrix (2 GB for llama3-8b's lm_head) is ever held.
    x2 = x.reshape(-1, x.shape[-1]).float()
    logits = torch.cat([x2 @ w[:, i:i + _VOCAB_CHUNK].float()
                        for i in range(0, w.shape[1], _VOCAB_CHUNK)], dim=1)
    logits = logits.reshape(*x.shape[:-1], -1)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _run(params: Params, tokens: torch.Tensor, cfg: ArchConfig, impl: str,
         keep_cache: bool, tap: Optional[Callable[[int, str, torch.Tensor], None]] = None):
    """The decoder stack over full sequences.  ``tap(l, kind, act)``, when
    given, sees the inputs of layer ``l``'s pruned projections as they are
    made: ``attn_in`` (wq/wk/wv), ``mlp_in`` (w_gate/w_up) and
    ``down_in`` (w_down), each (B, S, features) (the §IV-B profile)."""
    _check_supported(cfg)
    x = params["embed"][tokens]
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        layer_tap = None if tap is None else (lambda kind, a, l=l: tap(l, kind, a))
        x, (k, v) = _decoder_layer(x, _layer(params["layers"], l), cfg,
                                   positions=positions, impl=impl, tap=layer_tap)
        if keep_cache:
            ks.append(k)
            vs.append(v)
    return x, ks, vs


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
            impl: str = "auto") -> torch.Tensor:
    """Logits (B, S, V) in f32 for int tokens (B, S)."""
    x, _, _ = _run(params, tokens, cfg, impl, keep_cache=False)
    return _unembed(params, x, cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device: Optional[Union[str, torch.device]] = None) -> Cache:
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    dev = resolve_device(device)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "k": torch.zeros((L, batch, max_len, Hkv, hd), dtype=dtype, device=dev),
            "v": torch.zeros((L, batch, max_len, Hkv, hd), dtype=dtype, device=dev)}


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
            impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
    """Run the prompt; returns last-token logits (B, 1, V) and the cache
    {"pos": S, "k"/"v": (L, B, S, Hkv, hd)}."""
    x, ks, vs = _run(params, tokens, cfg, impl, keep_cache=True)
    logits = _unembed(params, x[:, -1:], cfg)
    S = tokens.shape[1]
    cache = {"pos": torch.full((), S, dtype=torch.int32, device=x.device),
             "k": torch.stack(ks), "v": torch.stack(vs)}
    return logits, cache


def decode_step(params: Params, tokens: torch.Tensor, cfg: ArchConfig, cache: Cache, *,
                impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
    """One new token per sequence against ``cache``; returns logits (B, V)
    and the cache with ``pos`` advanced.  ``cache["k"]``/``["v"]`` are
    updated in place (the reference returns new buffers)."""
    _check_supported(cfg)
    if tokens.dim() == 1:
        tokens = tokens[:, None]
    x = params["embed"][tokens]
    B = x.shape[0]
    pos = torch.as_tensor(cache["pos"], device=x.device)
    positions = (pos if pos.dim() == 0 else pos[:, None]).expand(B, 1)
    for l in range(cfg.n_layers):
        x, _ = _decoder_layer(x, _layer(params["layers"], l), cfg, positions=positions,
                              cache_kv=(cache["k"][l], cache["v"][l]), cache_len=pos,
                              impl=impl)
    logits = _unembed(params, x, cfg)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits[:, 0], new_cache
