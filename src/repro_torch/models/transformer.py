"""Decoder stack (port of ``repro/models/transformer.py`` for the dense,
MoE, SSM and hybrid families): global attention (llama3, qwen3, gemma,
qwen3-moe, dbrx), gemma2's alternation of local (sliding-window) and
global layers with attention and final-logit softcaps and post-norms,
the attention-free Mamba-2 stack (mamba2) and hymba's hybrid layer, in
which sliding-window attention and the SSM mixer run side by side on the
same normed input, each branch normed before they are summed.  A layer's
FFN is the gated MLP, the top-k MoE block when the config has more than
one expert, or none when ``d_ff`` is 0.

Parameters are a plain dict laid out like the reference pytree: layer
weights stacked on a leading L axis (``wq`` (L, d, Hq, hd), ``wo``
(L, Hq, hd, d), ``w_in`` (L, d, 2·din + 2·N + H), ...), plus ``embed``,
``final_norm`` and ``lm_head``.  A pruned projection may be a compressed
module (:class:`~.layers.BlockSparseLinear` or
:class:`~.layers.IntraBlockLinear`) instead of a dense tensor.  The
reference's ``lax.scan`` over layers is a Python loop here.

Entry points:

* ``forward``     — logits over a full sequence;
* ``prefill``     — forward + the per-layer cache (k/v, SSM and conv
  states), last-token logits;
* ``decode_step`` — one token per sequence against a cache, at a scalar
  or per-sequence (B,) position.  It writes the cache in place.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from .layers import COMPRESSED, attention_block, mlp_block, moe_block, rms_norm, ssm_block

__all__ = ["init_params", "init_cache", "forward", "prefill", "decode_step", "layer_flags"]

Params = Dict[str, Any]
Cache = Dict[str, Any]

_VOCAB_CHUNK = 16384      # lm_head columns widened to f32 at a time


def _check_supported(cfg: ArchConfig) -> None:
    """The port covers the dense and MoE GQA decoders with global or
    alternating local/global attention (attention softcap allowed), the
    pure-SSM family (no attention) and the hybrid family (sliding-window
    attention beside the SSM mixer); encoder-decoder and prefix-LM configs
    are not ported yet."""
    ported = ((cfg.family in ("dense", "moe") and not cfg.ssm_state
               and cfg.attention in ("global", "local_global"))
              or (cfg.family == "ssm" and cfg.ssm_state and cfg.attention == "none")
              or (cfg.family == "hybrid" and cfg.ssm_state and cfg.attention == "sliding"))
    if not ported or cfg.enc_dec or cfg.prefix_len:
        raise NotImplementedError(
            f"{cfg.name}: only the dense, MoE, SSM and hybrid families are ported "
            "to repro_torch")


def layer_flags(cfg: ArchConfig) -> Tuple[bool, ...]:
    """Per-layer is-global-attention flags (the reference's ``layer_flags``,
    ``transformer.py:169-175``): gemma2 alternates local (even) and global
    (odd) layers.  Python bools, computed once, so the layer loop never
    reads a flag back from the card."""
    if cfg.attention == "local_global":
        return tuple(l % 2 == 1 for l in range(cfg.n_layers))
    if cfg.attention == "sliding":
        return (False,) * cfg.n_layers
    return (True,) * cfg.n_layers


def _windows(cfg: ArchConfig) -> Tuple[Optional[int], ...]:
    """Each layer's attention window: None on global layers, ``cfg.window``
    on local ones.  The reference passes its traced stand-in for "no
    window" (``_BIG_WINDOW``, a mask that is true everywhere) on global
    layers; None is the same mask."""
    return tuple(None if g else cfg.window for g in layer_flags(cfg))


def _layer_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Per-layer leaf shapes, as the reference's ``_layer_shapes``
    (``transformer.py:67-108``) gives them for a decoder."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    shapes: Dict[str, Tuple[int, ...]] = {"ln1": (d,)}
    if cfg.attention != "none":
        shapes.update({"wq": (d, Hq, hd), "wk": (d, Hkv, hd), "wv": (d, Hkv, hd),
                       "wo": (Hq, hd, d)})
        if cfg.qk_norm:
            shapes.update({"q_norm": (hd,), "k_norm": (hd,)})
    if cfg.d_ff > 0:
        shapes["ln2"] = (d,)
        if cfg.n_experts > 1:
            E = cfg.n_experts
            shapes.update({"w_router": (d, E), "w_up": (E, d, cfg.d_ff),
                           "w_down": (E, cfg.d_ff, d)})
        else:
            shapes.update({"w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)})
        if cfg.gated_mlp:
            shapes["w_gate"] = shapes["w_up"]
    if cfg.ssm_state > 0:
        din, N, H = cfg.ssm_inner(), cfg.ssm_state, cfg.ssm_heads
        shapes.update({"w_in": (d, 2 * din + 2 * N + H), "w_out": (din, d),
                       "conv_w": (4, din), "dt_bias": (H,), "A_log": (H,), "D_skip": (H,)})
        if cfg.family == "hybrid":
            shapes.update({"attn_branch_norm": (d,), "ssm_branch_norm": (d,)})
    if cfg.post_norms:
        shapes.update({"post_ln1": (d,), "post_ln2": (d,)})
    return shapes


# SSM leaves with a constant init, as the reference's: A = -exp(0) = -1
_CONSTANT_INIT = {"A_log": 0.0, "dt_bias": 0.0, "D_skip": 0.5}


def init_params(cfg: ArchConfig, seed: int = 0, *, dtype=torch.bfloat16,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random weights with the reference init's distributions.

    Norm scales are zero, ``A_log`` and ``dt_bias`` zero, ``D_skip`` 0.5;
    a weight of per-layer shape ``shp`` is normal with std 1/sqrt(fan_in)
    (fan_in = d_model for wq/wk/wv, else the product of all but the last
    dim: E·d for an expert leaf (E, d, ff), 4 for ``conv_w`` (4, din), as
    the reference has it); embed and lm_head have std 1/sqrt(d).  Drawn
    on ``device`` (default ``cuda``) from a ``torch.Generator`` seeded
    with ``seed``, one layer at a time so the f32 draw never holds more
    than one layer.
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
        if name in _CONSTANT_INIT:
            layers[name] = torch.full((L,) + shp, _CONSTANT_INIT[name], dtype=dtype, device=dev)
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


def _decoder_layer(x, lp, cfg: ArchConfig, *, positions, window=None, cache=None,
                   cache_len=None, impl: str = "auto", tap=None):
    """One decoder layer; returns (x, new) with this layer's cache entries:
    ``k``/``v`` where it attends, ``ssm``/``conv`` where it has the SSM
    mixer.  In decode ``cache`` holds this layer's slices of the cache
    buffers, which are written in place (the reference returns new ones)."""
    new = {}
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if tap is not None:
        tap("attn_in", h)
    if cfg.attention != "none":
        kv = None if cache is None else (cache["k"], cache["v"])
        ya, (new["k"], new["v"]) = attention_block(
            h, lp, cfg, positions=positions, window=window, cache_kv=kv, cache_len=cache_len,
            impl=impl)
    if cfg.ssm_state:
        state = conv = None
        if cache is not None:
            state, conv = cache["ssm"], cache["conv"]
        ys, new["ssm"], new["conv"] = ssm_block(h, lp, cfg, state=state, conv_state=conv,
                                                impl=impl)
        if cache is not None:
            state.copy_(new["ssm"])
            conv.copy_(new["conv"])
    if cfg.family == "hybrid":
        mix = (rms_norm(ya, lp["attn_branch_norm"], cfg.norm_eps)
               + rms_norm(ys, lp["ssm_branch_norm"], cfg.norm_eps))
    else:
        mix = ys if cfg.attention == "none" else ya
    if cfg.post_norms:
        mix = rms_norm(mix, lp["post_ln1"], cfg.norm_eps)
    x = x + mix
    if cfg.d_ff == 0:
        return x, new
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if tap is not None:
        tap("mlp_in", h)
    ff = moe_block(h, lp, cfg) if cfg.n_experts > 1 else mlp_block(h, lp, cfg, impl, tap)
    if cfg.post_norms:
        ff = rms_norm(ff, lp["post_ln2"], cfg.norm_eps)
    return x + ff, new


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
    """The decoder stack over full sequences; returns (x, caches), caches
    mapping each cache entry of :func:`_decoder_layer` to its per-layer
    list (empty unless ``keep_cache``).  ``tap(l, kind, act)``, when
    given, sees the inputs of layer ``l``'s pruned projections as they are
    made: ``attn_in`` (wq/wk/wv), ``mlp_in`` (w_gate/w_up, or the MoE
    block's router and experts) and ``down_in`` (w_down of a dense MLP),
    each (B, S, features) (the §IV-B profile).  It does not reach the SSM
    mixer's inner projection ``w_out``, so a config with an SSM mixer
    refuses it rather than give a profile that misses it."""
    _check_supported(cfg)
    if tap is not None and cfg.ssm_state:
        raise NotImplementedError(f"{cfg.name}: the activation tap does not cover the SSM "
                                  "mixer (w_in/w_out)")
    x = params["embed"][tokens]
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    caches: Dict[str, list] = {}
    for l, window in enumerate(_windows(cfg)):
        layer_tap = None if tap is None else (lambda kind, a, l=l: tap(l, kind, a))
        x, new = _decoder_layer(x, _layer(params["layers"], l), cfg, positions=positions,
                                window=window, impl=impl, tap=layer_tap)
        if keep_cache:
            for key, t in new.items():
                caches.setdefault(key, []).append(t)
    return x, caches


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
            impl: str = "auto") -> torch.Tensor:
    """Logits (B, S, V) in f32 for int tokens (B, S)."""
    x, _ = _run(params, tokens, cfg, impl, keep_cache=False)
    return _unembed(params, x, cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device: Optional[Union[str, torch.device]] = None) -> Cache:
    """Zeroed serving cache: ``k``/``v`` (L, batch, max_len, Hkv, hd) where
    the config attends, ``ssm`` (L, batch, H, Pd, N) in f32 and ``conv``
    (L, batch, 3, din) where it has the SSM mixer."""
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    dev = resolve_device(device)
    cache: Cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.attention != "none":
        for key in ("k", "v"):
            cache[key] = torch.zeros((L, batch, max_len, Hkv, hd), dtype=dtype, device=dev)
    if cfg.ssm_state > 0:
        din, N, H = cfg.ssm_inner(), cfg.ssm_state, cfg.ssm_heads
        cache["ssm"] = torch.zeros((L, batch, H, din // H, N), dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros((L, batch, 3, din), dtype=dtype, device=dev)
    return cache


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
            impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
    """Run the prompt; returns last-token logits (B, 1, V) and the cache
    {"pos": S, "k"/"v": (L, B, S, Hkv, hd), "ssm": (L, B, H, Pd, N),
    "conv": (L, B, 3, din)}, each entry where the config has it."""
    x, caches = _run(params, tokens, cfg, impl, keep_cache=True)
    logits = _unembed(params, x[:, -1:], cfg)
    S = tokens.shape[1]
    cache = {"pos": torch.full((), S, dtype=torch.int32, device=x.device)}
    cache.update({key: torch.stack(ts) for key, ts in caches.items()})
    return logits, cache


def decode_step(params: Params, tokens: torch.Tensor, cfg: ArchConfig, cache: Cache, *,
                impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
    """One new token per sequence against ``cache``; returns logits (B, V)
    and the cache with ``pos`` advanced.  ``cache["k"]``/``["v"]`` and
    ``["ssm"]``/``["conv"]`` are updated in place (the reference returns
    new buffers)."""
    _check_supported(cfg)
    if tokens.dim() == 1:
        tokens = tokens[:, None]
    x = params["embed"][tokens]
    B = x.shape[0]
    pos = torch.as_tensor(cache["pos"], device=x.device)
    positions = (pos if pos.dim() == 0 else pos[:, None]).expand(B, 1)
    keys = [k for k in ("k", "v", "ssm", "conv") if k in cache]
    for l, window in enumerate(_windows(cfg)):
        x, _ = _decoder_layer(x, _layer(params["layers"], l), cfg, positions=positions,
                              window=window, cache={k: cache[k][l] for k in keys},
                              cache_len=pos, impl=impl)
    logits = _unembed(params, x, cfg)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits[:, 0], new_cache
