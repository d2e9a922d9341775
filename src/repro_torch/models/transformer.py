"""Model stack (port of ``repro/models/transformer.py`` for every family
of the reference): global attention (llama3, qwen3, gemma, qwen3-moe,
dbrx), gemma2's alternation of local (sliding-window) and global layers
with attention and final-logit softcaps and post-norms, the
attention-free Mamba-2 stack (mamba2), hymba's hybrid layer, in which
sliding-window attention and the SSM mixer run side by side on the same
normed input, each branch normed before they are summed, the
encoder-decoder (whisper: a bidirectional encoder over stub frame
embeddings, and a cross-attention step in every decoder layer) and the
prefix-LM (paligemma: stub patch embeddings joined ahead of the tokens,
seen bidirectionally).  A layer's FFN is the gated or plain MLP, the
top-k MoE block when the config has more than one expert, or none when
``d_ff`` is 0.

Parameters are a plain dict laid out like the reference pytree: layer
weights stacked on a leading L axis (``wq`` (L, d, Hq, hd), ``wo``
(L, Hq, hd, d), ``w_in`` (L, d, 2·din + 2·N + H), ...), plus ``embed``,
``final_norm`` and ``lm_head``; an encoder-decoder adds ``enc_layers``
(stacked on ``cfg.enc_layers``), ``enc_final_norm``, ``enc_cross``
(``wk``/``wv`` (L, d, Hkv, hd)) and ``dec_cross`` (``wq`` (L, d, Hq, hd),
``wo`` (L, Hq, hd, d), ``ln`` (L, d)).  A pruned projection may be a compressed
module (:class:`~.layers.BlockSparseLinear` or
:class:`~.layers.IntraBlockLinear`) instead of a dense tensor.  The
reference's ``lax.scan`` over layers is a Python loop here (:func:`_scan`),
which a capture (:mod:`repro_torch.trace.capture`) records as one scan.

Entry points:

* ``forward``     — logits over a full sequence (after the prefix,
  where one is given); with ``remat`` each decoder layer is checkpointed
  (``torch.utils.checkpoint``) under one of :data:`REMAT_POLICIES`;
* ``prefill``     — forward + the per-layer cache (k/v, SSM and conv
  states, the encoder's cross k/v), last-token logits;
* ``decode_step`` — one token per sequence against a cache, at a scalar
  or per-sequence (B,) position.  It writes the cache in place.

An encoder-decoder needs ``enc_embed`` (B, Se, d) in ``forward`` and
``prefill``, a prefix-LM takes ``prefix_embed`` (B, P, d); decode needs
neither (the cache holds the cross k/v, and every decode query sits past
the prefix, where the causal mask already shows all of it).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from .. import resolve_device
from ..configs.base import ArchConfig
from ..distributed import partition as part
from ..distributed import sharding as shd
from ..distributed.sharding import P
from ..kernels import hook
from .layers import (COMPRESSED, attention_block, chunked_attention, mlp_block, moe_block,
                     project, rms_norm, ssm_block)

__all__ = ["init_params", "param_struct", "init_cache", "forward", "prefill", "decode_step", "layer_flags",
           "REMAT_POLICIES"]

Params = Dict[str, Any]
Cache = Dict[str, Any]

_VOCAB_CHUNK = 16384      # lm_head columns widened to f32 at a time
# the residual stream's spec on a mesh (the reference's constraints,
# ``repro/models/transformer.py:230, 248, 276``): rows over the batch axes
_ROWS = P(("pod", "data"), None, None)


def _check_supported(cfg: ArchConfig) -> None:
    """The port covers every family of the reference: the dense and MoE
    GQA decoders with global or alternating local/global attention
    (attention softcap allowed), the encoder-decoder (``family="audio"``,
    ``enc_dec``) and the prefix-LM (``family="vlm"``, ``prefix_len``) on
    global attention, the pure-SSM family (no attention) and the hybrid
    family (sliding-window attention beside the SSM mixer).  Any other
    combination raises, an encoder or a prefix on another family too."""
    ported = ((cfg.family in ("dense", "moe", "audio", "vlm") and not cfg.ssm_state
               and cfg.attention in ("global", "local_global"))
              or (cfg.family == "ssm" and cfg.ssm_state and cfg.attention == "none")
              or (cfg.family == "hybrid" and cfg.ssm_state and cfg.attention == "sliding"))
    if cfg.enc_dec:
        ported = ported and cfg.family == "audio" and cfg.enc_layers > 0
    if cfg.prefix_len:
        ported = ported and cfg.family == "vlm"
    if not ported:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with attention {cfg.attention!r} is not "
            "one of the families the port covers")


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


def _layer_shapes(cfg: ArchConfig, *, encoder: bool = False) -> Dict[str, Tuple[int, ...]]:
    """Per-layer leaf shapes, as the reference's ``_layer_shapes``
    (``transformer.py:67-108``) gives them for a decoder layer or, with
    ``encoder``, an encoder layer: attention, ``ln2`` and the MLP, with no
    experts, no SSM mixer and no post-norms."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    shapes: Dict[str, Tuple[int, ...]] = {"ln1": (d,)}
    if encoder:
        shapes.update({"wq": (d, Hq, hd), "wk": (d, Hkv, hd), "wv": (d, Hkv, hd),
                       "wo": (Hq, hd, d), "ln2": (d,), "w_up": (d, cfg.d_ff),
                       "w_down": (cfg.d_ff, d)})
        if cfg.qk_norm:
            shapes.update({"q_norm": (hd,), "k_norm": (hd,)})
        if cfg.gated_mlp:
            shapes["w_gate"] = (d, cfg.d_ff)
        return shapes
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
                device: Optional[Union[str, torch.device]] = None,
                keep: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None) -> Params:
    """Random weights with the reference init's distributions.

    Norm scales are zero, ``A_log`` and ``dt_bias`` zero, ``D_skip`` 0.5;
    a weight of per-layer shape ``shp`` is normal with std 1/sqrt(fan_in)
    (fan_in = d_model for wq/wk/wv, else the product of all but the last
    dim: E·d for an expert leaf (E, d, ff), 4 for ``conv_w`` (4, din), as
    the reference has it); embed and lm_head have std 1/sqrt(d).  An
    encoder-decoder's encoder layers follow the same rule; its cross
    weights (``enc_cross`` wk/wv, ``dec_cross`` wq/wo) have std 1/sqrt(d)
    and ``dec_cross["ln"]`` is zero.  Drawn on ``device`` (default
    ``cuda``) from a ``torch.Generator`` seeded with ``seed``, one layer
    at a time so the f32 draw never holds more than one layer.  Each
    weight is its own draw: the reference draws ``enc_cross`` wk and wv
    from one key, so they are equal there, and not here.

    ``keep(name, w)``, when given, sees each drawn layer ``w`` of a decoder
    weight ``name`` and returns what to store of it (e.g. a rank's pruned
    slice of an expert leaf, so that the whole leaf never stands on the
    device); the draws, and so every other weight, are as without it.
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, L = cfg.d_model, cfg.n_layers

    def normal(shape, std):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    def stacked(shapes, n, keep=None):
        layers = {}
        for name, shp in sorted(shapes.items()):
            if name.startswith(("ln", "post_ln")) or name.endswith("_norm"):
                layers[name] = torch.zeros((n,) + shp, dtype=dtype, device=dev)
                continue
            if name in _CONSTANT_INIT:
                layers[name] = torch.full((n,) + shp, _CONSTANT_INIT[name], dtype=dtype,
                                          device=dev)
                continue
            fan_in = d if name in ("wq", "wk", "wv") else math.prod(shp[:-1])
            layers[name] = per_layer((n,) + shp, 1.0 / math.sqrt(max(fan_in, 1)),
                                     None if keep is None else functools.partial(keep, name))
        return layers

    def per_layer(shape, std, kept=None):
        w = None if kept is not None else torch.empty(shape, dtype=dtype, device=dev)
        for l in range(shape[0]):
            wl = normal(shape[1:], std)
            if kept is not None:
                wl = kept(wl)
                if w is None:
                    w = torch.empty((shape[0],) + tuple(wl.shape), dtype=wl.dtype, device=dev)
            w[l] = wl
        return w

    layers = stacked(_layer_shapes(cfg), L, keep)
    params: Params = {
        "embed": normal((cfg.vocab_size, d), 1.0 / math.sqrt(d)),
        "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), 1.0 / math.sqrt(d))
    if cfg.enc_dec:
        hd, Hq, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
        std = 1.0 / math.sqrt(d)
        params["enc_layers"] = stacked(_layer_shapes(cfg, encoder=True), cfg.enc_layers)
        params["enc_final_norm"] = torch.zeros((d,), dtype=dtype, device=dev)
        params["enc_cross"] = {"wk": per_layer((L, d, Hkv, hd), std),
                               "wv": per_layer((L, d, Hkv, hd), std)}
        params["dec_cross"] = {"wq": per_layer((L, d, Hq, hd), std),
                               "wo": per_layer((L, Hq, hd, d), std),
                               "ln": torch.zeros((L, d), dtype=dtype, device=dev)}
    return params


def param_struct(cfg: ArchConfig, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The tree of ``init_params(cfg, dtype=dtype)`` as ``meta`` tensors:
    the same key paths, shapes and dtypes.  (``init_params`` cannot build
    it: a ``meta`` generator does not exist, and it writes each layer into
    a preallocated stack.)"""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    hd, Hq, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def stacked(shapes, n):
        return {name: meta((n,) + shp, dtype) for name, shp in shapes.items()}

    params = {"embed": meta((V, d), dtype), "final_norm": meta((d,), dtype),
              "layers": stacked(_layer_shapes(cfg), L)}
    if not cfg.tie_embeddings:
        params["lm_head"] = meta((d, V), dtype)
    if cfg.enc_dec:
        params["enc_layers"] = stacked(_layer_shapes(cfg, encoder=True), cfg.enc_layers)
        params["enc_final_norm"] = meta((d,), dtype)
        params["enc_cross"] = {"wk": meta((L, d, Hkv, hd), dtype),
                               "wv": meta((L, d, Hkv, hd), dtype)}
        params["dec_cross"] = {"wq": meta((L, d, Hq, hd), dtype),
                               "wo": meta((L, Hq, hd, d), dtype),
                               "ln": meta((L, d), dtype)}
    return params


def _scan(body: Callable, carry, xs, length: int, *, unbind: bool = True):
    """The layer loop (the reference's ``_scan``, a ``jax.lax.scan``):
    ``carry, y = body(carry, l, x_l)`` for l in range(length), ``x_l`` layer
    l's slice of ``xs``, a tree of stacked ``(L, ...)`` leaves; returns
    (carry, [y_0, ..., y_{length-1}]).  The slices are :func:`_layers`'
    (each tensor leaf unbound once, before the loop), or with ``unbind``
    False :func:`_layer`'s, each taken as the loop reaches it (decode's,
    where nothing needs a gradient).

    Under a capture the body is recorded once, as a ``scan`` over ``xs``,
    and the outputs come back stacked; the recorded body is layer 0's
    (``l`` is 0), so where layers differ (gemma2's alternating windows,
    hymba's global layers) the trace holds layer 0's kind for every layer."""
    rec = hook.capturing()
    if rec is not None:
        return rec.scan(lambda c, x: body(c, 0, x), carry, xs, length)
    split = _layers(xs, length) if unbind else None
    ys = []
    for l in range(length):
        carry, y = body(carry, l, split[l] if unbind else _layer(xs, l))
        ys.append(y)
    return carry, ys


def _layer(xs, l: int):
    """Layer ``l``'s slice of a tree (dicts, tuples, ``None``) of stacked
    ``(L, ...)`` leaves: ``w.layer(l)`` for a compressed leaf, ``w[l]`` for
    a tensor."""
    if xs is None:
        return None
    if isinstance(xs, dict):
        return {k: _layer(w, l) for k, w in xs.items()}
    if isinstance(xs, tuple):
        return tuple(_layer(w, l) for w in xs)
    return xs.layer(l) if isinstance(xs, COMPRESSED) else xs[l]


def _layers(xs, n: int) -> List[Any]:
    """``[_layer(xs, l) for l in range(n)]`` with each tensor leaf unbound
    once (``torch.unbind``): under autograd its one backward stacks the
    per-layer grads, where ``n`` indexings would each add a zero-filled
    grad of the whole stacked leaf.  Compressed leaves give ``.layer(l)``."""
    if xs is None:
        return [None] * n
    if isinstance(xs, dict):
        split = {k: _layers(w, n) for k, w in xs.items()}
        return [{k: s[l] for k, s in split.items()} for l in range(n)]
    if isinstance(xs, tuple):
        split = [_layers(w, n) for w in xs]
        return [tuple(s[l] for s in split) for l in range(n)]
    return [xs.layer(l) for l in range(n)] if isinstance(xs, COMPRESSED) else list(xs.unbind(0))


def _decoder_layer(x, lp, cfg: ArchConfig, *, positions, window=None, cache=None,
                   cache_len=None, impl: str = "auto", tap=None, prefix: int = 0, cross=None):
    """One decoder layer; returns (x, new) with this layer's cache entries:
    ``k``/``v`` where it attends, ``ssm``/``conv`` where it has the SSM
    mixer.  In decode ``cache`` holds this layer's slices of the cache
    buffers, which are written in place (the reference returns new ones).
    ``prefix`` is the prefix-LM's bidirectional prefix length (prefill
    only).  ``cross`` (encoder-decoder) holds this layer's cross-attention:
    ``k``/``v`` (B, Se, Hkv, hd) from the encoder and ``wq``/``wo``/``ln``."""
    new = {}
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if tap is not None:
        tap("attn_in", h)
    if cfg.attention != "none":
        kv = None if cache is None else (cache["k"], cache["v"])
        ya, (new["k"], new["v"]) = attention_block(
            h, lp, cfg, positions=positions, window=window, prefix=prefix, cache_kv=kv,
            cache_len=cache_len, impl=impl)
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
    x = shd.maybe_shard(x + mix, _ROWS)
    if cross is not None:
        x = x + _cross_attention(x, cross, cfg, impl)
    if cfg.d_ff == 0:
        return x, new
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if tap is not None:
        tap("mlp_in", h)
    ff = moe_block(h, lp, cfg) if cfg.n_experts > 1 else mlp_block(h, lp, cfg, impl, tap)
    if cfg.post_norms:
        ff = rms_norm(ff, lp["post_ln2"], cfg.norm_eps)
    return shd.maybe_shard(x + ff, _ROWS), new


def _cross_attention(x, cross, cfg: ArchConfig, impl: str = "auto") -> torch.Tensor:
    """The decoder's cross-attention step (reference ``transformer.py:
    232-239``): norm, ``q = x·wq`` with no RoPE and no qk-norm, attention
    over every encoder frame, ``·wo``.  It runs through
    :func:`~.layers.chunked_attention` (``causal=False``, chunks of 512,
    the padded tail masked) as the reference's does: the flash kernel's
    contract is causal self-attention over tiled lengths, and 1500 frames
    neither tile by 128 nor are causal."""
    h = rms_norm(x, cross["ln"], cfg.norm_eps)
    q = project(h, cross["wq"], impl)
    out = chunked_attention(q, cross["k"], cross["v"], causal=False, chunk=512)
    return project(out, cross["wo"], impl, n_in=2)


def _encoder_stack(params: Params, enc_embed: torch.Tensor, cfg: ArchConfig,
                   impl: str = "auto") -> torch.Tensor:
    """The encoder (reference ``transformer.py:252-264``) over stub frame
    embeddings (B, Se, d): per layer a norm, bidirectional self-attention
    with RoPE at positions 0..Se-1 (through
    :func:`~.layers.chunked_attention`, as :func:`~.layers.attention_block`
    routes ``causal=False``), the residual, then the MLP; the final norm at
    the end.  Its weights are never pruned (the reference's
    ``prune_params`` walks ``params["layers"]`` only), so its projections
    are dense matmuls."""
    positions = torch.arange(enc_embed.shape[1], device=enc_embed.device)[None]

    def layer(x, l, lp):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, _ = attention_block(h, lp, cfg, positions=positions, causal=False, impl=impl)
        x = x + y
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + mlp_block(h, lp, cfg, impl), None

    x, _ = _scan(layer, enc_embed, params["enc_layers"], cfg.enc_layers)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _cross_kv(params: Params, enc_out: torch.Tensor, cfg: ArchConfig,
              impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross k/v from the encoder output (reference
    ``transformer.py:267-271``): (L, B, Se, Hkv, hd) each, in the compute
    dtype."""
    def stacked(w):
        _, ys = _scan(lambda c, l, wl: (c, project(enc_out, wl, impl)), None, w, w.shape[0])
        return ys if torch.is_tensor(ys) else torch.stack(ys)

    k, v = stacked(params["enc_cross"]["wk"]), stacked(params["enc_cross"]["wv"])
    return k.to(enc_out.dtype), v.to(enc_out.dtype)


def _unembed(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    # f32 logits from the stored operands, as the reference's
    # preferred_element_type=f32: both are widened exactly to f32, so no
    # logit is rounded to bf16 before the softcap or the argmax.  The
    # weight is widened one vocab chunk at a time, so no f32 copy of the
    # whole matrix (2 GB for llama3-8b's lm_head) is ever held.
    # (split, not slicing: under autograd one backward joins the chunks' grads)
    x2 = x.reshape(-1, x.shape[-1])
    if shd.split_on(w, 1):
        # a rank of a vocab-split weight widens its own columns whole
        logits = part.matmul(x2, w, dtype=torch.float32)
    elif hook.capturing() is not None:
        # a capture records the product once: the chunks are a memory
        # schedule, and each would be priced with the whole weight's size
        logits = x2.float() @ w.float()
    else:
        x2 = x2.float()
        mm = part.matmul if shd.is_dtensor(w) else torch.matmul
        logits = torch.cat([mm(x2, wc.float()) for wc in w.split(_VOCAB_CHUNK, dim=1)], dim=1)
    logits = logits.reshape(*x.shape[:-1], -1)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return shd.maybe_shard(logits, P(("pod", "data"), None, "model"))


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings, rows over the batch axes on a mesh (a DTensor
    table split by vocab: :func:`~repro_torch.distributed.partition.embed`)."""
    table = params["embed"]
    x = part.embed(table, tokens) if shd.split_on(table, 0) else table[tokens]
    return shd.maybe_shard(x, _ROWS)


# Activation rematerialisation (``forward(remat=True)``): the aten ops whose
# outputs a checkpointed decoder layer saves for its backward; everything
# else is recomputed.  The reference's jax.checkpoint policies:
REMAT_POLICIES = {
    # dots_with_no_batch_dims_saveable: the weight projections (``project``
    # is ``x2 @ w`` on 2-D operands, aten.mm); the attention einsums of
    # ``chunked_attention`` (aten.bmm) are recomputed
    "minimal": (torch.ops.aten.mm.default,),
    # dots_saveable: every matmul output
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.bmm.default),
    # nothing_saveable: a plain per-layer checkpoint
    "nothing": (),
}


def _remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under a non-reentrant ``torch.utils.checkpoint`` that saves the
    outputs of ``REMAT_POLICIES[policy]`` (a selective checkpoint), or
    nothing; an unknown policy raises ``KeyError``."""
    saved = REMAT_POLICIES[policy]
    ctx = ({"context_fn": functools.partial(create_selective_checkpoint_contexts, list(saved))}
           if saved else {})
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **ctx)


def _layer_output(x, lp, cross, *, cfg: ArchConfig, positions, window, impl: str,
                  prefix: int) -> torch.Tensor:
    """One decoder layer's output alone (the body a checkpoint recomputes)."""
    return _decoder_layer(x, lp, cfg, positions=positions, window=window, impl=impl,
                          prefix=prefix, cross=cross)[0]


def _run(params: Params, tokens: torch.Tensor, cfg: ArchConfig, impl: str,
         keep_cache: bool, tap: Optional[Callable[[int, str, torch.Tensor], None]] = None, *,
         prefix_embed: Optional[torch.Tensor] = None, enc_embed: Optional[torch.Tensor] = None,
         remat: Optional[str] = None):
    """The decoder stack over full sequences; returns (x, caches), caches
    mapping each cache entry of :func:`_decoder_layer` to its per-layer
    list (empty unless ``keep_cache``), and, for an encoder-decoder with
    ``keep_cache``, ``cross_k``/``cross_v`` to the stacked cross k/v.
    ``prefix_embed`` (B, P, d) is cast to the compute dtype and joined
    ahead of the token embeddings, so x covers P + S positions, the first
    P seen bidirectionally.  An encoder-decoder needs ``enc_embed``
    (B, Se, d): it runs the encoder (:func:`_encoder_stack`) and feeds
    every decoder layer its cross k/v.  ``tap(l, kind, act)``, when
    given, sees the inputs of layer ``l``'s pruned projections as they are
    made: ``attn_in`` (wq/wk/wv), ``mlp_in`` (w_gate/w_up, or the MoE
    block's router and experts) and ``down_in`` (w_down of a dense MLP),
    each (B, S, features) (the §IV-B profile).  It does not reach the SSM
    mixer's inner projection ``w_out``, so a config with an SSM mixer
    refuses it rather than give a profile that misses it.  ``remat`` (a
    key of :data:`REMAT_POLICIES`, forward only) checkpoints each decoder
    layer under that policy."""
    _check_supported(cfg)
    if tap is not None and cfg.ssm_state:
        raise NotImplementedError(f"{cfg.name}: the activation tap does not cover the SSM "
                                  "mixer (w_in/w_out)")
    x = _embed(params, tokens)
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(device=x.device, dtype=x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = shd.replicated(torch.arange(S, device=x.device), x).expand(B, S)
    prefix = 0 if prefix_embed is None else prefix_embed.shape[1]
    caches: Dict[str, list] = {}
    ck = cv = None
    if cfg.enc_dec:
        if enc_embed is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs enc_embed")
        enc_out = _encoder_stack(params, enc_embed.to(device=x.device, dtype=x.dtype), cfg,
                                 impl)
        ck, cv = _cross_kv(params, enc_out, cfg, impl)
        if keep_cache:
            caches["cross_k"], caches["cross_v"] = ck, cv
    windows = _windows(cfg)

    def layer(x, l, xs):
        lp, cross = xs
        if remat is not None:
            body = functools.partial(_layer_output, cfg=cfg, positions=positions,
                                     window=windows[l], impl=impl, prefix=prefix)
            return _remat(body, remat)(x, lp, cross), None
        layer_tap = None if tap is None else (lambda kind, a: tap(l, kind, a))
        x, new = _decoder_layer(x, lp, cfg, positions=positions, window=windows[l],
                                impl=impl, tap=layer_tap, prefix=prefix, cross=cross)
        return x, (new if keep_cache else None)

    stacked = (params["layers"], None if ck is None else dict(params["dec_cross"], k=ck, v=cv))
    x, ys = _scan(layer, x, stacked, cfg.n_layers)
    if keep_cache:
        # per layer, as the loop made them (stacked already under a capture)
        caches.update(ys if isinstance(ys, dict)
                      else {key: [y[key] for y in ys] for key in ys[0]})
    return x, caches


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
            prefix_embed: Optional[torch.Tensor] = None,
            enc_embed: Optional[torch.Tensor] = None, impl: str = "auto",
            remat: bool = False, remat_policy: str = "minimal") -> torch.Tensor:
    """Logits (B, P + S, V) in f32 for int tokens (B, S), after a prefix of
    P embeddings where ``prefix_embed`` is given (P = 0 otherwise).  An
    encoder-decoder needs ``enc_embed`` (B, Se, d) and raises
    ``ValueError`` without it.

    ``remat=True`` checkpoints each decoder layer (activation
    rematerialisation, the reference's ``jax.checkpoint`` of its scanned
    layer): backward saves only what ``remat_policy`` (a key of
    :data:`REMAT_POLICIES`; ``KeyError`` otherwise) allows and recomputes
    the rest.  It changes memory, not numbers."""
    x, _ = _run(params, tokens, cfg, impl, keep_cache=False, prefix_embed=prefix_embed,
                enc_embed=enc_embed, remat=remat_policy if remat else None)
    return _unembed(params, x, cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               enc_seq: int = 0, device: Optional[Union[str, torch.device]] = None) -> Cache:
    """Zeroed serving cache: ``k``/``v`` (L, batch, max_len, Hkv, hd) where
    the config attends, ``ssm`` (L, batch, H, Pd, N) in f32 and ``conv``
    (L, batch, 3, din) where it has the SSM mixer, ``cross_k``/``cross_v``
    (L, batch, Se, Hkv, hd) for an encoder-decoder, Se = ``enc_seq`` or
    else ``cfg.enc_seq``."""
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
    if cfg.enc_dec:
        se = enc_seq or cfg.enc_seq
        for key in ("cross_k", "cross_v"):
            cache[key] = torch.zeros((L, batch, se, Hkv, hd), dtype=dtype, device=dev)
    return cache


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
            prefix_embed: Optional[torch.Tensor] = None,
            enc_embed: Optional[torch.Tensor] = None,
            impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
    """Run the prompt (after the prefix, where ``prefix_embed`` (B, P, d) is
    given); returns last-token logits (B, 1, V) and the cache
    {"pos": P + S, "k"/"v": (L, B, P + S, Hkv, hd), "ssm": (L, B, H, Pd,
    N), "conv": (L, B, 3, din), "cross_k"/"cross_v": (L, B, Se, Hkv,
    hd)}, each entry where the config has it.  An encoder-decoder needs
    ``enc_embed`` (B, Se, d) and raises ``ValueError`` without it (the
    reference's ``prefill`` fails there with an ``AttributeError``)."""
    x, caches = _run(params, tokens, cfg, impl, keep_cache=True, prefix_embed=prefix_embed,
                     enc_embed=enc_embed)
    logits = _unembed(params, x[:, -1:], cfg)
    cache = {"pos": torch.full((), x.shape[1], dtype=torch.int32, device=x.device)}
    cache.update({key: ts if torch.is_tensor(ts) else torch.stack(ts)
                  for key, ts in caches.items()})
    return logits, cache


def decode_step(params: Params, tokens: torch.Tensor, cfg: ArchConfig, cache: Cache, *,
                impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
    """One new token per sequence against ``cache``; returns logits (B, V)
    and the cache with ``pos`` advanced.  ``cache["k"]``/``["v"]`` and
    ``["ssm"]``/``["conv"]`` are updated in place (the reference returns
    new buffers); a position past the end of k/v writes as the
    reference's does (:func:`~.layers.write_cache`).  An encoder-decoder
    reads its cross k/v from ``cache["cross_k"]``/``["cross_v"]``."""
    _check_supported(cfg)
    if tokens.dim() == 1:
        tokens = tokens[:, None]
    x = _embed(params, tokens)
    B = x.shape[0]
    pos = torch.as_tensor(cache["pos"], device=x.device)
    positions = (pos if pos.dim() == 0 else pos[:, None]).expand(B, 1)
    keys = [k for k in ("k", "v", "ssm", "conv") if k in cache]
    windows = _windows(cfg)

    def layer(x, l, xs):
        cross, lp, lc = xs
        x, _ = _decoder_layer(x, lp, cfg, positions=positions, window=windows[l], cache=lc,
                              cache_len=pos, impl=impl, cross=cross)
        return x, None

    cross = (dict(params["dec_cross"], k=cache["cross_k"], v=cache["cross_v"]) if cfg.enc_dec
             else None)
    x, _ = _scan(layer, x, (cross, params["layers"], {k: cache[k] for k in keys}),
                 cfg.n_layers, unbind=False)
    logits = _unembed(params, x, cfg)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits[:, 0], new_cache
