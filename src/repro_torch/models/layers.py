"""Model-layer primitives of the decoder (port of
``repro/models/layers.py``): RMSNorm, RoPE, softcap, chunked
online-softmax attention with GQA, windows, an attention softcap and a
prefix-LM mask, the attention sub-block (causal or bidirectional; on a
mesh, the sequence-parallel window path), the gated or plain MLP, the
capacity-bounded top-k MoE block (the global-dispatch path, and on a
mesh the expert-parallel path) and the Mamba-2 mixer (chunked SSD for
prefill, the single-step recurrence for decode).

The two mesh paths run in the global view of
:mod:`repro_torch.distributed.sharding`: every rank holds the global
tensors, a path cuts its rank's slice on entry, computes with explicit
collectives (:mod:`repro_torch.distributed.collectives`) and gathers the
global result on exit, so every rank's value at a layer boundary is the
reference's.  On DTensors (the dry-run's partitioned view of the dense
decoders) projections, attention and the cache write run on each rank's
shards (:mod:`repro_torch.distributed.partition`).

Projections are either dense weights in the reference layout (``wq``
(d, Hq, hd), ``wo`` (Hq, hd, d), ``w_up`` (d, F), ...) or compressed
modules: :class:`BlockSparseLinear` holds the FullBlock layout and runs
through the ``block_sparse_matmul`` op, :class:`IntraBlockLinear` holds
the row-aligned IntraBlock layout and runs through the
``intrablock_gather_matmul`` op.
"""
from __future__ import annotations

import contextlib
import functools
import math
import types
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import collectives as coll
from ..distributed import partition as part
from ..distributed import sharding as shd
from ..distributed.sharding import P
from ..kernels import decode_attention as _da
from ..kernels import ops
from ..kernels import ref as _kref
from ..kernels.intrablock_matmul import check_row_idx
from .spans import span

Params = Dict[str, Any]

# flash-attention tile: prefill pads q/k/v at the sequence tail to it
ATTN_TILE = 128


# ---------------------------------------------------------------------------
# Compressed projection
# ---------------------------------------------------------------------------

class BlockSparseLinear(nn.Module):
    """A FullBlock-compressed projection ``x @ W`` for a stack of layers.

    Holds ``w_comp`` (L, Gn, Ls, bm, bn) and ``idx`` (L, Gn, Ls) int32
    (-1 = padding slot), the contracted width ``in_features`` and the
    output shape of one token (e.g. (Hq, hd) for ``wq``).  :meth:`layer`
    selects one layer; a per-layer module maps (B, in_features) →
    (B, Gn*bn) through the ``block_sparse_matmul`` op.
    """

    def __init__(self, w_comp: torch.Tensor, idx: torch.Tensor, in_features: int,
                 out_shape: Tuple[int, ...]):
        super().__init__()
        self.register_buffer("w_comp", w_comp)
        self.register_buffer("idx", idx)
        self.in_features = in_features
        self.out_shape = tuple(out_shape)

    def layer(self, l: int) -> "BlockSparseLinear":
        return BlockSparseLinear(self.w_comp[l], self.idx[l], self.in_features,
                                 self.out_shape)

    def forward(self, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        if self.idx.dim() != 2:
            raise ValueError("call a single layer: use .layer(l) first")
        return ops.block_sparse_matmul(x, self.w_comp, self.idx, impl=impl)


class IntraBlockLinear(nn.Module):
    """A row-aligned IntraBlock-compressed projection ``x @ W`` for a stack
    of layers.

    Holds ``w_comp`` (L, Kc, N), the surviving rows of each layer's (K, N)
    matrix (rows contiguous; their stride may exceed N, as
    ``compress_params`` pads rows to 16 bytes, and :meth:`layer` keeps
    it), and ``row_idx`` (L, Kc) int32, their rows in that matrix, plus
    ``in_features`` (K) and the output shape of one token.  The indices
    are checked to lie in [0, K) once, when the module is built, so the
    per-call op skips that check (it would synchronise with the card on
    every projection).  :meth:`layer` selects one layer; a per-layer
    module maps (B, K) → (B, N) through the ``intrablock_gather_matmul`` op.
    """

    def __init__(self, w_comp: torch.Tensor, row_idx: torch.Tensor, in_features: int,
                 out_shape: Tuple[int, ...], *, _checked: bool = False):
        super().__init__()
        if row_idx.dtype != torch.int32 or row_idx.shape != w_comp.shape[:-1]:
            raise ValueError(f"row_idx must be int32 of shape {tuple(w_comp.shape[:-1])}, "
                             f"got {row_idx.dtype} {tuple(row_idx.shape)}")
        if not _checked:
            check_row_idx(row_idx, in_features)
        self.register_buffer("w_comp", w_comp)
        self.register_buffer("row_idx", row_idx)
        self.in_features = in_features
        self.out_shape = tuple(out_shape)

    def layer(self, l: int) -> "IntraBlockLinear":
        return IntraBlockLinear(self.w_comp[l], self.row_idx[l], self.in_features,
                                self.out_shape, _checked=True)

    def forward(self, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        if self.row_idx.dim() != 1:
            raise ValueError("call a single layer: use .layer(l) first")
        return ops.intrablock_gather_matmul(x, self.w_comp, self.row_idx, impl=impl,
                                            check_range=False)


COMPRESSED = (BlockSparseLinear, IntraBlockLinear)


def project(x: torch.Tensor, w, impl: str = "auto", n_in: int = 1) -> torch.Tensor:
    """Contract the last ``n_in`` dims of ``x`` with the leading ``n_in``
    dims of a dense weight (e.g. ``wo`` (Hq, hd, d) takes ``n_in=2``), or
    run a compressed one.  On DTensors each rank multiplies its shards
    (:func:`~repro_torch.distributed.partition.matmul`)."""
    lead = x.shape[:x.dim() - n_in]
    x2 = x.reshape(math.prod(lead), -1)
    if isinstance(w, COMPRESSED):
        return w(x2, impl).reshape(*lead, *w.out_shape)
    if shd.is_dtensor(w):
        return part.matmul(x2, part.mergeable(w, n_in).reshape(x2.shape[1], -1)).reshape(
            *lead, *w.shape[n_in:])
    y = x2 @ w.reshape(x2.shape[1], -1)
    return y.reshape(*lead, *w.shape[n_in:])


# ---------------------------------------------------------------------------
# Norms / positions
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    freqs = shd.replicated(freqs, positions)
    ang = positions[..., None].float() * freqs                      # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(x / cap)``; ``x`` itself when ``cap`` is 0."""
    return cap * torch.tanh(x / cap) if cap > 0 else x


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _as_batch(v, B: int, device) -> torch.Tensor:
    t = torch.as_tensor(v, device=device)
    return t.expand(B) if t.dim() == 0 else t


# The dtype of the attention score tiles in :func:`chunked_attention`
# (the reference's ``_SCORES_DTYPE``, ``repro/models/layers.py:41-52``).
# f32, the default, is the exact softmax; bf16 halves every score-sized
# tensor, approximating a fused flash kernel's traffic (``--scores-bf16``).
_SCORES_DTYPE = torch.float32


def set_scores_dtype(dtype: torch.dtype) -> torch.dtype:
    """Set the score tiles' dtype; returns the one it replaces."""
    global _SCORES_DTYPE
    prev, _SCORES_DTYPE = _SCORES_DTYPE, dtype
    return prev


@contextlib.contextmanager
def scores_dtype(dtype: torch.dtype) -> Iterator[None]:
    """:func:`set_scores_dtype` for the block, the previous dtype after."""
    prev = set_scores_dtype(dtype)
    try:
        yield
    finally:
        set_scores_dtype(prev)


# The A/B switch of :func:`chunked_attention`'s statically tiled path (the
# reference's ``_TILED_ATTN``, ``repro/models/layers.py:33-39``): on, the
# default, causal self-attention from position 0 over more than one chunk
# tiles the queries too and skips the kv tiles its mask hides whole.
_TILED_ATTN = True


def set_tiled_attn(on: bool) -> bool:
    """Switch the tiled path on or off; returns the setting it replaces."""
    global _TILED_ATTN
    prev, _TILED_ATTN = _TILED_ATTN, bool(on)
    return prev


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[Any] = None,
                      q_offset: Any = 0, kv_len: Optional[Any] = None,
                      attn_cap: float = 0.0, prefix: int = 0,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention scanned over kv chunks: the reference's
    generic path (``layers.py:277-294``), or, where the reference takes it
    (:func:`_takes_tiled`), its statically tiled path (``:209-273``,
    :func:`_tiled_attention`).

    q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd).  ``q_offset`` (absolute
    position of q[0]) and ``kv_len`` (valid cache length) may be scalars
    or (B,) tensors; ``window`` is a scalar: query i sees keys
    (i - window, i].  ``prefix > 0`` is the prefix-LM mask of the
    reference's ``_attn_bias``: inside the causal term, a query before
    ``prefix`` also sees every key before it (bidirectional within the
    prefix); without ``causal`` it changes nothing.  ``attn_cap > 0`` caps
    the scores as the reference's ``_attn_tile`` does: scores x scale,
    then ``cap * tanh(s / cap)``, then the additive mask.

    Every score-sized tensor (the scores, scaled, capped and masked, and
    ``p``) is in the scores dtype (:func:`set_scores_dtype`, f32 by
    default), the mask cast to it; the running max, the sum (summed in
    f32) and the accumulator are f32; P is cast to the value dtype and
    P·V accumulates in f32.  These are the reference's rounding points
    (``_gqa_scores``, ``_attn_tile``).  In f32 the score product is of q
    and k widened to f32; in another dtype it is the product of the
    operands as given, rounded to that dtype.

    On DTensors (the partitioned view) each rank attends its shards
    (:func:`~repro_torch.distributed.partition.attention_shards`); keys
    split by sequence combine their statistics by all-reduce, and there a
    ``chunk`` that covers every key covers every local key.  The tiled
    path reads the local shards: keys split by sequence never tile.
    """
    kw = dict(causal=causal, window=window, attn_cap=attn_cap, prefix=prefix, chunk=chunk)
    if shd.is_dtensor(q):
        sh = part.attention_shards(q, k, v, op="chunked_attention")
        q_offset, kv_len = part.local(q_offset), part.local(kv_len)
        if not sh.seq and _takes_tiled(sh.q, sh.k, q_offset=q_offset, kv_len=kv_len, **kw):
            out = _tiled_attention(sh.q, sh.k, sh.v, **kw)
        else:
            if sh.seq and chunk >= k.shape[1]:
                kw["chunk"] = sh.k.shape[1]
            m, l, acc = _attention_stats(sh.q, sh.k, sh.v, q_offset=q_offset, kv_len=kv_len,
                                         k_start=sh.k_start, **kw)
            m, l, acc = part.combine_stats(m, l, acc, sh)
            out = _attention_out(acc, l, sh.q)
        return part.from_local(out, sh.mesh, sh.placements, sh.shape)
    if _takes_tiled(q, k, q_offset=q_offset, kv_len=kv_len, **kw):
        return _tiled_attention(q, k, v, **kw)
    m, l, acc = _attention_stats(q, k, v, q_offset=q_offset, kv_len=kv_len, **kw)
    return _attention_out(acc, l, q)


def _takes_tiled(q, k, *, causal, q_offset, kv_len, chunk, **_) -> bool:
    """The reference's condition for its tiled path (``layers.py:216-217``):
    the switch on, causal, no cache length, queries from position 0 (a
    Python int), as many queries as keys, and more than one chunk."""
    return (_TILED_ATTN and causal and kv_len is None and isinstance(q_offset, int)
            and q_offset == 0 and q.shape[1] == k.shape[1] and q.shape[1] > chunk)


def _tiled_attention(q, k, v, *, causal, window, attn_cap, prefix, chunk) -> torch.Tensor:
    """The reference's statically tiled path (``layers.py:209-273``) for
    causal self-attention from position 0 (:func:`_takes_tiled`): queries
    in tiles of ``chunk`` rows, the last padded with rows past the end and
    sliced off after; query tile ``qi`` attends kv tiles ``lo..hi`` only,
    ``hi = qi`` (its own diagonal tile), widened to the prefix's last tile
    where a prefix is seen, and without a prefix ``lo`` the first tile a
    static int window reaches.  The tiles it skips are those its mask hides
    whole, so each row's value is the generic loop's; each q tile is one
    :func:`_attention_stats` call over its kv range, with the same masks."""
    B, S = q.shape[:2]
    nq = -(-S // chunk)
    q_pad = nq * chunk - S
    if q_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, q_pad))
    static_window = window if isinstance(window, int) else None
    outs = []
    for qi in range(nq):
        lo, hi = 0, qi
        if prefix > 0:
            hi = min(max(qi, -(-prefix // chunk) - 1), nq - 1)
        elif static_window is not None:
            lo = max(0, (qi * chunk - static_window + 1) // chunk)
        qt = q[:, qi * chunk:(qi + 1) * chunk]
        kv = slice(lo * chunk, (hi + 1) * chunk)
        m, l, acc = _attention_stats(qt, k[:, kv], v[:, kv], causal=causal, window=window,
                                     q_offset=qi * chunk, kv_len=None, attn_cap=attn_cap,
                                     prefix=prefix, chunk=chunk, k_start=lo * chunk)
        outs.append(_attention_out(acc, l, qt))
    out = torch.cat(outs, dim=1)
    return out[:, :S] if q_pad else out


def _attention_stats(q, k, v, *, causal, window, q_offset, kv_len, attn_cap, prefix, chunk,
                     k_start: int = 0):
    """The online softmax of :func:`chunked_attention` over k/v whose first
    key sits at position ``k_start``: returns the running max ``m``, sum
    ``l`` (B, Hkv, G, Sq) and accumulator ``acc`` (B, Hkv, G, Sq, hd), f32."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    sdt = _SCORES_DTYPE
    if sdt == torch.float32:
        qg = q.reshape(B, Sq, Hkv, G, hd).float()
    else:
        cdt = torch.promote_types(q.dtype, k.dtype)
        qg = q.reshape(B, Sq, Hkv, G, hd).to(cdt)
        scale = torch.full((), scale, dtype=sdt, device=dev)    # scale rounded, as the reference's
    nchunks = max(1, math.ceil(Skv / chunk))
    pad = nchunks * chunk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_idx = _as_batch(q_offset, B, dev)[:, None] + torch.arange(Sq, device=dev)[None, :]
    kvl = None if kv_len is None else _as_batch(kv_len, B, dev)
    win = None if window is None else _as_batch(window, B, dev)

    m = torch.full((B, Hkv, G, Sq), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, G, Sq), device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, hd), device=dev)
    for ci in range(nchunks):
        k_i = k[:, ci * chunk:(ci + 1) * chunk]
        v_i = v[:, ci * chunk:(ci + 1) * chunk]
        k_idx = k_start + ci * chunk + torch.arange(chunk, device=dev)
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
            ok &= (k_idx < k_start + Skv)[None, None, :]
        bias = torch.zeros(ok.shape, dtype=sdt, device=dev).masked_fill(~ok, float("-inf"))
        if sdt == torch.float32:
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_i.float()) * scale
        else:
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_i.to(qg.dtype)).to(sdt) * scale
        s = softcap(s, attn_cap) + bias[:, None, None]
        m_cur = torch.maximum(m, s.amax(dim=-1).float())
        m_safe = torch.where(torch.isinf(m_cur), torch.zeros_like(m_cur), m_cur)
        p = torch.exp(s - m_safe[..., None].to(sdt))
        corr = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1, dtype=torch.float32)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_i.dtype).float(), v_i.float())
        acc = acc * corr[..., None] + pv
        m = m_cur
    return m, l, acc


def _attention_out(acc: torch.Tensor, l: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, Sq, Hq, hd) in q's dtype from the final accumulator and sum."""
    B, Sq, Hq, hd = q.shape
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   window: Optional[int] = None, impl: str = "auto") -> torch.Tensor:
    """Causal (optionally windowed) self-attention through the
    ``flash_attention`` op.

    q/k/v are padded at the sequence tail to a multiple of the kernel's
    tile and the output is sliced back.  Under a causal mask this is
    exact: no real query sees a padded key.
    """
    S = q.shape[1]
    pad = (-S) % ATTN_TILE
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=True, window=window, impl=impl,
                              tile_q=ATTN_TILE, tile_k=ATTN_TILE)
    return out[:, :S]


def _causal_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg, *,
                           window: Optional[int], impl: str) -> torch.Tensor:
    """Causal self-attention with no prefix, by :func:`attention_block`'s
    route: :func:`self_attention` (the flash op) under no grad and without
    an attention softcap, else :func:`chunked_attention`."""
    train = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if train or cfg.attn_softcap > 0:
        return chunked_attention(q, k, v, causal=True, window=window, attn_cap=cfg.attn_softcap)
    return self_attention(q, k, v, window=window, impl=impl)


# the unit the sequence length must come in on each model rank for the
# sequence-parallel window path (the reference's query tile)
SEQPAR_CHUNK = 1024


def _swa_seqpar_attention(x: torch.Tensor, p: Params, cfg, mesh, *, window: int,
                          impl: str = "auto"):
    """Sequence-parallel sliding-window attention (the reference's
    ``_swa_seqpar_attention``, ``repro/models/layers.py:297-375``).

    For head counts that do not divide the "model" axis (hymba: 25 q / 5
    kv heads), each of the M model ranks takes a contiguous 1/M slice of
    the query sequence, starting at ``start = m·S/M``, against the keys of
    its block ``[lo, start + S/M)``, ``lo = max(0, start - W)``: the slice
    and the W positions before it, which are all a windowed query of the
    slice can see.  RoPE is applied at the absolute positions of both.
    Each data rank takes its batch slice, as the reference's ``in_specs``
    P(batch axes) cut it.  The projections run inside on the slice,
    through :func:`project` (a compressed weight runs its kernel).  On
    exit every rank gathers the output and the rank's own k/v (the
    prefill cache) over the mesh.  Returns (y, k, v), each global.  On
    DTensors each rank runs its block on its shards
    (:func:`~repro_torch.distributed.partition.swa_seqpar`).

    The attention is causal self-attention over the block, windowed by W,
    with the block's first ``start - lo`` query rows zero (they only hold
    keys) and dropped after: the causal and window masks read only index
    differences, which the offset keeps, so each kept row equals the
    reference's tile of W + S/M keys masked to positions >= 0.  So it takes
    :func:`attention_block`'s route: the flash op under no grad, else
    :func:`chunked_attention`.  ``positions`` is not read: as in the
    reference, RoPE comes from ``start + arange``, so the path is right for
    a prefill from position 0.
    """
    if shd.is_dtensor(x):
        shd.count_path("swa_seqpar")
        return part.swa_seqpar(x, p, functools.partial(
            _swa_block, cfg=cfg, S_loc=x.shape[1] // shd.axis_size(mesh, "model"), W=window,
            impl=impl))
    B, S, D = x.shape
    M = shd.axis_size(mesh, "model")
    S_loc = S // M
    baxes = shd.mesh_batch_axes(mesh)
    shd.count_path("swa_seqpar")

    xl = coll.enter(x, P(baxes, None, None), mesh)
    wq, wk, wv, wo = (coll.enter(p[k], P(), mesh) for k in ("wq", "wk", "wv", "wo"))
    start = shd.coordinate(mesh, "model")[0] * S_loc
    y, k, v = _swa_block(xl, wq, wk, wv, wo, start, cfg=cfg, S_loc=S_loc, W=window, impl=impl)
    groups = (baxes, ("model",))

    def gathered(piece):
        # (nb, M, B_loc, S_loc, ...) → (nb·B_loc, M·S_loc, ...)
        g = coll.gather_grid(piece, mesh, groups)
        g = g.transpose(1, 2)
        return g.reshape(B, S, *piece.shape[2:])

    return gathered(y), gathered(k), gathered(v)


def _swa_block(xl: torch.Tensor, wq, wk, wv, wo, start: int, *, cfg, S_loc: int, W: int,
               impl: str = "auto"):
    """One rank's block of the sequence-parallel window attention on local
    tensors: the queries of its slice ``[start, start + S_loc)`` of
    ``xl`` (B_loc, S, D) against the keys of ``[max(0, start - W), start +
    S_loc)``; returns this rank's y (B_loc, S_loc, D) and its slice's k/v."""
    dev = xl.device
    B_loc = xl.shape[0]
    lo = max(0, start - W)
    off, L = start - lo, start + S_loc - lo
    xb = xl[:, lo:start + S_loc]
    q = project(xb[:, off:], wq, impl).to(xl.dtype)
    k = project(xb, wk, impl).to(xl.dtype)
    v = project(xb, wv, impl).to(xl.dtype)
    q = rope(q, (start + torch.arange(S_loc, device=dev)).expand(B_loc, S_loc), cfg.rope_theta)
    k = rope(k, (lo + torch.arange(L, device=dev)).expand(B_loc, L), cfg.rope_theta)
    q = F.pad(q, (0, 0, 0, 0, off, 0))
    out = _causal_self_attention(q, k, v, cfg, window=W, impl=impl)[:, off:]
    y = project(out, wo, impl, n_in=2).to(xl.dtype)
    return y, k[:, off:], v[:, off:]


def _takes_seqpar(cfg, S: int, *, causal: bool, window, prefix: int) -> bool:
    """The reference's condition for the sequence-parallel path
    (``repro/models/layers.py:403-411``): no cache, causal, a static int
    window, no qk-norm, no prefix, and an active mesh whose "model" axis
    is > 1, does not divide the q heads and divides S in SEQPAR_CHUNKs."""
    mesh = shd.active_mesh()
    if mesh is None or "model" not in shd.axis_names(mesh):
        return False
    M = shd.axis_size(mesh, "model")
    return (causal and isinstance(window, int) and not cfg.qk_norm and prefix == 0
            and M > 1 and cfg.n_heads % M != 0 and S % (M * SEQPAR_CHUNK) == 0)


def attention_block(x: torch.Tensor, p: Params, cfg, *, positions: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None, prefix: int = 0,
                    cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    cache_len: Optional[Any] = None,
                    impl: str = "auto") -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Projections + RoPE + attention; ``window`` (None = global) bounds
    each query to its last ``window`` keys, in prefill and decode.

    * prefill/forward (``cache_kv=None``): self-attention over ``x``;
      returns the new (k, v).  Causal attention with ``prefix == 0`` and
      ``cfg.attn_softcap == 0`` runs through the flash-attention op.
      Everything else runs through :func:`chunked_attention`, as the
      reference computes it: bidirectional attention (``causal=False``,
      the encoder of an encoder-decoder), a prefix-LM mask (``prefix``
      keys seen by every query before them) and an attention softcap
      (gemma2).  The reference's Pallas flash kernel
      (``repro/kernels/flash_attention.py``) has none of these in its
      contract, and the JAX model never calls it, so the port's flash
      kernel takes none either; its tail padding is exact only under a
      causal mask.  Under autograd (grad mode on and q, k or v requiring
      grad: a training forward) causal attention runs through
      :func:`chunked_attention` too.  That is what the reference trains
      through: its ``forward`` computes attention in jnp, and neither its
      Pallas flash kernel nor the port's has a backward (the CUDA wrapper
      refuses an input that requires grad).  Under ``torch.no_grad`` or
      ``inference_mode`` serving keeps flash.  The route follows from the
      grad mode, the arguments and ``cfg`` alone, before any launch.
    * decode: ``cache_kv=(K, V)`` buffers (B, Smax, Hkv, hd).  The new
      k/v are written into them **in place** at ``cache_len``, and
      attention spans the whole cache through :func:`chunked_attention`,
      whose causal mask hides the unwritten tail.  The write follows the
      reference's: at a scalar ``cache_len`` the start is clamped to
      [0, Smax - S], as ``dynamic_update_slice`` clamps it (a full cache
      overwrites its last slots); at per-sequence (B,) positions a row
      whose position is past the end is dropped, as JAX's scatter drops
      it.  Neither reads the position back to the host.  Where the
      decode-attention kernel takes the step (``impl`` not ``"ref"`` and
      :func:`_takes_decode_kernel`: one token, a CUDA cache, no grad, f32
      scores, no softcap or window, bf16 at a head dim it is built for),
      the ``decode_attention`` op does the write and the attention in one
      launch; it reads only each row's keys 0..pos.
    * on a mesh, a prefill or forward with no cache that meets the
      reference's condition (:func:`_takes_seqpar`) runs through
      :func:`_swa_seqpar_attention`.
    """
    if cache_kv is None and _takes_seqpar(cfg, x.shape[1], causal=causal, window=window,
                                          prefix=prefix):
        y, k, v = _swa_seqpar_attention(x, p, cfg, shd.active_mesh(), window=window, impl=impl)
        return y, (k, v)
    q = project(x, p["wq"], impl)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = project(x, p["wk"], impl)
    v = project(x, p["wv"], impl)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    k = rope(k, positions, cfg.rope_theta)
    if cache_kv is None:
        if not causal or prefix > 0:
            out = chunked_attention(q, k, v, causal=causal, window=window, prefix=prefix,
                                    attn_cap=cfg.attn_softcap)
        else:
            out = _causal_self_attention(q, k, v, cfg, window=window, impl=impl)
        new_kv = (k, v)
    else:
        K, V = cache_kv
        pos = torch.as_tensor(cache_len, device=x.device)
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, K, V))
        if impl != "ref" and _takes_decode_kernel(cfg, q, K, window=window,
                                                  device=K.device.type, grad=grad):
            out = ops.decode_attention(q, k, v, K, V, pos, impl=impl)
        else:
            write_cache(K, k, pos)
            write_cache(V, v, pos)
            out = chunked_attention(q, K, V, causal=True, window=window, q_offset=pos,
                                    attn_cap=cfg.attn_softcap, chunk=K.shape[1])
        new_kv = (K, V)
    y = project(out, p["wo"], impl, n_in=2)
    return y, new_kv


def _takes_decode_kernel(cfg, q: torch.Tensor, K: torch.Tensor, *, window: Optional[int],
                         device: str, grad: bool) -> bool:
    """Whether :func:`attention_block`'s decode branch takes the
    ``decode_attention`` op: one new token per row against a cache on a
    CUDA ``device`` that is not a DTensor, no input requiring grad under
    grad mode (``grad``), no attention softcap, no window, the default f32
    scores (:func:`set_scores_dtype`), and q and the cache bf16 at a head
    dim the kernel is built for, with Hq a multiple of Hkv by at most its
    group.  Decided from the arguments and ``cfg`` before any launch;
    everything else keeps :func:`write_cache` + :func:`chunked_attention`."""
    B, Sq, Hq, hd = q.shape
    Hkv = K.shape[2]
    return (device == "cuda" and not shd.is_dtensor(K) and not grad and Sq == 1
            and cfg.attn_softcap == 0 and window is None and _SCORES_DTYPE == torch.float32
            and q.dtype == K.dtype == torch.bfloat16 and hd in _da.HEAD_DIMS
            and Hq % Hkv == 0 and Hq // Hkv <= _da.MAX_GROUP)


def write_cache(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """Write ``new`` (B, S, Hkv, hd) into the cache ``buf`` (B, Smax, Hkv,
    hd) in place at ``pos``, with the reference's semantics and no host
    sync (:func:`~repro_torch.kernels.ref.write_cache_ref`).  A scalar
    ``pos`` starts the write at ``pos`` clamped to [0, Smax - S]
    (``jax.lax.dynamic_update_slice``).  A (B,) ``pos`` (one token per
    row) writes row b at ``pos[b]`` and drops it where ``pos[b] >= Smax``
    (``.at[b, pos].set``): the old slot is written back."""
    new = new.to(buf.dtype)
    if shd.is_dtensor(buf):
        part.write_cache(buf, new, pos, write_cache)
        return
    _kref.write_cache_ref(buf, new, pos)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_block(x: torch.Tensor, p: Params, cfg, impl: str = "auto",
              tap: Optional[Callable[[str, torch.Tensor], None]] = None) -> torch.Tensor:
    """Gated (or plain) GELU MLP; ``tap("down_in", h)`` sees the input of
    ``w_down`` when given."""
    # jax.nn.gelu defaults to the tanh approximation
    if cfg.gated_mlp:
        g = project(x, p["w_gate"], impl)
        u = project(x, p["w_up"], impl)
        h = F.gelu(g, approximate="tanh") * u
    else:
        h = F.gelu(project(x, p["w_up"], impl), approximate="tanh")
    if tap is not None:
        tap("down_in", h)
    return project(h, p["w_down"], impl)


# ---------------------------------------------------------------------------
# MoE: top-k routing with capacity-bounded scatter dispatch
# ---------------------------------------------------------------------------

def _moe_route(xt: torch.Tensor, w_router: torch.Tensor, K: int,
               dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference router: f32 logits of the stored operands (its
    ``preferred_element_type=f32``), softmax, the K largest probabilities,
    renormalised over the K with a 1e-9 floor and cast to ``dtype``.
    Returns (top_p (T, K), top_e (T, K) int64).  Ties go to the lower
    expert, as ``jax.lax.top_k`` breaks them: the first K of a stable
    descending sort (``torch.topk`` promises no order among equals)."""
    probs = torch.softmax(xt.float() @ w_router.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_p = (top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)).to(dtype)
    return top_p, top_e


def _moe_dispatch(xt: torch.Tensor, w_router: torch.Tensor, E: int, K: int,
                  capacity_factor: float, dtype: torch.dtype):
    """Route tokens: returns (eb (E, C, D), top_p, keep, dest, tok_idx, C).

    Capacity ``C = max(1, ceil(T·K/E·capacity_factor))`` is a Python int
    from the shapes, so nothing is read back from the card.  A (token, k)
    slot's place within its expert is its rank in a stable argsort of the
    flattened expert ids, so the lower (t, k) index wins a place; slots at
    or past C go to the overflow row E·C, which is thrown away (GShard
    capacity drops, as the reference).
    """
    T, D = xt.shape
    dev = xt.device
    top_p, top_e = _moe_route(xt, w_router, K, dtype)
    C = max(1, math.ceil(T * K / E * capacity_factor))
    e_flat = top_e.reshape(-1)                                    # (T·K,)
    order = torch.argsort(e_flat, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(T * K, device=dev)
    starts = torch.searchsorted(e_flat[order], torch.arange(E, device=dev), side="left")
    pos = ranks - starts[e_flat]
    keep = pos < C
    dest = torch.where(keep, e_flat * C + pos, E * C)
    tok_idx = torch.arange(T, device=dev).repeat_interleave(K)
    # kept destinations are distinct, so each kept row is its token's copy;
    # only the discarded overflow row takes several writes
    buf = torch.zeros((E * C + 1, D), dtype=dtype, device=dev)
    buf.index_copy_(0, dest, xt[tok_idx].to(dtype))
    return buf[:-1].reshape(E, C, D), top_p, keep, dest, tok_idx, C


def _moe_combine(eo: torch.Tensor, top_p: torch.Tensor, keep: torch.Tensor,
                 dest: torch.Tensor, tok_idx: torch.Tensor, T: int, D: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Inverse of dispatch: gather each (token, k) slot's expert output (a
    dropped slot reads a zero row, so its weight is lost, not
    renormalised), scale by ``top_p`` and sum each token's K contributions
    in k order, rounding to ``dtype`` after each add: the order in which
    the reference's scatter-add applies them.  No atomics, so the sum is
    the same on every run and device."""
    E_C = eo.shape[0] * eo.shape[1]
    out_flat = torch.cat([eo.reshape(E_C, D), eo.new_zeros((1, D))])
    gathered = out_flat[torch.where(keep, dest, E_C)]             # (T·K, D)
    weighted = (gathered * top_p.reshape(-1)[:, None]).reshape(T, -1, D)
    y = weighted[:, 0].to(dtype)
    for k in range(1, weighted.shape[1]):
        y = y + weighted[:, k]
    return y


def _expert_ffn(eb: torch.Tensor, p: Params, cfg, dtype: torch.dtype) -> torch.Tensor:
    """(E, C, D) → (E, C, D) through every expert's (optionally gated) MLP,
    each over its whole capacity slab; GELU (tanh approximation) in the
    compute dtype, as the reference."""
    if cfg.gated_mlp:
        g = torch.bmm(eb, p["w_gate"]).to(dtype)
        u = torch.bmm(eb, p["w_up"]).to(dtype)
        h = F.gelu(g, approximate="tanh") * u
    else:
        h = F.gelu(torch.bmm(eb, p["w_up"]).to(dtype), approximate="tanh")
    return torch.bmm(h, p["w_down"]).to(dtype)


def _moe_block_global(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    """The global-dispatch path over the B·S tokens of ``x`` (B, S, D):
    the reference's ``_moe_block_global``.  The expert leaves are dense
    (masked) weights, so no kernel runs here.  Its three phases are the
    spans ``moe.dispatch`` (route and scatter), ``moe.experts`` and
    ``moe.combine``."""
    if shd.is_dtensor(x):
        return part.moe_global(x, p, cfg, _moe_dispatch, _expert_ffn, _moe_combine)
    B, S, D = x.shape
    T = B * S
    if p["w_up"].shape[0] != cfg.n_experts:
        raise ValueError(f"the expert leaves hold {p['w_up'].shape[0]} of {cfg.n_experts} "
                         "experts (a rank's slice): only the expert-parallel path takes them")
    with span("moe.dispatch"):
        eb, top_p, keep, dest, tok_idx, _ = _moe_dispatch(
            x.reshape(T, D), p["w_router"], cfg.n_experts, cfg.top_k, cfg.capacity_factor,
            x.dtype)
    with span("moe.experts"):
        eo = _expert_ffn(eb, p, cfg, x.dtype)
    with span("moe.combine"):
        return _moe_combine(eo, top_p, keep, dest, tok_idx, T, D, x.dtype).reshape(B, S, D)


def _expert_leaf(w: torch.Tensor, key: str, cfg, mesh, fsdp: bool) -> torch.Tensor:
    """This rank's experts of one layer's expert leaf, whole over their
    other dims: the slice the reference's ``in_specs`` cut (through
    :func:`~repro_torch.distributed.sharding.spec_for_param`), then, with
    ``fsdp``, all-gathered over "data" where the spec put it.  A leaf may
    be given whole (E, ...) or as this rank's "model" slice (E/M, ...),
    the layout a mesh run keeps when the whole model does not fit on
    every rank (``init_params(keep=)`` with
    :func:`~repro_torch.sparsity.apply.prune_local`)."""
    E, M = cfg.n_experts, shd.axis_size(mesh, "model")
    spec = shd.layer_spec(key, (E,) + tuple(w.shape[1:]), fsdp=fsdp)
    if w.shape[0] == E // M and M > 1:
        spec = P(None, *spec[1:])
    elif w.shape[0] != E:
        raise ValueError(f"{key}: {w.shape[0]} experts, neither {E} nor {E // M}")
    w = coll.enter(w, spec, mesh)
    for d, entry in enumerate(spec):
        if entry is not None and "data" in ((entry,) if isinstance(entry, str) else entry) \
                and "data" in shd.axis_names(mesh):
            w = coll.all_gather(w, mesh, "data", d)
    return w


def _moe_block_ep(x: torch.Tensor, p: Params, cfg, mesh, baxes) -> torch.Tensor:
    """Expert-parallel MoE (the reference's ``_moe_block_ep``,
    ``repro/models/layers.py:556-639``).

    Each rank takes its batch slice (P(batch axes)); each of the M model
    ranks routes a disjoint 1/M slice of the local T_loc tokens, zero-padded
    to Ts·M rows (Ts = ceil(T_loc / M); pad rows are routed too, as in the
    reference), with capacity C from its Ts tokens.  The (M, E/M, C, D)
    capacity blocks are exchanged over "model" (block j to the rank that
    holds experts j·E/M ...), the resident experts run over the M·C rows
    from every source, the blocks go back by the reverse exchange, and
    each rank combines its own tokens.  On exit every rank gathers the
    tokens of every rank.  Capacity drops are per slice, so at a dropping
    capacity they differ from the global path's, as in the reference.  On
    DTensors each rank runs its slice on its shards and gathers over
    "model" only (:func:`~repro_torch.distributed.partition.moe_ep`).
    """
    if shd.is_dtensor(x):
        shd.count_path("moe_ep")
        return part.moe_ep(x, p, functools.partial(_ep_body, cfg=cfg, dtype=x.dtype))
    B, S, D = x.shape
    M = shd.axis_size(mesh, "model")
    fsdp = shd.get_options().fsdp
    shd.count_path("moe_ep")

    xl = coll.enter(x, P(baxes, None, None), mesh)
    wr = coll.enter(p["w_router"], P(), mesh)
    lp = {k: _expert_leaf(p[k], k, cfg, mesh, fsdp) for k in ("w_gate", "w_up", "w_down")
          if k in p}
    B_loc = xl.shape[0]
    T_loc = B_loc * S
    xt = xl.reshape(T_loc, D)
    Ts = -(-T_loc // M)
    pad = Ts * M - T_loc
    if pad:
        xt = torch.cat([xt, xt.new_zeros((pad, D))])
    mi = shd.coordinate(mesh, "model")[0]
    ys = _ep_body(xt[mi * Ts:(mi + 1) * Ts], wr, lp,
                  lambda t: coll.all_to_all(t, mesh, "model"), cfg=cfg, dtype=x.dtype)
    nb = math.prod(shd.axis_size(mesh, a) for a in baxes)
    y = coll.gather_grid(ys, mesh, (baxes, ("model",)))                # (nb, M, Ts, D)
    return y.reshape(nb, M * Ts, D)[:, :T_loc].reshape(B, S, D)


def _ep_body(xs: torch.Tensor, wr: torch.Tensor, lp: Params, exchange: Callable, *, cfg,
             dtype: torch.dtype) -> torch.Tensor:
    """One model rank's part of the expert-parallel block on local tensors:
    route its Ts tokens ``xs`` with capacity C from them, send each
    expert's (C, D) block to the rank that holds it (``exchange``, an
    all-to-all of (M, E/M, C, D) over "model"; dim 0 of the result is the
    source rank), run the resident experts ``lp`` over the M·C rows from
    every source, send the blocks back and combine the rank's tokens."""
    E, K = cfg.n_experts, cfg.top_k
    E_loc = lp["w_up"].shape[0]
    M = E // E_loc
    D = xs.shape[1]
    eb, top_p, keep, dest, tok_idx, C = _moe_dispatch(xs, wr, E, K, cfg.capacity_factor, dtype)
    ex = exchange(eb.reshape(M, E_loc, C, D))                          # dim 0: source rank
    ex = ex.transpose(0, 1).reshape(E_loc, M * C, D)
    eo = _expert_ffn(ex, lp, cfg, dtype)                               # (E_loc, M·C, D)
    eo = eo.reshape(E_loc, M, C, D).transpose(0, 1)
    eo = exchange(eo).reshape(E, C, D)                                 # back to the sources
    return _moe_combine(eo, top_p, keep, dest, tok_idx, xs.shape[0], D, dtype)


def moe_block(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    """Capacity-based top-k MoE over the tokens of ``x`` (B, S, D), chosen
    as the reference's ``moe_block`` chooses (``layers.py:642-658``): the
    expert-parallel path (:func:`_moe_block_ep`) with ``ep_shardmap`` on,
    on a mesh whose "model" axis divides the expert count, when the batch
    divides the batch axes; the global-dispatch path
    (:func:`_moe_block_global`) otherwise."""
    mesh = shd.active_mesh()
    if (shd.get_options().ep_shardmap and mesh is not None
            and "model" in shd.axis_names(mesh)
            and cfg.n_experts % shd.axis_size(mesh, "model") == 0):
        baxes = shd.mesh_batch_axes(mesh)
        nb = math.prod(shd.axis_size(mesh, a) for a in baxes)
        if x.shape[0] % max(nb, 1) == 0:
            return _moe_block_ep(x, p, cfg, mesh, baxes)
    return _moe_block_global(x, p, cfg)


# ---------------------------------------------------------------------------
# Mamba-2 SSD mixer (chunked state-space duality) + single-step decode
# ---------------------------------------------------------------------------

def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, Q: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (Dao & Gu 2024): the intra-chunk quadratic term plus the
    inter-chunk state recurrence, a port of the reference's ``_ssd_chunked``
    (``repro/models/layers.py:665-721``).

    xh: (B, S, H, Pd); dt: (B, S, H) f32 > 0; A: (H,) f32 < 0; Bm/Cm:
    (B, S, N); S a multiple of Q.  Returns y (B, S, H, Pd) in xh's dtype
    and the final state (B, H, Pd, N) in f32.

    The precision points are the reference's: the cumulative decay, the
    decays and the chunk weights ``w`` in f32; the masked scores, ``w``
    and the carried states rounded to xh's dtype before their products;
    every contraction an f32 product of the stored operands (its
    ``preferred_element_type=f32``).  ``xh * dt`` is f32, as jnp promotes
    it.  The recurrence over chunks is a Python loop.
    """
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    nc = S // Q
    dtype = xh.dtype
    xq = xh.reshape(Bsz, nc, Q, H, Pd)
    dtq = dt.reshape(Bsz, nc, Q, H)
    Bq = Bm.reshape(Bsz, nc, Q, N).float()
    Cq = Cm.reshape(Bsz, nc, Q, N).float()

    cum = torch.cumsum(dtq * A, dim=2)                              # (B,nc,Q,H) f32
    total = cum[:, :, -1, :]                                        # (B,nc,H)

    # intra-chunk: scores[i,j] = C_i·B_j · exp(cum_i - cum_j) for j <= i.  The
    # exponent is clamped at 0, which changes no kept entry (cum only falls)
    # and keeps the masked ones (j > i) finite: exp of their rise overflows
    # past a chunk's worth of decay, and an inf there makes the backward NaN
    # (the mask's zero grad times inf)
    cb = torch.einsum("bcqn,bckn->bcqk", Cq, Bq)
    decay = torch.exp((cum[:, :, :, None, :] - cum[:, :, None, :, :]).clamp(max=0))  # (B,nc,Q,Q,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    scores = torch.where(tri[None, None, :, :, None], cb[..., None] * decay,
                         torch.zeros((), device=xh.device)).to(dtype)
    xdt = xq.float() * dtq[..., None]                               # (B,nc,Q,H,Pd) f32
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores.float(), xdt)

    # chunk states: S_c = sum_j exp(total - cum_j) · B_j ⊗ (x_j·dt_j)
    w = torch.exp(total[:, :, None, :] - cum).to(dtype).float()     # (B,nc,Q,H)
    Sc = torch.einsum("bcqn,bcqhp->bchpn", Bq, w[..., None] * xdt)  # (B,nc,H,Pd,N)

    # inter-chunk recurrence: h_c = exp(total_c)·h_{c-1} + S_c
    h = torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=xh.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None] + Sc[:, c]
    h_prevs = torch.stack(h_prevs, dim=1).to(dtype).float()         # (B,nc,H,Pd,N)

    # inter-chunk output: y_i += C_i · h_{c-1} · exp(cum_i)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cq, h_prevs) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)
    return y.to(dtype), h


def ssm_block(x: torch.Tensor, p: Params, cfg, *, state: Optional[torch.Tensor] = None,
              conv_state: Optional[torch.Tensor] = None,
              impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mamba-2 mixer (the reference's ``ssm_block``, ``layers.py:724-781``).
    Prefill/forward: chunked SSD over the sequence, in chunks of
    ``cfg.ssm_chunk``.  Decode (S == 1 with ``state``): the single-step
    recurrence.

    ``w_in`` → [z (din), xs (din), B (N), C (N), dt (H)]; a 4-tap depthwise
    causal conv on xs, then SiLU; SSD; the D skip, the gate silu(z) and
    ``w_out``.  ``w_in``/``w_out`` go through :func:`project`, so a
    compressed one runs its kernel.  Returns (y, final state (B, H, Pd, N)
    f32, conv state: the last 3 xs rows (B, 3, din)).

    One rounding differs from the reference, in decode only: the reference
    multiplies the f32 decode output by ``w_out`` in f32, the port rounds
    it to x's dtype first, so that a compressed ``w_out`` runs its kernel
    in the weight's dtype (no difference in f32).

    On DTensors each rank runs its channels and heads (prefill) or its
    slice of the state (decode) on its shards
    (:func:`~repro_torch.distributed.partition.ssm_block`).
    """
    if shd.is_dtensor(x):
        return part.ssm_block(x, p, cfg, state=state, conv_state=conv_state, local=_SSM_LOCAL,
                              impl=impl)
    B, S, D = x.shape
    din = cfg.ssm_inner(D)
    N, H = cfg.ssm_state, cfg.ssm_heads
    Pd = din // H
    proj = project(x, p["w_in"], impl).to(x.dtype)
    z, xs, Bm, Cm, dt_raw = torch.split(proj, [din, din, N, N, H], dim=-1)
    # log(1 + e^x) with no switch to x at large inputs (F.softplus's
    # threshold), as jax.nn.softplus computes it
    dt = torch.logaddexp(dt_raw.float() + p["dt_bias"], torch.zeros((), device=x.device))
    A = -torch.exp(p["A_log"].float())                                  # (H,) < 0

    decode = state is not None and S == 1
    xc, new_conv = _ssm_conv(xs, p["conv_w"], conv_state if decode else None)
    xc = F.silu(xc.float()).to(x.dtype)
    xh = xc.reshape(B, S, H, Pd)
    if not decode:
        y, hT = _ssm_scan(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    else:
        y, hT = _ssm_step(state, xh, dt, A, Bm, Cm)
    y = y + xh * p["D_skip"][None, None, :, None]
    y = y.reshape(B, S, din) * F.silu(z.float()).to(x.dtype)
    out = project(y.to(x.dtype), p["w_out"], impl).to(x.dtype)
    return out, hT, new_conv


def _ssm_conv(xs: torch.Tensor, kern: torch.Tensor, conv_state: Optional[torch.Tensor]):
    """The 4-tap depthwise causal conv of :func:`ssm_block` on ``xs`` (B, S,
    C) by ``kern`` (4, C): over the sequence, its first rows padded with
    zeros (``conv_state`` None), or one step after the 3 rows of
    ``conv_state`` (B, 3, C).  Returns (the conv before its SiLU, the new
    conv state: the last 3 rows)."""
    if conv_state is None:
        S = xs.shape[1]
        xpad = F.pad(xs, (0, 0, 3, 0))
        xc = xpad[:, 0:S] * kern[3]
        for i in range(1, 4):                      # the reference's sum(), in its order
            xc = xc + xpad[:, i:i + S] * kern[3 - i]
        return xc, xpad[:, -3:]
    hist = torch.cat([conv_state, xs], dim=1)                           # (B, 4, C)
    return (hist * kern.flip(0)[None]).sum(dim=1, keepdim=True), hist[:, 1:]


def _ssm_scan(xh, dt, A, Bm, Cm, chunk: int):
    """The chunked SSD of a prefill over ``xh`` (B, S, H, Pd), the sequence
    padded to a multiple of ``chunk``: (y (B, S, H, Pd), final state)."""
    S = xh.shape[1]
    pad = (-S) % chunk
    xp, dtp, Bp, Cp = xh, dt, Bm, Cm
    if pad:
        xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtp, Bp, Cp = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, Cm))
    y, hT = _ssd_chunked(xp, dtp, A, Bp, Cp, min(chunk, xp.shape[1]))
    return y[:, :S], hT


def _ssm_step(state, xh, dt, A, Bm, Cm):
    """The single-step recurrence of decode: h' = exp(dt·A)·h + dt·(B ⊗ x),
    y = C·h'.  Returns (y (B, 1, H, Pd) f32, h').  Over a slice of the
    state dim N (``state``, ``Bm`` and ``Cm`` alike), y is that slice's
    part of the sum."""
    a = torch.exp(dt[:, 0] * A[None])                                   # (B, H)
    upd = torch.einsum("bn,bhp->bhpn", Bm[:, 0].float(), xh[:, 0].float() * dt[:, 0, :, None])
    hT = state * a[:, :, None, None] + upd
    return torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), hT)[:, None], hT


# the mixer's local math, for its partitioned view
_SSM_LOCAL = types.SimpleNamespace(conv=_ssm_conv, scan=_ssm_scan, step=_ssm_step,
                                   project=project)
