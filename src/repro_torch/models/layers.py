"""Model-layer primitives of the dense decoder (port of
``repro/models/layers.py``): RMSNorm, RoPE, chunked online-softmax
attention with GQA and windows, the attention sub-block and the gated
MLP.

Projections are either dense weights in the reference layout (``wq``
(d, Hq, hd), ``wo`` (Hq, hd, d), ``w_up`` (d, F), ...) or compressed
modules: :class:`BlockSparseLinear` holds the FullBlock layout and runs
through the ``block_sparse_matmul`` op, :class:`IntraBlockLinear` holds
the row-aligned IntraBlock layout and runs through the
``intrablock_gather_matmul`` op.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..kernels.intrablock_matmul import check_row_idx

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
    matrix, and ``row_idx`` (L, Kc) int32, their rows in that matrix, plus
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
    run a compressed one."""
    lead = x.shape[:x.dim() - n_in]
    x2 = x.reshape(math.prod(lead), -1)
    if isinstance(w, COMPRESSED):
        return w(x2, impl).reshape(*lead, *w.out_shape)
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
    ang = positions[..., None].float() * freqs                      # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _as_batch(v, B: int, device) -> torch.Tensor:
    t = torch.as_tensor(v, device=device)
    return t.expand(B) if t.dim() == 0 else t


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[Any] = None,
                      q_offset: Any = 0, kv_len: Optional[Any] = None,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention scanned over kv chunks (the generic path
    of the reference, ``layers.py:277-294``).

    q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd).  ``q_offset`` (absolute
    position of q[0]) and ``kv_len`` (valid cache length) may be scalars
    or (B,) tensors; ``window`` is a scalar.  Scores and the running max/sum/accumulator
    are f32; P is cast to the value dtype before P·V, as in the reference.
    """
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
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
        k_idx = ci * chunk + torch.arange(chunk, device=dev)
        ok = torch.ones((B, Sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            ok &= k_idx[None, None, :] <= q_idx[:, :, None]
        if win is not None:
            ok &= k_idx[None, None, :] > q_idx[:, :, None] - win[:, None, None]
        if kvl is not None:
            ok &= k_idx[None, None, :] < kvl[:, None, None]
        if pad:
            ok &= (k_idx < Skv)[None, None, :]
        bias = torch.zeros(ok.shape, device=dev).masked_fill(~ok, float("-inf"))
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_i.float()) * scale
        s = s + bias[:, None, None]
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


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   impl: str = "auto") -> torch.Tensor:
    """Causal self-attention through the ``flash_attention`` op.

    q/k/v are padded at the sequence tail to a multiple of the kernel's
    tile and the output is sliced back.  Under a causal mask this is
    exact: no real query sees a padded key.
    """
    S = q.shape[1]
    pad = (-S) % ATTN_TILE
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=True, impl=impl,
                              tile_q=ATTN_TILE, tile_k=ATTN_TILE)
    return out[:, :S]


def attention_block(x: torch.Tensor, p: Params, cfg, *, positions: torch.Tensor,
                    cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    cache_len: Optional[Any] = None,
                    impl: str = "auto") -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Projections + RoPE + causal attention with no window (global).

    * prefill/forward (``cache_kv=None``): self-attention over ``x``
      through the flash-attention op; returns the new (k, v).
    * decode: ``cache_kv=(K, V)`` buffers (B, Smax, Hkv, hd).  The new
      k/v are written into them **in place** at ``cache_len`` (scalar or
      (B,)), and attention spans the whole cache through
      :func:`chunked_attention`, whose causal mask hides the unwritten tail.
    """
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
        out = self_attention(q, k, v, impl=impl)
        new_kv = (k, v)
    else:
        K, V = cache_kv
        pos = torch.as_tensor(cache_len, device=x.device)
        if pos.dim() == 0:
            K[:, int(pos):int(pos) + x.shape[1]] = k.to(K.dtype)
            V[:, int(pos):int(pos) + x.shape[1]] = v.to(V.dtype)
        else:
            bidx = torch.arange(K.shape[0], device=x.device)
            K[bidx, pos.long()] = k[:, 0].to(K.dtype)
            V[bidx, pos.long()] = v[:, 0].to(V.dtype)
        out = chunked_attention(q, K, V, causal=True, q_offset=pos, chunk=K.shape[1])
        new_kv = (K, V)
    y = project(out, p["wo"], impl, n_in=2)
    return y, new_kv


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
