"""Plain float32 reference of the benchmark's decoders: GQA attention
with q/k RMS norms and rotary positions, and a gated GELU MLP or a top-k
MoE block, as the port's model states them.

It imports nothing of the program: each layer's weights are drawn again
from the seed (:mod:`portbench.harness.weights`, the benchmark's own
generator) and pruned again (:mod:`.prune`), one layer at a time, and
every request of a batch is carried through that layer before the next
is drawn, so that a 30 B-parameter model fits beside its activations.
TF32 is off: every product is a float32 product.

The model, as the port states it (``repro_torch/models``): RMSNorm
scales ``1 + s``; rotary angles over the two halves of a head; causal
softmax attention with scale 1/sqrt(hd); ``gelu_tanh(h Wg) * (h Wu) Wd``;
the MoE router's softmax, its top k renormalised (ties to the lower
expert), and GShard capacity drops in a prefill: the engine prefills a
prompt of S tokens alone, so its (token, k) slots take places in their
expert in (token, k) order up to C = max(1, ceil(S·k/E·capacity)), and
the rest are dropped; a decode token is alone in its one-slot batch and
keeps its k experts.  Logits come from the final norm and the tied
embedding (or ``lm_head``).

``quant="fp8"`` is the control: every matrix product's operands rounded
to float8 e4m3 (per-row scales on activations, per-column on weights),
products summed in f32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..harness import weights
from . import prune

__all__ = ["served_logits", "f32_matmuls"]

_ROWS = 512          # query rows per attention block
_FP8_MAX = 448.0


@contextlib.contextmanager
def f32_matmuls() -> Iterator[None]:
    """TF32 off for the block, the previous settings after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rms(x: torch.Tensor, s: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + s)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    S, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention: q (S, Hq, hd), k/v (S, Hkv, hd) → (S, Hq, hd)."""
    S, Hq, hd = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    out = torch.empty_like(q)
    for r0 in range(0, S, _ROWS):
        r1 = min(S, r0 + _ROWS)
        qb = q[r0:r1].reshape(r1 - r0, Hkv, G, hd)
        s = torch.einsum("qhgd,khd->hgqk", qb, k[:r1]) / math.sqrt(hd)
        hidden = torch.arange(r1, device=q.device)[None, :] > \
            torch.arange(r0, r1, device=q.device)[:, None]
        p = torch.softmax(s.masked_fill(hidden, float("-inf")), dim=-1)
        out[r0:r1] = torch.einsum("hgqk,khd->qhgd", p, v[:r1]).reshape(r1 - r0, Hq, hd)
    return out


def _mlp(h, W, quant):
    g = _mm(h, W["w_gate"], quant)
    u = _mm(h, W["w_up"], quant)
    return _mm(F.gelu(g, approximate="tanh") * u, W["w_down"], quant)


def _capacity_keep(top_e: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """(T, K) keep flags of one prefill's (token, k) slots: a slot keeps
    its place when fewer than C slots before it in (token, k) order went
    to its expert."""
    T, K = top_e.shape
    e_flat = top_e.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(e_flat.numel(), device=top_e.device)
    starts = torch.searchsorted(e_flat[order], torch.arange(E, device=top_e.device),
                                side="left")
    return (ranks - starts[e_flat] < C).reshape(T, K)


def _moe(hs: List[torch.Tensor], W, arch, n_prompts: List[int], quant) -> List[torch.Tensor]:
    """The MoE block over every sequence at once: routing and the
    prefill's capacity per sequence, each expert over all the tokens
    that keep it."""
    E, K = arch["n_experts"], arch["top_k"]
    h = torch.cat(hs)
    probs = torch.softmax(_mm(h, W["w_router"], quant), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    keep = torch.ones_like(top_e, dtype=torch.bool)
    start = 0
    for x, S in zip(hs, n_prompts):
        C = max(1, math.ceil(S * K / E * arch["capacity_factor"]))
        keep[start:start + S] = _capacity_keep(top_e[start:start + S], E, C)
        start += x.shape[0]
    y = torch.zeros_like(h)
    for e in range(E):
        t_idx, k_idx = ((top_e == e) & keep).nonzero(as_tuple=True)
        if t_idx.numel() == 0:
            continue
        xe = h[t_idx]
        g = _mm(xe, W["w_gate"][e], quant)
        u = _mm(xe, W["w_up"][e], quant)
        out = _mm(F.gelu(g, approximate="tanh") * u, W["w_down"][e], quant)
        y.index_add_(0, t_idx, out * top_p[t_idx, k_idx, None])
    return list(y.split([x.shape[0] for x in hs]))


def _attention_half(x, W, arch, quant):
    """Norm, projections, q/k norms, rotary positions, attention and the
    residual of one sequence x (S, d)."""
    S, d = x.shape
    Hq, Hkv = arch["n_heads"], arch["n_kv_heads"]
    hd = arch.get("head_dim") or d // Hq
    eps = arch.get("norm_eps", 1e-6)
    h = _rms(x, W["ln1"], eps)
    q = _mm(h, W["wq"].reshape(d, -1), quant).reshape(S, Hq, hd)
    k = _mm(h, W["wk"].reshape(d, -1), quant).reshape(S, Hkv, hd)
    v = _mm(h, W["wv"].reshape(d, -1), quant).reshape(S, Hkv, hd)
    if arch.get("qk_norm"):
        q, k = _rms(q, W["q_norm"], eps), _rms(k, W["k_norm"], eps)
    theta = arch.get("rope_theta", 10000.0)
    o = _attention(_rope(q, theta), _rope(k, theta), v)
    return x + _mm(o.reshape(S, Hq * hd), W["wo"].reshape(Hq * hd, d), quant)


def _layer(xs: List[torch.Tensor], W, arch, n_prompts: List[int], quant) -> List[torch.Tensor]:
    """One decoder layer over every sequence: attention per sequence, the
    MLP or MoE block over all their tokens at once."""
    eps = arch.get("norm_eps", 1e-6)
    xs = [_attention_half(x, W, arch, quant) for x in xs]
    hs = [_rms(x, W["ln2"], eps) for x in xs]
    if arch.get("n_experts", 1) > 1:
        ys = _moe(hs, W, arch, n_prompts, quant)
    else:
        ys = list(_mlp(torch.cat(hs), W, quant).split([h.shape[0] for h in hs]))
    return [x + y for x, y in zip(xs, ys)]


def _layer_weights(cfg: dict, seed: int, l: int, device) -> dict:
    arch, init, pruning = cfg["arch"], cfg["init"], cfg["pruning"]
    W = {}
    for name in weights.layer_shapes(arch):
        w = weights.draw(arch, init, seed, name, l, device).float()
        if name in pruning["keys"]:
            w = w * prune.mask_of(w, pruning)
        W[name] = w
    return W


def served_logits(cfg: dict, seed: int, seqs: Sequence[Tuple[np.ndarray, List[int]]],
                  device, quant: Optional[str] = None) -> List[torch.Tensor]:
    """For each (prompt, served tokens) pair: the logits (n, V) f32 at the
    positions that produced the n served tokens (the prompt's last, then
    each served token but the last, teacher-forced)."""
    arch, init = cfg["arch"], cfg["init"]
    eps = arch.get("norm_eps", 1e-6)
    with f32_matmuls(), torch.no_grad():
        embed = weights.draw_global(arch, init, seed, "embed", device).float()
        xs, n_prompts = [], []
        for prompt, served in seqs:
            ids = np.concatenate([np.asarray(prompt, np.int64),
                                  np.asarray(served[:-1], np.int64)])
            xs.append(embed[torch.as_tensor(ids, device=device)])
            n_prompts.append(len(prompt))
        for l in range(arch["n_layers"]):
            W = _layer_weights(cfg, seed, l, device)
            xs = _layer(xs, W, arch, n_prompts, quant)
            del W
        norm = weights.draw_global(arch, init, seed, "final_norm", device).float()
        head = (embed.T if arch.get("tie_embeddings")
                else weights.draw_global(arch, init, seed, "lm_head", device).float())
        out = []
        for x, S in zip(xs, n_prompts):
            h = _rms(x[S - 1:], norm, eps)
            out.append(_mm(h, head, quant))
        return out
