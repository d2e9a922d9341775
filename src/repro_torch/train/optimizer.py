"""AdamW with global-norm clipping on nested-dict params (port of
``repro/train/optimizer.py``).

The math is the reference's, operation for operation: ``m``/``v`` mirror
the params in f32, the update runs on an f32 copy of each parameter with
bias correction and decoupled weight decay, and is cast back to the
parameter's dtype.  Unlike the reference, :func:`adamw_update` writes the
params, ``m``, ``v`` and ``step`` in place, one slice of each leaf at a
time: at qwen3-4b's width a functional update would hold a second copy of
the params and the f32 moments (about 40 GB) beside the first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..distributed import partition as part
from ..distributed import sharding as shd
from ..tree import leaves, map_with_path

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]

# elements per slice of a leaf that the update and the norm take at a time
# (f32 temporaries of 64 MB), so no full-leaf f32 temporary is made
_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params) -> Dict[str, Any]:
    """``step`` (int32, 0-dim) and f32 zero ``m``/``v`` mirroring the params,
    on the params' device."""
    def zeros(_, p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
            "m": map_with_path(zeros, params), "v": map_with_path(zeros, params)}


def _chunks(t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Views of ``t`` along its first dim, each of at most about _CHUNK
    elements (a whole leaf when it is small)."""
    if t.dim() == 0 or t.numel() <= _CHUNK:
        return (t,)
    return t.split(max(1, _CHUNK * t.shape[0] // t.numel()))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (0-dim tensor); of
    DTensor leaves, over every rank's shards
    (:func:`~repro_torch.distributed.partition.sum_over_shards`)."""
    ls = leaves(tree)
    per_leaf = [torch.stack([c.float().square().sum() for c in _chunks(part.local(l))]).sum()
                for l in ls]
    return torch.sqrt(part.sum_over_shards(per_leaf, ls))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio (f32, 0-dim)."""
    step_f = step.float()
    warm = torch.clamp(step_f / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step_f - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def adamw_update(grads, opt_state: Dict[str, Any], params, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, written in place into ``params`` and ``opt_state``;
    returns (params, opt_state, metrics) with metrics ``grad_norm`` and
    ``lr`` (0-dim f32 tensors).  ``grads`` mirrors ``params`` (any float
    dtype).

    On DTensors (the dry-run on a mesh) each grad is first brought to its
    param's layout (a partial sum reduced: an all-reduce, or a
    reduce-scatter where the param is split), and each rank updates its
    shards; ``m`` and ``v`` are laid out as the param."""
    if shd.is_dtensor(leaves(params)[0]):
        grads = {i: g if tuple(g.placements) == tuple(p.placements)
                 else g.redistribute(p.device_mesh, p.placements)
                 for i, (g, p) in enumerate(zip(leaves(grads), leaves(params)))}
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(gnorm.new_tensor(cfg.clip_norm) / torch.clamp(gnorm, min=1e-9),
                         max=1.0)
             if cfg.clip_norm > 0 else 1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    lr_l, bc1, bc2 = part.local(lr), part.local(bc1), part.local(bc2)
    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt_state["m"]),
                              leaves(opt_state["v"])):
            p, g, m, v = (part.local(t) for t in (p, g, m, v))
            for pc, gc, mc, vc in zip(_chunks(p), _chunks(g), _chunks(m), _chunks(v)):
                g32 = gc.float() * scale
                mc.mul_(b1).add_((1 - b1) * g32)
                vc.mul_(b2).add_((1 - b2) * g32.square())
                delta = (mc / bc1) / (torch.sqrt(vc / bc2) + cfg.eps)
                p32 = pc.float()
                pc.copy_(p32 - lr_l * (delta + cfg.weight_decay * p32))
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
