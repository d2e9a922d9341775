"""Faults planted in the program underneath the timed path, for the
checks that show ``correct`` comes out false: ``portbench/control.py
--fault <name>`` reads them at a cell's own size, the CPU tests at a toy
size.  Each is planted by :func:`plant`, which returns the call that
takes it out again."""
from __future__ import annotations

from typing import Callable, Dict

__all__ = ["FAULTS", "plant"]


def _unchanged_cache(real):
    """decode_step returns its state unchanged: the new k/v never land.
    The positions a step writes (each slot's ``pos``) are saved before it
    and put back after it, so that no copy of the whole cache is made."""
    import torch

    def step(params, tokens, cfg, cache, **kw):
        L, B, T = cache["k"].shape[:3]
        pos = torch.as_tensor(cache["pos"], device=cache["k"].device).long()
        at = (pos.expand(B) if pos.dim() == 0 else pos).clamp(max=T - 1)
        rows = torch.arange(B, device=at.device)
        saved = {k: cache[k][:, rows, at].clone() for k in ("k", "v")}
        logits, new = real(params, tokens, cfg, cache, **kw)
        for k, v in saved.items():
            cache[k][:, rows, at] = v
        return logits, new
    return step


def _half_batch(real):
    """Half the batch left out: its rows take the mean of the others'."""
    def step(params, tokens, cfg, cache, **kw):
        logits, new = real(params, tokens, cfg, cache, **kw)
        h = logits.shape[0] // 2
        logits[h:] = logits[:h].mean(dim=0, keepdim=True)
        return logits, new
    return step


def _altered_token(real):
    """One token altered where it is produced: the slot-0 argmax of every
    decode step moves to the next id."""
    import torch

    def step(params, tokens, cfg, cache, **kw):
        logits, new = real(params, tokens, cfg, cache, **kw)
        top = int(torch.argmax(logits[0]))
        logits[0, (top + 1) % logits.shape[1]] = logits[0, top] + 1.0
        return logits, new
    return step


def _noncausal_prefill(real):
    """Prefill attention without its causal mask: every prompt token also
    sees the keys after it."""
    def flash(q, k, v, causal=True, **kw):
        return real(q, k, v, causal=False, **kw)
    return flash


# name -> (module, attribute, wrapper); the one-slot cells have no half batch
FAULTS: Dict[str, tuple] = {
    "unchanged_cache": ("repro_torch.serve.engine", "decode_step", _unchanged_cache),
    "half_batch": ("repro_torch.serve.engine", "decode_step", _half_batch),
    "altered_token": ("repro_torch.serve.engine", "decode_step", _altered_token),
    "noncausal_prefill": ("repro_torch.kernels.ops", "flash_attention", _noncausal_prefill),
}


def plant(name: str) -> Callable[[], None]:
    """Plant fault ``name``; returns the call that restores the program."""
    import importlib

    module, attr, wrap = FAULTS[name]
    mod = importlib.import_module(module)
    real = getattr(mod, attr)
    setattr(mod, attr, wrap(real))

    def undo() -> None:
        setattr(mod, attr, real)
    return undo
