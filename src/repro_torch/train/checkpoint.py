"""Fault-tolerant checkpointing (port of ``repro/train/checkpoint.py``), in
the reference's on-disk format.

A checkpoint is a directory ``step_<10 digits>`` holding ``params.npz``
and ``opt_state.npz`` (one array per leaf, keyed by the ``::``-joined key
path of the nested dicts, bf16 widened to f32: npz has no bf16) and
``meta.json`` (``step``, ``data_state``, ``extra``).  It is written to a
``mkdtemp`` directory and moved into place with ``os.replace``, the last
``keep`` are kept, and a directory without ``meta.json`` is never listed.
The port's params are nested dicts laid out like the reference pytree, so
the keys are the reference's: a checkpoint written by either package
restores in the other.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import leaves_with_paths, map_with_path

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "list_checkpoints"]

_SEP = "::"


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for path, leaf in leaves_with_paths(tree):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            # npz has no native bfloat16: store widened, restore re-casts
            t = t.float()
        flat[_SEP.join(path)] = t.numpy()
    return flat


def _unflatten_into(template, flat: Dict[str, np.ndarray]):
    """``template``'s nesting with each leaf read from ``flat`` and cast to
    the template leaf's dtype and device; ``KeyError`` for a missing leaf,
    ``ValueError`` for a shape mismatch."""
    def leaf(path, t):
        key = _SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                             f"template {tuple(t.shape)}")
        return torch.from_numpy(np.array(arr)).to(device=t.device, dtype=t.dtype)

    return map_with_path(leaf, template)


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state=None, *,
                    data_state: Optional[Dict] = None, extra_meta: Optional[Dict] = None,
                    keep: int = 3) -> str:
    """Atomically write the checkpoint of ``step``; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, "params.npz"), **_flatten(params))
        if opt_state is not None:
            np.savez(os.path.join(tmp, "opt_state.npz"), **_flatten(opt_state))
        meta = {"step": step, "data_state": data_state or {}, "extra": extra_meta or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _rotate(ckpt_dir, keep)
    return final


def _rotate(ckpt_dir: str, keep: int) -> None:
    for s in list_checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)


def list_checkpoints(ckpt_dir: str) -> List[int]:
    """Steps of the complete checkpoints under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d{10})", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, params_template, opt_template=None, *,
                       step: Optional[int] = None) -> Tuple[Any, Any, Dict]:
    """Restore (params, opt_state, meta) as new tensors shaped, typed and
    placed like the templates; ``step=None`` → the latest complete one."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "params.npz")) as z:
        params = _unflatten_into(params_template, dict(z))
    opt_state = None
    if opt_template is not None:
        with np.load(os.path.join(path, "opt_state.npz")) as z:
            opt_state = _unflatten_into(opt_template, dict(z))
    return params, opt_state, meta
