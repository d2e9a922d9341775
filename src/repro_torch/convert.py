"""Convert parameters of the JAX package into the port's dict.

``params_from_jax`` takes the reference pytree (params or masks: nested
dicts) with its leaves already pulled to host numpy arrays (``np.asarray(leaf)``) and
returns the same nesting of torch tensors on ``device``.  The port never
imports jax: the caller does the host transfer.  bf16 leaves arrive as
``ml_dtypes.bfloat16`` ndarrays, which ``torch.from_numpy`` refuses; they
cross as their uint16 bit patterns and are viewed back as bf16.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

__all__ = ["params_from_jax"]


def _leaf(a: Any, device) -> Any:
    if a is None:
        return None
    arr = np.array(a)   # a writable host copy: jax's host views are read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree: Any, device: Union[str, torch.device]) -> Any:
    """Nested dicts of numpy arrays (or None) → the same dicts of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _leaf(tree, device)
