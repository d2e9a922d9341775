"""PyTorch/CUDA port of the CIMinus execution plane.

The port sits beside the JAX package ``repro`` and imports nothing from
it: what it needs of the jax-free modules (configs, FlexBlock specs,
pruning, serve metrics) is copied here.  Plain tensor code is PyTorch;
every Pallas TPU kernel on the ported path is a hand-written CUDA C++
kernel for Hopper (``sm_90a``) under :mod:`repro_torch.kernels`.

Entry points (``init_params``, ``prune_params``, ``ServeEngine``) run on
``cuda`` unless the caller passes ``device="cpu"``.  With no device
given and no CUDA present they raise instead of carrying on on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda`` (raises when no card is present); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
