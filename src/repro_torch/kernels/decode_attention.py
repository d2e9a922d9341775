"""Decode attention over a slot-indexed cache on Hopper: wrapper of
``csrc/decode_attention.cu``.

Replaces no TPU kernel: the JAX package computes decode attention in jnp
(``chunked_attention`` after ``write_cache``), and the plain version
``ref.decode_attention_ref`` is that computation.  One launch writes a
decode step's new k/v into the layer's cache and attends each slot's one
query over its keys 0..pos; :func:`plans.da_plan` splits the cache from
the shapes alone.  The CUDA source says what bounds the kernel and how
its design answers that.  This wrapper checks its inputs, allocates the
output and the splits' scratch and launches on PyTorch's current stream;
it never reads a position back to the host, so a CUDA graph can capture
and replay it.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import _build
from .plans import da_plan

__all__ = ["decode_attention_cuda", "HEAD_DIMS", "MAX_GROUP", "launches", "variant_launches"]

HEAD_DIMS = (128,)
MAX_GROUP = 16         # q heads per kv head: the rows of one mma.sync tile

# launches of the CUDA kernel since the last reset (see ops.reset_launch_counts),
# in all and per variant (one)
launches = 0
variant_launches = {"split": 0}

# Per device, the int32 tickets, one per (slot, kv head), each buffer
# zeroed once; each launch leaves its tickets at 0 again.  A wider batch
# gets a new, wider buffer, and every buffer a launch has used is kept for
# the life of the process: a CUDA graph captured at a narrower batch
# replays on the buffer it captured, which no other tensor may come to
# own.  Calls on one device must not overlap on two streams (a decode step
# issues its layers in order on one stream).
_TICKETS: Dict[int, List[torch.Tensor]] = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    kept = _TICKETS.setdefault(device.index, [])
    if not kept or kept[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attention's first call at a batch of this size must "
                               "come before a CUDA graph capture (it allocates the device's "
                               "tickets)")
        kept.append(torch.zeros(n, dtype=torch.int32, device=device))
    return kept[-1]


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          K: torch.Tensor, V: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write k/v (B, 1, Hkv, hd) into the caches K/V (B, Smax, Hkv, hd) at
    ``pos`` (a scalar or (B,) integer tensor) in place, then attend q (B,
    1, Hq, hd) over each slot's keys 0..pos; returns (B, 1, Hq, hd) in q's
    dtype.  bf16 CUDA tensors, hd 128, Hq a multiple of Hkv by at most 16."""
    global launches
    if not (q.dtype == k.dtype == v.dtype == K.dtype == V.dtype == torch.bfloat16):
        raise TypeError(f"q/k/v and the caches must be bf16, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}/{K.dtype}/{V.dtype}")
    B, Sq, Hq, hd = q.shape
    Smax, Hkv = K.shape[1], K.shape[2]
    if Sq != 1 or k.shape != (B, 1, Hkv, hd) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: one "
                         "new token per slot")
    if K.shape != (B, Smax, Hkv, hd) or V.shape != K.shape:
        raise ValueError(f"caches {tuple(K.shape)}/{tuple(V.shape)} mismatch q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv} by at most {MAX_GROUP}")
    if pos.dim() > 1 or (pos.dim() == 1 and pos.shape[0] != B) or pos.is_floating_point():
        raise ValueError(f"pos must be an integer scalar or ({B},), got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    if not all(t.is_cuda for t in (q, k, v, K, V, pos)):
        raise ValueError("decode_attention_cuda takes CUDA tensors")
    if not (K.is_contiguous() and V.is_contiguous()) or _build.alignment(
            K.data_ptr(), V.data_ptr()) % 16:
        raise ValueError("the caches must be contiguous and 16-byte aligned")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    pos = pos.to(torch.int64).contiguous()
    G = Hq // Hkv
    chunk, nsplit = da_plan(B, Smax, Hkv)
    out = torch.empty_like(q)
    part = torch.empty(B * Hkv * nsplit * G * (hd + 2), dtype=torch.float32, device=q.device)
    lib = _build.load("decode_attention")
    with torch.cuda.device(q.device):
        rc = lib.da_decode_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), K.data_ptr(),
                                V.data_ptr(), pos.data_ptr(), int(pos.dim() == 1),
                                part.data_ptr(), _tickets(q.device, B * Hkv).data_ptr(),
                                out.data_ptr(), B, Smax, Hkv, G, chunk, nsplit,
                                1.0 / math.sqrt(hd), _build.stream_ptr(q.device))
    _build.check(rc, "da_decode_bf16")
    launches += 1
    variant_launches["split"] += 1
    return out
