"""Input (activation) sparsity profiling (paper §IV-B pre-simulation),
port of ``repro/core/input_sparsity.py``.

Digital CIM processes inputs bit-serially; a bit position can be skipped
only when it is zero across *all* inputs broadcast to the activated rows
of an array (§III-B).  The profile:

1. quantise activations to symmetric int8 (the paper's 8-bit precision);
2. for each group of ``group_rows`` inputs (one CIM array's row
   broadcast), a bit position is skippable iff the OR of the group's
   magnitudes has that bit clear;
3. the skippable ratio feeds the cost model's effective bit-serial
   length.

Steps 1 and 2 are the ``quantized_zero_profile`` op: on a CUDA tensor
one kernel reads the activation once, quantises it in registers and
counts, after a min/max pass for the scale; the counts stay on the card
until one host copy returns every profile's.  ``skippable_bit_ratio``
counts an int8 tensor with the ``bitserial_zero_profile`` op.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ..kernels import ops
from ..kernels.ref import quantize_int8

__all__ = ["quantize_int8", "skippable_bit_ratio", "profile_activations",
           "analytic_skip_ratio", "capture_mlp_activations"]


def skippable_bit_ratio(q: torch.Tensor, group_rows: int, n_bits: int = 8, *,
                        impl: str = "auto") -> float:
    """Fraction of (vector × group × bit) slots whose bit plane is all-zero.

    ``q`` is int8 (n_vectors, K), or (K,) for one vector; the contraction
    elements split into groups of ``group_rows`` (the array's broadcast
    span).  Sign-magnitude bit planes, as bit-serial digital CIM uses.
    """
    if q.dim() == 1:
        q = q[None, :]
    skippable, total = ops.bitserial_zero_profile(q, group_rows, n_bits, impl=impl).tolist()
    return float(skippable) / max(total, 1)


def profile_activations(acts: Dict[str, torch.Tensor], group_rows: int, n_bits: int = 8, *,
                        impl: str = "auto") -> Dict[str, float]:
    """Per-layer skippable-bit ratios from captured activation samples.

    Each activation is quantised to int8 and counted by
    ``ops.quantized_zero_profile``; the counts come back to the host in
    one copy for the whole dict.
    """
    if not acts:
        return {}
    counts = [ops.quantized_zero_profile(a.reshape(-1, a.shape[-1]), group_rows, n_bits,
                                         impl=impl) for a in acts.values()]
    pairs = torch.stack(counts).tolist()
    return {name: float(s) / max(t, 1) for name, (s, t) in zip(acts, pairs)}


def analytic_skip_ratio(zero_rate: float, group_rows: int, n_bits: int = 8,
                        mean_mag_bits: float = 4.0) -> float:
    """Closed-form estimate when no activation samples are available.

    Each activation is zero w.p. ``zero_rate`` and, when non-zero, each
    magnitude bit above ``mean_mag_bits`` is set with geometrically
    decaying probability.  A (group, bit) slot skips iff every element's
    bit is zero.
    """
    ratio = 0.0
    for b in range(n_bits):
        p_set = min(0.5, 0.5 * 2.0 ** (-(max(b - mean_mag_bits, 0.0))))
        p_elem_zero = zero_rate + (1.0 - zero_rate) * (1.0 - p_set)
        ratio += p_elem_zero ** group_rows
    return ratio / n_bits


def capture_mlp_activations(apply_fn: Callable, params, sample_inputs,
                            layer_names: List[str]) -> Dict[str, torch.Tensor]:
    """Run a model that returns (out, intermediates-dict) and keep the
    named intermediate activations for profiling (on their device)."""
    _, inter = apply_fn(params, sample_inputs)
    return {k: v for k, v in inter.items() if k in layer_names}
