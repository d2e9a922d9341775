"""Public kernel API of the port: layout builders + ``impl`` dispatch.

``impl`` for every op:

* ``"auto"`` — the Hopper CUDA kernel for a CUDA tensor, the plain
  PyTorch version for a CPU tensor.
* ``"cuda"`` — the CUDA kernel (a CPU tensor raises).
* ``"ref"``  — the plain PyTorch version, on any device.

Shapes, layouts and errors follow ``repro/kernels/ops.py``.  No CUDA
kernel has a backward (nor has any Pallas kernel of the reference): an op
that resolves to ``cuda`` while grad mode is on and a float input
requires grad raises ``RuntimeError`` rather than return an output that
silently cuts the autograd graph.  Each CUDA
wrapper counts its launches in a plain integer; :func:`launch_counts`
reads them, :func:`variant_counts` reads the per-variant counts of the
five kernels, :func:`gather_matmul_shape_counts` and
:func:`block_sparse_shape_counts` the two compressed matmuls' per variant
and weight shape, and :func:`reset_launch_counts` sets them all to 0.

Inside a :func:`~repro_torch.launch.counting.count` block each op counts
as one launch of its CUDA kernel, with the flops and bytes of
:mod:`.work` for the plan it would take on the card, whatever the device
and ``impl``; the ops of the plain stand-in that computes its values
there are not counted.  On the ``meta`` device, which computes nothing,
each op returns an empty tensor laid out as its kernel's output, and no
stand-in runs.  Inside a capture (:mod:`repro_torch.trace.capture`)
``flash_attention`` is recorded as the attention it computes, from the
operands the hook hands on; every other op raises, naming itself.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import bitserial_profile as _bsp
from . import block_importance as _bi
from . import block_sparse_matmul as _bsm
from . import flash_attention as _fa
from . import hook as _hook
from . import intrablock_matmul as _igm
from . import ref as _ref
from . import work as _work

__all__ = ["IMPLS", "compress_fullblock", "compress_fullblock_torch",
           "compress_intrablock", "compress_intrablock_torch", "aligned_rows",
           "decompress_intrablock",
           "block_sparse_matmul", "intrablock_gather_matmul", "block_importance",
           "bitserial_zero_profile", "quantized_zero_profile", "flash_attention",
           "launch_counts", "variant_counts", "gather_matmul_shape_counts",
           "block_sparse_shape_counts", "reset_launch_counts"]

IMPLS = ("auto", "cuda", "ref")
_KERNELS = {"flash_attention": _fa, "block_sparse_matmul": _bsm,
            "block_importance": _bi, "intrablock_gather_matmul": _igm,
            "bitserial_zero_profile": _bsp}


def _resolve(impl: str, t: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "cuda" if t.is_cuda else "ref"
    return impl


def _route(op: str, impl: str, t: torch.Tensor, *inputs: torch.Tensor) -> str:
    """``impl`` resolved for the tensor ``t``; a ``cuda`` route raises where
    grad mode is on and any of ``t`` and ``inputs`` requires grad."""
    route = _resolve(impl, t)
    if (route == "cuda" and torch.is_grad_enabled()
            and any(x.requires_grad for x in (t, *inputs))):
        raise RuntimeError(f"{op}: the CUDA kernel has no backward, and an input requires "
                           "grad; call it under torch.no_grad(), or use impl='ref'")
    return route


def launch_counts() -> Dict[str, int]:
    """CUDA kernel launches per op since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def variant_counts() -> Dict[str, Dict[str, int]]:
    """Launches per variant (see :mod:`~repro_torch.kernels.plans`) of the
    five kernels, since the last reset."""
    return {name: dict(mod.variant_launches) for name, mod in _KERNELS.items()}


def gather_matmul_shape_counts() -> Dict[Tuple[str, int, int], int]:
    """Launches of the gather-matmul per (variant, Kc, N) of its weight,
    since the last reset."""
    return dict(_igm.shape_launches)


def block_sparse_shape_counts() -> Dict[Tuple[str, int, int], int]:
    """Launches of the block-sparse matmul per (variant, K, N) of its
    weight, since the last reset."""
    return dict(_bsm.shape_launches)


def reset_launch_counts() -> None:
    _igm.shape_launches.clear()
    _bsm.shape_launches.clear()
    for mod in _KERNELS.values():
        mod.launches = 0
        for v in mod.variant_launches:
            mod.variant_launches[v] = 0


# ---------------------------------------------------------------------------
# Layout builders (run once, at pruning time)
# ---------------------------------------------------------------------------

def compress_fullblock(w: np.ndarray, keep: np.ndarray, bm: int,
                       bn: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a FullBlock-pruned matrix into the kernel layout (numpy).

    A copy of ``repro.kernels.ops.compress_fullblock``.  ``keep``:
    (K/bm, N/bn) bool block keep-grid.  Returns ``w_comp`` (Gn, L, bm, bn)
    and ``idx`` (Gn, L) int32 with -1 padding, L = max surviving K-blocks
    over the output-column groups.
    """
    K, N = w.shape
    gk, gn = keep.shape
    if gk * bm != K or gn * bn != N:
        raise ValueError(f"keep grid {keep.shape} mismatches {w.shape}/({bm},{bn})")
    L = max(1, int(keep.sum(axis=0).max()))
    w_comp = np.zeros((gn, L, bm, bn), dtype=w.dtype)
    idx = np.full((gn, L), -1, dtype=np.int32)
    for j in range(gn):
        ks = np.nonzero(keep[:, j])[0]
        for l, kblk in enumerate(ks):
            w_comp[j, l] = w[kblk * bm:(kblk + 1) * bm, j * bn:(j + 1) * bn]
            idx[j, l] = kblk
    return w_comp, idx


def compress_fullblock_torch(w: torch.Tensor, keep: torch.Tensor, bm: int, bn: int,
                             L: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`compress_fullblock` on the tensor's own device, by indexing.

    Gives the same bytes as the numpy builder.  ``L`` may raise the slot
    count above the minimum (extra slots are -1 padding), so that the
    layers of a stacked weight share one shape.
    """
    K, N = w.shape
    gk, gn = keep.shape
    if gk * bm != K or gn * bn != N:
        raise ValueError(f"keep grid {tuple(keep.shape)} mismatches {tuple(w.shape)}/({bm},{bn})")
    keep = keep.to(torch.bool)
    counts = keep.sum(dim=0)
    L_min = max(1, int(counts.max()))
    L = L_min if L is None else L
    if not L_min <= L <= gk:
        raise ValueError(f"L={L} outside [{L_min}, {gk}] for this keep grid")
    # kept K-blocks of each column group first, in ascending order
    order = torch.sort((~keep).to(torch.uint8), dim=0, stable=True).indices   # (gk, gn)
    kblk = order[:L].T                                                       # (gn, L)
    valid = torch.arange(L, device=w.device)[None, :] < counts[:, None]      # (gn, L)
    idx = torch.where(valid, kblk, torch.full_like(kblk, -1)).to(torch.int32)
    blocks = w.reshape(gk, bm, gn, bn).permute(2, 0, 1, 3)                    # (gn, gk, bm, bn)
    w_comp = blocks[torch.arange(gn, device=w.device)[:, None], kblk.clamp(min=0)]
    w_comp = torch.where(valid[:, :, None, None], w_comp, torch.zeros_like(w_comp))
    return w_comp.contiguous(), idx


def compress_intrablock(w: np.ndarray, mask: np.ndarray,
                        m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a *row-aligned* IntraBlock(m,1)-pruned matrix (numpy).

    A copy of ``repro.kernels.ops.compress_intrablock``.  When the
    survivors of every m-row block sit in the same rows for every column
    (``intrablock_mask(..., align_cols=True)``), compression is a row
    subset: ``w_comp`` (Kc, N) = ``w[row_idx]`` with ``row_idx`` (Kc,)
    int32.  Raises if the mask is not row-aligned or the survivor counts
    are not uniform per block.
    """
    K, N = w.shape
    if K % m:
        raise ValueError(f"K={K} not a multiple of intra block m={m}")
    nblocks = K // m
    mb = mask.reshape(nblocks, m, N).astype(bool)
    if not np.all(mb == mb[:, :, :1]):
        raise ValueError(
            "mask is not row-aligned across columns; per-column IntraBlock "
            "has no gather layout — use decompress_intrablock()")
    pattern = mb[:, :, 0]                       # (nblocks, m)
    counts = pattern.sum(axis=1)
    phi = int(counts.max())
    if phi == 0:
        raise ValueError("mask keeps nothing")
    if not np.all(counts == phi):
        raise ValueError(f"non-uniform survivors per block: {set(counts.tolist())}")
    row_idx = np.nonzero(pattern.reshape(-1))[0].astype(np.int32)   # (nblocks*phi,)
    w_comp = np.ascontiguousarray(w[row_idx, :])
    return w_comp, row_idx


def decompress_intrablock(w: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """General per-column IntraBlock: masked-dense weights (numpy copy of
    the reference's)."""
    return np.asarray(w) * np.asarray(mask, dtype=w.dtype)


def compress_intrablock_torch(w: torch.Tensor, mask: torch.Tensor,
                              m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`compress_intrablock` on the tensor's own device.

    Gives the same bytes and raises the same errors as the numpy version.
    """
    K, N = w.shape
    if K % m:
        raise ValueError(f"K={K} not a multiple of intra block m={m}")
    mb = mask.reshape(K // m, m, N).to(torch.bool)
    pattern = mb[:, :, 0]                                          # (nblocks, m)
    if not torch.equal(mb, pattern[:, :, None].expand_as(mb)):
        raise ValueError(
            "mask is not row-aligned across columns; per-column IntraBlock "
            "has no gather layout — use decompress_intrablock()")
    counts = pattern.sum(dim=1)
    phi = int(counts.max()) if counts.numel() else 0
    if phi == 0:
        raise ValueError("mask keeps nothing")
    if not bool((counts == phi).all()):
        raise ValueError(f"non-uniform survivors per block: {set(counts.tolist())}")
    row_idx = torch.nonzero(pattern.reshape(-1)).reshape(-1).to(torch.int32)
    return w[row_idx.long()].contiguous(), row_idx


def aligned_rows(w: torch.Tensor) -> torch.Tensor:
    """``w`` (..., N) as it is where its rows are a multiple of 16 bytes
    long, else a view of its first N columns in a zero-filled buffer whose
    rows are rounded up to 16 bytes (N to a multiple of 8 in bf16).  The
    gather-matmul's main variants read a weight through a TMA tensor map,
    whose row stride must be a multiple of 16 bytes; hymba-1.5b's w_in (N
    6482) has rows of 12,964 bytes.  The view keeps the (..., N) contract
    and the kernels read it in place."""
    per = 16 // w.element_size()
    N = w.shape[-1]
    if N % per == 0:
        return w
    buf = w.new_zeros(*w.shape[:-1], -(-N // per) * per)
    buf[..., :N] = w
    return buf[..., :N]


# ---------------------------------------------------------------------------
# Dispatch wrappers
# ---------------------------------------------------------------------------

def _on_shards(name: str, op: Callable, args, kwargs):
    """``op`` on DTensor inputs (the partitioned view), run on each rank's
    local shards and handed back as a DTensor.  Flash attention only, by
    its batch and head split (:func:`~repro_torch.distributed.partition.
    attention_shards`, which takes each rank's kv heads where k/v are
    replicated; keys split by sequence raise): the other kernels run on
    pruned params, which no cell on a mesh builds, and raise, naming the
    op."""
    from ..distributed import partition as part

    if name != "flash_attention":
        raise NotImplementedError(f"{name} on DTensors: no cell on a mesh reaches it (the "
                                  "dry-run on a mesh builds no pruned params)")
    sh = part.attention_shards(*args[:3], op=name, allow_seq=False)
    out = op(sh.q, sh.k, sh.v, *args[3:], **kwargs)
    return part.from_local(out, sh.mesh, sh.placements, sh.shape)


def _counted(kernel: str, work: Callable[..., Dict[str, int]],
             out: Callable[..., Tuple[Tuple[int, ...], torch.dtype]]) -> Callable:
    """The op, under a count, as one launch of ``kernel`` doing ``work(*args,
    **kwargs)``; on ``meta``, an empty tensor of ``out(*args, **kwargs)``'s
    (shape, dtype) in place of the op (see the module docstring).  Off
    ``meta`` and outside a count, the op unchanged.  On DTensors, the op
    on each rank's shards (:func:`_on_shards`), so a count reads one
    rank's work."""
    def wrap(op: Callable) -> Callable:
        def on_meta(*args, **kwargs):
            shape, dtype = out(*args, **kwargs)
            return torch.empty(shape, dtype=dtype, device="meta")

        @functools.wraps(op)
        def counted(*args, **kwargs):
            if hasattr(args[0], "device_mesh"):
                return _on_shards(op.__name__, counted, args, kwargs)
            run = on_meta if args[0].is_meta else op
            if _hook.active() is None:
                return run(*args, **kwargs)
            with _hook.paused():
                cost = work(*args, **kwargs)
            with _hook.kernel(kernel, **cost, op=op.__name__, operands=(args, kwargs)) as adopt:
                return adopt(run(*args, **kwargs))
        return counted
    return wrap


def _check_tiles(**tiles: int) -> None:
    """The reference's tile arguments only pad B, N or V, so the result
    does not depend on them; here they are checked and otherwise unused
    (:mod:`.plans` picks the launch)."""
    for name, v in tiles.items():
        if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
            raise ValueError(f"{name} must be a positive int, got {v!r}")


@_counted("block_sparse_matmul", _work.block_sparse_matmul,
          lambda x, w_comp, *_, **__: ((x.shape[0], w_comp.shape[0] * w_comp.shape[3]),
                                       x.dtype))
def block_sparse_matmul(x: torch.Tensor, w_comp: torch.Tensor, idx: torch.Tensor, *,
                        impl: str = "auto", tile_b: int = 128) -> torch.Tensor:
    """(B, K) @ FullBlock-compressed weight (Gn, L, bm, bn) → (B, Gn*bn).
    ``tile_b`` is the reference's; see :func:`_check_tiles`."""
    _check_tiles(tile_b=tile_b)
    if _route("block_sparse_matmul", impl, x, w_comp) == "ref":
        return _ref.block_sparse_matmul_ref(x, w_comp, idx)
    return _bsm.block_sparse_matmul_cuda(x, w_comp, idx)


@_counted("intrablock_gather_matmul", _work.intrablock_gather_matmul,
          lambda x, w_comp, *_, **__: ((x.shape[0], w_comp.shape[1]), x.dtype))
def intrablock_gather_matmul(x: torch.Tensor, w_comp: torch.Tensor, row_idx: torch.Tensor, *,
                             impl: str = "auto", tile_b: int = 128, tile_n: int = 128,
                             check_range: bool = True) -> torch.Tensor:
    """``x[:, row_idx] @ w_comp``: x (B, K), w_comp (Kc, N), row_idx (Kc,)
    int32 → (B, N).  ``check_range`` as in
    :func:`~repro_torch.kernels.intrablock_matmul.intrablock_gather_matmul_cuda`;
    ``tile_b`` / ``tile_n`` are the reference's (see :func:`_check_tiles`)."""
    _check_tiles(tile_b=tile_b, tile_n=tile_n)
    if _route("intrablock_gather_matmul", impl, x, w_comp) == "ref":
        return _ref.intrablock_gather_matmul_ref(x, w_comp, row_idx)
    return _igm.intrablock_gather_matmul_cuda(x, w_comp, row_idx, check_range=check_range)


@_counted("bitserial_zero_profile", _work.bitserial_zero_profile,
          lambda *_, **__: ((2,), torch.int32))
def bitserial_zero_profile(q: torch.Tensor, group_rows: int, n_bits: int = 8, *,
                           impl: str = "auto", tile_v: int = 128) -> torch.Tensor:
    """int32 ``[skippable, total]`` zero-plane slots of int8 q (V, K).
    ``tile_v`` is the reference's; see :func:`_check_tiles`."""
    _check_tiles(tile_v=tile_v)
    if _route("bitserial_zero_profile", impl, q) == "ref":
        return _ref.bitserial_zero_profile_ref(q, group_rows, n_bits)
    return _bsp.bitserial_zero_profile_cuda(q, group_rows, n_bits)


@_counted("bitserial_zero_profile", _work.quantized_zero_profile,
          lambda *_, **__: ((2,), torch.int32))
def quantized_zero_profile(x: torch.Tensor, group_rows: int, n_bits: int = 8, *,
                           per_tensor_scale: Optional[float] = None,
                           impl: str = "auto") -> torch.Tensor:
    """int32 ``[skippable, total]`` of ``quantize_int8(x)`` for a float x
    (V, K): the §IV-B profile of one activation.  On the card the
    quantisation is fused into the count's read of x."""
    if _route("quantized_zero_profile", impl, x) == "ref":
        return _ref.quantized_zero_profile_ref(x, group_rows, n_bits,
                                               per_tensor_scale=per_tensor_scale)
    return _bsp.quantized_zero_profile_cuda(x, group_rows, n_bits,
                                            per_tensor_scale=per_tensor_scale)


@_counted("block_importance", _work.block_importance,
          lambda w, bm, bn, *_, **__: ((w.shape[0] // bm, w.shape[1] // bn), torch.float32))
def block_importance(w: torch.Tensor, bm: int, bn: int, criterion: str = "l1", *,
                     impl: str = "auto", tile_n: int = 0) -> torch.Tensor:
    """Eq. 1 block losses (M/bm, N/bn) f32.  ``tile_n`` keeps the TPU
    kernel's column-strip contract: it must tile N in whole blocks."""
    if criterion not in _bi.CRITERIA:
        raise ValueError(f"criterion must be one of {tuple(_bi.CRITERIA)}, got {criterion!r}")
    if _route("block_importance", impl, w) == "ref":
        return _ref.block_importance_ref(w, bm, bn, criterion)
    M, N = w.shape
    if M % bm or N % bn:
        raise ValueError(f"matrix {tuple(w.shape)} not divisible by block ({bm},{bn})")
    TN = tile_n or N
    if TN % bn or N % TN:
        raise ValueError(f"tile_n={TN} must tile N={N} in whole blocks of {bn}")
    return _bi.block_importance_cuda(w, bm, bn, criterion)


@_counted("flash_attention", _work.flash_attention,
          lambda q, *_, **__: (tuple(q.shape), q.dtype))
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    impl: str = "auto", tile_q: int = 128,
                    tile_k: int = 128) -> torch.Tensor:
    """Fused attention over (B, S, H, hd) tensors with GQA broadcast.

    q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd) with Hq % Hkv == 0.  The
    CUDA path requires Sq and Skv to tile by ``tile_q``/``tile_k``, as
    the TPU kernel does.
    """
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if _route("flash_attention", impl, q, k, v) == "ref":
        G = Hq // Hkv
        if G > 1:
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)
        qf = q.transpose(1, 2).reshape(B * Hq, Sq, hd)
        kf = k.transpose(1, 2).reshape(B * Hq, Skv, hd)
        vf = v.transpose(1, 2).reshape(B * Hq, Skv, hd)
        of = _ref.flash_attention_ref(qf, kf, vf, causal=causal, window=window)
        return of.reshape(B, Hq, Sq, hd).transpose(1, 2)
    if Sq % tile_q or Skv % tile_k:
        raise ValueError(f"Sq={Sq}/Skv={Skv} must tile by {tile_q}/{tile_k}")
    return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
