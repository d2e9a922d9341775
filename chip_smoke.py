#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each reported on its own line(s):

1. build    — compile the port's five CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
2. kernels  — hold each kernel against its plain PyTorch version at the
   shapes of the main paths, in bf16 and f32 (int8 for the bit-serial
   profile), and time kernel, plain version and the nearest single
   PyTorch call.  Every row names the variant that ran and is timed from
   CUDA graphs (card time alone), with the eager times beside them (what
   back-to-back calls from Python cost, host included); each
   row gives ``share_of_bound`` (bound / ms) and ``x_library`` (ms /
   library ms).  The bf16 matmul rows add the card time of the same
   variant at cluster sizes 1, 2, 4 and 8 beside the plan's, the flash
   wgmma rows (S = 512 and 2048) the card time at every lever setting
   (rows per CTA / keys per tile / q heads per CTA), and the
   block-importance and int8 bit-serial rows the first kernel's card time
   (``general_ms``); the fused quantise-and-count rows (bf16 and f32 at the
   profile's shapes) add the whole op, its min/max pass and the unfused
   quantize_int8 + count;
3. llama3-8b FullBlock path: init at full width (random bf16 weights
   from a seed), check the kernel's Eq. 1 block losses against the plain
   ones, prune with FullBlock(128, 128, 0.5), compress, serve 8 requests
   (prompts of 100..512 tokens, 32 new tokens each) through
   ``ServeEngine(slots=4, max_len=1024)``, then the parity phase:
   rerun the 8 prompts' prefill and the first request's first 4 decode
   steps with ``impl="ref"`` on the same compressed weights, show that a
   planted fault breaks the logit tolerance, check that the served
   logits are f32 products;
4. qwen3-4b IntraBlock path: free the llama weights, init qwen3-4b at
   full width, prune wq/wk/wv/w_gate/w_up/w_down with row-aligned
   IntraBlock(4, 1, 0.5), compress to the gather layout, serve the same
   8 requests, and run the same parity phase;
5. profile  — §IV-B bit-serial profile of every pruned projection's
   input (36 layers x 3 kinds, the 8 prompts' prefill) through the fused
   quantise-and-count, one launch per activation, all ``fused``, and one
   host sync for the whole profile; the fused kernel against
   quantize_int8 + the plain count, and the int8 kernel against the plain
   count, in every (layer, kind);
6. microbench — ``microbench_kernels`` on the card, its samples written
   as JSONL under ``build/`` and read back;
7. cost     — on the host, from what the card produced in this run: a
   calibration profile fitted to the microbench samples (saved under
   ``build/profiles/``), the profile's 108 skippable-bit ratios mapped
   onto ``lm_workload``'s op names, and CIMinus cost reports of the two
   served models with the FlexBlock specs they were pruned with, on
   ``usecase_arch(4, input_sparsity=True)`` at 512 tokens: qwen3-4b (a)
   without input sparsity, (b) with the measured ratios, (c) with the
   ratios and the fitted profile; llama3-8b (a) and (c).  Each report must
   be finite and round-trip through JSON, (b) may not be slower than (a),
   a profile with unit efficiencies must give (b) bit for bit, (c) must be
   (b) with each op's latency divided by its class's efficiency, and the
   density of every mask the card produced must be the spec's;
8. the ``{"kernels": [...]}`` line; 9. the card's name and power limit.

The launch counts are set to 0 just before each path and read just
after it: the three FullBlock-path kernels from prune to the end of
llama3-8b serving, ``intrablock_gather_matmul`` from prune to the end of
qwen3-4b serving, ``bitserial_zero_profile`` over the profile call.
After each served path its compressed projections must have run only
through the ``decode`` and ``prefill`` variants, one launch per
projection, layer and decode step or prompt, none through ``general``;
its prefill attention only through the flash ``wgmma`` variant (one
launch per layer and prompt), and the llama3-8b prune only through the
block-importance ``strip`` variant (one launch per projection and layer),
and the profile only through the bit-serial ``fused`` variant.
Any failed check exits nonzero.  Without a CUDA device, or without the
repository beside it, the script exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (dense): bytes and operations bounds.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12

KEYS = ("wq", "wk", "wv", "w_gate", "w_up", "w_down")
BLOCK = 128
INTRA_M = 4            # IntraBlock(4, 1, 0.5): 2 of every 4 rows, shared by all columns
# rows one CIM array broadcasts an input group to: sub_rows of usecase_arch
# (src/repro/core/presets.py:200)
GROUP_ROWS = 32
SEED = 0


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def cuda_ms(fn, sets, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn(*sets[i % len(sets)])`` between CUDA events.

    ``sets`` holds distinct copies of the inputs, together larger than the
    50 MB L2 cache, so each call finds its operands in device memory as
    the main path does.
    """
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def graph_ms(fn, sets, iters: int = 20) -> float:
    """Mean ms of ``fn(*sets[i % len(sets)])`` replayed from a CUDA graph.

    The graph holds ``iters`` calls, so the events time the card alone:
    none of the host's launch cost (Python wrapper, plan, ctypes call)
    that a run of eager calls waits on when the card is faster than the
    host.  Inputs rotate as in :func:`cuda_ms`.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*sets[i % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    del graph
    return e0.elapsed_time(e1) / iters


def n_copies(nbytes: int) -> int:
    return max(1, min(16, math.ceil(128e6 / max(nbytes, 1))))


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def bound(nbytes: int, ops: float, peak: float) -> dict:
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate of their type, whichever is larger."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, ops / peak
    return {"bound_ms": max(t_b, t_f) * 1e3, "bound_by": "bytes" if t_b >= t_f else "operations"}


def ratios(line: dict) -> dict:
    """share_of_bound (bound / ms) and x_library (ms / library ms) of a row."""
    lib = line.get("library_ms")
    return {"share_of_bound": line["bound_ms"] / line["ms"],
            "x_library": line["ms"] / lib if lib else None}


def moved_variant(op: str, before: dict) -> str:
    """The one variant of ``op`` whose launch count moved since ``before``."""
    from repro_torch.kernels import ops
    after = ops.variant_counts()[op]
    moved = [v for v in after if after[v] != before[v]]
    check(len(moved) == 1, f"{op}: variants {moved} moved on one call")
    return moved[0]


def cluster_sweep(op: str, variant: str, sets) -> dict:
    """Card ms of the ``variant`` of ``op`` at cluster sizes 1, 2, 4 and 8
    (the plan picks one), calling the C entry point directly."""
    from repro_torch.kernels import _build
    lib = _build.load("block_sparse_matmul" if op == "block_sparse_matmul"
                      else "intrablock_matmul")
    out = {}
    for c in (1, 2, 4, 8):
        def call(a, wc, ix, d, c=c):
            stream = _build.stream_ptr(a.device)
            B, K = a.shape
            if op == "block_sparse_matmul":
                Gn, L = wc.shape[:2]
                y = torch.empty(B, Gn * BLOCK, dtype=a.dtype, device=a.device)
                rc = getattr(lib, f"bsm_bf16_{variant}")(a.data_ptr(), wc.data_ptr(),
                                                         ix.data_ptr(), y.data_ptr(), B, K, Gn,
                                                         L, c, stream)
            else:
                Kc, N = wc.shape
                y = torch.empty(B, N, dtype=a.dtype, device=a.device)
                if variant == "decode":
                    rc = lib.igm_bf16_decode(a.data_ptr(), wc.data_ptr(), ix.data_ptr(),
                                             y.data_ptr(), B, K, Kc, N, c, stream)
                else:
                    Kp = -(-Kc // 8) * 8
                    xg = torch.empty(B, Kp, dtype=a.dtype, device=a.device)
                    rc = lib.igm_bf16_prefill(a.data_ptr(), wc.data_ptr(), ix.data_ptr(),
                                              xg.data_ptr(), y.data_ptr(), B, K, Kc, Kp, N, c,
                                              stream)
            _build.check(rc, f"{op} {variant} cluster {c}")
        out[c] = graph_ms(call, sets)
    return out


FA_LEVERS = [(rows, keys, pack) for rows in (128, 64) for keys in (128, 64) for pack in (1, 4)]


def flash_sweep(sets, window) -> dict:
    """Card ms of the flash wgmma variant at every lever setting it was
    built with (rows per CTA / keys per tile / q heads packed per CTA),
    calling the C entry point directly."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    out = {}
    for rows, keys, pack in FA_LEVERS:
        def call(q, k, v, rows=rows, keys=keys, pack=pack):
            B, S, Hq, hd = q.shape
            o = torch.empty_like(q)
            rc = lib.fa_fwd_bf16_wgmma(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                       B, S, Hq, k.shape[2], hd, int(window or 0),
                                       1.0 / math.sqrt(hd), rows, keys, pack,
                                       _build.stream_ptr(q.device))
            _build.check(rc, f"flash_attention wgmma {rows}/{keys}/{pack}")
        out[f"{rows}/{keys}/{pack}"] = graph_ms(call, sets)
    return out


def kernel_phase() -> dict:
    """Hold each kernel to its plain version at main-path shapes and time
    kernel, plain version and library call on every row.  Returns the
    main-path row of each kernel for the ``{"kernels": ...}`` line."""
    from repro_torch.kernels import block_importance as bi_mod
    from repro_torch.kernels import block_sparse_matmul as bsm_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import _build, ops, plans, ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = {}
    dtypes = (torch.bfloat16, torch.float32)
    peak = {torch.bfloat16: BF16_TC_FLOPS, torch.float32: F32_FLOPS}   # f32 avoids TF32

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def report(name, line):
        print(f"[kernels] {name}: " + json.dumps(line), flush=True)

    # -- flash attention: prefill self-attention ------------------------------
    # (B, S, Hq, Hkv, hd, window): llama3-8b prefill of the longest prompt
    # (512 tokens) and the same heads at S = 2048, where the tensor cores
    # bound it; head dims 64/256 and a window for coverage (general variant).
    fa_cases = [(1, 512, 32, 8, 128, None), (1, 2048, 32, 8, 128, None),
                (1, 256, 8, 2, 64, 64), (1, 256, 8, 2, 256, None)]
    tol = {torch.bfloat16: 3e-2, torch.float32: 3e-5}
    for (B, S, Hq, Hkv, hd, window) in fa_cases:
        G = Hq // Hkv
        pairs = B * Hq * sum(min(i + 1, window or S) for i in range(S))   # live (q, k) pairs
        for dt in dtypes if S <= 512 else (torch.bfloat16,):
            esize = torch.empty((), dtype=dt).element_size()
            nbytes = 2 * B * S * (Hq + Hkv) * hd * esize           # q, k, v read; o written
            sets = [(randn(B, S, Hq, hd, dtype=dt), randn(B, S, Hkv, hd, dtype=dt),
                     randn(B, S, Hkv, hd, dtype=dt)) for _ in range(n_copies(nbytes))]
            q, k, v = sets[0]
            before = ops.variant_counts()["flash_attention"]
            out = fa_mod.flash_attention_cuda(q, k, v, causal=True, window=window)
            variant = moved_variant("flash_attention", before)
            plain = ops.flash_attention(q, k, v, causal=True, window=window, impl="ref")
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            name = (f"flash_attention B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} window={window} "
                    f"{str(dt)[6:]}")
            check(err <= tol[dt], f"{name}: max_abs_err {err} > {tol[dt]}")
            lib_sets = [(a.transpose(1, 2).contiguous(),
                         b.transpose(1, 2).repeat_interleave(G, 1).contiguous(),
                         c.transpose(1, 2).repeat_interleave(G, 1).contiguous())
                        for a, b, c in sets]
            mask = None
            if window is not None:
                i = torch.arange(S, device="cuda")
                mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            kern = lambda a, b, c: fa_mod.flash_attention_cuda(a, b, c, causal=True,
                                                               window=window)
            lib = lambda a, b, c: F.scaled_dot_product_attention(a, b, c, attn_mask=mask,
                                                                 is_causal=mask is None)
            line = {"variant": variant, "max_abs_err": err, "tol": tol[dt],
                    "ms": graph_ms(kern, sets),
                    "plain_ms": graph_ms(lambda a, b, c: ops.flash_attention(
                        a, b, c, causal=True, window=window, impl="ref"), sets),
                    "library_ms": graph_ms(lib, lib_sets),
                    "eager_ms": cuda_ms(kern, sets), "eager_library_ms": cuda_ms(lib, lib_sets),
                    **bound(nbytes, 4 * hd * pairs, peak[dt])}
            line.update(ratios(line))
            if variant == "wgmma":
                p = plans.fa_plan(B, S, S, Hq, Hkv, hd, dt, True, window, 256)
                line["levers"] = f"{p.rows}/{p.keys}/{p.pack}"
                line["ms_by_levers"] = flash_sweep(sets, window)
            report(name, line)
            if S == 512 and dt == torch.bfloat16:
                rows["flash_attention"] = dict(
                    line, shape=f"q ({B},{S},{Hq},{hd}) k/v ({B},{S},{Hkv},{hd}) bf16 causal",
                    library="F.scaled_dot_product_attention (kv heads repeated)")
            del sets, lib_sets, q, k, v, out, plain

    # -- block-sparse matmul: the six pruned projections ---------------------
    # (K, N) of llama3-8b's projections at 50% FullBlock(128,128) density,
    # at decode (B = 4 slots) and at prefill (B = 512).
    proj = {"wq": (4096, 4096), "wk": (4096, 1024), "w_gate": (4096, 14336),
            "w_down": (14336, 4096)}
    tol = {torch.bfloat16: 1e-2, torch.float32: 1e-5}   # of max |plain|

    def layout(K, N, dt):
        gk, gn = K // BLOCK, N // BLOCK
        scores = torch.rand(gk * gn, generator=g, device="cuda")
        keep = torch.zeros(gk * gn, dtype=torch.bool, device="cuda")
        keep[scores.argsort()[: gk * gn // 2]] = True
        w = randn(K, N, dtype=torch.float32).mul_(1.0 / math.sqrt(K)).to(dt)
        w_comp, idx = ops.compress_fullblock_torch(w, keep.reshape(gk, gn), BLOCK, BLOCK)
        dense = (w.reshape(gk, BLOCK, gn, BLOCK)
                 * keep.reshape(gk, 1, gn, 1)).reshape(K, N)
        return w_comp, idx, dense

    for key, (K, N) in proj.items():
        for dt in dtypes:
            esize = torch.empty((), dtype=dt).element_size()
            for B in (4, 512):
                live = K * N // (BLOCK * BLOCK) // 2
                nbytes = B * K * esize + live * BLOCK * BLOCK * esize + B * N * esize
                sets = [(randn(B, K, dtype=dt),) + layout(K, N, dt)
                        for _ in range(n_copies(nbytes))]
                x, w_comp, idx, dense = sets[0]
                check(int((idx >= 0).sum()) == live, "layout has the wrong live block count")
                before = ops.variant_counts()["block_sparse_matmul"]
                out = bsm_mod.block_sparse_matmul_cuda(x, w_comp, idx)
                variant = moved_variant("block_sparse_matmul", before)
                plain = ref.block_sparse_matmul_ref(x, w_comp, idx)
                torch.cuda.synchronize()
                err = (out.float() - plain.float()).abs().max().item()
                scale = max(plain.float().abs().max().item(), 1.0)
                name = f"block_sparse_matmul {key} B={B} K={K} N={N} {str(dt)[6:]}"
                check(err / scale <= tol[dt], f"{name}: max_abs_err {err} > {tol[dt]}*{scale}")
                kern = lambda a, wc, ix, d: bsm_mod.block_sparse_matmul_cuda(a, wc, ix)
                lib = lambda a, wc, ix, d: torch.matmul(a, d)
                line = {"variant": variant, "max_abs_err": err,
                        "tol": f"{tol[dt]} x max|plain| = {tol[dt] * scale:.4g}",
                        "ms": graph_ms(kern, sets),
                        "plain_ms": graph_ms(lambda a, wc, ix, d: ref.block_sparse_matmul_ref(
                            a, wc, ix), sets),
                        "library_ms": graph_ms(lib, sets),
                        "eager_ms": cuda_ms(kern, sets), "eager_library_ms": cuda_ms(lib, sets),
                        **bound(nbytes + tensor_bytes(idx), 2 * B * live * BLOCK * BLOCK,
                                peak[dt])}
                line.update(ratios(line))
                if dt == torch.bfloat16:
                    line["cluster"] = plans.bsm_plan(
                        B, K, N // BLOCK, w_comp.shape[1], BLOCK, BLOCK, dt,
                        _build.alignment(x.data_ptr(), w_comp.data_ptr())).cluster
                    line["ms_by_cluster"] = cluster_sweep("block_sparse_matmul", variant, sets)
                report(name, line)
                if key == "w_gate" and B == 4 and dt == torch.bfloat16:
                    rows["block_sparse_matmul"] = dict(
                        line, shape=f"decode x ({B},{K}) @ w_gate ({K},{N}) at 50% "
                                    f"FullBlock(128,128), {live} live blocks, bf16",
                        library="torch.matmul on the decompressed dense weight")
                del sets, x, w_comp, idx, dense

    # -- block importance: Eq. 1 losses of every pruned projection -------------
    # The l1 losses are one library call: the f32 L1 norm over the two
    # in-block axes (|w| is exact in any dtype).  The l2 losses square in
    # the weight's dtype, as the reference does, which no norm call does,
    # so their rows have no library time.
    def l1_norm(a, bm, bn):
        return torch.linalg.vector_norm(a.view(a.shape[0] // bm, bm, a.shape[1] // bn, bn),
                                        ord=1, dim=(1, 3), dtype=torch.float32)

    bi_lib = _build.load("block_importance")

    def bi_general(a, crit):
        """The first kernel (the general variant) at 128 x 128, for comparison."""
        o = torch.empty(a.shape[0] // BLOCK, a.shape[1] // BLOCK, dtype=torch.float32,
                        device=a.device)
        fn = "bi_bf16" if a.dtype == torch.bfloat16 else "bi_f32"
        _build.check(getattr(bi_lib, fn)(a.data_ptr(), o.data_ptr(), a.shape[0], a.shape[1],
                                         BLOCK, BLOCK, bi_mod.CRITERIA[crit],
                                         _build.stream_ptr(a.device)), fn)
        return o

    bi_shapes = {"wq": (4096, 4096), "wk/wv": (4096, 1024), "w_gate/w_up": (4096, 14336),
                 "w_down": (14336, 4096)}
    for key, (M, N) in bi_shapes.items():
        for dt in dtypes:
            esize = torch.empty((), dtype=dt).element_size()
            sets = [(randn(M, N, dtype=dt),) for _ in range(n_copies(M * N * esize))]
            w = sets[0][0]
            for crit in ("l1", "l2"):
                before = ops.variant_counts()["block_importance"]
                out = bi_mod.block_importance_cuda(w, BLOCK, BLOCK, crit)
                variant = moved_variant("block_importance", before)
                again = bi_mod.block_importance_cuda(w, BLOCK, BLOCK, crit)
                plain = ref.block_importance_ref(w, BLOCK, BLOCK, crit)
                torch.cuda.synchronize()
                rel = ((out - plain).abs() / plain.abs()).max().item()
                name = f"block_importance {key} ({M},{N}) {str(dt)[6:]} {crit}"
                check(rel <= 1e-5, f"{name}: max rel err {rel} > 1e-5")
                check(torch.equal(out, again), f"{name}: two calls differ")
                lib_ms = eager_lib = None
                if crit == "l1":
                    lib = l1_norm(w, BLOCK, BLOCK)
                    lib_rel = ((lib - plain).abs() / plain.abs()).max().item()
                    check(lib_rel <= 1e-5, f"{name}: library call differs by {lib_rel}")
                    lib_ms = graph_ms(lambda a: l1_norm(a, BLOCK, BLOCK), sets)
                    eager_lib = cuda_ms(lambda a: l1_norm(a, BLOCK, BLOCK), sets)
                kern = lambda a: bi_mod.block_importance_cuda(a, BLOCK, BLOCK, crit)
                line = {"variant": variant, "max_abs_err": (out - plain).abs().max().item(),
                        "max_rel_err": rel, "tol": "rtol 1e-5", "ms": graph_ms(kern, sets),
                        "plain_ms": graph_ms(lambda a: ref.block_importance_ref(
                            a, BLOCK, BLOCK, crit), sets),
                        "library_ms": lib_ms, "eager_ms": cuda_ms(kern, sets),
                        "eager_library_ms": eager_lib,
                        "general_ms": graph_ms(lambda a: bi_general(a, crit), sets),
                        **bound(tensor_bytes(w, out), 2 * M * N, F32_FLOPS)}
                line.update(ratios(line))
                report(name, line)
                if key == "w_gate/w_up" and dt == torch.bfloat16 and crit == "l1":
                    rows["block_importance"] = dict(
                        line, shape=f"w_gate ({M},{N}) bf16, l1",
                        library="torch.linalg.vector_norm(ord=1) over the in-block axes, f32")
            del sets, w

    # -- IntraBlock gather-matmul: qwen3-4b's pruned projections ------------
    # (K, N) at row-aligned 2:4 (Kc = K/2), decode (B = 4) and prefill (B = 512).
    # The library yardstick is torch.matmul on the decompressed masked-dense
    # weight: one call computing the same function, reading twice the
    # weight bytes.
    from repro_torch.kernels import intrablock_matmul as igm_mod
    iproj = {"wq": (2560, 4096), "wk": (2560, 1024), "w_gate": (2560, 9728),
             "w_down": (9728, 2560)}
    tol = {torch.bfloat16: 1e-2, torch.float32: 1e-5}   # of max |plain|

    def intra_layout(K, N, dt):
        perm = torch.rand(K // INTRA_M, INTRA_M, generator=g, device="cuda").argsort(dim=1)
        kept = torch.zeros(K // INTRA_M, INTRA_M, dtype=torch.bool, device="cuda")
        kept.scatter_(1, perm[:, :INTRA_M // 2], True)
        mask = kept.reshape(K, 1).expand(K, N)
        w = randn(K, N, dtype=torch.float32).mul_(1.0 / math.sqrt(K)).to(dt)
        w_comp, row_idx = ops.compress_intrablock_torch(w, mask, INTRA_M)
        return w_comp, row_idx, w * mask

    for key, (K, N) in iproj.items():
        Kc = K // 2
        for dt in dtypes:
            esize = torch.empty((), dtype=dt).element_size()
            for B in (4, 512):
                nbytes = B * K * esize + Kc * N * esize + Kc * 4 + B * N * esize
                sets = [(randn(B, K, dtype=dt),) + intra_layout(K, N, dt)
                        for _ in range(n_copies(nbytes))]
                x, w_comp, row_idx, dense = sets[0]
                before = ops.variant_counts()["intrablock_gather_matmul"]
                out = igm_mod.intrablock_gather_matmul_cuda(x, w_comp, row_idx)
                variant = moved_variant("intrablock_gather_matmul", before)
                plain = ref.intrablock_gather_matmul_ref(x, w_comp, row_idx)
                torch.cuda.synchronize()
                err = (out.float() - plain.float()).abs().max().item()
                scale = plain.float().abs().max().item()
                name = f"intrablock_gather_matmul {key} B={B} K={K} Kc={Kc} N={N} {str(dt)[6:]}"
                check(err <= tol[dt] * scale, f"{name}: max_abs_err {err} > {tol[dt]}*{scale}")
                kern = lambda a, wc, ix, d: igm_mod.intrablock_gather_matmul_cuda(
                    a, wc, ix, check_range=False)
                lib = lambda a, wc, ix, d: torch.matmul(a, d)
                line = {"variant": variant, "max_abs_err": err,
                        "tol": f"{tol[dt]} x max|plain| = {tol[dt] * scale:.4g}",
                        "ms": graph_ms(kern, sets),
                        "plain_ms": graph_ms(lambda a, wc, ix, d:
                                             ref.intrablock_gather_matmul_ref(a, wc, ix), sets),
                        "library_ms": graph_ms(lib, sets),
                        "eager_ms": cuda_ms(kern, sets), "eager_library_ms": cuda_ms(lib, sets),
                        **bound(nbytes, 2 * B * Kc * N, peak[dt])}
                line.update(ratios(line))
                if dt == torch.bfloat16:
                    line["cluster"] = plans.igm_plan(B, Kc, N, dt,
                                                     _build.alignment(w_comp.data_ptr())).cluster
                    line["ms_by_cluster"] = cluster_sweep("intrablock_gather_matmul", variant,
                                                          sets)
                report(name, line)
                if key == "w_gate" and B == 4 and dt == torch.bfloat16:
                    rows["intrablock_gather_matmul"] = dict(
                        line, shape=f"decode x ({B},{K}) gathered by row_idx ({Kc},) @ w_comp "
                                    f"({Kc},{N}), row-aligned IntraBlock(4,1,0.5), bf16",
                        library="torch.matmul on the decompressed masked-dense weight")
                del sets, x, w_comp, row_idx, dense

    # -- bit-serial zero profile: int8 count, and the fused quantise-and-count --
    # int8 (V, K): the profile's shapes (1916 prefill tokens of the d_model
    # and d_ff inputs), 2048 tokens of the same, a ragged case and
    # n_bits < 8; the plan's variant (strip, or general for ragged K) is
    # timed from CUDA graphs beside the first kernel (general_ms).  Then the
    # fused variant on bf16 and f32 activations of the profile's shapes:
    # the kernel alone (ms, given the tensor's min and max), the whole op
    # with its torch.aminmax pass (op_ms, eager_ms), the min/max pass alone
    # (amax_ms) and quantize_int8 followed by the int8 count (unfused_ms).
    # Exact equality everywhere.  No single PyTorch call computes the
    # count, so these rows have no library time; the plain versions are
    # timed eagerly (they copy the slot total to the card).
    from repro_torch.kernels import bitserial_profile as bsp_mod
    bsp_lib = _build.load("bitserial_profile")

    def bsp_general(a, n_bits):
        """The first kernel (the general variant), for comparison."""
        o = torch.empty(2, dtype=torch.int32, device=a.device)
        counter = torch.empty(1, dtype=torch.int64, device=a.device)
        _build.check(bsp_lib.bsp_count(a.data_ptr(), counter.data_ptr(), o.data_ptr(),
                                       a.shape[0], a.shape[1], GROUP_ROWS, n_bits,
                                       _build.stream_ptr(a.device)), "bsp_count")
        return o

    bsp_variants = {}
    for (V, K, n_bits) in [(1916, 2560, 8), (1916, 9728, 8), (2048, 2560, 8), (2048, 9728, 8),
                           (100, 100, 8), (100, 100, 5)]:
        sets = []
        for _ in range(n_copies(V * K)):
            q = ref.quantize_int8(torch.randn(V, K, generator=g, device="cuda"))
            q[0, :4] = -128
            sets.append((q,))
        q = sets[0][0]
        before = ops.variant_counts()["bitserial_zero_profile"]
        out = bsp_mod.bitserial_zero_profile_cuda(q, GROUP_ROWS, n_bits)
        variant = moved_variant("bitserial_zero_profile", before)
        plain = ref.bitserial_zero_profile_ref(q, GROUP_ROWS, n_bits)
        first = bsp_general(q, n_bits)
        name = f"bitserial_zero_profile V={V} K={K} g={GROUP_ROWS} n_bits={n_bits} int8"
        check(out.tolist() == plain.tolist() == first.tolist(),
              f"{name}: kernel {out.tolist()}, first kernel {first.tolist()} != plain "
              f"{plain.tolist()}")
        kern = lambda a: bsp_mod.bitserial_zero_profile_cuda(a, GROUP_ROWS, n_bits)
        line = {"variant": variant, "max_abs_err": 0.0, "tol": "exact", "counts": out.tolist(),
                "ms": graph_ms(kern, sets), "eager_ms": cuda_ms(kern, sets),
                "general_ms": graph_ms(lambda a: bsp_general(a, n_bits), sets),
                "plain_ms": cuda_ms(lambda a: ref.bitserial_zero_profile_ref(
                    a, GROUP_ROWS, n_bits), sets),
                "library_ms": None,
                **bound(V * K + 8, 2 * V * K, F32_FLOPS)}
        line.update(ratios(line))
        report(name, line)
        if (V, K) == (2048, 9728):
            bsp_variants["strip"] = dict(line, shape=f"q ({V},{K}) int8, groups of "
                                                     f"{GROUP_ROWS}, 8 bits")
        if (V, K, n_bits) == (100, 100, 8):
            bsp_variants["general"] = dict(line, shape=f"q ({V},{K}) int8 (ragged K), groups "
                                                       f"of {GROUP_ROWS}, 8 bits")
        del sets, q

    for (V, K) in [(1916, 2560), (1916, 9728)]:
        for dt in dtypes:
            esize = torch.empty((), dtype=dt).element_size()
            sets = [(randn(V, K, dtype=dt),) for _ in range(n_copies(V * K * esize))]
            x = sets[0][0]
            before = ops.variant_counts()["bitserial_zero_profile"]
            out = bsp_mod.quantized_zero_profile_cuda(x, GROUP_ROWS)
            variant = moved_variant("bitserial_zero_profile", before)
            plain = ref.quantized_zero_profile_ref(x, GROUP_ROWS)
            host = ref.quantized_zero_profile_ref(x.cpu(), GROUP_ROWS)
            name = f"quantized_zero_profile V={V} K={K} g={GROUP_ROWS} {str(dt)[6:]}"
            check(variant == "fused", f"{name}: ran the {variant} variant")
            check(out.tolist() == plain.tolist() == host.tolist(),
                  f"{name}: kernel {out.tolist()} != plain {plain.tolist()} (CPU "
                  f"{host.tolist()})")
            plan = plans.bsp_plan(V, K, GROUP_ROWS, dt, 256)
            fn = "bsp_fused_bf16" if dt == torch.bfloat16 else "bsp_fused_f32"
            acc = bsp_mod._accumulator(x.device)

            def fused_kernel(a, mn, mx, fn=fn, plan=plan, acc=acc):
                o = torch.empty(2, dtype=torch.int32, device=a.device)
                _build.check(getattr(bsp_lib, fn)(
                    a.data_ptr(), mn.data_ptr(), mx.data_ptr(), 0.0, acc.data_ptr(),
                    o.data_ptr(), a.shape[0], a.shape[1], GROUP_ROWS, 8, plan.grid,
                    _build.stream_ptr(a.device)), fn)
                return o

            ksets = [(a,) + tuple(torch.aminmax(a)) for (a,) in sets]
            check(fused_kernel(*ksets[0]).tolist() == plain.tolist(),
                  f"{name}: kernel alone differs")
            op = lambda a: bsp_mod.quantized_zero_profile_cuda(a, GROUP_ROWS)
            line = {"variant": variant, "max_abs_err": 0.0, "tol": "exact",
                    "counts": out.tolist(), "ms": graph_ms(fused_kernel, ksets),
                    "op_ms": graph_ms(op, sets), "eager_ms": cuda_ms(op, sets),
                    "amax_ms": graph_ms(lambda a: torch.aminmax(a), sets),
                    "unfused_ms": graph_ms(lambda a: bsp_mod.bitserial_zero_profile_cuda(
                        ref.quantize_int8(a), GROUP_ROWS), sets),
                    "plain_ms": cuda_ms(lambda a: ref.quantized_zero_profile_ref(
                        a, GROUP_ROWS), sets),
                    "library_ms": None,
                    # per element: divide, clamp, round (one add), OR
                    **bound(V * K * esize + 8, 4 * V * K, F32_FLOPS),
                    "amax_bound_ms": V * K * esize / HBM_BYTES_PER_S * 1e3}
            line.update(ratios(line))
            report(name, line)
            if (K, dt) == (9728, torch.bfloat16):
                rows["bitserial_zero_profile"] = dict(
                    line, shape=f"x ({V},{K}) bf16 quantised to int8 in registers and "
                                f"counted, groups of {GROUP_ROWS}, 8 bits (given its min/max)",
                    library="none: no single PyTorch call computes the zero-plane count",
                    variants=bsp_variants)
            del sets, ksets, x
    return rows


# ---------------------------------------------------------------------------
# Phases 3-5: the main path at full width
# ---------------------------------------------------------------------------

def matrix_shapes(params) -> dict:
    """Each pruned key's per-layer matrix (K, N), as ``prune_params`` masks it."""
    return {k: (params["layers"][k].shape[1], math.prod(params["layers"][k].shape[2:]))
            for k in KEYS}


def main_path(cfg, rows: dict) -> dict:
    """Prune, compress, serve and check llama3-8b; returns what the cost
    phase needs of it (config, spec, the masks' densities, matrix shapes)."""
    from repro_torch.core.flexblock import FlexBlockSpec, FullBlock
    from repro_torch.core.pruning import block_losses, keep_from_losses
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.sparsity.apply import compress_params, prune_params, sparsity_report

    spec = FlexBlockSpec((FullBlock(BLOCK, BLOCK, 0.5),))
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    shapes = matrix_shapes(params)
    print(f"[prune] init {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{sum(t.numel() for t in params['layers'].values()) / 1e9:.3f} G layer params "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)

    # Kernel losses against plain losses, and the masks each would give.
    # A block whose kept/dropped state differs sits at the keep threshold:
    # its gap is |plain loss - threshold| / threshold, the threshold being
    # the n_keep-th largest plain loss of its matrix.
    worst, flipped, n_blocks, gap = 0.0, 0, 0, 0.0
    for key in KEYS:
        w = params["layers"][key]
        for l in range(cfg.n_layers):
            mat = w[l].reshape(w.shape[1], -1)
            lk = block_losses(mat, BLOCK, BLOCK, "l1", impl="cuda")
            lp = block_losses(mat, BLOCK, BLOCK, "l1", impl="ref")
            worst = max(worst, ((lk - lp).abs() / lp.abs()).max().item())
            n_keep = FullBlock(BLOCK, BLOCK, 0.5).nonzero_blocks(tuple(mat.shape))
            differ = keep_from_losses(lk, n_keep) != keep_from_losses(lp, n_keep)
            if differ.any():
                threshold = lp.reshape(-1).topk(n_keep).values[-1]
                gap = max(gap, ((lp[differ] - threshold).abs() / threshold).max().item())
            flipped += int(differ.sum())
            n_blocks += lk.numel()
    print(f"[prune] block losses kernel vs plain: max rel err {worst:.3e} (rtol 1e-5); "
          f"mask blocks that differ: {flipped} of {n_blocks}, each within {gap:.2e} "
          f"(relative) of its matrix's keep threshold: ties at f32 rounding", flush=True)
    check(gap <= 2 * worst, f"a mask block differs {gap} from the threshold, beyond rounding")
    check(worst <= 1e-5, f"block losses differ: {worst} > 1e-5")

    # ---- the main path: counts from here to the end of serving --------------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, masks = prune_params(params, spec, keys=KEYS, impl="auto", device="cuda")
    rep = sparsity_report(params, masks)
    cparams = compress_params(params, masks, BLOCK, BLOCK)
    del params, masks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[prune] pruned + compressed in {time.perf_counter() - t0:.1f}s; density "
          + json.dumps({k.split('/')[-1]: round(v, 6) for k, v in rep.items()}), flush=True)
    for key in KEYS:
        check(abs(rep[f"layers/{key}"] - 0.5) < 1e-9, f"{key}: density {rep[f'layers/{key}']}")
    comp = {k: tuple(cparams["layers"][k].w_comp.shape) for k in KEYS}
    print(f"[prune] compressed w_comp (L, Gn, slots, bm, bn): {json.dumps(comp)}; "
          f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    prompts, reqs, counts = serve_phase(cfg, cparams)
    # ---- end of the main path ------------------------------------------------
    for name in ("flash_attention", "block_sparse_matmul", "block_importance"):
        check(counts[name] > 0, f"{name} was not launched on the llama3-8b path")
        rows[name]["launches"] = counts[name]
    check_main_variants(cfg, "block_sparse_matmul", counts, len(reqs))
    check_single_variant(cfg, "flash_attention", "wgmma", counts, cfg.n_layers * len(reqs))
    check_single_variant(cfg, "block_importance", "strip", counts, len(KEYS) * cfg.n_layers)

    parity_phase(cfg, cparams, prompts, [r.output for r in reqs], tol=0.15,
                 faults=fullblock_faults(cfg, cparams))
    return {"cfg": cfg, "spec": spec, "density": rep, "shapes": shapes}


def check_main_variants(cfg, op: str, counts: dict, prefills: int) -> None:
    """The path's compressed projections ran only through the main
    variants: one decode launch per projection, layer and decode step (4
    slots), one prefill launch per projection, layer and prompt, and no
    general or f32 launch."""
    v = counts["variants"][op]
    per = len(KEYS) * cfg.n_layers
    want = {"decode": per * counts["steps"], "prefill": per * prefills, "general": 0, "f32": 0}
    print(f"[serve] {cfg.name}: {op} launches by variant {json.dumps(v)}; want "
          f"{json.dumps(want)} ({counts[op]} in all)", flush=True)
    check(v == want and counts[op] == want["decode"] + want["prefill"],
          f"{op}: launches by variant {v}, want {want}")


def check_single_variant(cfg, op: str, variant: str, counts: dict, want: int) -> None:
    """Every launch of ``op`` on the path ran ``variant``: ``want`` of
    them, none through ``general`` or ``f32``."""
    v = counts["variants"][op]
    print(f"[serve] {cfg.name}: {op} launches by variant {json.dumps(v)}; want {want} "
          f"{variant}", flush=True)
    check(v[variant] == want == counts[op] and sum(v.values()) == want,
          f"{op}: launches by variant {v}, want {want} {variant} and no other")


def serve_phase(cfg, cparams):
    """Serve 8 requests (prompts of 100..512 tokens from numpy seed 0, 32
    new tokens each) through ``ServeEngine(slots=4, max_len=1024)``; read
    the launch counts at the end of serving.  Returns (prompts, requests,
    counts)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(SEED)
    lens = rng.integers(100, 513, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]
    engine = ServeEngine(cfg, cparams, slots=4, max_len=1024, dtype=torch.bfloat16,
                         impl="auto", device="cuda")
    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
    for r in reqs:
        check(engine.submit(r), "submit refused")
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    counts["variants"] = ops.variant_counts()
    snap = engine.stats_snapshot()
    for i, r in enumerate(reqs):
        check(r.done and len(r.output) == 32 and r.reject_reason is None,
              f"request {i}: done={r.done} tokens={len(r.output or [])}")
    decode_tokens = snap["tokens_generated"] - len(reqs)
    print(f"[serve] {cfg.name}: 8 requests, prompt lengths {lens.tolist()}, 32 new tokens "
          f"each: all done in {wall:.2f}s wall; TTFT p50 {snap['ttft_s']['p50'] * 1e3:.1f} ms; "
          f"step p50 {snap['token_latency_s']['p50'] * 1e3:.2f} ms over {snap['steps']} steps; "
          f"{snap['tokens_per_s']:.1f} tokens/s (engine busy time, prefill included); "
          f"{decode_tokens} decode tokens", flush=True)
    print(f"[serve] {cfg.name}: launches on the path: {json.dumps(counts)}", flush=True)
    counts["steps"] = snap["steps"]

    # Host or device: time the host's issue of one 4-slot decode step (the
    # path has no synchronisation inside decode_step) against the time to
    # its end on the card.  Issue close to the whole step means the card
    # waits on the host.
    from repro_torch.models.transformer import decode_step
    cache = dict(engine.cache, pos=torch.full((4,), 600, dtype=torch.int64, device="cuda"))
    tokens = torch.zeros(4, dtype=torch.int64, device="cuda")
    issue, step = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_step(cparams, tokens, cfg, cache, impl="auto")
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        issue.append(t1 - t0)
        step.append(time.perf_counter() - t0)
    issue, step = sorted(issue[1:])[2], sorted(step[1:])[2]
    print(f"[serve] {cfg.name}: one decode step, median of 5: host issue {issue * 1e3:.2f} ms, "
          f"to its end on the card {step * 1e3:.2f} ms (issue {issue / step:.0%} of the step)",
          flush=True)
    return prompts, reqs, counts


def step_logits(cparams, cfg, prompt: np.ndarray, impl: str, feed=()) -> torch.Tensor:
    """f32 logits of the prompt's last token, then of one decode step per
    token of ``feed`` (teacher-forced), stacked (1 + len(feed), V)."""
    from repro_torch.models.transformer import decode_step, prefill
    lg, cache = prefill(cparams, torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None],
                        cfg, impl=impl)
    for key in ("k", "v"):
        cache[key] = F.pad(cache[key], (0, 0, 0, 0, 0, len(feed)))
    out = [lg[0, -1]]
    for t in feed:
        lg, cache = decode_step(cparams, torch.tensor([t], device="cuda"), cfg, cache, impl=impl)
        out.append(lg[0])
    return torch.stack(out)


def fullblock_faults(cfg, cparams) -> dict:
    """Planted faults in layer 16's w_down (shared w_comp, copied idx):
    the whole projection left out, and one live 128x128 block dropped."""
    from repro_torch.models.layers import BlockSparseLinear

    wd, l = cparams["layers"]["w_down"], cfg.n_layers // 2
    faults = {}
    for what in ("w_down of one layer left out", "one block of one layer dropped"):
        idx = wd.idx.clone()
        if what.startswith("w_down"):
            idx[l] = -1
        else:
            idx[l, 0, int((idx[l, 0] >= 0).nonzero()[0])] = -1
        faults[what] = dict(cparams, layers=dict(cparams["layers"], w_down=BlockSparseLinear(
            wd.w_comp, idx, wd.in_features, wd.out_shape)))
    return faults


def intrablock_faults(cfg, cparams) -> dict:
    """Planted faults in layer 18's w_down: its w_comp zeroed (the whole
    projection left out), and its row_idx moved to the neighbouring row
    of each pair (r xor 1: every gathered input is the wrong one, each
    still inside its 4-row block)."""
    from repro_torch.models.layers import IntraBlockLinear

    wd, l = cparams["layers"]["w_down"], cfg.n_layers // 2
    zeroed = wd.w_comp.clone()
    zeroed[l] = 0
    shifted = wd.row_idx.clone()
    shifted[l] ^= 1
    bad = {"w_down of one layer left out": IntraBlockLinear(
               zeroed, wd.row_idx, wd.in_features, wd.out_shape),
           "w_down row_idx of one layer shifted to the neighbouring row": IntraBlockLinear(
               wd.w_comp, shifted, wd.in_features, wd.out_shape)}
    return {what: dict(cparams, layers=dict(cparams["layers"], w_down=w))
            for what, w in bad.items()}


def parity_phase(cfg, cparams, prompts, served, *, tol: float, faults: dict) -> None:
    """The served path against ``impl="ref"`` on the same compressed weights.

    Logits: the last prompt token of all 8 prompts, plus 4 decode steps of
    the first request fed its served tokens, kernels vs plain.  Greedy
    tokens: each served token against the plain path's argmax, required
    to agree where the plain top-2 margin exceeds 2*tol (a smaller margin
    can flip within the tolerance).  ``faults`` maps a name to a copy of
    the params with a fault planted in it; the logit error each gives is
    reported, and the first must exceed the tolerance.  Last, the served logits must be f32 products,
    as the reference's ``preferred_element_type=f32`` unembedding gives.
    """
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import _run

    feed = served[0][:4]
    auto = [step_logits(cparams, cfg, prompts[0], "auto", feed)]
    plain = [step_logits(cparams, cfg, prompts[0], "ref", feed)]
    want = [served[0][:5]]
    for p, out in zip(prompts[1:], served[1:]):
        auto.append(step_logits(cparams, cfg, p, "auto"))
        plain.append(step_logits(cparams, cfg, p, "ref"))
        want.append(out[:1])
    auto, plain = torch.cat(auto), torch.cat(plain)
    want = [t for w in want for t in w]
    err = (auto - plain).abs().amax(dim=1)
    top2 = plain.topk(2, dim=1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    picked = plain.argmax(dim=1).tolist()
    decided = [i for i, m in enumerate(margins) if m > 2 * tol]
    wrong = [i for i in decided if picked[i] != want[i]]
    print(f"[parity] {cfg.name}: kernels vs impl=ref over {len(margins)} steps (8 prompts' last "
          f"token, 4 decode steps of request 0): max |dlogit| {err.max().item():.4f} "
          f"(tol {tol}), per step {[round(e, 4) for e in err.tolist()]}", flush=True)
    print(f"[parity] {cfg.name}: served tokens vs impl=ref argmax: agree on "
          f"{sum(p == w for p, w in zip(picked, want))} of {len(want)} steps; "
          f"{len(decided)} steps have a ref top-2 margin above 2*tol and must agree, "
          f"{len(wrong)} do not; margins {[round(m, 4) for m in margins]}", flush=True)

    fault_err = {what: (step_logits(bad, cfg, prompts[0], "auto", feed) - plain[:5])
                 .abs().max().item() for what, bad in faults.items()}
    print(f"[parity] {cfg.name}: planted faults, max |dlogit| vs impl=ref on request 0: "
          + json.dumps({k: round(v, 4) for k, v in fault_err.items()}), flush=True)

    # f32 unembedding: the served prefill logits against an f32 product
    # of the final hidden state and the whole unembedding widened to f32.
    x, _, _ = _run(cparams, torch.as_tensor(prompts[0], dtype=torch.long,
                                             device="cuda")[None], cfg, "auto", False)
    h = rms_norm(x[0, -1:], cparams["final_norm"], cfg.norm_eps)
    w = cparams["embed"].T if cfg.tie_embeddings else cparams["lm_head"]
    f32 = (h.float() @ w.float())[0]
    rounded = (h @ w).float()[0]
    e32 = (auto[0] - f32).abs().max().item()
    e16 = (rounded - f32).abs().max().item()
    del f32, rounded
    print(f"[parity] {cfg.name}: served prefill logits vs an f32 unembedding: max |d| "
          f"{e32:.3e} (tol 1e-4); bf16-rounded logits would differ by {e16:.3e}", flush=True)
    check(err.max().item() <= tol, f"logits differ by {err.max().item()} > {tol}")
    check(not wrong, f"served tokens differ from impl=ref at decided steps {wrong}")
    first = next(iter(fault_err))
    check(fault_err[first] > tol, f"{first}: stays within the logit tolerance {tol}")
    check(e32 <= 1e-4, f"served logits are not f32 products: {e32} > 1e-4")


# ---------------------------------------------------------------------------
# Phases 4-5: the qwen3-4b IntraBlock path and its §IV-B profile
# ---------------------------------------------------------------------------

def intrablock_path(cfg, rows: dict) -> dict:
    """Prune, compress, serve, check and profile qwen3-4b; returns what the
    cost phase needs of it, the profile's ratios included."""
    from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.sparsity.apply import compress_params, prune_params, sparsity_report

    spec = FlexBlockSpec((IntraBlock(INTRA_M, 1, 0.5),))
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    shapes = matrix_shapes(params)
    n_all = sum(t.numel() for t in params["layers"].values()) + params["embed"].numel()
    print(f"[prune] init {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_all / 1e9:.3f} G params (tied embedding included) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # ---- the IntraBlock path: counts from here to the end of serving -------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, masks = prune_params(params, spec, keys=KEYS, align_cols=True, impl="auto",
                                 device="cuda")
    rep = sparsity_report(params, masks)
    aligned = {}
    for key in KEYS:
        m = masks["layers"][key]
        m = m.reshape(m.shape[0], m.shape[1], -1)
        aligned[key] = bool(torch.equal(m, m[:, :, :1].expand_as(m)))
    cparams = compress_params(params, masks, m=INTRA_M)
    del params, masks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[prune] {cfg.name}: IntraBlock({INTRA_M},1,0.5) row-aligned, pruned + compressed "
          f"in {time.perf_counter() - t0:.1f}s; density "
          + json.dumps({k.split('/')[-1]: round(v, 6) for k, v in rep.items()})
          + f"; row-aligned {json.dumps(aligned)}", flush=True)
    for key in KEYS:
        check(abs(rep[f"layers/{key}"] - 0.5) < 1e-9, f"{key}: density {rep[f'layers/{key}']}")
        check(aligned[key], f"{key}: a mask is not row-aligned")
    comp = {k: [tuple(cparams["layers"][k].w_comp.shape),
                tuple(cparams["layers"][k].row_idx.shape)] for k in KEYS}
    print(f"[prune] {cfg.name}: compressed w_comp (L, Kc, N), row_idx (L, Kc): "
          f"{json.dumps(comp)}; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
          flush=True)

    prompts, reqs, counts = serve_phase(cfg, cparams)
    # ---- end of the IntraBlock path ------------------------------------------
    for name in ("intrablock_gather_matmul", "flash_attention"):
        check(counts[name] > 0, f"{name} was not launched on the {cfg.name} path")
    check(counts["block_sparse_matmul"] == 0, "a FullBlock matmul ran on the IntraBlock path")
    rows["intrablock_gather_matmul"]["launches"] = counts["intrablock_gather_matmul"]
    check_main_variants(cfg, "intrablock_gather_matmul", counts, len(reqs))
    check_single_variant(cfg, "flash_attention", "wgmma", counts, cfg.n_layers * len(reqs))

    # Logits have std ~1 at this init.  On an H100 the kernel path stays
    # within 0.068 of the plain one (bf16 over 36 layers), while leaving out
    # layer 18's w_down moves them by 0.40: 0.15 sits between the two.
    parity_phase(cfg, cparams, prompts, [r.output for r in reqs], tol=0.15,
                 faults=intrablock_faults(cfg, cparams))
    ratios = profile_phase(cfg, cparams, prompts, rows)
    return {"cfg": cfg, "spec": spec, "density": rep, "shapes": shapes, "ratios": ratios}


def profile_phase(cfg, cparams, prompts, rows: dict) -> dict:
    """§IV-B: the skippable bit-serial ratio of every pruned projection's
    input, from the 8 prompts' prefill concatenated over tokens, int8, in
    groups of GROUP_ROWS; each (layer, kind) held to the plain count.
    Returns the ratios by ``l{LL}/{kind}``."""
    from repro_torch.core.input_sparsity import (capture_mlp_activations,
                                                 profile_activations, quantize_int8,
                                                 skippable_bit_ratio)
    from repro_torch.kernels import ops, ref
    from repro_torch.models.transformer import _run

    kinds = ("attn_in", "mlp_in", "down_in")
    names = [f"l{l:02d}/{k}" for l in range(cfg.n_layers) for k in kinds]

    def apply_fn(params, prompt_list):
        parts = {}
        for p in prompt_list:
            tokens = torch.as_tensor(p, dtype=torch.long, device="cuda")[None]
            _run(params, tokens, cfg, "auto", False,
                 tap=lambda l, k, a: parts.setdefault(f"l{l:02d}/{k}", []).append(a[0]))
        return None, {k: torch.cat(v) for k, v in parts.items()}

    t0 = time.perf_counter()
    acts = capture_mlp_activations(apply_fn, cparams, prompts, names)
    torch.cuda.synchronize()
    n_tok = acts[names[0]].shape[0]
    held = sum(a.numel() * a.element_size() for a in acts.values())
    t_cap = time.perf_counter() - t0

    # ---- the profile: counts over this call only -------------------------------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ratios = profile_activations(acts, GROUP_ROWS)
    t_prof = time.perf_counter() - t0
    counts = ops.launch_counts()
    variants = ops.variant_counts()["bitserial_zero_profile"]
    # ---- end of the profile ------------------------------------------------------
    check(counts["bitserial_zero_profile"] == len(names),
          f"bitserial_zero_profile launched {counts['bitserial_zero_profile']} times, "
          f"want {len(names)}")
    check(variants == {"strip": 0, "fused": len(names), "general": 0},
          f"the profile's variants {variants}, want {len(names)} fused")
    rows["bitserial_zero_profile"]["launches"] = counts["bitserial_zero_profile"]

    # host syncs of one more profile call, against those of one host copy:
    # torch's sync debug mode warns on each synchronising call
    def sync_warnings(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                result = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return result, sum("synchroniz" in str(w.message) for w in caught)

    sync_warnings(lambda: torch.zeros(2, device="cuda").tolist())   # the mode's first use
    _, one_copy = sync_warnings(lambda: torch.zeros(2, device="cuda").tolist())
    again, syncs = sync_warnings(lambda: profile_activations(acts, GROUP_ROWS))
    check(again == ratios, "a second profile call gave other ratios")
    check(one_copy >= 1 and syncs == one_copy,
          f"the profile raised {syncs} sync warnings, one host copy {one_copy}")

    # the profile as it ran before the fused kernel: quantize_int8, then the
    # int8 count and a host copy, per activation
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unfused = {name: skippable_bit_ratio(quantize_int8(a.reshape(-1, a.shape[-1])), GROUP_ROWS)
               for name, a in acts.items()}
    t_unfused = time.perf_counter() - t0
    check(unfused == ratios, "quantize_int8 + the int8 count gave other ratios")

    differ, differ_int8 = [], []
    for name, a in acts.items():
        x = a.reshape(-1, a.shape[-1])
        k = ops.quantized_zero_profile(x, GROUP_ROWS, impl="cuda").tolist()
        p = ref.quantized_zero_profile_ref(x, GROUP_ROWS).tolist()
        if k != p or ratios[name] != p[0] / max(p[1], 1):
            differ.append((name, k, p, ratios[name]))
        q = quantize_int8(x)
        k = ops.bitserial_zero_profile(q, GROUP_ROWS, impl="cuda").tolist()
        if k != p:
            differ_int8.append((name, k, p))
    summary = {}
    for kind in kinds:
        vals = [ratios[f"l{l:02d}/{kind}"] for l in range(cfg.n_layers)]
        summary[kind] = {"min": min(vals), "mean": sum(vals) / len(vals), "max": max(vals),
                         "features": acts[f"l00/{kind}"].shape[-1]}
    print(f"[profile] {cfg.name}: {n_tok} prefill tokens of 8 prompts, {len(names)} "
          f"(layer, kind) activations ({held / 2**30:.2f} GiB bf16 held) captured in "
          f"{t_cap:.2f}s, profiled in {t_prof:.4f}s with one host copy ({syncs} sync warnings, "
          f"as one copy alone; quantize_int8 + the int8 count per activation: "
          f"{t_unfused:.4f}s); "
          f"int8, groups of {GROUP_ROWS} rows, 8 bits; "
          f"skippable ratio per kind over {cfg.n_layers} layers: {json.dumps(summary)}",
          flush=True)
    print(f"[profile] fused kernel vs quantize_int8 + plain count [skippable, total]: "
          f"{len(names) - len(differ)} of {len(names)} (layer, kind) pairs equal; int8 kernel "
          f"vs plain on quantize_int8's output: {len(names) - len(differ_int8)} equal; "
          f"launches {json.dumps(counts)}, variants {json.dumps(variants)}", flush=True)
    check(not differ, f"fused bit-serial counts differ from plain: {differ[:4]}")
    check(not differ_int8, f"bit-serial counts differ kernel vs plain: {differ_int8[:4]}")
    check(all(0.0 <= r <= 1.0 for r in ratios.values()), "a skippable ratio outside [0, 1]")
    return ratios


def microbench_phase() -> list:
    """``microbench_kernels`` on the card; its samples go to JSONL under
    build/ and must read back unchanged.  Returns the samples."""
    from repro_torch.calibrate.harvest import microbench_kernels, read_samples, write_samples

    rep = microbench_kernels(sizes=(256, 512), repeats=3)
    path = write_samples(rep.samples, HERE / "build" / "microbench_samples.jsonl", append=False)
    back = read_samples(path)
    for s in rep.samples:
        meta = dict(s.meta)
        print(f"[microbench] {s.op_class} {meta['shape']}: {s.time_s * 1e3:.4f} ms, "
              f"{s.flops / s.time_s / 1e12:.3f} TFLOP/s, {s.bytes / s.time_s / 1e9:.1f} GB/s "
              f"({meta['impl']}, {meta['device']})", flush=True)
    check(len(rep.samples) == 8, f"{len(rep.samples)} microbench samples, want 8")
    check(all(dict(s.meta)["impl"] == "cuda" and s.time_s > 0 for s in rep.samples),
          "a microbench sample is not a timed CUDA sample")
    check(back == rep.samples, "microbench samples do not read back unchanged")
    print(f"[microbench] {len(back)} samples written to {path.relative_to(HERE)} and read back "
          f"unchanged", flush=True)
    return back


# ---------------------------------------------------------------------------
# Phase 7: the CIMinus cost model, fed by this run's measurements
# ---------------------------------------------------------------------------

# the profile's three input kinds → the ops of lm_workload that read them
RATIO_OPS = {"attn_in": ("attn_q", "attn_k", "attn_v"), "mlp_in": ("mlp_up",),
             "down_in": ("mlp_down",)}
COST_SEQ = 512


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def measured_sparsity(cfg, ratios: dict) -> dict:
    """Each lm_workload op that reads a profiled input → the mean of its
    kind's ratio over the layers."""
    out = {}
    for kind, names in RATIO_OPS.items():
        vals = [ratios[f"l{l:02d}/{kind}"] for l in range(cfg.n_layers)]
        out.update(dict.fromkeys(names, sum(vals) / len(vals)))
    return out


def report_line(label: str, rep, cmp: dict, card: str) -> None:
    print(f"[cost] {label}: latency {rep.latency_cycles!r} cycles ({rep.latency_ms!r} ms at the "
          f"arch's clock), energy {rep.total_energy_uj!r} uJ, speedup {cmp['speedup']!r}, energy "
          f"saving {cmp['energy_saving']!r}, utilization {cmp['utilization']!r}; energy by "
          f"component (pJ) {json.dumps(rep.energy_pj)} [{card}]", flush=True)


def check_report(label: str, rep) -> None:
    """Finite, positive latency, and a JSON round trip."""
    from repro_torch.core.report import CostReport
    nums = [rep.latency_cycles, rep.latency_ms, rep.total_energy_uj, rep.utilization,
            *rep.energy_pj.values(), *(o.latency_cycles for o in rep.op_costs)]
    check(all(math.isfinite(x) for x in nums), f"{label}: a non-finite number")
    check(rep.latency_cycles > 0, f"{label}: latency {rep.latency_cycles}")
    back = CostReport.from_dict(json.loads(rep.to_json()))
    check(back.to_dict() == rep.to_dict(), f"{label}: does not round-trip through to_json")


def check_scaled(label: str, scaled, base, wl, prof) -> None:
    """Each op of ``scaled`` is ``base``'s divided by the profile's
    efficiency for its op class, to 1e-12 relative."""
    from repro_torch.core.costmodel import op_class
    check([o.name for o in scaled.op_costs] == [o.name for o in base.op_costs],
          f"{label}: other ops")
    for a, b in zip(scaled.op_costs, base.op_costs):
        want = b.latency_cycles / prof.efficiency_for(op_class(wl.nodes[a.name]))
        check(abs(a.latency_cycles - want) <= 1e-12 * abs(want),
              f"{label}: {a.name} latency {a.latency_cycles} != {want}")


def cost_phase(samples: list, served: list) -> None:
    """Fit the card's profile, then cost each served model (see the
    module docstring, phase 7).  Runs on the host."""
    from repro_torch.calibrate.fit import fit_profile
    from repro_torch.core.costmodel import compare, dense_baseline, simulate
    from repro_torch.core.mapping import default_mapping
    from repro_torch.core.presets import usecase_arch
    from repro_torch.core.workload import lm_workload
    from repro_torch.sparsity.apply import cim_cost_of_model

    t0 = time.perf_counter()
    card = card_line()
    name = "".join(c if c.isalnum() else "-" for c in torch.cuda.get_device_name(0).lower())
    prof = fit_profile(samples, name=f"{name}-microbench",
                       provenance={"source": "chip_smoke.py microbench_kernels", "card": card})
    path = prof.save_addressed(HERE / "build" / "profiles")
    res = prof.residuals
    check("ici_bw" not in prof.provenance["identified"], "ici_bw identified from one card")
    print(f"[cost] profile fitted from {int(res['n_samples'])} microbench samples "
          f"({prof.provenance['solver']} solver), saved as {path.relative_to(HERE)}: "
          f"peak_flops {prof.peak_flops!r} FLOP/s, hbm_bw {prof.hbm_bw!r} B/s, efficiency "
          f"{json.dumps(prof.efficiency)}, rel_rmse {res['rel_rmse']!r}, rel_max_abs "
          f"{res['rel_max_abs']!r} [{card}]", flush=True)
    print(f"[cost] profile: ici_bw not identified (prior kept); the samples are the f32, hd-64 "
          f"variants microbench_kernels draws, not the bf16 variants the served paths run; "
          f"op classes the cost model prices: matmul and attention (intrablock has no op of "
          f"its own there, post_proc rides at 1.0)", flush=True)

    arch = usecase_arch(4, input_sparsity=True)
    check(arch.macro.sub_rows == GROUP_ROWS,
          f"the arch broadcasts to {arch.macro.sub_rows} rows, the profile grouped {GROUP_ROWS}")
    mapping = default_mapping(arch, "duplicate")
    for model in served:
        cfg, spec = model["cfg"], model["spec"]
        for key in KEYS:
            got, want = model["density"][f"layers/{key}"], spec.overall_density(model["shapes"][key])
            check(math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0),
                  f"{cfg.name} {key}: mask density {got}, spec {want}")
        print(f"[cost] {cfg.name}: the card's mask density of each pruned key equals "
              f"{spec.describe()}'s overall_density of its per-layer matrix: "
              + json.dumps({k: [model["density"][f"layers/{k}"], list(model["shapes"][k])]
                            for k in KEYS}), flush=True)
        wl = lm_workload(cfg, seq_len=COST_SEQ, batch=1).set_sparsity(spec)
        label = f"{cfg.name} {spec.describe()} on {arch.name}, seq_len {COST_SEQ}"
        rep_a, cmp_a = cim_cost_of_model(cfg, arch, spec, seq_len=COST_SEQ)
        check_report(f"{label} (a)", rep_a)
        report_line(f"{label} (a) no input sparsity", rep_a, cmp_a, card)
        base, ratios = rep_a, None
        if "ratios" in model:
            ratios = measured_sparsity(cfg, model["ratios"])
            print(f"[cost] {cfg.name}: measured skippable-bit ratios by op (mean over "
                  f"{cfg.n_layers} layers): {json.dumps(ratios)}; no measured ratio: "
                  f"{[n for n in wl.nodes if n not in ratios]}", flush=True)
            rep_b, cmp_b = cim_cost_of_model(cfg, arch, spec, seq_len=COST_SEQ,
                                             input_sparsity=ratios)
            check_report(f"{label} (b)", rep_b)
            report_line(f"{label} (b) measured ratios", rep_b, cmp_b, card)
            check(rep_b.latency_cycles <= rep_a.latency_cycles,
                  f"{label}: measured skips added cycles")
            unit = dataclasses.replace(prof, efficiency=dict.fromkeys(prof.efficiency, 1.0))
            check(simulate(arch, wl, mapping, input_sparsity=ratios, profile=unit).to_dict()
                  == rep_b.to_dict(), f"{label}: a unit-efficiency profile changed (b)")
            base = rep_b
        rep_c = simulate(arch, wl, mapping, input_sparsity=ratios, profile=prof)
        dense_c = dense_baseline(arch, wl, mapping, profile=prof)
        check_report(f"{label} (c)", rep_c)
        check_report(f"{label} (c) dense baseline", dense_c)
        check_scaled(f"{label} (c)", rep_c, base, wl, prof)
        report_line(f"{label} (c) {'measured ratios + ' if ratios else ''}fitted profile",
                    rep_c, compare(rep_c, dense_c), card)
    print(f"[time] cost phase {time.perf_counter() - t0:.2f}s", flush=True)


# what the kernels line gives of each further variant of a kernel
VARIANT_KEYS = ("shape", "ms", "eager_ms", "general_ms", "plain_ms", "bound_ms", "bound_by",
                "share_of_bound")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = HERE / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[build] {len(libs)} kernels built from src/repro_torch/kernels/csrc in "
          f"{time.perf_counter() - t0:.1f}s: {sorted(libs)}", flush=True)

    csrc, kdir = "src/repro_torch/kernels/csrc", "src/repro/kernels"
    sources = {"flash_attention": ("cuda", f"{csrc}/flash_attention.cu",
                                   f"{kdir}/flash_attention.py:94"),
               "block_sparse_matmul": ("cuda", f"{csrc}/block_sparse_matmul.cu",
                                       f"{kdir}/block_sparse_matmul.py:49"),
               "block_importance": ("cuda", f"{csrc}/block_importance.cu",
                                    f"{kdir}/block_importance.py:34"),
               "intrablock_gather_matmul": ("cuda", f"{csrc}/intrablock_matmul.cu",
                                            f"{kdir}/intrablock_matmul.py:41"),
               "bitserial_zero_profile": ("cuda", f"{csrc}/bitserial_profile.cu",
                                          f"{kdir}/bitserial_profile.py:41")}
    try:
        t0 = time.perf_counter()
        rows = kernel_phase()
        print(f"[time] kernels phase {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        llama = main_path(get_config("llama3-8b"), rows)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[time] llama3-8b path {time.perf_counter() - t0:.1f}s; device memory after "
              f"freeing it {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
        t0 = time.perf_counter()
        qwen = intrablock_path(get_config("qwen3-4b"), rows)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[time] qwen3-4b path {time.perf_counter() - t0:.1f}s", flush=True)
        samples = microbench_phase()
        cost_phase(samples, [qwen, llama])
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name, (route, source, replaces) in sources.items():
        r = rows[name]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"], "library": r["library"],
                        **({"variant": r["variant"]} if "variant" in r else {}),
                        **{k: r[k] for k in ("op_ms", "eager_ms", "amax_ms", "amax_bound_ms",
                                             "unfused_ms") if k in r},
                        **({"variants": {v: {k: l[k] for k in VARIANT_KEYS}
                                         for v, l in r["variants"].items()}}
                           if "variants" in r else {}),
                        **ratios(r)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
