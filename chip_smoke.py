#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each reported on its own line(s):

1. build    — compile the port's five CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
2. kernels  — hold each kernel against its plain PyTorch version at the
   shapes of the main paths, in bf16 and f32 (int8 for the bit-serial
   profile), and time kernel, plain version and the nearest single
   PyTorch call;
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
   input (36 layers x 3 kinds, the 8 prompts' prefill), kernel against
   plain version in every (layer, kind);
6. microbench — ``microbench_kernels`` on the card, its samples written
   as JSONL under ``build/`` and read back;
7. the ``{"kernels": [...]}`` line; 8. the card's name and power limit.

The launch counts are set to 0 just before each path and read just
after it: the three FullBlock-path kernels from prune to the end of
llama3-8b serving, ``intrablock_gather_matmul`` from prune to the end of
qwen3-4b serving, ``bitserial_zero_profile`` over the profile call.  Any
failed check exits nonzero.  Without a CUDA device, or without the
repository beside it, the script exits nonzero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
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


def kernel_phase() -> dict:
    """Hold each kernel to its plain version at main-path shapes and time
    kernel, plain version and library call on every row.  Returns the
    main-path row of each kernel for the ``{"kernels": ...}`` line."""
    from repro_torch.kernels import block_importance as bi_mod
    from repro_torch.kernels import block_sparse_matmul as bsm_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops, ref
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
    # (512 tokens), plus head dims 64/256 and a window for coverage.
    fa_cases = [(1, 512, 32, 8, 128, None), (1, 256, 8, 2, 64, 64), (1, 256, 8, 2, 256, None)]
    tol = {torch.bfloat16: 3e-2, torch.float32: 3e-5}
    for (B, S, Hq, Hkv, hd, window) in fa_cases:
        G = Hq // Hkv
        pairs = B * Hq * sum(min(i + 1, window or S) for i in range(S))   # live (q, k) pairs
        for dt in dtypes:
            esize = torch.empty((), dtype=dt).element_size()
            nbytes = 2 * B * S * (Hq + Hkv) * hd * esize           # q, k, v read; o written
            sets = [(randn(B, S, Hq, hd, dtype=dt), randn(B, S, Hkv, hd, dtype=dt),
                     randn(B, S, Hkv, hd, dtype=dt)) for _ in range(n_copies(nbytes))]
            q, k, v = sets[0]
            out = fa_mod.flash_attention_cuda(q, k, v, causal=True, window=window)
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
            line = {"max_abs_err": err, "tol": tol[dt],
                    "ms": cuda_ms(lambda a, b, c: fa_mod.flash_attention_cuda(
                        a, b, c, causal=True, window=window), sets),
                    "plain_ms": cuda_ms(lambda a, b, c: ops.flash_attention(
                        a, b, c, causal=True, window=window, impl="ref"), sets),
                    "library_ms": cuda_ms(lambda a, b, c: F.scaled_dot_product_attention(
                        a, b, c, attn_mask=mask, is_causal=mask is None), lib_sets),
                    **bound(nbytes, 4 * hd * pairs, peak[dt])}
            report(name, line)
            if S == 512 and dt == torch.bfloat16:
                rows["flash_attention"] = dict(
                    line, shape=f"q ({B},{S},{Hq},{hd}) k/v ({B},{S},{Hkv},{hd}) bf16 causal",
                    library="F.scaled_dot_product_attention (kv heads repeated)")

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
                out = bsm_mod.block_sparse_matmul_cuda(x, w_comp, idx)
                plain = ref.block_sparse_matmul_ref(x, w_comp, idx)
                torch.cuda.synchronize()
                err = (out.float() - plain.float()).abs().max().item()
                scale = max(plain.float().abs().max().item(), 1.0)
                name = f"block_sparse_matmul {key} B={B} K={K} N={N} {str(dt)[6:]}"
                check(err / scale <= tol[dt], f"{name}: max_abs_err {err} > {tol[dt]}*{scale}")
                line = {"max_abs_err": err,
                        "tol": f"{tol[dt]} x max|plain| = {tol[dt] * scale:.4g}",
                        "ms": cuda_ms(lambda a, wc, ix, d: bsm_mod.block_sparse_matmul_cuda(
                            a, wc, ix), sets),
                        "plain_ms": cuda_ms(lambda a, wc, ix, d: ref.block_sparse_matmul_ref(
                            a, wc, ix), sets),
                        "library_ms": cuda_ms(lambda a, wc, ix, d: torch.matmul(a, d), sets),
                        **bound(nbytes + tensor_bytes(idx), 2 * B * live * BLOCK * BLOCK,
                                peak[dt])}
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

    bi_shapes = {"wq": (4096, 4096), "wk/wv": (4096, 1024), "w_gate/w_up": (4096, 14336),
                 "w_down": (14336, 4096)}
    for key, (M, N) in bi_shapes.items():
        for dt in dtypes:
            esize = torch.empty((), dtype=dt).element_size()
            sets = [(randn(M, N, dtype=dt),) for _ in range(n_copies(M * N * esize))]
            w = sets[0][0]
            for crit in ("l1", "l2"):
                out = bi_mod.block_importance_cuda(w, BLOCK, BLOCK, crit)
                plain = ref.block_importance_ref(w, BLOCK, BLOCK, crit)
                torch.cuda.synchronize()
                rel = ((out - plain).abs() / plain.abs()).max().item()
                name = f"block_importance {key} ({M},{N}) {str(dt)[6:]} {crit}"
                check(rel <= 1e-5, f"{name}: max rel err {rel} > 1e-5")
                lib_ms = None
                if crit == "l1":
                    lib = l1_norm(w, BLOCK, BLOCK)
                    lib_rel = ((lib - plain).abs() / plain.abs()).max().item()
                    check(lib_rel <= 1e-5, f"{name}: library call differs by {lib_rel}")
                    lib_ms = cuda_ms(lambda a: l1_norm(a, BLOCK, BLOCK), sets)
                line = {"max_abs_err": (out - plain).abs().max().item(), "max_rel_err": rel,
                        "tol": "rtol 1e-5",
                        "ms": cuda_ms(lambda a: bi_mod.block_importance_cuda(
                            a, BLOCK, BLOCK, crit), sets),
                        "plain_ms": cuda_ms(lambda a: ref.block_importance_ref(
                            a, BLOCK, BLOCK, crit), sets),
                        "library_ms": lib_ms,
                        **bound(tensor_bytes(w, out), 2 * M * N, F32_FLOPS)}
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
                out = igm_mod.intrablock_gather_matmul_cuda(x, w_comp, row_idx)
                plain = ref.intrablock_gather_matmul_ref(x, w_comp, row_idx)
                torch.cuda.synchronize()
                err = (out.float() - plain.float()).abs().max().item()
                scale = plain.float().abs().max().item()
                name = f"intrablock_gather_matmul {key} B={B} K={K} Kc={Kc} N={N} {str(dt)[6:]}"
                check(err <= tol[dt] * scale, f"{name}: max_abs_err {err} > {tol[dt]}*{scale}")
                line = {"max_abs_err": err,
                        "tol": f"{tol[dt]} x max|plain| = {tol[dt] * scale:.4g}",
                        "ms": cuda_ms(lambda a, wc, ix, d: igm_mod.intrablock_gather_matmul_cuda(
                            a, wc, ix, check_range=False), sets),
                        "plain_ms": cuda_ms(lambda a, wc, ix, d:
                                            ref.intrablock_gather_matmul_ref(a, wc, ix), sets),
                        "library_ms": cuda_ms(lambda a, wc, ix, d: torch.matmul(a, d), sets),
                        **bound(nbytes, 2 * B * Kc * N, peak[dt])}
                report(name, line)
                if key == "w_gate" and B == 4 and dt == torch.bfloat16:
                    rows["intrablock_gather_matmul"] = dict(
                        line, shape=f"decode x ({B},{K}) gathered by row_idx ({Kc},) @ w_comp "
                                    f"({Kc},{N}), row-aligned IntraBlock(4,1,0.5), bf16",
                        library="torch.matmul on the decompressed masked-dense weight")
                del sets, x, w_comp, row_idx, dense

    # -- bit-serial zero profile: int8 activations of the §IV-B profile -------
    # (V, K): 2048 tokens of the d_model and d_ff inputs, a ragged case and
    # n_bits < 8; exact equality.  No single PyTorch call computes the
    # count, so these rows have no library time.
    from repro_torch.core.input_sparsity import quantize_int8
    from repro_torch.kernels import bitserial_profile as bsp_mod
    for (V, K, n_bits) in [(2048, 2560, 8), (2048, 9728, 8), (100, 100, 8), (100, 100, 5)]:
        sets = []
        for _ in range(n_copies(V * K)):
            q = quantize_int8(torch.randn(V, K, generator=g, device="cuda"))
            q[0, :4] = -128
            sets.append((q,))
        q = sets[0][0]
        out = bsp_mod.bitserial_zero_profile_cuda(q, GROUP_ROWS, n_bits)
        plain = ref.bitserial_zero_profile_ref(q, GROUP_ROWS, n_bits)
        name = f"bitserial_zero_profile V={V} K={K} g={GROUP_ROWS} n_bits={n_bits} int8"
        check(out.tolist() == plain.tolist(), f"{name}: kernel {out.tolist()} != plain "
                                              f"{plain.tolist()}")
        line = {"max_abs_err": 0.0, "tol": "exact", "counts": out.tolist(),
                "ms": cuda_ms(lambda a: bsp_mod.bitserial_zero_profile_cuda(
                    a, GROUP_ROWS, n_bits), sets),
                "plain_ms": cuda_ms(lambda a: ref.bitserial_zero_profile_ref(
                    a, GROUP_ROWS, n_bits), sets),
                "library_ms": None,
                **bound(V * K + 8, 2 * V * K, F32_FLOPS)}
        report(name, line)
        if (V, K) == (2048, 9728):
            rows["bitserial_zero_profile"] = dict(
                line, shape=f"q ({V},{K}) int8, groups of {GROUP_ROWS}, 8 bits",
                library="none: no single PyTorch call computes the zero-plane count")
        del sets, q
    return rows


# ---------------------------------------------------------------------------
# Phases 3-5: the main path at full width
# ---------------------------------------------------------------------------

def main_path(cfg, rows: dict) -> None:
    from repro_torch.core.flexblock import FlexBlockSpec, FullBlock
    from repro_torch.core.pruning import block_losses, keep_from_losses
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.sparsity.apply import compress_params, prune_params, sparsity_report

    spec = FlexBlockSpec((FullBlock(BLOCK, BLOCK, 0.5),))
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    print(f"[prune] init {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{sum(t.numel() for t in params['layers'].values()) / 1e9:.3f} G layer params "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)

    # Kernel losses against plain losses, and the masks each would give.
    worst, flipped, n_blocks = 0.0, 0, 0
    for key in KEYS:
        w = params["layers"][key]
        for l in range(cfg.n_layers):
            mat = w[l].reshape(w.shape[1], -1)
            lk = block_losses(mat, BLOCK, BLOCK, "l1", impl="cuda")
            lp = block_losses(mat, BLOCK, BLOCK, "l1", impl="ref")
            worst = max(worst, ((lk - lp).abs() / lp.abs()).max().item())
            n_keep = FullBlock(BLOCK, BLOCK, 0.5).nonzero_blocks(tuple(mat.shape))
            flipped += int((keep_from_losses(lk, n_keep) != keep_from_losses(lp, n_keep)).sum())
            n_blocks += lk.numel()
    print(f"[prune] block losses kernel vs plain: max rel err {worst:.3e} (rtol 1e-5); "
          f"mask blocks that differ: {flipped} of {n_blocks}", flush=True)
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

    parity_phase(cfg, cparams, prompts, [r.output for r in reqs], tol=0.15,
                 faults=fullblock_faults(cfg, cparams))


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

def intrablock_path(cfg, rows: dict) -> None:
    from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.sparsity.apply import compress_params, prune_params, sparsity_report

    spec = FlexBlockSpec((IntraBlock(INTRA_M, 1, 0.5),))
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
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

    # Logits have std ~1 at this init.  On an H100 the kernel path stays
    # within 0.068 of the plain one (bf16 over 36 layers), while leaving out
    # layer 18's w_down moves them by 0.40: 0.15 sits between the two.
    parity_phase(cfg, cparams, prompts, [r.output for r in reqs], tol=0.15,
                 faults=intrablock_faults(cfg, cparams))
    profile_phase(cfg, cparams, prompts, rows)


def profile_phase(cfg, cparams, prompts, rows: dict) -> None:
    """§IV-B: the skippable bit-serial ratio of every pruned projection's
    input, from the 8 prompts' prefill concatenated over tokens, int8, in
    groups of GROUP_ROWS; each (layer, kind) held to the plain count."""
    from repro_torch.core.input_sparsity import (capture_mlp_activations,
                                                 profile_activations, quantize_int8)
    from repro_torch.kernels import ops
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
    # ---- end of the profile ------------------------------------------------------
    check(counts["bitserial_zero_profile"] == len(names),
          f"bitserial_zero_profile launched {counts['bitserial_zero_profile']} times, "
          f"want {len(names)}")
    rows["bitserial_zero_profile"]["launches"] = counts["bitserial_zero_profile"]

    differ = []
    for name, a in acts.items():
        q = quantize_int8(a.reshape(-1, a.shape[-1]))
        k = ops.bitserial_zero_profile(q, GROUP_ROWS, impl="cuda").tolist()
        p = ops.bitserial_zero_profile(q, GROUP_ROWS, impl="ref").tolist()
        if k != p:
            differ.append((name, k, p))
    summary = {}
    for kind in kinds:
        vals = [ratios[f"l{l:02d}/{kind}"] for l in range(cfg.n_layers)]
        summary[kind] = {"min": min(vals), "mean": sum(vals) / len(vals), "max": max(vals),
                         "features": acts[f"l00/{kind}"].shape[-1]}
    print(f"[profile] {cfg.name}: {n_tok} prefill tokens of 8 prompts, {len(names)} "
          f"(layer, kind) activations ({held / 2**30:.2f} GiB bf16 held) captured in "
          f"{t_cap:.2f}s, profiled in {t_prof:.2f}s; int8, groups of {GROUP_ROWS} rows, 8 bits; "
          f"skippable ratio per kind over {cfg.n_layers} layers: {json.dumps(summary)}",
          flush=True)
    print(f"[profile] kernel vs plain [skippable, total]: {len(names) - len(differ)} of "
          f"{len(names)} (layer, kind) pairs equal; launches {json.dumps(counts)}", flush=True)
    check(not differ, f"bit-serial counts differ kernel vs plain: {differ[:4]}")
    check(all(0.0 <= r <= 1.0 for r in ratios.values()), "a skippable ratio outside [0, 1]")


def microbench_phase() -> None:
    """``microbench_kernels`` on the card; its samples go to JSONL under
    build/ and must read back unchanged."""
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
        main_path(get_config("llama3-8b"), rows)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[time] llama3-8b path {time.perf_counter() - t0:.1f}s; device memory after "
              f"freeing it {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
        t0 = time.perf_counter()
        intrablock_path(get_config("qwen3-4b"), rows)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[time] qwen3-4b path {time.perf_counter() - t0:.1f}s", flush=True)
        microbench_phase()
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
                        "shape": r["shape"], "library": r["library"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
