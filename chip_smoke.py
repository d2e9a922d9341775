#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each reported on its own line(s):

1. build   — compile the port's CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. kernels — hold each kernel against its plain PyTorch version at the
   shapes of the main path, in bf16 and f32, and time kernel, plain
   version and the nearest single PyTorch call;
3. prune   — init llama3-8b at full width (random bf16 weights from a
   seed), check the kernel's Eq. 1 block losses against the plain ones,
   then prune with FullBlock(128, 128, 0.5) and compress;
4. serve   — serve 8 requests (prompts of 100..512 tokens, 32 new tokens
   each) through ``ServeEngine(slots=4, max_len=1024)``;
5. parity  — rerun the 8 prompts' prefill and the first request's first
   4 decode steps with ``impl="ref"`` on the same compressed weights and
   compare logits and served tokens; show that a planted fault breaks
   the logit tolerance; check that the served logits are f32 products;
6. the ``{"kernels": [...]}`` line; 7. the card's name and power limit.

The launch counts are set to 0 just before phase 3 prunes and read just
after phase 4, so they count the main path only.  Any failed check exits
nonzero.  Without a CUDA device, or without the repository beside it,
the script exits nonzero and prints no result.
"""
from __future__ import annotations

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
    return rows


# ---------------------------------------------------------------------------
# Phases 3-5: the main path at full width
# ---------------------------------------------------------------------------

def main_path(cfg, rows: dict) -> None:
    from repro_torch.core.flexblock import FlexBlockSpec, FullBlock
    from repro_torch.core.pruning import block_losses, keep_from_losses
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Request, ServeEngine
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
    # ---- end of the main path ------------------------------------------------
    snap = engine.stats_snapshot()
    for i, r in enumerate(reqs):
        check(r.done and len(r.output) == 32 and r.reject_reason is None,
              f"request {i}: done={r.done} tokens={len(r.output or [])}")
    decode_tokens = snap["tokens_generated"] - len(reqs)
    print(f"[serve] 8 requests, prompt lengths {lens.tolist()}, 32 new tokens each: all done "
          f"in {wall:.2f}s wall; TTFT p50 {snap['ttft_s']['p50'] * 1e3:.1f} ms; "
          f"step p50 {snap['token_latency_s']['p50'] * 1e3:.2f} ms over {snap['steps']} steps; "
          f"{snap['tokens_per_s']:.1f} tokens/s (engine busy time, prefill included); "
          f"{decode_tokens} decode tokens", flush=True)
    print(f"[serve] launches on the main path: {json.dumps(counts)}", flush=True)
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the main path")

    parity_phase(cfg, cparams, prompts, [r.output for r in reqs])
    for name in rows:
        rows[name]["launches"] = counts[name]


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


def parity_phase(cfg, cparams, prompts, served) -> None:
    """The served path against ``impl="ref"`` on the same compressed weights.

    Logits: the last prompt token of all 8 prompts, plus 4 decode steps of
    the first request fed its served tokens, kernels vs plain.  Greedy
    tokens: each served token against the plain path's argmax, required
    to agree where the plain top-2 margin exceeds 2*tol (a smaller margin
    can flip within the tolerance).  Two faults planted in a copy of the
    weights give the logit error that a wrong path shows; the first must
    exceed the tolerance.  Last, the served logits must be f32 products,
    as the reference's ``preferred_element_type=f32`` unembedding gives.
    """
    from repro_torch.models.layers import BlockSparseLinear, rms_norm
    from repro_torch.models.transformer import _run

    # Logits have std ~1 at this init.  On an H100 the kernel path stays
    # within 0.07 of the plain one (bf16 over 32 layers), while leaving out
    # one layer's w_down moves them by 0.38: 0.15 sits between the two.
    tol = 0.15
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
    print(f"[parity] kernels vs impl=ref over {len(margins)} steps (8 prompts' last token, "
          f"4 decode steps of request 0): max |dlogit| {err.max().item():.4f} (tol {tol}), "
          f"per step {[round(e, 4) for e in err.tolist()]}", flush=True)
    print(f"[parity] served tokens vs impl=ref argmax: agree on "
          f"{sum(p == w for p, w in zip(picked, want))} of {len(want)} steps; "
          f"{len(decided)} steps have a ref top-2 margin above 2*tol and must agree, "
          f"{len(wrong)} do not; margins {[round(m, 4) for m in margins]}", flush=True)

    # Planted faults in layer 16's w_down (shared w_comp, copied idx):
    # the whole projection left out, and one live 128x128 block dropped.
    wd, l = cparams["layers"]["w_down"], cfg.n_layers // 2
    faults = {}
    for what in ("w_down of one layer left out", "one block of one layer dropped"):
        idx = wd.idx.clone()
        if what.startswith("w_down"):
            idx[l] = -1
        else:
            idx[l, 0, int((idx[l, 0] >= 0).nonzero()[0])] = -1
        bad = dict(cparams, layers=dict(cparams["layers"], w_down=BlockSparseLinear(
            wd.w_comp, idx, wd.in_features, wd.out_shape)))
        got = step_logits(bad, cfg, prompts[0], "auto", feed)
        faults[what] = (got - plain[:5]).abs().max().item()
    print(f"[parity] planted faults, max |dlogit| vs impl=ref on request 0: "
          + json.dumps({k: round(v, 4) for k, v in faults.items()}), flush=True)

    # f32 unembedding: the served prefill logits against an f32 product
    # of the final hidden state and the whole lm_head widened to f32.
    x, _, _ = _run(cparams, torch.as_tensor(prompts[0], dtype=torch.long,
                                             device="cuda")[None], cfg, "auto", False)
    h = rms_norm(x[0, -1:], cparams["final_norm"], cfg.norm_eps)
    w = cparams["lm_head"]
    f32 = (h.float() @ w.float())[0]
    rounded = (h @ w).float()[0]
    e32 = (auto[0] - f32).abs().max().item()
    e16 = (rounded - f32).abs().max().item()
    print(f"[parity] served prefill logits vs an f32 unembedding: max |d| {e32:.3e} "
          f"(tol 1e-4); bf16-rounded logits would differ by {e16:.3e}", flush=True)
    check(err.max().item() <= tol, f"logits differ by {err.max().item()} > {tol}")
    check(not wrong, f"served tokens differ from impl=ref at decided steps {wrong}")
    check(faults["w_down of one layer left out"] > tol,
          f"a missing projection stays within the logit tolerance {tol}")
    check(e32 <= 1e-4, f"served logits are not f32 products: {e32} > 1e-4")


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
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[build] {len(libs)} kernels built from src/repro_torch/kernels/csrc in "
          f"{time.perf_counter() - t0:.1f}s: {sorted(libs)}", flush=True)

    sources = {"flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:94"),
               "block_sparse_matmul": ("cuda",
                                       "src/repro_torch/kernels/csrc/block_sparse_matmul.cu",
                                       "src/repro/kernels/block_sparse_matmul.py:49"),
               "block_importance": ("cuda", "src/repro_torch/kernels/csrc/block_importance.cu",
                                    "src/repro/kernels/block_importance.py:34")}
    try:
        rows = kernel_phase()
        main_path(get_config("llama3-8b"), rows)
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
