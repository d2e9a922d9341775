#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each reported on its own line(s):

1. build    — compile the port's six CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel),
   then print ptxas's registers and spill bytes of every flash wgmma
   setting built; a setting at hd 256 or one the plan picks must not spill;
2. kernels  — hold each kernel against its plain PyTorch version at the
   shapes of the main paths, in bf16 and f32 (int8 for the bit-serial
   profile), and time kernel, plain version and the nearest single
   PyTorch call; flash attention also at gemma-7b's prefill shape (head
   dim 256), hymba-1.5b's (head dim 64, window 1024) and whisper-medium's
   (4 prompts, head dim 64, MHA), the block-sparse matmul also at
   whisper-medium's w_up, the gather-matmul also at the SSM paths' w_in
   (N % 128 != 0; hymba's N % 8 != 0 through its padded row stride) and at
   paligemma-3b's w_gate, the flash and w_in rows each beside the general
   variant's card time on the same inputs (``general_ms``).  Every row names the variant that ran
   and is timed from CUDA graphs (card time alone), with the eager times
   beside them (what back-to-back calls from Python cost, host included);
   each row gives ``share_of_bound`` (bound / ms) and ``x_library`` (ms /
   library ms).  The bf16 matmul rows add the card time of the same
   variant at cluster sizes 1, 2, 4 and 8 beside the plan's, the flash
   wgmma rows the card time at every lever setting built for their head
   dim (rows per CTA / keys per tile / q heads per CTA), and the
   block-importance and int8 bit-serial rows the first kernel's card time
   (``general_ms``); the fused quantise-and-count rows (bf16 and f32 at the
   profile's shapes) add the whole op, its min/max pass and the unfused
   quantize_int8 + count; decode attention at qwen3-4b longdoc's decode
   step (``decode_attention_row``: ragged positions, its bound over the
   filled keys only, ``F.scaled_dot_product_attention`` as the yardstick);
   each served path then counts one decode-attention launch a layer and
   decode step where the route takes it (``check_path_launches``);
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
5b. train   — free the qwen3-4b weights, take the masks of its served
   prune (row-aligned IntraBlock(4, 1, 0.5) on the six projections,
   ``prune_params`` from the seed-0 weights), and fine-tune qwen3-4b at
   full width and depth from the same seed through ``Trainer``: 6 steps of
   ``TokenPipeline`` batches (vocab 151936, 2 x 512 tokens, seed 0) in 2
   microbatches, bf16 params, f32 AdamW (lr 3e-4, warmup 1, 6 steps),
   remat ``minimal``, no checkpoint on disk.  Hard checks: every loss and
   grad_norm finite, grad_norm > 0; on step 1 a nonzero grad on layer 0's
   wq/wk/wv/q_norm/k_norm/wo/w_gate/w_up/w_down and on embed; after every
   step each pruned leaf exactly zero off its mask (density 0.5); no
   kernel launch in the steps (a training forward takes
   ``chunked_attention``, and a wrapper given an input that requires grad
   would raise); peak device memory under 79.18 GiB.  Prints the step
   wall p50, tokens/s, the split by CUDA events (forward + backward,
   optimizer, masks), the host's issue of forward + backward against its
   card time, the loss curve.  Then, with m/v freed, one forward +
   backward of 1 x 512 without remat and with each remat policy (the
   memory each forward keeps, the peak, the time; ``nothing`` must peak
   below no remat, loss and grad_norm equal to 1e-6); then the fine-tuned
   weights compressed to the gather layout, 4 of the served prompts
   through ``ServeEngine(slots=4, max_len=1024)`` for 8 tokens each with
   the launches held exactly (flash ``wgmma`` 36 a prefill, the
   gather-matmul 6 x 36 a prefill and a decode step) and the parity phase;
6. gemma-7b IntraBlock path: free the qwen3-4b weights, init gemma-7b
   at full width (28 layers, d_model 3072, 16 heads of 256, MHA, vocab
   256000 tied), prune the six projections with row-aligned
   IntraBlock(4, 1, 0.5), compress, serve the same 8 requests and run the
   same parity phase; its prefill attention runs flash's wgmma variant at
   head dim 256, whose card time per prefill is printed;
7. gemma2-9b FullBlock path: free the gemma-7b weights, init gemma2-9b at
   full width (42 layers alternating local (window 4096) and global
   attention, attention softcap 50, final-logit softcap 30, post-norms),
   prune with FullBlock(128, 128, 0.5), compress, serve the 8 requests
   with the first prompt replaced by one of 4600 tokens through
   ``ServeEngine(slots=4, max_len=5120)`` (its local layers drop keys in
   prefill and in every decode step), run the parity phase, then the
   window check: layer 0 (local) on the long prompt through
   ``chunked_attention`` with window 4096 must equal the same call with no
   window bit for bit on the rows before position 4096, and differ on
   every row after it.  Its prefill takes no flash launch: the softcap is
   outside the flash kernel's contract;
8. qwen3-moe-30b-a3b FullBlock path: free the gemma2-9b weights, init
   qwen3-moe-30b-a3b at full width and depth (48 layers, d_model 2048,
   32 q / 4 kv heads of 128, 128 experts of d_ff 768, top-8, capacity
   factor 1.25; 30.5 G parameters, 61 GB in bf16), prune the six
   projections with FullBlock(128, 128, 0.5) (each expert leaf moved to
   the host first and pruned on its own, its 128x128 blocks spanning all
   128 experts of the (E, d·ff) view), compress wq/wk/wv (the expert
   leaves stay masked-dense, as the reference runs them), serve the 8
   requests through ``ServeEngine(slots=4, max_len=1024)`` and run the
   parity phase, with the share of routing choices that differ between
   the kernel and plain paths and each layer on the same input through
   both; the peak device memory of the prune step and of serving is
   printed;
9. mamba2-130m IntraBlock path: free the MoE weights, init mamba2-130m at
   full width and depth (24 attention-free Mamba-2 layers, d_model 768,
   24 SSM heads of 64, state 128, no MLP), prune w_in/w_out with
   row-aligned IntraBlock(4, 1, 0.5), compress, serve the 8 requests
   (the engine merges each prefill's SSM and conv states into its slot)
   and run the parity phase; then the chunked SSD against the recurrence:
   in f32 on the plain path, a 300-token prefill (two chunks, the second
   ragged) against a 236-token prefill and 64 decode steps;
10. hymba-1.5b IntraBlock path: init hymba-1.5b at full width and depth
   (32 layers of sliding-window attention (window 1024, 25 q / 5 kv heads
   of 64) beside the SSM mixer (50 heads, state 16), gated MLP), prune its
   eight projections with row-aligned IntraBlock(4, 1, 0.5), compress,
   serve the 8 requests with the first prompt made 1600 tokens long
   through ``ServeEngine(slots=4, max_len=2048)`` and run the parity
   phase, then the window check on layer 0, with flash's wgmma variant
   (head dim 64) held against ``chunked_attention`` on the long prompt;
11. whisper-medium FullBlock path: init at full width and depth (24
   decoder and 24 encoder layers, d_model 1024, 16 heads of 64, MHA,
   plain GELU MLP, cross-attention in every decoder layer), prune the
   decoder's wq/wk/wv/w_up/w_down with FullBlock(128, 128, 0.5) (the
   encoder and the cross weights stay dense, as the reference prunes
   them), compress, then serve through the entry points (no engine takes
   an encoder input): 4 prompts of 416 tokens from numpy seed 0 with stub
   1500-frame embeddings (std 1/sqrt(d)), one batched ``prefill`` merged
   into ``init_cache(max_len=448, enc_seq=1500)``, 31 ``decode_step``s;
   the encoder's time apart from the decoder's prefill; the parity phase
   over 12 steps, with the middle layer's w_down left out and the cross
   k/v swapped in the cache as planted faults; then the reach check:
   negating the last frame moves encoder layer 0's output at frame 0;
12. paligemma-3b IntraBlock path: init at full width and depth (18
   layers, d_model 2048, 8 q heads and 1 kv head of 256, gated MLP, vocab
   257216 tied), prune its six projections with row-aligned
   IntraBlock(4, 1, 0.5), compress, serve 4 prompts of 128 tokens after
   stub 256-patch prefixes through the entry points to ``max_len=512``,
   the parity phase, then the prefix check: layer 0's attention with the
   prefix of 256 against none differs on exactly rows 0..254.  Its
   prefill takes no flash launch: the prefix-LM mask is outside the flash
   kernel's contract;
12b. mesh   — the two mesh paths at full width in worlds of ranks on
   the one card (``torch.distributed`` over gloo, each rank this script
   again with ``--mesh-rank``): qwen3-moe-30b-a3b on a (data 1, model 2)
   mesh, each rank holding half the experts (pruned whole, then cut),
   served through ``ServeEngine(slots=4)`` with the launches held as on
   one card, the expert path of layers 0 and 47 against the global
   dispatch at dropless capacity (and a planted fault past the
   tolerance); hymba-1.5b on (data 2, model 2), one 2 x 4096 prefill
   through the window path on every attention layer (flash's wgmma
   variant on each rank's block, one launch a layer), decode steps, and
   each layer's attention and k/v against one process's (and planted
   faults); tokens equal on every rank, card memory under 79.18 GiB (see
   :func:`mesh_phase`);
13. microbench — ``microbench_kernels`` on the card, its samples written
   as JSONL under ``build/`` and read back;
14. cost    — on the host, from what the card produced in this run: a
   calibration profile fitted to the microbench samples (saved under
   ``build/profiles/``), the profile's 108 skippable-bit ratios mapped
   onto ``lm_workload``'s op names, and CIMinus cost reports of the nine
   served models with the FlexBlock specs they were pruned with, on
   ``usecase_arch(4, input_sparsity=True)`` at 512 tokens: qwen3-4b (a)
   without input sparsity, (b) with the measured ratios, (c) with the
   ratios and the fitted profile; llama3-8b, gemma-7b, gemma2-9b,
   qwen3-moe-30b-a3b, mamba2-130m, hymba-1.5b, whisper-medium and
   paligemma-3b (a) and (c); mamba2-130m's and hymba-1.5b's (a) must equal
   the cycles and speedup the port's
   ``cim_cost_of_model`` gives on a CPU.  Each report must be finite and
   round-trip through JSON, (b) may not be slower than (a), a profile with
   unit efficiencies must give (b) bit for bit, (c) must be (b) (or (a))
   with each op's latency divided by its class's efficiency, and the
   density of every mask the card produced must be the spec's;
15. dry-run — the launch layer (:func:`dryrun_phase`): cells counted on
   ``meta``, qwen3-4b's train_4k (B 1), prefill_32k (B 1) and decode_32k
   (B 8) executed on zeros, each with ``--emit-trace``: the record's five
   ``trace_*`` fields, its graph reloading to the recorded digest, and for
   the prefill and train cells MVM macs equal to ``lm_workload``'s at the
   record's shape (:func:`emitted_trace_check`); then the three cells
   again with ``--scores-bf16`` (:func:`scores_bf16_cells`: time, counted
   bytes, peaks and flash launches beside the f32 records; the flops and
   the launches may not move, the bytes must fall where
   ``chunked_attention`` runs and not on flash's prefill), and one decode
   step of full-width qwen3-4b over a prefilled cache with bf16 against
   f32 score tiles (:func:`scores_logit_check`, the logits within
   SCORES_LOGIT_TOL); then train_4k again with ``chunked_attention``'s
   tiled path switched off (:func:`tiled_attn_cell`: the generic loop's
   time, counted flops and bytes and peaks beside the tiled record's; the
   tiled flops must be the lower, no launch in either), and the tiled path
   against the generic loop on the card at train_4k's attention shape;
15b. mesh-dryrun — the dry-run on a mesh (:func:`mesh_dryrun_phase`),
   counted in seven processes of their own started once phase 15 is done,
   so that no timed phase shares the host with them
   (:func:`start_mesh_dryrun`; the card hidden from them, a fake world
   their default group; the jobs spread longest first, :func:`_jobs_of`),
   and read after phase 16: llama3-8b's, qwen3-4b's and
   qwen3-moe-30b-a3b's three cells on both meshes (256 / 512 ranks),
   gemma-7b's, gemma2-9b's and dbrx-132b's prefill_32k on the single-pod
   one, llama3-8b's train_4k under ``--fsdp`` and ``--legacy-sharding``,
   qwen3-moe's train_4k under ``--fsdp`` and prefill_32k under
   ``--no-ep``, every cell of mamba2-130m and hymba-1.5b (long_500k too)
   on the single-pod mesh and their prefill_32k on the multi-pod one,
   whisper-medium's and paligemma-3b's three cells on both meshes, a
   train_4k of each under ``--fsdp`` and paligemma's prefill_32k under
   ``--legacy-sharding``, and seven single-pod cells whose attention
   passes one chunk again with ``chunked_attention``'s tiled path switched
   off (tag ``untiled``; the tiled record's flops must be the lower and
   its collectives the same); no
   ``error``, per-device argument bytes equal to the specs' reckoning,
   collective bytes on every train cell, all-to-all on every MoE record
   of the expert-parallel path and none under ``--no-ep`` (whose flops
   must exceed the expert-parallel path's), prefill's flash counted once
   a layer at its per-device ``wgmma`` work (hymba-1.5b's on the window
   path's block of rank 0: S/16 queries, every head; whisper-medium's on
   its decoder alone), none for mamba2, gemma2 or paligemma (the
   prefix).  On a fake (2, 2) world, llama3-8b ``.reduced()``'s prefill
   and train step under each knob (and ``--fsdp --no-zero1``, which
   changes nothing), its widened train step, qwen3-moe ``.reduced()``'s
   prefill and train step (default and ``--fsdp``), hymba
   ``.reduced()``'s window-path prefill, whisper-medium widened (heads
   split) and paligemma-3b ``.reduced()``: prefill, train (default and
   ``--fsdp``) and decode, paligemma's prefill also under
   ``--legacy-sharding`` and past one chunk (the tiled prefix path), must
   issue the collectives of a hand count (:func:`hand_collectives`), by
   kind, bytes and number.
   Counts of one rank on ``meta``, no card time; each record on a
   ``[mesh-dryrun]`` line;
16. trace   — the modeling plane's front end (:func:`trace_phase`), on
   ``meta`` tensors and the host, no launch: every config's forward,
   prefill and decode at published width and depth (S 128, B 1) captured
   and lowered, forward and prefill diffed against ``lm_workload`` (MVM
   macs, MVM weights and total weights equal), decode sorted and
   simulated on ``usecase_arch(16)`` under the three schedule policies;
   vgg16, resnet18 and resnet50 at img 32 diffed against their builders;
   two captures of llama3-8b forward with equal digests; llama3-8b's own
   forward (``source="model"``) at S 8 and 128, its MVM weights equal to
   the hand DAG's and, at S 8, its macs within (0.9, 1.2) of them;
16b. explore — the exploration plane's CLIs (:func:`start_explore`, read
   by :func:`explore_phase`), started with phase 15b and each a process of
   its own (the card hidden from all but ``collect``), in seven chains at
   once: ``python -m repro_torch.calibrate collect --kernels --sizes 256
   --repeats 1`` on the card (4 samples, each ``impl`` ``cuda`` and
   timed); ``calibrate fit`` over this run's microbench samples, ``show
   --check`` and ``diff`` against the profile phase 14 fitted from them
   (identical peaks and efficiencies); ``python -m repro_torch.explore lm``
   over qwen3-4b traced on ``meta`` (S 64, ``--workload traced:qwen3-4b``)
   priced by that profile, with ``--diff-analytic``, schedules monolithic
   and resident over 16 invocations and a run directory: every
   calibrated/analytic ratio finite and positive, then ``--resume``
   evaluating 0 points and ``--check-store`` passing; resnet18's sparsity
   sweep on 2 workers without faults and under ``REPRO_FAULTS`` crashes
   and exceptions, the two CSVs byte-identical; ``python -m
   repro_torch.obs energy`` and ``timeline`` of qwen3-4b's cost report (c)
   (its components summing to its total within 1e-9, the trace passing
   ``obs check``); each CLI's seconds printed beside those of a run in
   which every process of the port imported torch
   (``EXPLORE_SECONDS_WITH_TORCH``);
16c. analysis — the static checker on the host (:func:`_analysis_chain`,
   read by :func:`analysis_phase`), one more chain beside phase 16b's: a
   process with torch, triton and jax shadowed by modules that raise
   ``ImportError`` imports ``repro_torch`` and every module of its host
   plane (core, explore, trace, configs, calibrate, analysis, obs) and
   must load none of the three; then ``python -m repro_torch.analysis
   --all --format json --out build/analysis.json`` must exit 0 with 0
   errors from all four passes, in a process shadowed the same way;
17. the ``{"kernels": [...]}`` line (flash's ``launches`` are the card's; the
   mesh records' counted calls are on the ``[mesh-dryrun]`` lines); 18. the
   card's name and power limit.

The launch counts are set to 0 just before each path and read just
after it: on each served path from prune to the end of serving (every
kernel's count is kept per path; whisper-medium and paligemma-3b: one
batched prefill and 31 decode steps), ``bitserial_zero_profile`` over
the profile call.
After each served path its compressed projections must have run only
through the ``decode`` and ``prefill`` variants, whatever their width N
(one launch per projection, layer and decode step or prompt; the
gather-matmul's last 128-column tile is ragged, and hymba-1.5b's w_in (N
6482) is read through rows padded to 16 bytes), never ``general`` or
``f32`` (qwen3-moe-30b-a3b: wq/wk/wv only); its prefill attention only
through the flash ``wgmma`` variant (one launch per layer and prompt, at
head dim 128, gemma-7b's 256, hymba-1.5b's and whisper-medium's 64;
gemma2-9b, mamba2-130m and paligemma-3b: no flash launch at all), the
llama3-8b, gemma2-9b, qwen3-moe-30b-a3b and whisper-medium prunes only
through the
block-importance ``strip`` variant (one launch per projection and
layer), and the profile only through the bit-serial ``fused`` variant.
Any failed check exits nonzero.  Without a CUDA device, or without the
repository beside it, the script exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import signal
import statistics
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
SSM_KEYS = ("w_in", "w_out")                      # the SSM mixer's projections
EXPERT_KEYS = ("w_gate", "w_up", "w_down")      # an MoE's: (L, E, K, N), kept masked-dense
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


def live_pairs(S: int, window=None) -> int:
    """The (query, key) pairs a causal attention of one head over S
    positions needs: query i sees min(i + 1, window) keys."""
    w = min(window or S, S)
    return w * (w + 1) // 2 + (S - w) * w


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
                ldw = wc.stride(0)
                y = torch.empty(B, N, dtype=a.dtype, device=a.device)
                if variant == "decode":
                    rc = lib.igm_bf16_decode(a.data_ptr(), wc.data_ptr(), ix.data_ptr(),
                                             y.data_ptr(), B, K, Kc, N, ldw, c, stream)
                else:
                    Kp = -(-Kc // 8) * 8
                    xg = torch.empty(B, Kp, dtype=a.dtype, device=a.device)
                    rc = lib.igm_bf16_prefill(a.data_ptr(), wc.data_ptr(), ix.data_ptr(),
                                              xg.data_ptr(), y.data_ptr(), B, K, Kc, Kp, N, ldw,
                                              c, stream)
            _build.check(rc, f"{op} {variant} cluster {c}")
        out[c] = graph_ms(call, sets)
    return out


def ptxas_phase() -> None:
    """Registers and spills of every flash wgmma setting built, as ptxas
    reported them at this run's build (``-Xptxas -v``).  Each setting of
    ``plans.FA_BUILT`` must have been compiled; no setting at hd 256 and
    no setting the plan picks (``plans.FA_LEVERS``) may spill."""
    import re
    from repro_torch.kernels import _build, plans
    got = {}
    for fn, info in _build.ptxas_info("flash_attention").items():
        m = re.search(r"fa_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", fn)
        if m:
            hd, nwg, keys, pack = map(int, m.groups())
            got[hd, 64 * nwg, keys, pack] = info
    for hd, built in plans.FA_BUILT.items():
        line = {f"{r}/{k}/{p}": (f"{got[hd, r, k, p]['registers']} regs, spill "
                                 f"{got[hd, r, k, p]['spill_stores']}/"
                                 f"{got[hd, r, k, p]['spill_loads']} B")
                for r, k, p in built if (hd, r, k, p) in got}
        print(f"[ptxas] flash wgmma hd {hd} (rows/keys/pack: registers a thread, spill stores/"
              f"loads bytes): {json.dumps(line)}", flush=True)
        for r, k, p in built:
            check((hd, r, k, p) in got, f"flash wgmma hd {hd} {r}/{k}/{p}: not compiled")
            spill = got[hd, r, k, p]["spill_stores"] + got[hd, r, k, p]["spill_loads"]
            if hd == 256 or (r, k) == plans.FA_LEVERS[hd][:2]:
                check(spill == 0, f"flash wgmma hd {hd} {r}/{k}/{p} spills {spill} bytes")


def flash_sweep(sets, window) -> dict:
    """Card ms of the flash wgmma variant at every lever setting it was
    built with for the inputs' head dim and head group (rows per CTA /
    keys per tile / q heads packed per CTA: ``plans.fa_settings``),
    calling the C entry point directly."""
    from repro_torch.kernels import _build, plans
    lib = _build.load("flash_attention")
    q, k, _ = sets[0]
    out = {}
    for rows, keys, pack in plans.fa_settings(q.shape[3], q.shape[2] // k.shape[2]):
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


def flash_general_ms(sets, window) -> float:
    """Card ms of the flash general variant (the first kernel) on the
    same inputs, calling its C entry point directly."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")

    def call(q, k, v):
        B, S, Hq, hd = q.shape
        o = torch.empty_like(q)
        _build.check(lib.fa_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                                     S, S, Hq, k.shape[2], hd, 1, int(window or 0),
                                     1.0 / math.sqrt(hd), _build.stream_ptr(q.device)),
                     "flash_attention general")
    return graph_ms(call, sets)


def igm_general_ms(sets) -> float:
    """Card ms of the gather-matmul general variant (the first kernel) on
    the same inputs (the weight read in place through its row stride)."""
    from repro_torch.kernels import _build
    lib = _build.load("intrablock_matmul")

    def call(a, wc, ix, d):
        (B, K), (Kc, N) = a.shape, wc.shape
        y = torch.empty(B, N, dtype=a.dtype, device=a.device)
        _build.check(lib.igm_bf16_general(a.data_ptr(), wc.data_ptr(), ix.data_ptr(),
                                          y.data_ptr(), B, K, Kc, N, wc.stride(0),
                                          _build.stream_ptr(a.device)),
                     "intrablock_gather_matmul general")
    return graph_ms(call, sets)


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
    # bound it; gemma-7b's prefill of the longest prompt (16 heads of 256,
    # MHA); qwen3-moe-30b-a3b's (8 q heads per kv head); head dims 64/256
    # and a window for coverage; hymba-1.5b's prefill of its 1600-token
    # prompt (padded to 1664; 25 q / 5 kv heads of 64, window 1024);
    # whisper-medium's decoder prefill of its 4 prompts of 416 tokens
    # (padded to 512; 16 heads of 64, MHA).  Every one runs the wgmma
    # variant; the served models' rows add the general variant's card time
    # on the same inputs (general_ms).
    fa_cases = [(1, 512, 32, 8, 128, None), (1, 2048, 32, 8, 128, None),
                (1, 512, 16, 16, 256, None), (1, 512, 32, 4, 128, None),
                (1, 256, 8, 2, 64, 64), (1, 256, 8, 2, 256, None),
                (1, 1664, 25, 5, 64, 1024), (4, 512, 16, 16, 64, None)]
    fa_variants = {}
    tol = {torch.bfloat16: 3e-2, torch.float32: 3e-5}
    for (B, S, Hq, Hkv, hd, window) in fa_cases:
        G = Hq // Hkv
        pairs = B * Hq * live_pairs(S, window)
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
            served = {(512, 16, 256, None): "gemma-7b", (1664, 25, 64, 1024): "hymba-1.5b",
                      (512, 16, 64, None): "whisper-medium"}
            if dt == torch.bfloat16:
                check(variant == "wgmma", f"{name}: ran the {variant} variant")
                p = plans.fa_plan(B, S, S, Hq, Hkv, hd, dt, True, window, 256)
                line["levers"] = f"{p.rows}/{p.keys}/{p.pack}"
                line["ms_by_levers"] = flash_sweep(sets, window)
                if (S, Hq, hd, window) in served:
                    line["general_ms"] = flash_general_ms(sets, window)
            report(name, line)
            if (S, Hkv, hd, dt) == (512, 8, 128, torch.bfloat16):
                rows["flash_attention"] = dict(
                    line, shape=f"q ({B},{S},{Hq},{hd}) k/v ({B},{S},{Hkv},{hd}) bf16 causal",
                    library="F.scaled_dot_product_attention (kv heads repeated)")
            if dt == torch.bfloat16 and (S, Hq, hd, window) in served:
                model = served[(S, Hq, hd, window)]
                fa_variants[f"wgmma hd {hd}/{model}"] = dict(
                    line, shape=f"q ({B},{S},{Hq},{hd}) k/v ({B},{S},{Hkv},{hd}) bf16 causal"
                                + (f", window {window}" if window else "")
                                + f" ({model} prefill)")
            del sets, lib_sets, q, k, v, out, plain
    rows["flash_attention"]["variants"] = fa_variants

    # -- block-sparse matmul: the six pruned projections ---------------------
    # (K, N) of llama3-8b's projections, of qwen3-moe-30b-a3b's wq and
    # wk/wv and of whisper-medium's w_up, at 50% FullBlock(128,128) density,
    # at decode (B = 4 slots) and at prefill (B = 512).
    proj = {"wq": (4096, 4096), "wk": (4096, 1024), "w_gate": (4096, 14336),
            "w_down": (14336, 4096), "moe wq": (2048, 4096), "moe wk/wv": (2048, 512),
            "whisper-medium w_up": (1024, 4096)}
    bsm_variants = {}
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
                if key.startswith("whisper") and dt == torch.bfloat16:
                    variant_name = "decode" if B == 4 else "prefill"
                    bsm_variants[f"{variant_name}/{key}"] = dict(
                        line, shape=f"{variant_name} x ({B},{K}) @ ({K},{N}) ({key}) at 50% "
                                    f"FullBlock(128,128), {live} live blocks, bf16")
                del sets, x, w_comp, idx, dense
    rows["block_sparse_matmul"]["variants"] = bsm_variants

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

    # llama3-8b's projections, and one layer of a qwen3-moe-30b-a3b expert
    # leaf in the (E, d·ff) view prune_params masks
    bi_shapes = {"wq": (4096, 4096), "wk/wv": (4096, 1024), "w_gate/w_up": (4096, 14336),
                 "w_down": (14336, 4096), "moe expert": (128, 2048 * 768)}
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
    # (K, N) at row-aligned 2:4 (Kc = K/2), decode (B = 4) and prefill (B = 512);
    # then the SSM paths' w_in in bf16 (mamba2-130m (768, 3352), hymba-1.5b
    # (1600, 6482)): N % 128 != 0 runs the main variants with a ragged last
    # tile, hymba's N % 8 != 0 through the padded row stride compress_params
    # stores (ops.aligned_rows); their rows add the general variant's card
    # time on the same inputs (general_ms); and paligemma-3b's w_gate
    # (2048, 16384) in bf16, whose shape it shares with w_up.  The library yardstick is
    # torch.matmul on the decompressed masked-dense weight: one call
    # computing the same function, reading twice the weight bytes.
    from repro_torch.kernels import intrablock_matmul as igm_mod
    iproj = {"wq": (2560, 4096), "wk": (2560, 1024), "w_gate": (2560, 9728),
             "w_down": (9728, 2560), "mamba2-130m w_in": (768, 3352),
             "hymba-1.5b w_in": (1600, 6482), "paligemma-3b w_gate": (2048, 16384)}
    tol = {torch.bfloat16: 1e-2, torch.float32: 1e-5}   # of max |plain|

    def intra_layout(K, N, dt):
        perm = torch.rand(K // INTRA_M, INTRA_M, generator=g, device="cuda").argsort(dim=1)
        kept = torch.zeros(K // INTRA_M, INTRA_M, dtype=torch.bool, device="cuda")
        kept.scatter_(1, perm[:, :INTRA_M // 2], True)
        mask = kept.reshape(K, 1).expand(K, N)
        w = randn(K, N, dtype=torch.float32).mul_(1.0 / math.sqrt(K)).to(dt)
        w_comp, row_idx = ops.compress_intrablock_torch(w, mask, INTRA_M)
        return ops.aligned_rows(w_comp), row_idx, w * mask

    igm_variants = {}
    for key, (K, N) in iproj.items():
        ssm = key.endswith("w_in")
        model_row = " " in key          # a served model's own shape: bf16, kept as a variant
        Kc = K // 2
        for dt in (torch.bfloat16,) if model_row else dtypes:
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
                if dt == torch.bfloat16:
                    want = "decode" if B <= plans.DECODE_MAX_B else "prefill"
                    check(variant == want, f"{name}: ran the {variant} variant, want {want}")
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
                                                     _build.alignment(w_comp.data_ptr()),
                                                     w_comp.stride(0)).cluster
                    line["ms_by_cluster"] = cluster_sweep("intrablock_gather_matmul", variant,
                                                          sets)
                if ssm:
                    line["row_stride"] = w_comp.stride(0)
                    line["general_ms"] = igm_general_ms(sets)
                    if w_comp.stride(0) != N:
                        # what ran before rows were padded: general on the
                        # contiguous weight, whose rows take scalar loads
                        line["general_contiguous_ms"] = igm_general_ms(
                            [(a, wc.contiguous(), ix, d) for a, wc, ix, d in sets])
                report(name, line)
                stride = (f" (row stride {w_comp.stride(0)})"
                          if w_comp.stride(0) != N else "")
                shape = (f"{'decode' if B <= 4 else 'prefill'} x ({B},{K}) gathered by row_idx "
                         f"({Kc},) @ w_comp ({Kc},{N}){stride}{f' ({key})' if model_row else ''}, "
                         f"row-aligned IntraBlock(4,1,0.5), bf16")
                if key == "w_gate" and B == 4 and dt == torch.bfloat16:
                    rows["intrablock_gather_matmul"] = dict(
                        line, shape=shape,
                        library="torch.matmul on the decompressed masked-dense weight")
                if model_row:
                    igm_variants[f"{variant}/{key}"] = dict(line, shape=shape)
                del sets, x, w_comp, row_idx, dense
    rows["intrablock_gather_matmul"]["variants"] = igm_variants

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
    rows["decode_attention"] = decode_attention_row()
    return rows


# the decode-attention row: qwen3-4b-intrablock.longdoc's decode step (32
# slots of an 8320-key cache, 32 q / 8 kv heads of 128), each slot's
# position drawn so that the cache is filled as that cell fills it (56.8%);
# the MoE cell's decode step (one slot of 8256 keys, 32 q / 4 kv heads),
# which the plan splits further, is checked beside it
DA_SHAPE, DA_FILL, DA_MOE_SHAPE = (32, 8320, 32, 8), 0.568, (1, 8256, 32, 4)


def da_edges(Smax: int) -> list:
    """Positions where a kernel misreads first: the first keys, the last
    slot, and past the end (the write dropped, every key attended)."""
    return [0, 1, Smax - 1, Smax, Smax + 7]


def da_check(what: str, q, k, v, K, V, pos) -> dict:
    """``ops.decode_attention`` against its plain version: one launch, the
    caches bit-equal, the output within two bf16 roundings of |V|'s
    attention + |out| (tests/test_torch_gpu.py's bound).  Leaves K/V as
    they were; returns the max error and the largest excess over the bound."""
    from repro_torch.kernels import ops

    K1, V1, K2, V2 = K.clone(), V.clone(), K.clone(), V.clone()
    before = ops.launch_counts()["decode_attention"]
    out = ops.decode_attention(q, k, v, K1, V1, pos)
    check(ops.launch_counts()["decode_attention"] == before + 1, f"decode_attention {what}: "
          "no launch")
    want = ops.decode_attention(q, k, v, K2, V2, pos, impl="ref")
    mag = ops.decode_attention(q, k, v.abs(), K.clone(), V.abs(), pos, impl="ref")
    torch.cuda.synchronize()
    check(torch.equal(K1, K2) and torch.equal(V1, V2), f"decode_attention {what}: caches differ")
    err = (out.float() - want.float()).abs()
    excess = float((err - 2 ** -7 * (mag.float() + want.float().abs())).max())
    check(excess <= 0, f"decode_attention {what}: {excess} over the rounding bound")
    return {"max_abs_err": float(err.max()), "excess_over_bound": excess}


def da_checks(g) -> dict:
    """:func:`da_check` at the longdoc shape with ragged positions that
    hold :func:`da_edges`, with scores ~N(0, 1) and sharp ones (q x 8,
    ~N(0, 64)); at the MoE shape at each edge and at a drawn position, and
    sharp at a drawn one."""
    hd = 128
    done = {}
    for shape in (DA_SHAPE, DA_MOE_SHAPE):
        B, Smax, Hq, Hkv = shape
        q = torch.randn(B, 1, Hq, hd, generator=g, device="cuda")
        k, v = (torch.randn(B, 1, Hkv, hd, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        K, V = (torch.randn(B, Smax, Hkv, hd, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        drawn = torch.randint(0, Smax, (B,), generator=g, device="cuda")
        if B > 1:
            drawn[:5] = torch.tensor(da_edges(Smax), device="cuda")
            cases = [("ragged", drawn, 1.0), ("sharp", drawn, 8.0)]
        else:
            cases = [(f"pos {p}", torch.tensor([p], device="cuda"), 1.0) for p in da_edges(Smax)]
            cases += [(f"pos {int(drawn)}", drawn, 1.0), (f"sharp pos {int(drawn)}", drawn, 8.0)]
        for name, pos, sharp in cases:
            what = f"({B},{Smax},{Hq}/{Hkv}) {name}"
            done[what] = da_check(what, q.mul(sharp).bfloat16(), k, v, K, V, pos)
            print(f"[kernels] decode_attention check {what}: {json.dumps(done[what])}",
                  flush=True)
    return done


def decode_attention_row() -> dict:
    """``decode_attention`` held to its plain version (:func:`da_checks`),
    then at the longdoc decode shape with ragged positions the kernel's
    card time from a CUDA graph and eager, its bound (K and V of the
    filled keys only, read once), the plain version's time and
    ``F.scaled_dot_product_attention``'s over the whole cache with the
    causal mask (kv heads as GQA groups), the yardstick only."""
    from repro_torch.kernels import ops

    B, Smax, Hq, Hkv = DA_SHAPE
    hd = 128
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    checks = da_checks(g)

    def inputs():
        q = torch.randn(B, 1, Hq, hd, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, 1, Hkv, hd, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        K, V = (torch.randn(B, Smax, Hkv, hd, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        lo = int(Smax * DA_FILL / 2)
        pos = torch.randint(lo, 2 * int(Smax * DA_FILL) - lo, (B,), generator=g, device="cuda")
        return q, k, v, K, V, pos

    cache_bytes = 2 * B * Smax * Hkv * hd * 2
    sets = [inputs() for _ in range(max(2, math.ceil(400e6 / cache_bytes)))]
    checks["longdoc fill"] = da_check("longdoc fill", *sets[0])
    keys = sum(int((s[5] + 1).sum()) for s in sets) / len(sets)
    nbytes = 2 * keys * Hkv * hd * 2 + 2 * B * (Hq + 2 * Hkv) * hd * 2
    lib_sets = [(a.transpose(1, 2), c.transpose(1, 2).contiguous(),
                 d.transpose(1, 2).contiguous(),
                 (torch.arange(Smax, device="cuda")[None, :] <= p[:, None])[:, None, None])
                for a, _, _, c, d, p in sets]
    kern = lambda *a: ops.decode_attention(*a)
    lib = lambda a, c, d, m: F.scaled_dot_product_attention(a, c, d, attn_mask=m, enable_gqa=True)
    line = {"max_abs_err": max(c["max_abs_err"] for c in checks.values()),
            "excess_over_bound": max(c["excess_over_bound"] for c in checks.values()),
            "checks": checks,
            "filled_share": keys / (B * Smax), "ms": graph_ms(kern, sets),
            "eager_ms": cuda_ms(kern, sets),
            "plain_ms": cuda_ms(lambda *a: ops.decode_attention(*a, impl="ref"), sets[:2],
                                iters=4, warmup=1),
            "library_ms": graph_ms(lib, lib_sets), "eager_library_ms": cuda_ms(lib, lib_sets),
            **bound(nbytes, 4 * hd * Hq * keys, BF16_TC_FLOPS)}
    line.update(ratios(line))
    print(f"[kernels] decode_attention B={B} Smax={Smax} Hq={Hq} Hkv={Hkv} hd={hd} bf16: "
          + json.dumps(line), flush=True)
    return dict(line, shape=f"q ({B},1,{Hq},{hd}), K/V ({B},{Smax},{Hkv},{hd}) bf16, ragged pos "
                            f"({line['filled_share']:.3f} of the cache filled)",
                library="F.scaled_dot_product_attention (whole cache, boolean mask, enable_gqa)")


# ---------------------------------------------------------------------------
# Phases 3-12: the served paths at full width
# ---------------------------------------------------------------------------

def pruned_keys(cfg) -> tuple:
    """The projections a served path prunes: wq/wk/wv where the config
    attends, w_gate/w_up/w_down where it has a gated MLP (w_up/w_down where
    the MLP is plain), w_in/w_out where it has the SSM mixer.  ``wo`` is
    never pruned here, nor an encoder's or the cross-attention's weights
    (the reference's ``prune_params`` walks the decoder layers only)."""
    keys = KEYS[:3] if cfg.attention != "none" else ()
    if cfg.d_ff > 0:
        keys += KEYS[3:] if cfg.gated_mlp else KEYS[4:]
    return keys + (SSM_KEYS if cfg.ssm_state else ())


def leaves(tree) -> list:
    """The tensors of a nested params dict."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def matrix_shapes(cfg, params) -> dict:
    """Each pruned key's per-layer matrix (K, N), as ``prune_params`` masks it."""
    return {k: (params["layers"][k].shape[1], math.prod(params["layers"][k].shape[2:]))
            for k in pruned_keys(cfg)}


def block_loss_check(cfg, params) -> None:
    """Kernel Eq. 1 block losses against plain losses, and the masks each
    would give.  A block whose kept/dropped state differs sits at the keep
    threshold: its gap is |plain loss - threshold| / threshold, the
    threshold being the n_keep-th largest plain loss of its matrix."""
    from repro_torch.core.flexblock import FullBlock
    from repro_torch.core.pruning import block_losses, keep_from_losses

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


def served_path(cfg, rows: dict, spec, *, flash, pre_check=None, max_len: int = 1024,
                long_prompt=None) -> dict:
    """Drive a served path with the launch counts set to 0 just before it:
    prune and compress (:func:`prune_phase`), serve the 8 requests
    (:func:`serve_phase`), read the counts and check them
    (:func:`check_path_launches`), print the peak device memory of
    serving; then run the parity phase.  Returns what the later phases
    need: config, spec, densities, matrix shapes, compressed params,
    prompts and the path's launch counts."""
    intra, moe = spec.patterns[0].kind == "intra", cfg.n_experts > 1
    model = prune_phase(cfg, spec, pre_check=pre_check)
    cparams = model["cparams"]
    torch.cuda.reset_peak_memory_stats()
    prompts, reqs, counts = serve_phase(cfg, cparams, max_len=max_len, long_prompt=long_prompt)
    print(f"[serve] {cfg.name}: peak device memory while serving "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (max_memory_allocated; card "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB)", flush=True)
    # ---- end of the path ---------------------------------------------------------
    check_path_launches(cfg, rows, model, counts, len(reqs), flash)
    # Logits have std ~1 at this init.  On an H100 (700 W) the kernel paths
    # stay within 0.06-0.07 of the plain one for llama3-8b, qwen3-4b and
    # gemma-7b and within 0.114 for gemma2-9b (bf16 over 28-42 layers),
    # while leaving out the middle layer's w_down moves them by 0.38-0.86:
    # 0.15 sits between the two.  An SSM path's faults are planted in the
    # mixer's w_out (and hymba's w_down).
    if moe:
        faults = moe_faults(cfg, cparams)
    elif cfg.ssm_state:
        faults = intrablock_faults(cfg, cparams, "w_out")
        if cfg.d_ff:
            faults.update(intrablock_faults(cfg, cparams, "w_down"))
    else:
        faults = intrablock_faults(cfg, cparams) if intra else fullblock_faults(cfg, cparams)
    t0 = time.perf_counter()
    parity_phase(cfg, cparams, prompts, [r.output for r in reqs], tol=0.15, faults=faults)
    print(f"[time] {cfg.name} parity phase {time.perf_counter() - t0:.1f}s", flush=True)
    return dict(model, prompts=prompts, counts=counts)


def prune_phase(cfg, spec, *, pre_check=None) -> dict:
    """Init ``cfg`` at full width (random bf16 weights from SEED), run
    ``pre_check(cfg, params)`` if given, then set the launch counts to 0
    and prune the config's projections (:func:`pruned_keys`) with ``spec``
    (IntraBlock row-aligned) and compress them.  An MoE's expert leaves are
    each moved to the host and pruned on their own (``prune_params``
    builds the pruned copy on the card one layer at a time and keeps its
    mask on the host), so that no leaf stands twice on the card; a mask is
    dropped once its density is read.  Checks the densities and that only
    the projections with a compressed layout were compressed (an MoE's
    expert leaves stay masked-dense); prints the peak device memory of the
    prune step.  The counts run on: the caller reads them at the end of
    its path.  Returns config, spec, densities, matrix shapes, the
    compressed params and the compressed keys."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import COMPRESSED
    from repro_torch.models.transformer import init_params
    from repro_torch.sparsity.apply import compress_params, prune_params, sparsity_report

    intra = spec.patterns[0].kind == "intra"
    moe = cfg.n_experts > 1
    host_keys = EXPERT_KEYS if moe else ()
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    keys = pruned_keys(cfg)
    shapes = matrix_shapes(cfg, params)
    n_all = sum(t.numel() for t in leaves(params))
    print(f"[prune] init {cfg.name}: {cfg.n_layers} layers"
          + (f" (and {cfg.enc_layers} encoder layers)" if cfg.enc_dec else "")
          + f", d_model {cfg.d_model}, {n_all / 1e9:.3f} G params (every weight, the "
            f"embedding included) in {time.perf_counter() - t0:.1f}s", flush=True)
    if pre_check is not None:
        pre_check(cfg, params)

    # ---- the path: counts from here to the end of the caller's serving ----------
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, masks = prune_params(params, spec, keys=tuple(k for k in keys if k not in host_keys),
                                 align_cols=intra, impl="auto", device="cuda")
    rep = sparsity_report(params, masks)
    for key in host_keys:
        t1 = time.perf_counter()
        leaf = params["layers"].pop(key).cpu()           # frees the card's copy
        t2 = time.perf_counter()
        one, m = prune_params({"layers": {key: leaf}}, spec, keys=(key,), align_cols=intra,
                              impl="auto", device="cuda")
        del leaf
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        params["layers"][key] = one["layers"][key]
        rep[f"layers/{key}"] = sparsity_report(one, m)[f"layers/{key}"]
        masks["layers"][key] = None
        del one, m
        print(f"[prune] {cfg.name}: {key} to the host {t2 - t1:.1f}s, pruned back onto the card "
              f"{t3 - t2:.1f}s, density read from its host mask {time.perf_counter() - t3:.1f}s",
              flush=True)
    if host_keys:
        sizes = {k: params["layers"][k].numel() for k in keys}
        rep["overall_density"] = (sum(rep[f"layers/{k}"] * n for k, n in sizes.items())
                                  / sum(sizes.values()))
    aligned = {}
    if intra:
        for key in keys:
            m = masks["layers"][key]
            m = m.reshape(m.shape[0], m.shape[1], -1)
            aligned[key] = bool(torch.equal(m, m[:, :, :1].expand_as(m)))
        cparams = compress_params(params, masks, m=INTRA_M)
    else:
        cparams = compress_params(params, masks, BLOCK, BLOCK)
    del params, masks
    torch.cuda.synchronize()
    prune_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    print(f"[prune] {cfg.name}: {spec.describe()}{' row-aligned' if intra else ''}, pruned + "
          f"compressed in {time.perf_counter() - t0:.1f}s; density "
          + json.dumps({k.split('/')[-1]: round(v, 6) for k, v in rep.items()})
          + (f"; row-aligned {json.dumps(aligned)}" if intra else ""), flush=True)
    for key in keys:
        check(abs(rep[f"layers/{key}"] - 0.5) < 1e-9, f"{key}: density {rep[f'layers/{key}']}")
        check(aligned.get(key, True), f"{key}: a mask is not row-aligned")
    comp_keys = tuple(k for k in keys if isinstance(cparams["layers"][k], COMPRESSED))
    dense_keys = tuple(k for k in keys if k not in comp_keys)
    check(dense_keys == (EXPERT_KEYS if moe else ()),
          f"{cfg.name}: {dense_keys} were not compressed")
    if intra:
        comp = {k: [tuple(cparams["layers"][k].w_comp.shape),
                    tuple(cparams["layers"][k].row_idx.shape)] for k in comp_keys}
        layout = "w_comp (L, Kc, N), row_idx (L, Kc)"
    else:
        comp = {k: tuple(cparams["layers"][k].w_comp.shape) for k in comp_keys}
        layout = "w_comp (L, Gn, slots, bm, bn)"
    print(f"[prune] {cfg.name}: compressed {layout}: {json.dumps(comp)}"
          + (f"; masked-dense (no compressed layout, as the reference): "
             + json.dumps({k: tuple(cparams["layers"][k].shape) for k in dense_keys})
             if dense_keys else "")
          + f"; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak of the "
            f"prune step {prune_peak / 2**30:.2f} GiB", flush=True)

    return {"cfg": cfg, "spec": spec, "density": rep, "shapes": shapes, "cparams": cparams,
            "comp_keys": comp_keys}


# Whether each served family's decode steps take the decode-attention kernel
# on every layer, stated here rather than asked of the route itself (as
# tests/test_torch_kernels.py's route test states it): the hd-128 GQA
# decoders without softcap or window do; hd 256 (gemma, paligemma), hd 64
# (hymba, whisper), a softcap (gemma2), a window (hymba) or no attention
# (mamba2) do not.
DECODE_KERNEL_ROUTE = {"llama3-8b": True, "qwen3-4b": True, "qwen3-moe-30b-a3b": True,
                       "gemma-7b": False, "gemma2-9b": False, "paligemma-3b": False,
                       "hymba-1.5b": False, "whisper-medium": False, "mamba2-130m": False}


def check_path_launches(cfg, rows: dict, model: dict, counts: dict, prefills: int,
                        flash) -> None:
    """Record the path's launches per kernel in ``rows`` and check them: the
    compressed projections ran only through the variants their widths call
    for (:func:`check_main_variants`), the block losses (FullBlock) only
    through ``strip``, the prefill attention only through flash's ``flash``
    variant, one launch per layer and prefill (or, for ``flash=None``, no
    flash launch), decode attention once a layer and decode step where
    :data:`DECODE_KERNEL_ROUTE` says the family takes it and never where it
    does not, and the other compressed op not at all."""
    intra = model["spec"].patterns[0].kind == "intra"
    op, other = (("intrablock_gather_matmul", "block_sparse_matmul") if intra
                 else ("block_sparse_matmul", "intrablock_gather_matmul"))
    cparams, keys = model["cparams"], pruned_keys(cfg)
    comp_keys = model["comp_keys"]
    for name in ("flash_attention", "block_sparse_matmul", "block_importance",
                 "intrablock_gather_matmul", "decode_attention"):
        rows[name].setdefault("launches_by_path", {})[cfg.name] = counts[name]
    # decode attention: one launch a layer and decode step where the route takes it
    family = cfg.name.removesuffix(" fine-tuned")
    check(family in DECODE_KERNEL_ROUTE, f"{cfg.name}: no decode-attention route stated")
    want = cfg.n_layers * counts["steps"] if DECODE_KERNEL_ROUTE[family] else 0
    print(f"[serve] {cfg.name}: decode_attention launches {counts['decode_attention']}; want "
          f"{want} (route {'taken' if want else 'not taken'}, {counts['steps']} decode steps)",
          flush=True)
    check(counts["decode_attention"] == want,
          f"{cfg.name}: decode_attention launched {counts['decode_attention']}, want {want}")
    check(counts[op] > 0, f"{op} was not launched on the {cfg.name} path")
    check(counts[other] == 0, f"{other} ran on the {cfg.name} path")
    check_main_variants(cfg, op, counts, prefills, cparams, comp_keys)
    if intra:
        check(counts["block_importance"] == 0, f"block_importance ran on the {cfg.name} path")
    else:
        check_single_variant(cfg, "block_importance", "strip", counts, len(keys) * cfg.n_layers)
    if flash is None:
        v = counts["variants"]["flash_attention"]
        why = ("no attention" if cfg.attention == "none"
               else "prefix-LM: chunked_attention" if cfg.prefix_len
               else f"attention softcap {cfg.attn_softcap}: chunked_attention")
        print(f"[serve] {cfg.name}: flash_attention launches by variant {json.dumps(v)}; want "
              f"none ({why})", flush=True)
        check(counts["flash_attention"] == 0 and not any(v.values()),
              f"{cfg.name}: flash_attention ran {v} on a path without flash ({why})")
    else:
        check_single_variant(cfg, "flash_attention", flash, counts, cfg.n_layers * prefills)


def main_path(cfg, rows: dict) -> dict:
    """Prune, compress, serve and check llama3-8b (FullBlock); returns what
    the cost phase needs of it."""
    from repro_torch.core.flexblock import FlexBlockSpec, FullBlock

    model = served_path(cfg, rows, FlexBlockSpec((FullBlock(BLOCK, BLOCK, 0.5),)),
                        flash="wgmma", pre_check=block_loss_check)
    for name in ("flash_attention", "block_sparse_matmul", "block_importance"):
        rows[name]["launches"] = model["counts"][name]
    return cost_inputs(model)


def cost_inputs(model: dict) -> dict:
    """What the cost phase needs of a served model (no tensor)."""
    return {k: model[k] for k in ("cfg", "spec", "density", "shapes", "ratios") if k in model}


def check_main_variants(cfg, op: str, counts: dict, prefills: int, cparams, keys) -> None:
    """The path's compressed projections ``keys`` ran only through the
    main variants, whatever their width N: each one decode launch per
    layer and decode step (4 slots) and one prefill launch per layer and
    prompt; no general or f32 launch.  The gather-matmul tiles N by 128
    with a ragged last tile and reads a weight through its row stride
    (rows padded to 16 bytes where N % 8 != 0), so the plan of each
    layer-0 leaf must name a main variant too, and the wrapper's count
    per (variant, Kc, N) must give each weight shape its leaves' share."""
    from repro_torch.kernels import _build, plans
    v = counts["variants"][op]
    n = {k: math.prod(cparams["layers"][k].out_shape) for k in keys}
    steps = counts["steps"]
    want = {"decode": len(keys) * cfg.n_layers * steps,
            "prefill": len(keys) * cfg.n_layers * prefills, "general": 0, "f32": 0}
    stride = {}
    if op == "intrablock_gather_matmul":
        for k in keys:
            w = cparams["layers"][k].w_comp[0]
            stride[k] = w.stride(0)
            plan = plans.igm_plan(4, w.shape[0], w.shape[1], w.dtype,
                                  _build.alignment(w.data_ptr()), w.stride(0))
            check(plan.variant == "decode", f"{cfg.name} {k}: plan {plan} at decode")
    print(f"[serve] {cfg.name}: {op} launches by variant {json.dumps(v)}; want "
          f"{json.dumps(want)} ({counts[op]} in all; N by projection {json.dumps(n)}"
          + (f", row stride {json.dumps(stride)}" if stride else "") + ")", flush=True)
    check(v == want and counts[op] == sum(want.values()),
          f"{op}: launches by variant {v}, want {want}")
    if op == "intrablock_gather_matmul":
        by_shape = {}
        for k in keys:
            Kc, N = cparams["layers"][k].w_comp.shape[1:]
            for variant, per in (("decode", steps), ("prefill", prefills)):
                key = (variant, Kc, N)
                if per:
                    by_shape[key] = by_shape.get(key, 0) + cfg.n_layers * per
        got = {" ".join(map(str, k)): c for k, c in sorted(counts["shapes"].items())}
        print(f"[serve] {cfg.name}: {op} launches by (variant, Kc, N) {json.dumps(got)}",
              flush=True)
        check(counts["shapes"] == by_shape,
              f"{op}: launches by (variant, Kc, N) {counts['shapes']}, want {by_shape}")


def check_single_variant(cfg, op: str, variant: str, counts: dict, want: int) -> None:
    """Every launch of ``op`` on the path ran ``variant``: ``want`` of
    them, none through ``general`` or ``f32``."""
    v = counts["variants"][op]
    print(f"[serve] {cfg.name}: {op} launches by variant {json.dumps(v)}; want {want} "
          f"{variant}", flush=True)
    check(v[variant] == want == counts[op] and sum(v.values()) == want,
          f"{op}: launches by variant {v}, want {want} {variant} and no other")


def serve_phase(cfg, cparams, *, max_len: int = 1024, long_prompt=None, n_requests: int = 8,
                new_tokens: int = 32):
    """Serve the first ``n_requests`` of 8 requests (prompts of 100..512
    tokens from numpy seed 0, the first made ``long_prompt`` tokens long
    when given, ``new_tokens`` new tokens each) through
    ``ServeEngine(slots=4, max_len=max_len)``; read the launch counts at the
    end of serving.  Returns (prompts, requests, counts)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(SEED)
    lens = rng.integers(100, 513, size=8)
    if long_prompt:
        lens[0] = long_prompt
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens][:n_requests]
    lens = lens[:n_requests]
    engine = ServeEngine(cfg, cparams, slots=4, max_len=max_len, dtype=torch.bfloat16,
                         impl="auto", device="cuda")
    reqs = [Request(prompt=p, max_new_tokens=new_tokens) for p in prompts]
    for r in reqs:
        check(engine.submit(r), "submit refused")
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    counts["variants"] = ops.variant_counts()
    shapes = ops.gather_matmul_shape_counts()      # keyed (variant, Kc, N): not JSON
    snap = engine.stats_snapshot()
    for i, r in enumerate(reqs):
        check(r.done and len(r.output) == new_tokens and r.reject_reason is None,
              f"request {i}: done={r.done} tokens={len(r.output or [])}")
    decode_tokens = snap["tokens_generated"] - len(reqs)
    print(f"[serve] {cfg.name}: {len(reqs)} requests, prompt lengths {lens.tolist()}, "
          f"{new_tokens} new tokens each: all done in {wall:.2f}s wall; "
          f"TTFT p50 {snap['ttft_s']['p50'] * 1e3:.1f} ms; "
          f"step p50 {snap['token_latency_s']['p50'] * 1e3:.2f} ms over {snap['steps']} steps; "
          f"{snap['tokens_per_s']:.1f} tokens/s (engine busy time, prefill included); "
          f"{decode_tokens} decode tokens", flush=True)
    print(f"[serve] {cfg.name}: launches on the path: {json.dumps(counts)}", flush=True)
    counts["steps"], counts["prompts"], counts["shapes"] = snap["steps"], len(reqs), shapes

    host_issue(cfg, cparams, engine.cache, 600)
    return prompts, reqs, counts


def host_issue(cfg, cparams, cache, pos: int) -> None:
    """Host or device: time the host's issue of one 4-slot decode step at
    per-slot position ``pos`` (the path has no synchronisation inside
    decode_step) against the time to its end on the card.  Issue close to
    the whole step means the card waits on the host."""
    from repro_torch.models.transformer import decode_step
    cache = dict(cache, pos=torch.full((4,), pos, dtype=torch.int64, device="cuda"))
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


def step_logits(cparams, cfg, prompt: np.ndarray, impl: str, feed=(), **extra) -> torch.Tensor:
    """f32 logits of the prompt's last token, then of one decode step per
    token of ``feed`` (teacher-forced), stacked (1 + len(feed), V).
    ``extra`` goes to ``prefill``: an encoder-decoder's ``enc_embed`` or a
    prefix-LM's ``prefix_embed`` of this prompt (batch 1)."""
    from repro_torch.models.transformer import decode_step, prefill
    lg, cache = prefill(cparams, torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None],
                        cfg, impl=impl, **extra)
    for key in ("k", "v"):
        if key in cache:
            cache[key] = F.pad(cache[key], (0, 0, 0, 0, 0, len(feed)))
    out = [lg[0, -1]]
    for t in feed:
        lg, cache = decode_step(cparams, torch.tensor([t], device="cuda"), cfg, cache, impl=impl)
        out.append(lg[0])
    return torch.stack(out)


def fullblock_faults(cfg, cparams) -> dict:
    """Planted faults in the middle layer's w_down (shared w_comp, copied
    idx): the whole projection left out, and one live 128x128 block
    dropped."""
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


def intrablock_faults(cfg, cparams, key: str = "w_down") -> dict:
    """Planted faults in the middle layer's ``key``: its w_comp zeroed (the
    whole projection left out), and its row_idx moved to the neighbouring
    row of each pair (r xor 1: every gathered input is the wrong one, each
    still inside its 4-row block)."""
    from repro_torch.models.layers import IntraBlockLinear

    wd, l = cparams["layers"][key], cfg.n_layers // 2
    zeroed = wd.w_comp.clone()
    zeroed[l] = 0
    shifted = wd.row_idx.clone()
    shifted[l] ^= 1
    bad = {f"{key} of one layer left out": IntraBlockLinear(
               zeroed, wd.row_idx, wd.in_features, wd.out_shape),
           f"{key} row_idx of one layer shifted to the neighbouring row": IntraBlockLinear(
               wd.w_comp, shifted, wd.in_features, wd.out_shape)}
    return {what: dict(cparams, layers=dict(cparams["layers"], **{key: w}))
            for what, w in bad.items()}


def moe_faults(cfg, cparams) -> dict:
    """Planted faults in the middle layer of an MoE: wv left out (its
    block list emptied, a copied idx), and the layer's expert w_down
    zeroed.  The second is made in place for the fault's run and undone
    after it: a copy of the 19 GB leaf would not fit beside the model."""
    from repro_torch.models.layers import BlockSparseLinear

    l, wv = cfg.n_layers // 2, cparams["layers"]["wv"]
    idx = wv.idx.clone()
    idx[l] = -1
    no_wv = dict(cparams, layers=dict(cparams["layers"], wv=BlockSparseLinear(
        wv.w_comp, idx, wv.in_features, wv.out_shape)))

    @contextlib.contextmanager
    def zeroed_w_down():
        wd = cparams["layers"]["w_down"][l]
        saved = wd.clone()
        wd.zero_()
        try:
            yield cparams
        finally:
            wd.copy_(saved)

    return {"wv of one layer left out": no_wv, "expert w_down of one layer zeroed": zeroed_w_down}


def route_sets(cfg, cparams, prompt, impl: str) -> torch.Tensor:
    """The top-k expert set (sorted) of every (layer, token) of the
    prompt's prefill through ``impl``: (L, S, K).  The router is applied
    to each MoE block's input as the block applies it."""
    from repro_torch.models.layers import _moe_route
    from repro_torch.models.transformer import _run

    sets = {}

    def tap(l, kind, a):
        if kind == "mlp_in":
            e = _moe_route(a.reshape(-1, a.shape[-1]), cparams["layers"]["w_router"][l],
                           cfg.top_k, a.dtype)[1]
            sets[l] = e.sort(dim=1).values
    _run(cparams, torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None], cfg, impl,
         False, tap=tap)
    return torch.stack([sets[l] for l in range(cfg.n_layers)])


def layer_parity(cfg, cparams, prompt, ref_params=None) -> tuple:
    """Each layer on the same input through both paths: the plain path's
    hidden state before layer l goes through layer l with impl="auto" (on
    ``cparams``) and with impl="ref" (on ``ref_params``, default
    ``cparams``), first as a prefill of the prompt's tokens but the last,
    then as one decode step of the last token against the plain path's
    cache entries of that layer (a copy for each path).  Returns, per
    layer, the logit difference its output difference d_l would make
    carried unchanged to the end (d_l through the final norm's scale at
    the plain path's final hidden state, then the unembedding, in f32;
    max over the prefill's positions, the decode token and the
    vocabulary), and for an MoE the share of its prefill tokens whose
    top-k set differs.  The final hidden state's scale, not the layer's
    own: the residual stream grows with depth, and normalising an early
    layer's small output by its own scale would magnify its rounding."""
    from repro_torch.models.layers import _moe_route
    from repro_torch.models.transformer import _decoder_layer, _layer, _windows

    ref_params = cparams if ref_params is None else ref_params
    routed = cfg.n_experts > 1
    tokens = torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None]
    S = tokens.shape[1] - 1
    x = ref_params["embed"][tokens[:, :S]]
    xd = ref_params["embed"][tokens[:, S:]]
    pos = torch.arange(S, device="cuda")[None]
    dpos = torch.full((1, 1), S, device="cuda")
    deltas, flips = [], []
    for l, window in enumerate(_windows(cfg)):
        lps = (_layer(cparams["layers"], l), _layer(ref_params["layers"], l))
        outs, routes, dec = [], [], []
        for impl, lp in zip(("auto", "ref"), lps):
            seen = {}
            y, new = _decoder_layer(x, lp, cfg, positions=pos, window=window, impl=impl,
                                    tap=lambda kind, a: seen.setdefault(kind, a))
            outs.append(y)
            if routed:
                routes.append(_moe_route(seen["mlp_in"][0], lp["w_router"], cfg.top_k,
                                         y.dtype)[1].sort(dim=1).values)
        for impl, lp in zip(("auto", "ref"), lps):
            # the plain path's cache entries of this layer, k/v with room for one token
            cache = {k: (F.pad(t, (0, 0, 0, 0, 0, 1)) if k in ("k", "v") else t.clone())
                     for k, t in new.items()}
            dec.append(_decoder_layer(xd, lp, cfg, positions=dpos, window=window, cache=cache,
                                      cache_len=torch.tensor(S, device="cuda"), impl=impl)[0])
        deltas.append(torch.cat([outs[0][0] - outs[1][0], dec[0][0] - dec[1][0]]))
        if routed:
            flips.append((routes[0] != routes[1]).any(dim=1).float().mean().item())
        x, xd = outs[1], dec[1]
    xf = torch.cat([x[0], xd[0]]).float()
    scale = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + cfg.norm_eps) \
        * (1.0 + ref_params["final_norm"].float())
    w = (ref_params["embed"].T if cfg.tie_embeddings else ref_params["lm_head"]).float()
    diffs = [max((d.float()[i:i + 128] * scale[i:i + 128] @ w).abs().max().item()
                 for i in range(0, d.shape[0], 128)) for d in deltas]
    return diffs, flips


def parity_phase(cfg, cparams, prompts, served, *, tol: float, faults: dict, extras=None,
                 every_fault: bool = False) -> None:
    """The served path against ``impl="ref"`` on the same compressed weights.

    Logits over 12 steps: the last prompt token of every prompt, plus
    12 - len(prompts) decode steps of the first request fed its served
    tokens (4 for 8 prompts; at most one fewer than it was served), kernels
    vs plain; ``extras`` gives each
    prompt's encoder or prefix input (batch 1) where the config takes one.  Greedy
    tokens: each served token against the plain path's argmax, required
    to agree where the plain top-2 margin exceeds 2*tol (a smaller margin
    can flip within the tolerance).  ``faults`` maps a name to a copy of
    the params with a fault planted in it, or to a context manager factory
    that plants it and yields the params; the logit error each gives over
    the same steps is reported, and the first must exceed the tolerance
    (every one on an MoE or SSM path).  Last, the served
    logits must be f32 products, as the reference's
    ``preferred_element_type=f32`` unembedding gives (then the config's
    final-logit softcap, where it has one).

    Two families can carry a last-bit difference far: an MoE's routing is
    discrete, so a bf16 difference in a router's input can move a top-k
    choice or who keeps a capacity slot; the SSM mixer rounds large
    intermediates (masked scores, carried states) to bf16, so a
    difference in one element's rounding moves others' roundings, layer
    after layer (where an SSM path passes the tolerance end to end, the
    plain path in bf16 is also held against the same weights in f32 over
    the same steps, to show that drift's size).  For
    these, each layer on the same input through both paths is printed
    (:func:`layer_parity`, the first prompt) and, for an MoE, the share of
    (layer, token) top-k sets that differ over the 8 prompts' prefill.
    The logits must stay within ``tol`` end to end; where the flips carry
    them past it, every layer must stay within ``tol`` on the same input
    instead, each planted fault given as a copy of the params must exceed
    ``tol`` read the same way (its largest layer), and the served tokens
    must agree where the plain margin exceeds twice the measured
    difference.  The first planted fault must exceed the tolerance, and
    every one of them on an MoE or SSM path or with ``every_fault``.
    """
    from repro_torch.models.layers import rms_norm, softcap
    from repro_torch.models.transformer import _run

    routed = cfg.n_experts > 1
    layered = routed or cfg.ssm_state > 0
    extras = extras or [{}] * len(prompts)
    feed = served[0][:min(12 - len(prompts), len(served[0]) - 1)]

    def steps(params, impl):
        return torch.cat([step_logits(params, cfg, prompts[0], impl, feed, **extras[0])]
                         + [step_logits(params, cfg, p, impl, **e)
                            for p, e in zip(prompts[1:], extras[1:])])

    auto, plain = steps(cparams, "auto"), steps(cparams, "ref")
    want = served[0][:len(feed) + 1] + [out[0] for out in served[1:]]
    err = (auto - plain).abs().amax(dim=1)
    top2 = plain.topk(2, dim=1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    picked = plain.argmax(dim=1).tolist()
    e2e = err.max().item()
    print(f"[parity] {cfg.name}: kernels vs impl=ref over {len(margins)} steps ({len(prompts)} "
          f"prompts' last token, {len(feed)} decode steps of request 0): max |dlogit| {e2e:.4f} "
          f"(tol {tol}), per step {[round(e, 4) for e in err.tolist()]}", flush=True)
    layer_max = None
    if routed:
        differ = total = 0
        for p in prompts:
            a, b = route_sets(cfg, cparams, p, "auto"), route_sets(cfg, cparams, p, "ref")
            differ += int((a != b).any(dim=2).sum())
            total += a.shape[0] * a.shape[1]
        print(f"[parity] {cfg.name}: routing, kernels vs impl=ref over the 8 prompts' prefill: "
              f"{differ} of {total} (layer, token) top-{cfg.top_k} sets differ "
              f"({differ / total:.4%})", flush=True)
    if layered:
        t0 = time.perf_counter()
        diffs, flips = layer_parity(cfg, cparams, prompts[0])
        layer_max = max(diffs)
        print(f"[parity] {cfg.name}: each layer on the same input (request 0, a prefill of its "
              f"first {len(prompts[0]) - 1} tokens and a decode step of its last): max |dlogit| "
              f"of a layer's output {layer_max:.4f} (tol {tol}), per layer "
              f"{[round(d, 4) for d in diffs]}"
              + (f", top-k sets that differ per layer {[round(f, 4) for f in flips]}"
                 if routed else "") + f" ({time.perf_counter() - t0:.1f}s)", flush=True)
    fallback = layered and e2e > tol
    bound = e2e if fallback else tol
    decided = [i for i, m in enumerate(margins) if m > 2 * bound]
    wrong = [i for i in decided if picked[i] != want[i]]
    print(f"[parity] {cfg.name}: served tokens vs impl=ref argmax: agree on "
          f"{sum(p == w for p, w in zip(picked, want))} of {len(want)} steps; "
          f"{len(decided)} steps have a ref top-2 margin above {2 * bound:.4f} and must agree, "
          f"{len(wrong)} do not; margins {[round(m, 4) for m in margins]}", flush=True)

    fault_err = {}
    for what, bad in faults.items():
        with (bad() if callable(bad) else contextlib.nullcontext(bad)) as p:
            fault_err[what] = (steps(p, "auto") - plain).abs().max().item()
    print(f"[parity] {cfg.name}: planted faults, max |dlogit| vs impl=ref over the same "
          f"{len(margins)} steps: " + json.dumps({k: round(v, 4) for k, v in fault_err.items()}),
          flush=True)
    if fallback and cfg.ssm_state:
        drift = (steps(f32_copy(cparams), "ref") - plain).abs().max().item()
        print(f"[parity] {cfg.name}: the plain path in bf16 against the same weights in f32 over "
              f"the same {len(margins)} steps: max |dlogit| {drift:.4f} (bf16 rounding drift "
              f"end to end, beside the kernels' {e2e:.4f})", flush=True)
    if fallback:
        # read layer by layer, against the unfaulted plain path on the same input
        for what, bad in faults.items():
            if not callable(bad):
                fault_err[what] = max(layer_parity(cfg, bad, prompts[0], ref_params=cparams)[0])
        print(f"[parity] {cfg.name}: end to end past the tolerance, so each planted fault read "
              f"as its largest layer on the same input (the in-place ones end to end): "
              + json.dumps({k: round(v, 4) for k, v in fault_err.items()}), flush=True)

    # f32 unembedding: the served prefill logits against an f32 product
    # of the final hidden state and the whole unembedding widened to f32.
    x, _ = _run(cparams, torch.as_tensor(prompts[0], dtype=torch.long, device="cuda")[None],
                cfg, "auto", False, **extras[0])
    h = rms_norm(x[0, -1:], cparams["final_norm"], cfg.norm_eps)
    w = cparams["embed"].T if cfg.tie_embeddings else cparams["lm_head"]
    f32 = softcap((h.float() @ w.float())[0], cfg.logit_softcap)
    rounded = softcap((h @ w).float()[0], cfg.logit_softcap)
    e32 = (auto[0] - f32).abs().max().item()
    e16 = (rounded - f32).abs().max().item()
    del f32, rounded
    print(f"[parity] {cfg.name}: served prefill logits vs an f32 unembedding: max |d| "
          f"{e32:.3e} (tol 1e-4); bf16-rounded logits would differ by {e16:.3e}", flush=True)
    if fallback:
        check(layer_max <= tol, f"logits differ by {e2e} > {tol} end to end, and a layer on the "
                                f"same input by {layer_max} > {tol}")
    else:
        check(e2e <= tol, f"logits differ by {e2e} > {tol}")
    check(not wrong, f"served tokens differ from impl=ref at decided steps {wrong}")
    for what in (fault_err if layered or every_fault else list(fault_err)[:1]):
        check(fault_err[what] > tol, f"{what}: stays within the logit tolerance {tol}")
    check(e32 <= 1e-4, f"served logits are not f32 products: {e32} > 1e-4")


# ---------------------------------------------------------------------------
# Phases 4-5: the qwen3-4b IntraBlock path and its §IV-B profile
# ---------------------------------------------------------------------------

def intrablock_path(cfg, rows: dict) -> dict:
    """Prune, compress, serve, check and profile qwen3-4b; returns what the
    cost phase needs of it, the profile's ratios included."""
    from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock

    model = served_path(cfg, rows, FlexBlockSpec((IntraBlock(INTRA_M, 1, 0.5),)),
                        flash="wgmma")
    for name in ("intrablock_gather_matmul", "decode_attention"):
        rows[name]["launches"] = model["counts"][name]
    model["ratios"] = profile_phase(cfg, model["cparams"], model["prompts"], rows)
    return cost_inputs(model)


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
    rows["bitserial_zero_profile"]["launches_by_path"] = {
        f"{cfg.name} profile": counts["bitserial_zero_profile"]}
    for v, line in rows["bitserial_zero_profile"]["variants"].items():
        line["launches"] = variants[v]

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


# ---------------------------------------------------------------------------
# Phase 5b: training on the card — qwen3-4b sparse-fine-tuned, then served
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6
TRAIN_SEQ = 512
TRAIN_BATCH = 2          # global batch, in 2 microbatches of 1
MEMORY_LIMIT_GIB = 79.18
LAYER0_GRADS = ("wq", "wk", "wv", "q_norm", "k_norm", "wo", "w_gate", "w_up", "w_down")


def train_phase(cfg, rows: dict) -> None:
    """Train ``cfg`` (qwen3-4b) at full width and depth on the card for
    TRAIN_STEPS steps with the masks it is served with, then serve the
    fine-tuned weights (module docstring, phase 5b)."""
    from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import REMAT_POLICIES, init_params
    from repro_torch.sparsity.apply import compress_params, prune_params
    from repro_torch.train.optimizer import AdamWConfig, global_norm
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import map_with_path

    spec = FlexBlockSpec((IntraBlock(INTRA_M, 1, 0.5),))
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, dtype=torch.bfloat16, device="cuda")
    pruned, masks = prune_params(params, spec, keys=KEYS, align_cols=True, impl="auto",
                                 device="cuda")
    del params, pruned
    gc.collect()
    torch.cuda.empty_cache()
    density = {k: torch.count_nonzero(masks["layers"][k]).item() / masks["layers"][k].numel()
               for k in KEYS}
    check(all(d == 0.5 for d in density.values()), f"mask densities {density}")
    print(f"[train] {cfg.name}: masks from prune_params, {spec.describe()} row-aligned on "
          f"{list(KEYS)}, density {json.dumps(density)}, in {time.perf_counter() - t0:.1f}s",
          flush=True)

    pcfg = PipelineConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=SEED)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, ocfg, TrainerConfig(steps=TRAIN_STEPS, microbatches=2,
                                              param_dtype=torch.bfloat16, ckpt_dir=None,
                                              seed=SEED, device="cuda"),
                      TokenPipeline(pcfg), masks=masks, remat=True, remat_policy="minimal")
    torch.cuda.synchronize()
    print(f"[train] {cfg.name}: Trainer (dense bf16 init from seed {SEED}, f32 AdamW state) in "
          f"{time.perf_counter() - t0:.1f}s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    # ---- the wrapped step: stage events, step-1 grads, checks after each step ----
    # (the trainer retries a step that raises, so what fails inside a step is
    # recorded in ``failures`` and checked after the run)
    step = trainer.step_fn
    marks, walls, layer0, failures, zeros = [], [], {}, [], {}

    def on_stage(stage, grads):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1][stage] = (ev, time.perf_counter())
        if stage == "grads" and len(marks) == 1:
            layer0.update({k: grads["layers"][k][0].float().norm().item() for k in LAYER0_GRADS})
            layer0["embed"] = grads["embed"].float().norm().item()

    def timed(params, opt_state, batch):
        ev = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ev.record()
        marks.append({"start": (ev, t)})
        try:
            out = step(params, opt_state, batch)
        except Exception as e:
            failures.append(f"step call {len(marks)}: {type(e).__name__}: {e}")
            marks.pop()
            raise
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        marks[-1]["end"] = (end, time.perf_counter())
        walls.append(time.perf_counter() - t)
        for k in KEYS:
            w, m = params["layers"][k], masks["layers"][k]
            if ((w != 0) & ~m).any():
                failures.append(f"step {len(walls)}: {k} nonzero off its mask")
            if torch.count_nonzero(m).item() != m.numel() // 2:
                failures.append(f"step {len(walls)}: {k} mask density is not the spec's 0.5")
            # a kept weight may step onto exactly 0.0; counted, not a fault
            zeros[k] = m.sum().item() - torch.count_nonzero(w).item()
        return out

    step.on_stage = on_stage
    trainer.step_fn = timed
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    log = trainer.train()
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = ops.launch_counts()
    variants = ops.variant_counts()
    # ---- end of the train steps -----------------------------------------------------
    check(not failures, f"train steps: {failures}")
    losses = [m["loss"] for m in log]
    norms = [m.get("grad_norm", float("nan")) for m in log]
    check(len(log) == len(walls) == TRAIN_STEPS and [m["step"] for m in log]
          == list(range(TRAIN_STEPS)) and trainer.skipped_nonfinite == 0,
          f"{len(log)} steps logged, {len(walls)} step calls, "
          f"{trainer.skipped_nonfinite} skipped: a step raised or was skipped")
    check(all(math.isfinite(x) for x in losses + norms) and all(n > 0 for n in norms),
          f"losses {losses}, grad norms {norms}")
    check(all(v > 0 for v in layer0.values()), f"step 1: a zero grad in layer 0 {layer0}")
    check(not any(counts.values()) and not any(any(v.values()) for v in variants.values()),
          f"kernels launched in the train steps: {counts}")
    check(peak < MEMORY_LIMIT_GIB, f"train peak {peak:.2f} GiB >= {MEMORY_LIMIT_GIB}")
    for name in counts:
        rows[name].setdefault("launches_by_path", {})[f"{cfg.name} train steps"] = counts[name]

    def ms(a, b, m):
        return m[a][0].elapsed_time(m[b][0])

    fb = statistics.median(ms("start", "grads", m) for m in marks)
    msk = statistics.median(ms("grads", "grad masks", m) + ms("optimizer", "param masks", m)
                            for m in marks)
    opt = statistics.median(ms("grad masks", "optimizer", m) for m in marks)
    card = statistics.median(ms("start", "end", m) for m in marks)
    issue = statistics.median((m["grads"][1] - m["start"][1]) * 1e3 for m in marks)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    p50 = statistics.median(walls)
    print(f"[train] {cfg.name}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
          f"(2 microbatches, remat minimal, masks on {len(KEYS)} projections) in "
          f"{t_train:.1f}s; step wall p50 {p50 * 1e3:.1f} ms (host clock, to its end on the "
          f"card; per step {[round(w * 1e3, 1) for w in walls]}), {tokens / p50:.0f} tokens/s",
          flush=True)
    print(f"[train] {cfg.name}: split by CUDA events, p50 over the steps: forward+backward "
          f"{fb:.1f} ms, optimizer (the loss read + AdamW) {opt:.1f} ms, mask application "
          f"{msk:.1f} ms, the step on the card {card:.1f} ms; host issue of forward+backward "
          f"{issue:.1f} ms against its {fb:.1f} ms on the card ({issue / fb:.0%})", flush=True)
    print(f"[train] {cfg.name}: loss curve {[round(x, 4) for x in losses]} (ln V = "
          f"{math.log(cfg.vocab_size):.4f}); grad_norm {[round(x, 4) for x in norms]}; lr "
          f"{[round(m['lr'], 9) for m in log]}", flush=True)
    print(f"[train] {cfg.name}: step 1 grad norms of layer 0 and embed "
          f"{json.dumps({k: float(f'{v:.4g}') for k, v in layer0.items()})}; after the last "
          f"step every pruned leaf is zero off its mask (density 0.5), kept weights at exactly "
          f"0.0 {json.dumps(zeros)}; launches in the steps {json.dumps(counts)}; peak device "
          f"memory of the train steps {peak:.2f} GiB (limit {MEMORY_LIMIT_GIB})", flush=True)

    # ---- remat: one forward + backward per policy at one microbatch -----------------
    trainer.opt_state = None                     # free m/v (32 GB)
    gc.collect()
    torch.cuda.empty_cache()
    batch = TokenPipeline(pcfg).next_batch()
    batch = {k: torch.as_tensor(v[:1], device="cuda") for k, v in batch.items()}
    remat = {}
    for policy in (None, *REMAT_POLICIES):
        kw = {"remat": policy is not None, "remat_policy": policy or "minimal"}
        st = make_train_step(cfg, ocfg, **kw)
        # what the forward keeps for the backward: memory held after it alone
        alias = map_with_path(lambda _, p: p.detach().requires_grad_(), trainer.params)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss = st.loss_fn(alias, batch, **kw)
        torch.cuda.synchronize()
        saved = (torch.cuda.memory_allocated() - before) / 2**30
        del loss, alias
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss, grads = st.grads(trainer.params, batch)
        gn = global_norm(grads).item()
        torch.cuda.synchronize()
        remat[policy or "none"] = {"loss": loss.item(), "grad_norm": gn,
                                   "saved_after_forward_gib": saved,
                                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                                   "above_base_gib": (torch.cuda.max_memory_allocated() - base)
                                   / 2**30, "ms": (time.perf_counter() - t) * 1e3}
        del grads
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[train] {cfg.name}: remat, one forward + backward of 1 x {TRAIN_SEQ} tokens each, "
          f"no update (saved_after_forward: held after the forward alone; ms: host clock to "
          f"the end on the card): " + json.dumps({k: {n: float(f"{x:.7g}") for n, x in v.items()}
                                       for k, v in remat.items()}), flush=True)
    none = remat["none"]
    check(remat["nothing"]["peak_gib"] < none["peak_gib"],
          f"remat nothing peak {remat['nothing']['peak_gib']} >= no remat {none['peak_gib']}")
    for policy, r in remat.items():
        # 1e-6 relative: the same f32 accumulation, recomputed (the embedding's
        # grad sums with atomics, in any order)
        for key in ("loss", "grad_norm"):
            check(abs(r[key] - none[key]) <= 1e-6 * abs(none[key]),
                  f"remat {policy}: {key} {r[key]} vs {none[key]} without remat")

    # ---- serve the fine-tuned weights ------------------------------------------------
    t0 = time.perf_counter()
    cparams = compress_params(trainer.params, masks, m=INTRA_M)
    trainer.params = None
    del trainer, step, masks
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] {cfg.name}: fine-tuned weights compressed in {time.perf_counter() - t0:.1f}s;"
          f" device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    served = dataclasses.replace(cfg, name=f"{cfg.name} fine-tuned")
    ops.reset_launch_counts()
    prompts, reqs, counts = serve_phase(served, cparams, n_requests=4, new_tokens=8)
    model = {"spec": spec, "cparams": cparams, "comp_keys": KEYS}
    check_path_launches(served, rows, model, counts, len(reqs), "wgmma")
    parity_phase(served, cparams, prompts, [r.output for r in reqs], tol=0.15,
                 faults=intrablock_faults(cfg, cparams))
    print(f"[train] card {card_line()}", flush=True)


# ---------------------------------------------------------------------------
# Phases 6-7: the gemma family
# ---------------------------------------------------------------------------

LONG_PROMPT = 4600      # gemma2-9b's long request: past its 4096-token local window


def gemma7b_path(cfg, rows: dict) -> dict:
    """Prune (row-aligned IntraBlock), compress, serve and check gemma-7b,
    whose prefill attention runs flash's wgmma variant at head dim 256;
    then that variant's card time per prefill of the 8 prompts."""
    from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock
    from repro_torch.kernels import ops

    model = served_path(cfg, rows, FlexBlockSpec((IntraBlock(INTRA_M, 1, 0.5),)),
                        flash="wgmma")
    rows["flash_attention"]["variants"][f"wgmma hd 256/{cfg.name}"]["launches"] = \
        model["counts"]["flash_attention"]
    # one launch per layer at each prompt's padded length, on random bf16
    # q/k/v of the layer's shape, replayed from CUDA graphs
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def padded(p):
        return -(-len(p) // 128) * 128

    per_len = {}
    for S in sorted({padded(p) for p in model["prompts"]}):
        sets = [tuple(torch.randn(1, S, H, hd, generator=g, device="cuda").to(torch.bfloat16)
                      for H in (Hq, Hkv, Hkv))
                for _ in range(n_copies(2 * S * (Hq + Hkv) * hd * 2))]
        per_len[S] = graph_ms(lambda q, k, v: ops.flash_attention(q, k, v, causal=True), sets)
        del sets
    per_prefill = [cfg.n_layers * per_len[padded(p)] for p in model["prompts"]]
    print(f"[serve] {cfg.name}: flash wgmma (hd {hd}) card ms per launch by padded prompt "
          f"length {json.dumps({str(k): round(v, 4) for k, v in per_len.items()})}; per prefill "
          f"({cfg.n_layers} launches) {[round(t, 3) for t in per_prefill]} ms, "
          f"{sum(per_prefill):.3f} ms over the 8 prompts", flush=True)
    return cost_inputs(model)


def gemma2_path(cfg, rows: dict) -> dict:
    """Prune (FullBlock), compress, serve and check gemma2-9b with one
    request of LONG_PROMPT tokens, then the window check and the
    softcaps' reach."""
    from repro_torch.core.flexblock import FlexBlockSpec, FullBlock

    model = served_path(cfg, rows, FlexBlockSpec((FullBlock(BLOCK, BLOCK, 0.5),)), flash=None,
                        max_len=5120, long_prompt=LONG_PROMPT)
    t0 = time.perf_counter()
    window_check(cfg, model["cparams"], model["prompts"][0])
    print(f"[time] {cfg.name} window check {time.perf_counter() - t0:.1f}s", flush=True)
    return cost_inputs(model)


def window_check(cfg, cparams, prompt) -> None:
    """Layer 0 (a local layer) on the long prompt: its attention through
    ``chunked_attention`` with ``window=cfg.window`` must equal the same
    call with ``window=None`` bit for bit on the query rows before
    position cfg.window (the mask is all true there, so the same code
    gives the same bits) and differ on every row from it on.  In f32, so
    that the one key row cfg.window drops shows after rounding.  Where the
    prefill attention runs flash (no attention softcap), flash's output on
    the same bf16 q/k/v must equal ``chunked_attention(window=cfg.window)``
    within 3e-2, through the variant the path ran.  Where the config has
    softcaps, prints how far layer 0's raw scores and the raw final logits
    reach toward them."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import (chunked_attention, project, rms_norm, rope,
                                           self_attention)
    from repro_torch.models.transformer import _layer, _run, _unembed, _windows

    W, cap = cfg.window, cfg.attn_softcap
    check(_windows(cfg)[0] == W, f"{cfg.name}: layer 0 is not a local layer")
    tokens = torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None]
    S = tokens.shape[1]
    check(S > W, f"the long prompt ({S}) does not pass the window {W}")
    lp = _layer(cparams["layers"], 0)
    h = rms_norm(cparams["embed"][tokens], lp["ln1"], cfg.norm_eps)
    pos = torch.arange(S, device="cuda")[None]
    q, k, v = (project(h, lp[w]) for w in ("wq", "wk", "wv"))
    if cfg.qk_norm:
        q, k = rms_norm(q, lp["q_norm"], cfg.norm_eps), rms_norm(k, lp["k_norm"], cfg.norm_eps)
    qb, kb, vb = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v
    q, k, v = qb.float(), kb.float(), vb.float()
    win = chunked_attention(q, k, v, causal=True, window=W, attn_cap=cap)
    glob = chunked_attention(q, k, v, causal=True, window=None, attn_cap=cap)
    same = torch.equal(win[:, :W], glob[:, :W])
    rows_differ = int((win[:, W:] != glob[:, W:]).flatten(2).any(dim=2).sum())
    d_max = (win[:, W:] - glob[:, W:]).abs().max().item()
    print(f"[window] {cfg.name}: layer 0 (window {W}) on the {S}-token prompt, chunked_attention "
          f"in f32 with window {W} vs none: rows < {W} bit-equal: {same}; rows >= {W} that "
          f"differ: {rows_differ} of {S - W} (max |d| {d_max:.3e})", flush=True)
    check(same, f"{cfg.name}: the window changed a row before position {W}")
    check(rows_differ == S - W, f"{cfg.name}: {S - W - rows_differ} rows past the window "
                                f"equal the global attention")
    if not cap:
        before = ops.variant_counts()["flash_attention"]
        fa = self_attention(qb, kb, vb, window=W, impl="cuda")
        variant = moved_variant("flash_attention", before)
        plain = chunked_attention(qb, kb, vb, causal=True, window=W)
        err = (fa.float() - plain.float()).abs().max().item()
        print(f"[window] {cfg.name}: layer 0's attention on the {S}-token prompt through flash "
              f"({variant} variant, q ({S} padded to {-(-S // 128) * 128}) x {qb.shape[2]} heads "
              f"of {qb.shape[3]}, {kb.shape[2]} kv heads, window {W}) vs chunked_attention with "
              f"window {W}, both on the bf16 q/k/v: max |d| {err:.3e} (tol 3e-2)", flush=True)
        check(variant == "wgmma", f"{cfg.name}: flash ran the {variant} variant")
        check(err <= 3e-2, f"{cfg.name}: flash differs from chunked_attention by {err}")
        return

    Hkv, hd = k.shape[2], k.shape[3]
    qg = q.reshape(1, S, Hkv, -1, hd)
    s_max = max((torch.einsum("bqhgd,bkhd->bhgqk", qg[:, i:i + 1024], k) / math.sqrt(hd))
                .abs().max().item() for i in range(0, S, 1024))
    x, _ = _run(cparams, tokens, cfg, "auto", False)
    z_max = _unembed(cparams, x[:, -64:], dataclasses.replace(cfg, logit_softcap=0.0)) \
        .abs().max().item()
    below = s_max < cap and z_max < cfg.logit_softcap
    print(f"[softcap] {cfg.name}: layer 0's raw attention scores on the long prompt reach "
          f"max |s| {s_max:.3f} (cap {cap}); the raw final logits of its last 64 tokens reach "
          f"max |z| {z_max:.3f} (cap {cfg.logit_softcap}); "
          + ("both below their caps: with random weights a planted 'softcap off' fault would "
             "not show on the card, so the caps are held to the reference by the CPU tests "
             "(tests/test_torch_gemma.py), which scale the inputs until each cap bites"
             if below else "a cap is reached on the card"), flush=True)


# ---------------------------------------------------------------------------
# Phase 8: the MoE family
# ---------------------------------------------------------------------------

def host_memory_gib() -> dict:
    """The host's total and available memory (``free -g``'s columns), GiB."""
    info = dict(line.split(":", 1) for line in Path("/proc/meminfo").read_text().splitlines())
    return {k: int(info[k].split()[0]) / 2**20 for k in ("MemTotal", "MemAvailable")}


def dense_scale_experts(cfg, params) -> None:
    """Give every expert the std of a dense MLP of its own shape (1/sqrt(d)
    for w_gate/w_up, 1/sqrt(ff) for w_down), in place: the init's rule
    counts E in an expert leaf's fan_in (E·d), which leaves the MoE
    block's output ~E^-1.5 (1/1448 at 128 experts) of a dense MLP's, so
    small beside attention that no routing choice or planted expert fault
    could show in the logits."""
    for key in EXPERT_KEYS:
        params["layers"][key].mul_(math.sqrt(cfg.n_experts))
    torch.cuda.synchronize()
    print(f"[moe] {cfg.name}: expert leaves scaled by sqrt(E) = {math.sqrt(cfg.n_experts):.4f} "
          f"to a dense MLP's std (w_up std now "
          f"{params['layers']['w_up'][0].float().std().item():.5f}, "
          f"1/sqrt(d) = {1 / math.sqrt(cfg.d_model):.5f})", flush=True)


def moe_path(cfg, rows: dict) -> dict:
    """Prune (FullBlock), compress, serve and check qwen3-moe-30b-a3b at
    full width and depth: 61 GB of bf16 weights, 58 GB of them in the
    expert leaves (scaled as :func:`dense_scale_experts` says), which are
    moved to the host and pruned one key at a time (see
    :func:`served_path`) and stay masked-dense; wq/wk/wv run through the
    block-sparse kernel."""
    from repro_torch.core.flexblock import FlexBlockSpec, FullBlock

    mem = host_memory_gib()
    print(f"[moe] host memory: total {mem['MemTotal']:.1f} GiB, available "
          f"{mem['MemAvailable']:.1f} GiB; device memory reserved before the path "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB, allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(mem["MemAvailable"] > 40, "the host cannot hold one expert leaf and its mask")
    model = served_path(cfg, rows, FlexBlockSpec((FullBlock(BLOCK, BLOCK, 0.5),)),
                        flash="wgmma", pre_check=dense_scale_experts)
    # prompt 0's prefill logits, for the mesh phase's diagnostic on the same weights
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(step_logits(model["cparams"], cfg, model["prompts"][0], "auto")[0].cpu(),
               MOE_LOGITS)
    return cost_inputs(model)


# ---------------------------------------------------------------------------
# Phases 9-10: the SSM family
# ---------------------------------------------------------------------------

HYMBA_PROMPT = 1600     # hymba-1.5b's long request: past its 1024-token window
CHUNKED, RECURRENT = 300, 236    # the recurrence check's prompt, and its prefill part
# f32, plain path.  Layer by layer (each mixer on the same input) the
# chunked SSD and the recurrence are the same sums in another order: a
# chunk sums at most 256 decayed terms, so they differ by ~256 f32 unit
# roundoffs (1.5e-5) of the largest value; 1e-4 leaves room.  End to end
# the 24 layers amplify such differences: at this init a 1e-6 relative
# change of the embedding moves the f32 logits (std ~1) by ~1e-3 (the
# check prints it), so the logits are held to 2e-2 and the final states
# to 1e-3 of their largest value.
RECUR_LAYER_RTOL, RECUR_LOGIT_TOL, RECUR_STATE_RTOL = 1e-4, 2e-2, 1e-3


def f32_copy(cparams) -> dict:
    """The compressed params in f32 (IntraBlockLinear w_comp widened, the
    same rows kept), for the plain path."""
    from repro_torch.models.layers import IntraBlockLinear

    def widen(w):
        if isinstance(w, IntraBlockLinear):
            return IntraBlockLinear(w.w_comp.float(), w.row_idx, w.in_features, w.out_shape,
                                    _checked=True)
        return w.float()
    return {k: ({n: widen(w) for n, w in v.items()} if k == "layers" else widen(v))
            for k, v in cparams.items()}


def rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def mixer_recurrence(cfg, p32, toks, zero_conv: bool = False) -> dict:
    """Each layer's SSM mixer on the same input (the chunked plain path's
    normed hidden state before it): ``ssm_block`` over the CHUNKED tokens
    against ``ssm_block`` over the first RECURRENT and one single-step call
    per later token (with the conv state zeroed before them if
    ``zero_conv``).  Returns the largest relative difference over layers
    of the outputs of the recurrent tokens, the final SSM state and the
    final conv state."""
    from repro_torch.models.layers import rms_norm, ssm_block
    from repro_torch.models.transformer import _decoder_layer, _layer

    x = p32["embed"][toks]
    pos = torch.arange(CHUNKED, device="cuda")[None]
    worst = {"y": 0.0, "ssm": 0.0, "conv": 0.0}
    for l in range(cfg.n_layers):
        lp = _layer(p32["layers"], l)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, state, conv = ssm_block(h, lp, cfg, impl="ref")
        _, st, cv = ssm_block(h[:, :RECURRENT], lp, cfg, impl="ref")
        if zero_conv:
            cv = torch.zeros_like(cv)
        ys = []
        for t in range(RECURRENT, CHUNKED):
            yt, st, cv = ssm_block(h[:, t:t + 1], lp, cfg, state=st, conv_state=cv, impl="ref")
            ys.append(yt)
        for key, a, b in (("y", torch.cat(ys, dim=1), y[:, RECURRENT:]), ("ssm", st, state),
                          ("conv", cv, conv)):
            worst[key] = max(worst[key], rel(a, b))
        x, _ = _decoder_layer(x, lp, cfg, positions=pos, impl="ref")
    return worst


def recurrence_check(cfg, cparams, prompt) -> None:
    """The chunked SSD against the single-step recurrence, in f32 on the
    plain path, for the prompt's first CHUNKED tokens (one full chunk of
    256 and a ragged one): each layer's mixer on the same input
    (:func:`mixer_recurrence`), then end to end, ``prefill`` of the
    CHUNKED tokens against ``prefill`` of the first RECURRENT and one
    ``decode_step`` per token after them: the final SSM and conv states,
    the last logits, and the logits of every decode step against
    ``forward``'s at its position.  A planted fault, the conv state zeroed
    before the decodes, must exceed each logit and output tolerance (the
    SSM state forgets it within the 64 steps, so the final state cannot
    show it)."""
    from repro_torch.models.transformer import decode_step, forward, prefill

    t0 = time.perf_counter()
    check(len(prompt) >= CHUNKED, f"prompt of {len(prompt)} tokens, want {CHUNKED}")
    p32 = f32_copy(cparams)
    toks = torch.as_tensor(prompt[:CHUNKED], dtype=torch.long, device="cuda")[None]
    layer, layer_bad = mixer_recurrence(cfg, p32, toks), mixer_recurrence(cfg, p32, toks, True)
    full = forward(p32, toks, cfg, impl="ref")[0]
    nudged = forward(dict(p32, embed=p32["embed"] * (1 + 1e-6)), toks, cfg, impl="ref")[0]
    last, chunked = prefill(p32, toks, cfg, impl="ref")

    def recurrent(zero_conv: bool):
        _, cache = prefill(p32, toks[:, :RECURRENT], cfg, impl="ref")
        if zero_conv:
            cache["conv"].zero_()
        steps = []
        for t in range(RECURRENT, CHUNKED):
            lg, cache = decode_step(p32, toks[:, t], cfg, cache, impl="ref")
            steps.append(lg[0])
        return torch.stack(steps), cache

    steps, cache = recurrent(False)
    bad_steps, _ = recurrent(True)
    want = full[RECURRENT:CHUNKED]
    d_last = (steps[-1] - last[0, -1]).abs().max().item()
    d_steps = (steps - want).abs().max().item()
    d_state = {k: rel(cache[k], chunked[k]) for k in ("ssm", "conv")}
    d_fault = (bad_steps - want).abs().max().item()
    d_nudge = (nudged - full).abs().max().item()
    fmt = lambda d: json.dumps({k: float(f"{v:.3e}") for k, v in d.items()})
    print(f"[ssm] {cfg.name}: chunked SSD (chunk {cfg.ssm_chunk}, {CHUNKED} tokens) vs the "
          f"recurrence ({RECURRENT} tokens, then {CHUNKED - RECURRENT} single steps), f32 plain "
          f"path; each layer's mixer on the same input, max |d| / max |value| over layers: "
          f"{fmt(layer)} (tol {RECUR_LAYER_RTOL}), with the conv state zeroed before the steps "
          f"{fmt(layer_bad)}", flush=True)
    print(f"[ssm] {cfg.name}: end to end (prefill, then decode_step): last logits max |d| "
          f"{d_last:.3e}, every decode step's logits vs forward {d_steps:.3e} (tol "
          f"{RECUR_LOGIT_TOL}), final states {fmt(d_state)} (tol {RECUR_STATE_RTOL}); with the "
          f"conv state zeroed before the decodes, decode logits {d_fault:.3e}; f32 sensitivity: "
          f"the embedding scaled by 1 + 1e-6 moves forward's logits by {d_nudge:.3e} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    check(max(layer.values()) <= RECUR_LAYER_RTOL,
          f"{cfg.name}: a layer's recurrence differs from its chunked SSD: {layer}")
    check(max(d_last, d_steps) <= RECUR_LOGIT_TOL,
          f"{cfg.name}: recurrence differs from the chunked SSD by {max(d_last, d_steps)}")
    check(max(d_state.values()) <= RECUR_STATE_RTOL, f"{cfg.name}: states differ {d_state}")
    check(layer_bad["y"] > RECUR_LAYER_RTOL and d_fault > RECUR_LOGIT_TOL,
          f"{cfg.name}: a zeroed conv state stays within the tolerances")


def mamba2_path(cfg, rows: dict) -> dict:
    """Prune (row-aligned IntraBlock), compress, serve and check
    mamba2-130m at full width and depth, then the chunked SSD against the
    recurrence."""
    from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock

    model = served_path(cfg, rows, FlexBlockSpec((IntraBlock(INTRA_M, 1, 0.5),)), flash=None)
    ssm_launches(cfg, rows, model)
    recurrence_check(cfg, model["cparams"], model["prompts"][0])
    return cost_inputs(model)


def ssm_launches(cfg, rows: dict, model: dict) -> None:
    """Give the kernel rows of an SSM path's w_in (decode and prefill)
    their launches on the path, as the wrapper counted them by weight
    shape: w_in's (Kc, N) is no other compressed leaf's on these paths,
    so the count at its shape is w_in's own."""
    from repro_torch.models.layers import COMPRESSED
    leaves = model["cparams"]["layers"]
    shape = lambda k: tuple(leaves[k].w_comp.shape[1:])
    Kc, N = shape("w_in")
    others = [k for k in leaves if k != "w_in" and isinstance(leaves[k], COMPRESSED)
              and shape(k) == (Kc, N)]
    check(not others, f"{cfg.name}: {others} share w_in's shape ({Kc}, {N})")
    variants = rows["intrablock_gather_matmul"]["variants"]
    for variant in ("decode", "prefill"):
        variants[f"{variant}/{cfg.name} w_in"]["launches"] = \
            model["counts"]["shapes"].get((variant, Kc, N), 0)


def hymba_path(cfg, rows: dict) -> dict:
    """Prune (row-aligned IntraBlock), compress, serve and check hymba-1.5b
    at full width and depth with one request of HYMBA_PROMPT tokens, then
    the window check on layer 0 with flash beside chunked_attention."""
    from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock

    model = served_path(cfg, rows, FlexBlockSpec((IntraBlock(INTRA_M, 1, 0.5),)),
                        flash="wgmma", max_len=2048, long_prompt=HYMBA_PROMPT)
    ssm_launches(cfg, rows, model)
    rows["flash_attention"]["variants"][f"wgmma hd 64/{cfg.name}"]["launches"] = \
        model["counts"]["variants"]["flash_attention"]["wgmma"]
    t0 = time.perf_counter()
    window_check(cfg, model["cparams"], model["prompts"][0])
    print(f"[time] {cfg.name} window check {time.perf_counter() - t0:.1f}s", flush=True)
    return cost_inputs(model)


# ---------------------------------------------------------------------------
# Phases 11-12: the encoder-decoder and the prefix-LM, served through the
# entry points (neither engine takes an encoder or a prefix input)
# ---------------------------------------------------------------------------

WHISPER_PROMPT, WHISPER_CTX = 416, 448     # 448: whisper's text context
PALIGEMMA_PROMPT, PALIGEMMA_CTX = 128, 512
DIRECT_BATCH, DIRECT_TOKENS = 4, 32


def stub_inputs(cfg, n: int, prompt_len: int, extra_len: int) -> tuple:
    """``n`` prompts of ``prompt_len`` tokens from numpy seed SEED, and the
    stub frontend's output (n, extra_len, d_model) with std 1/sqrt(d): the
    encoder's frame embeddings or the prefix's patch embeddings."""
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, size=(n, prompt_len)).astype(np.int32)
    stub = rng.normal(size=(n, extra_len, cfg.d_model)) / math.sqrt(cfg.d_model)
    return prompts, torch.as_tensor(stub, dtype=torch.bfloat16, device="cuda")


def events_ms(fn, n: int = 3) -> float:
    """Median ms of ``n`` calls of ``fn`` between CUDA events (after one
    call to warm up)."""
    fn()
    times = []
    for _ in range(n):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[n // 2]


def direct_serve(cfg, cparams, prompts: np.ndarray, extra: dict, *, max_len: int):
    """Serve the batch of equal-length prompts through the entry points:
    one batched ``prefill`` (with ``extra``: ``enc_embed`` or
    ``prefix_embed``), its k/v merged into an ``init_cache(max_len)`` that
    has headroom (and its cross k/v copied), then DIRECT_TOKENS - 1
    ``decode_step``s at the batch's scalar position, greedy.  Reads the
    launch counts at the end.  Returns (tokens per request, counts, the
    cache)."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import decode_step, init_cache, prefill

    B, S = prompts.shape
    toks = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, pc = prefill(cparams, toks, cfg, impl="auto", **extra)
    out = [lg[:, -1].argmax(dim=-1)]
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    enc_seq = extra["enc_embed"].shape[1] if "enc_embed" in extra else 0
    cache = init_cache(cfg, B, max_len, torch.bfloat16, enc_seq=enc_seq, device="cuda")
    n = pc["k"].shape[2]
    check(n + DIRECT_TOKENS - 1 <= max_len, f"{cfg.name}: {n} + {DIRECT_TOKENS} > {max_len}")
    for key in ("k", "v"):
        cache[key][:, :, :n] = pc[key]
    for key in ("cross_k", "cross_v"):
        if key in pc:
            cache[key].copy_(pc[key])
    cache["pos"] = pc["pos"]
    del pc
    step_s = []
    for _ in range(DIRECT_TOKENS - 1):
        t0 = time.perf_counter()
        lg, cache = decode_step(cparams, out[-1], cfg, cache, impl="auto")
        out.append(lg.argmax(dim=-1))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    counts["variants"] = ops.variant_counts()
    shapes = ops.gather_matmul_shape_counts()        # keyed (variant, Kc, N): not JSON
    bsm_shapes = ops.block_sparse_shape_counts()     # keyed (variant, K, N)
    tokens = torch.stack(out, dim=1).tolist()
    check(all(len(t) == DIRECT_TOKENS for t in tokens), "a request has the wrong token count")
    print(f"[serve] {cfg.name}: {B} prompts of {S} tokens"
          + (f" after a prefix of {n - S}" if n > S else "")
          + (f" with {enc_seq} encoder frames" if enc_seq else "")
          + f", batched prefill then {DIRECT_TOKENS - 1} decode steps (scalar position, "
            f"init_cache(max_len={max_len}) with headroom): first prefill {t_prefill * 1e3:.1f} "
            f"ms wall; decode step p50 {sorted(step_s)[len(step_s) // 2] * 1e3:.2f} ms (each to "
            f"its end on the card)", flush=True)
    print(f"[serve] {cfg.name}: launches on the path: {json.dumps(counts)}", flush=True)
    counts["steps"], counts["shapes"], counts["bsm_shapes"] = DIRECT_TOKENS - 1, shapes, bsm_shapes
    return tokens, counts, cache


def swapped_cross_fault(cparams):
    """A planted fault of the cross cache: ``prefill`` hands back its cache
    with ``cross_k`` and ``cross_v`` swapped, so every decode step reads
    the encoder's values as keys and its keys as values.  It shows only
    where the init drew wk and wv apart, as the port's does."""
    from repro_torch.models import transformer

    @contextlib.contextmanager
    def swapped():
        real = transformer.prefill

        def prefill(*args, **kw):
            lg, cache = real(*args, **kw)
            cache["cross_k"], cache["cross_v"] = cache["cross_v"], cache["cross_k"]
            return lg, cache

        transformer.prefill = prefill
        try:
            yield cparams
        finally:
            transformer.prefill = real
    return swapped


def encoder_reach_check(cfg, cparams, enc: torch.Tensor) -> None:
    """The encoder is bidirectional: changing the last frame of request 0's
    input changes encoder layer 0's output at frame 0 (then the final norm,
    which acts per frame).  In f32, so that one key among 1500 shows."""
    from repro_torch.models.transformer import _encoder_stack

    one = {"enc_layers": {k: w[:1].float() for k, w in cparams["enc_layers"].items()},
           "enc_final_norm": cparams["enc_final_norm"].float()}
    cfg1 = dataclasses.replace(cfg, enc_layers=1)
    x = enc[:1].float()
    moved = x.clone()
    moved[:, -1] = -moved[:, -1]
    a, b = _encoder_stack(one, x, cfg1), _encoder_stack(one, moved, cfg1)
    d0 = (a[:, 0] - b[:, 0]).abs().max().item()
    rows = int((a != b).flatten(2).any(dim=2).sum())
    print(f"[encoder] {cfg.name}: frame {x.shape[1] - 1} of the input negated: encoder layer 0's "
          f"output (f32) moves at frame 0 by max |d| {d0:.3e}; {rows} of {x.shape[1]} frames "
          f"move (bidirectional attention over every frame)", flush=True)
    check(d0 > 0, f"{cfg.name}: the last frame does not reach frame 0 of the encoder")


def prefix_check(cfg, cparams, prompt: np.ndarray, prefix: torch.Tensor) -> None:
    """Layer 0's attention on request 0's prefix and prompt, through
    ``chunked_attention`` in f32 with ``prefix=P`` against ``prefix=0``:
    row i < P - 1 sees keys up to P - 1 with the prefix and up to i
    without, so rows 0..P-2 must differ; row P - 1 and every row after it
    see the same keys either way and must be equal bit for bit."""
    from repro_torch.models.layers import chunked_attention, project, rms_norm, rope
    from repro_torch.models.transformer import _layer

    P = prefix.shape[1]
    tokens = torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None]
    lp = _layer(cparams["layers"], 0)
    x = torch.cat([prefix[:1], cparams["embed"][tokens]], dim=1)
    S = x.shape[1]
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    pos = torch.arange(S, device="cuda")[None]
    q, k, v = (project(h, lp[w]) for w in ("wq", "wk", "wv"))
    if cfg.qk_norm:
        q, k = rms_norm(q, lp["q_norm"], cfg.norm_eps), rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q, k, v = rope(q, pos, cfg.rope_theta).float(), rope(k, pos, cfg.rope_theta).float(), v.float()
    a = chunked_attention(q, k, v, causal=True, prefix=P)
    b = chunked_attention(q, k, v, causal=True, prefix=0)
    differ = (a != b).flatten(2).any(dim=2)[0]
    n_before = int(differ[:P - 1].sum())
    same_after = torch.equal(a[:, P - 1:], b[:, P - 1:])
    print(f"[prefix] {cfg.name}: layer 0 on request 0 ({P} prefix + {S - P} tokens), "
          f"chunked_attention in f32 with prefix {P} vs none: rows 0..{P - 2} that differ: "
          f"{n_before} of {P - 1}; rows {P - 1}..{S - 1} bit-equal: {same_after}", flush=True)
    check(n_before == P - 1, f"{cfg.name}: {P - 1 - n_before} prefix rows ignore the prefix")
    check(same_after, f"{cfg.name}: the prefix changed a row from {P - 1} on")


def direct_path(cfg, rows: dict, spec, *, prompt_len: int, extra_key: str, extra_len: int,
                max_len: int, flash) -> dict:
    """Prune and compress ``cfg`` (:func:`prune_phase`, counts set to 0 just
    before), serve DIRECT_BATCH prompts of ``prompt_len`` tokens with stub
    inputs ``extra_key`` of ``extra_len`` rows through the entry points
    (:func:`direct_serve`), read and check the launch counts (one batched
    prefill), then time the prefill (and an encoder apart from it), the
    host's issue of a decode step and run the parity phase on the 4
    prompts.  Returns the model with its prompts, stub inputs, counts and
    served tokens."""
    from repro_torch.models.transformer import prefill

    model = prune_phase(cfg, spec)
    cparams = model["cparams"]
    prompts, stub = stub_inputs(cfg, DIRECT_BATCH, prompt_len, extra_len)
    torch.cuda.reset_peak_memory_stats()
    tokens, counts, cache = direct_serve(cfg, cparams, prompts, {extra_key: stub},
                                         max_len=max_len)
    print(f"[serve] {cfg.name}: peak device memory while serving "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    # ---- end of the path ---------------------------------------------------------
    check_path_launches(cfg, rows, model, counts, 1, flash)
    toks = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
    t_all = events_ms(lambda: prefill(cparams, toks, cfg, **{extra_key: stub}))
    if cfg.enc_dec:
        from repro_torch.models.transformer import _cross_kv, _encoder_stack
        t_enc = events_ms(lambda: _cross_kv(cparams, _encoder_stack(cparams, stub, cfg), cfg))
        print(f"[serve] {cfg.name}: batched prefill on the card, median of 3: {t_all:.2f} ms, of "
              f"which the encoder ({cfg.enc_layers} layers over {extra_len} frames, dense, "
              f"chunked_attention) and the cross k/v {t_enc:.2f} ms timed alone, the decoder's "
              f"prefill {t_all - t_enc:.2f} ms", flush=True)
    else:
        print(f"[serve] {cfg.name}: batched prefill on the card, median of 3: {t_all:.2f} ms",
              flush=True)
    host_issue(cfg, cparams, cache, max_len - 8)
    del cache
    return dict(model, prompts=list(prompts), stub=stub, counts=counts, served=tokens)


def whisper_path(cfg, rows: dict) -> dict:
    """whisper-medium, FullBlock(128, 128, 0.5) on wq/wk/wv/w_up/w_down of
    its decoder (the encoder and the cross weights stay dense, as the
    reference prunes them): 4 prompts of WHISPER_PROMPT tokens and stub
    1500-frame embeddings, served to WHISPER_CTX; flash wgmma at hd 64 in
    the decoder's prefill, chunked_attention in the encoder and the cross
    step.  Planted faults: the middle layer's w_down left out, and the
    cross k/v swapped in the cache; then the encoder's reach check."""
    from repro_torch.core.flexblock import FlexBlockSpec, FullBlock

    model = direct_path(cfg, rows, FlexBlockSpec((FullBlock(BLOCK, BLOCK, 0.5),)),
                        prompt_len=WHISPER_PROMPT, extra_key="enc_embed",
                        extra_len=cfg.enc_seq, max_len=WHISPER_CTX, flash="wgmma")
    cparams, stub, counts = model["cparams"], model["stub"], model["counts"]
    rows["flash_attention"]["variants"][f"wgmma hd 64/{cfg.name}"]["launches"] = \
        counts["variants"]["flash_attention"]["wgmma"]
    w_up = cparams["layers"]["w_up"]
    for variant in ("decode", "prefill"):
        rows["block_sparse_matmul"]["variants"][f"{variant}/{cfg.name} w_up"]["launches"] = \
            counts["bsm_shapes"].get((variant, w_up.in_features, math.prod(w_up.out_shape)), 0)
    faults = dict(list(fullblock_faults(cfg, cparams).items())[:1])
    faults["cross_k and cross_v swapped in the cache"] = swapped_cross_fault(cparams)
    t0 = time.perf_counter()
    parity_phase(cfg, cparams, model["prompts"], model["served"], tol=0.15, faults=faults,
                 extras=[{"enc_embed": stub[i:i + 1]} for i in range(DIRECT_BATCH)],
                 every_fault=True)
    print(f"[time] {cfg.name} parity phase {time.perf_counter() - t0:.1f}s", flush=True)
    encoder_reach_check(cfg, cparams, stub)
    return cost_inputs(model)


def paligemma_path(cfg, rows: dict) -> dict:
    """paligemma-3b, row-aligned IntraBlock(4, 1, 0.5) on its six
    projections: 4 prompts of PALIGEMMA_PROMPT tokens after stub prefixes
    of 256 patch embeddings, served to PALIGEMMA_CTX; no flash launch (the
    prefix-LM mask takes chunked_attention).  Planted faults as
    :func:`intrablock_faults`; then the prefix check on layer 0."""
    from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock

    model = direct_path(cfg, rows, FlexBlockSpec((IntraBlock(INTRA_M, 1, 0.5),)),
                        prompt_len=PALIGEMMA_PROMPT, extra_key="prefix_embed",
                        extra_len=cfg.prefix_len, max_len=PALIGEMMA_CTX, flash=None)
    cparams, stub, counts = model["cparams"], model["stub"], model["counts"]
    # w_gate and w_up share (Kc, N): the count at the shape is both leaves'
    Kc, N = cparams["layers"]["w_gate"].w_comp.shape[1:]
    for variant in ("decode", "prefill"):
        rows["intrablock_gather_matmul"]["variants"][f"{variant}/{cfg.name} w_gate"][
            "launches"] = counts["shapes"].get((variant, Kc, N), 0)
    t0 = time.perf_counter()
    parity_phase(cfg, cparams, model["prompts"], model["served"], tol=0.15,
                 faults=intrablock_faults(cfg, cparams),
                 extras=[{"prefix_embed": stub[i:i + 1]} for i in range(DIRECT_BATCH)])
    print(f"[time] {cfg.name} parity phase {time.perf_counter() - t0:.1f}s", flush=True)
    prefix_check(cfg, cparams, model["prompts"][0], stub)
    return cost_inputs(model)


# ---------------------------------------------------------------------------
# Phase 12b: the mesh on the card — ranks on one card over gloo
# ---------------------------------------------------------------------------

MESH_DIR = HERE / "build" / "mesh"
# case → (config, mesh (data, model), time limit of the world in s)
MESH_CASES = {"moe": ("qwen3-moe-30b-a3b", (1, 2), 420),
              "hymba": ("hymba-1.5b", (2, 2), 300)}
MESH_TOL = 3e-2           # a layer's window path vs one process: of the output's max |y|, bf16
# the expert path vs the global dispatch at dropless capacity, of max |y|: both
# route the same tokens to the same experts and run the same expert products,
# so they read 0.0 on the card (NVIDIA H100 80GB HBM3); 1e-3 leaves room for a
# reordered bf16 sum and none for a wrong weight or route on a few tokens
MOE_MESH_TOL = 1e-3
MESH_NEW_TOKENS = 32      # per request on the MoE mesh path, as the served path
HYMBA_MESH_B, HYMBA_MESH_S, HYMBA_MESH_STEPS = 2, 4096, 4
MOE_LOGITS = MESH_DIR / "moe_single_logits.pt"   # moe_path's prefill logits of prompt 0


KERNEL_NAMES = ("flash_attention", "block_sparse_matmul", "block_importance", "decode_attention",
                "intrablock_gather_matmul", "bitserial_zero_profile")


def mesh_phase(rows: dict) -> None:
    """Both mesh paths at full width, in worlds of ranks on the one card
    (``torch.distributed`` over gloo: NCCL refuses two ranks on one
    device).  Each rank is this script again (``--mesh-rank R
    --mesh-case C``), imports the port alone and holds its own CUDA
    context; every collective of the paths asserts CUDA tensors and has a
    120 s timeout, and a world that overruns its limit is killed and
    fails the phase.

    (a) qwen3-moe-30b-a3b, (data 1, model 2): each rank keeps 64 of the
    128 experts of every layer (drawn whole, scaled and pruned whole, then
    cut: :func:`~repro_torch.sparsity.apply.prune_local`), the rest
    replicated; served through ``ServeEngine(slots=4)`` with the served
    path's 8 requests (MESH_NEW_TOKENS each), its launches held as the
    single-process path's; the expert path's layer 0 and last layer
    against the global dispatch of the gathered experts at dropless
    capacity, and a planted fault (each rank's experts offset by one).
    (b) hymba-1.5b, (data 2, model 2): one prefill of B 2 x S 4096 (every
    attention layer takes the window path, whose attention is one flash
    wgmma launch on the rank's block), decode steps, and each layer's
    attention output and k/v against one process's on the same input,
    with planted faults (RoPE restarted at each rank's block, the block
    cut to its slice without the W keys before it).  Tokens
    must agree across ranks: a liveness check that every rank ran the
    same program to its end, not a correctness check, since each rank
    gathers the same global tensors and a wrong exchange gives equal
    wrong tokens; the layer parities are the correctness checks.  Rank
    0's launches go into ``rows`` as the path "<config> mesh, rank 0"."""
    card = card_line()
    for case, (arch, shape, limit) in MESH_CASES.items():
        t0 = time.perf_counter()
        res = run_mesh_world(case, shape, limit)
        r0 = res[0]
        check(all(r["tokens"] == r0["tokens"] for r in res),
              f"mesh {case}: ranks disagree on the tokens")
        print(f"[mesh] {arch} on a (data {shape[0]}, model {shape[1]}) mesh, {len(res)} ranks on "
              f"one card ({card}): tokens equal on every rank; card memory in use with every "
              f"rank's state loaded {r0['mem_used_gib']:.2f} GiB of {r0['mem_total_gib']:.2f} "
              f"(mem_get_info, every process on the card); per rank peak allocated "
              f"{json.dumps([round(r['peak_gib'], 2) for r in res])} GiB; "
              f"world {time.perf_counter() - t0:.1f}s", flush=True)
        for name, n in r0["launches"].items():
            rows[name].setdefault("launches_by_path", {})[f"{arch} mesh, rank 0"] = n
        check(r0["mem_used_gib"] < MEMORY_LIMIT_GIB,
              f"mesh {case}: {r0['mem_used_gib']:.2f} GiB in use on the card")
        shown = {k: v for k, v in r0.items() if k != "tokens"}
        print(f"[mesh] {arch} results: {json.dumps(shown)}", flush=True)


def run_mesh_world(case: str, shape, limit: float) -> list:
    """Start the ranks of ``case``, wait for all within ``limit`` s (killing
    every one left past it), print rank 0's log (and a failed rank's
    tail); fails unless each exits 0.  Returns each rank's result."""
    import shutil

    d = MESH_DIR / case
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    world = math.prod(shape)
    logs = [open(d / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
                               str(r), "--mesh-case", case], stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=HERE) for r in range(world)]
    deadline = time.monotonic() + limit
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for line in (d / "rank0.log").read_text().splitlines():
        print(f"  {line}", flush=True)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in bad[:2]:
        tail = (d / f"rank{r}.log").read_text().splitlines()[-15:]
        print(f"[mesh] {case} rank {r} exited {procs[r].returncode}:\n  " + "\n  ".join(tail),
              flush=True)
    check(not timed_out, f"mesh {case}: the world ran past its {limit} s limit")
    check(not bad, f"mesh {case}: ranks {bad} failed")
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(world)]


def mesh_rank(rank: int, case: str) -> int:
    """One rank of a mesh world (see :func:`mesh_phase`)."""
    sys.path.insert(0, str(HERE / "src"))
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as lmesh

    arch, shape, _ = MESH_CASES[case]
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lmesh.init_world(rank, math.prod(shape), f"file://{MESH_DIR / case / 'store'}")
    mesh = lmesh.make_mesh(shape, ("data", "model"))
    check(mesh.device_type == "cuda", f"the mesh is on {mesh.device_type}")
    fn = moe_rank if case == "moe" else hymba_rank
    with torch.no_grad():
        res = fn(get_config(arch), mesh, rank)
    (MESH_DIR / case / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mesh_memory(res: dict) -> None:
    """Card memory in use by every process, read after every rank has
    loaded its state (``mem_get_info``: total - free)."""
    import torch.distributed as dist
    dist.barrier()
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    res["mem_used_gib"], res["mem_total_gib"] = (total - free) / 2**30, total / 2**30
    res["allocated_gib"] = torch.cuda.memory_allocated() / 2**30
    dist.barrier()


def moe_rank(cfg, mesh, rank: int) -> dict:
    """Rank ``rank`` of the MoE world: init with this rank's experts pruned,
    prune the rest, compress, serve, then the layer parity and the
    collective times."""
    from repro_torch.core.flexblock import FlexBlockSpec, FullBlock
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models.layers import _moe_block_global, moe_block
    from repro_torch.models.transformer import decode_step, init_cache, init_params, prefill
    from repro_torch.sparsity.apply import (compress_params, prune_local, prune_params,
                                            sparsity_report)

    tag = f"[mesh r{rank}] {cfg.name}"
    spec = FlexBlockSpec((FullBlock(BLOCK, BLOCK, 0.5),))
    keys = pruned_keys(cfg)
    scale = math.sqrt(cfg.n_experts)
    kept = {k: [0, 0] for k in EXPERT_KEYS}
    M = shd.axis_size(mesh, "model")

    def keep(name, w):
        if name not in EXPERT_KEYS:
            return w
        w.mul_(scale)                       # a dense MLP's std, as dense_scale_experts
        wl, ml = prune_local(w, name, spec, mesh, device="cuda")
        kept[name][0] += int(torch.count_nonzero(ml))
        kept[name][1] += ml.numel()
        return wl

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, dtype=torch.bfloat16, device="cuda", keep=keep)
    params, masks = prune_params(params, spec, keys=KEYS[:3], device="cuda")
    density = {k.split("/")[-1]: v for k, v in sparsity_report(params, masks).items()
               if k.startswith("layers/")}
    density.update({k: n / tot for k, (n, tot) in kept.items()})
    cparams = compress_params(params, masks, BLOCK, BLOCK)
    del params, masks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res = {"prune_s": time.perf_counter() - t0, "density": density,
           "experts_local": int(cparams["layers"]["w_up"].shape[1])}
    print(f"{tag}: init + prune + compress {res['prune_s']:.1f}s, experts on this rank "
          f"{res['experts_local']} of {cfg.n_experts}, density {json.dumps(density)}", flush=True)
    for k in keys:
        check(abs(density[k] - 0.5) < 1e-9, f"{k}: density {density[k]}")
    check(res["experts_local"] == cfg.n_experts // M, "the rank does not hold its experts")
    mesh_memory(res)

    torch.cuda.reset_peak_memory_stats()
    shd.reset_path_counts()
    with shd.set_mesh(mesh):
        prompts, reqs, counts = serve_phase(cfg, cparams, new_tokens=MESH_NEW_TOKENS)
    paths = shd.path_counts()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["tokens"] = [[int(t) for t in r.output] for r in reqs]
    res["launches"] = {n: counts[n] for n in KERNEL_NAMES}
    model = {"spec": spec, "cparams": cparams, "comp_keys": KEYS[:3]}
    stub = {n: {} for n in KERNEL_NAMES}
    check_path_launches(cfg, stub, model, counts, len(reqs), "wgmma")
    # every prefill and decode step, and host_issue's 6 steps after the count
    want = cfg.n_layers * (len(reqs) + counts["steps"] + 6)
    res["paths"] = paths
    print(f"{tag}: mesh paths taken {json.dumps(paths)}; want moe_ep {want} (every layer of "
          f"{len(reqs)} prefills, {counts['steps']} engine steps and 6 timed steps)", flush=True)
    check(paths == {"moe_ep": want, "swa_seqpar": 0}, f"mesh paths {paths}")

    with shd.set_mesh(mesh):
        tok = torch.as_tensor(prompts[0], dtype=torch.long, device="cuda")[None]
        res["prefill_ms"] = events_ms(lambda: prefill(cparams, tok, cfg), 3)
        cache = init_cache(cfg, 4, 1024, device="cuda")
        cache["pos"] = torch.full((4,), 600, dtype=torch.int64, device="cuda")
        step_tok = torch.zeros(4, dtype=torch.long, device="cuda")
        res["decode_step_ms"] = events_ms(lambda: decode_step(cparams, step_tok, cfg, cache))
        del cache
        lg = prefill(cparams, tok, cfg)[0][0, -1].float()
    if MOE_LOGITS.exists():
        single = torch.load(MOE_LOGITS).to("cuda")
        res["logits_vs_single_process"] = (lg - single).abs().max().item()
    else:
        res["logits_vs_single_process"] = "not measured (no single-process run)"

    # collectives of one layer at the decode and prefill shapes, bf16
    D, E_loc = cfg.d_model, cfg.n_experts // M
    for label, T_loc in (("decode", 4), (f"prefill_{len(prompts[0])}", len(prompts[0]))):
        Ts = -(-T_loc // M)
        C = max(1, math.ceil(Ts * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
        blocks = torch.zeros((M, E_loc, C, D), dtype=torch.bfloat16, device="cuda")
        piece = torch.zeros((Ts, D), dtype=torch.bfloat16, device="cuda")
        a2a = events_ms(lambda: coll.all_to_all(blocks, mesh, "model"), 10)
        gat = events_ms(lambda: coll.gather_grid(piece, mesh, ((), ("model",))), 10)
        res[f"collective_ms_{label}"] = {"all_to_all": a2a, "gather": gat,
                                         "per_layer": 2 * a2a + gat,
                                         "all_to_all_bytes": blocks.numel() * 2}

    # layer parity at dropless capacity: the gathered experts through the global dispatch
    dropless = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    parity = {}
    for l in (0, cfg.n_layers - 1):
        lp = {k: cparams["layers"][k][l] for k in (*EXPERT_KEYS, "w_router")}
        whole = dict(lp, **{k: coll.all_gather(lp[k], mesh, "model", 0) for k in EXPERT_KEYS})
        g = torch.Generator(device="cuda").manual_seed(SEED + l)
        x = torch.randn((2, 128, cfg.d_model), generator=g, device="cuda").to(torch.bfloat16)
        with shd.set_mesh(mesh):
            y_ep = moe_block(x, lp, dropless)
            shifted = dict(lp, **{k: lp[k].roll(1, dims=0) for k in EXPERT_KEYS})
            y_fault = moe_block(x, shifted, dropless)
        y_glob = _moe_block_global(x, whole, dropless)
        y_glob = y_glob.float()
        parity[l] = {"err": rel(y_ep.float(), y_glob),
                     "fault_experts_offset": rel(y_fault.float(), y_glob)}
        del whole
    res["layer_parity"] = parity
    print(f"{tag}: expert path vs global dispatch of the gathered experts at dropless capacity "
          f"{dropless.capacity_factor}, (2, 128) tokens, max |d| / max |y| "
          f"{json.dumps(parity)} (tol {MOE_MESH_TOL}); prefill of {len(prompts[0])} tokens "
          f"{res['prefill_ms']:.1f} ms, 4-slot decode step {res['decode_step_ms']:.1f} ms; "
          f"collectives {json.dumps({k: v for k, v in res.items() if k.startswith('collective')})}"
          f"; prefill logits vs one process's (served capacity, drops differ by design): "
          f"{res['logits_vs_single_process']}", flush=True)
    for l, r in parity.items():
        check(r["err"] <= MOE_MESH_TOL, f"layer {l}: expert path off by {r['err']}")
        check(r["fault_experts_offset"] > MOE_MESH_TOL, f"layer {l}: the planted fault reads "
                                                    f"{r['fault_experts_offset']}")
    return res


def hymba_rank(cfg, mesh, rank: int) -> dict:
    """Rank ``rank`` of the window world: prune and compress hymba-1.5b
    (replicated), one prefill through the window path with its launches
    (one flash wgmma launch a layer, on the rank's block of B/2 x
    (W + S/2) rows; rank coordinate 0 of "model" on S/2 rows),
    decode steps, then each layer's attention against one process's."""
    from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models import layers as TL
    from repro_torch.models.layers import COMPRESSED, attention_block, rms_norm
    from repro_torch.models.transformer import (_decoder_layer, _layer, decode_step,
                                                init_params, prefill)
    from repro_torch.sparsity.apply import compress_params, prune_params

    tag = f"[mesh r{rank}] {cfg.name}"
    spec = FlexBlockSpec((IntraBlock(INTRA_M, 1, 0.5),))
    keys = pruned_keys(cfg)
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, dtype=torch.bfloat16, device="cuda")
    params, masks = prune_params(params, spec, keys=keys, align_cols=True, device="cuda")
    cparams = compress_params(params, masks, m=INTRA_M)
    del params, masks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    comp_keys = tuple(k for k in keys if isinstance(cparams["layers"][k], COMPRESSED))
    check(comp_keys == keys, f"{cfg.name}: {comp_keys} compressed of {keys}")
    res = {"prune_s": time.perf_counter() - t0}
    mesh_memory(res)

    B, S, W = HYMBA_MESH_B, HYMBA_MESH_S, cfg.window
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(B, S)), dtype=torch.long,
                             device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    shd.reset_path_counts()
    with shd.set_mesh(mesh):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = prefill(cparams, tokens, cfg)
        torch.cuda.synchronize()
        res["prefill_ms"] = (time.perf_counter() - t1) * 1e3
    counts = ops.launch_counts()
    counts["variants"], counts["shapes"] = ops.variant_counts(), ops.gather_matmul_shape_counts()
    counts["steps"] = 0
    paths = shd.path_counts()
    res["paths"], res["launches"] = paths, {n: counts[n] for n in KERNEL_NAMES}
    print(f"{tag}: prefill of {B} x {S} on the mesh {res['prefill_ms']:.1f} ms; mesh paths "
          f"{json.dumps(paths)} (want swa_seqpar {cfg.n_layers})", flush=True)
    check(paths == {"moe_ep": 0, "swa_seqpar": cfg.n_layers}, f"mesh paths {paths}")
    check_single_variant(cfg, "flash_attention", "wgmma", counts, cfg.n_layers)
    check(counts["block_sparse_matmul"] == 0, "block_sparse_matmul ran on an IntraBlock path")
    check_main_variants(cfg, "intrablock_gather_matmul", counts, 1, cparams, comp_keys)

    steps = HYMBA_MESH_STEPS
    for key in ("k", "v"):
        cache[key] = F.pad(cache[key], (0, 0, 0, 0, 0, steps))
    out = [logits[:, -1].argmax(-1)]
    with shd.set_mesh(mesh):
        t1 = time.perf_counter()
        for _ in range(steps):
            lg, cache = decode_step(cparams, out[-1], cfg, cache)
            out.append(lg.argmax(-1))
        torch.cuda.synchronize()
        res["decode_step_ms"] = (time.perf_counter() - t1) * 1e3 / steps
    res["tokens"] = torch.stack(out, dim=1).tolist()
    check(shd.path_counts()["swa_seqpar"] == cfg.n_layers, "a decode step took the window path")
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del cache, logits

    # each layer on the same input: the window path against one process's attention
    x = cparams["embed"][tokens]
    pos = torch.arange(S, device="cuda").expand(B, S)
    worst = {"y": 0.0, "k": 0.0, "v": 0.0}
    S_loc = S // shd.axis_size(mesh, "model")
    rope, attend = TL.rope, TL._causal_self_attention

    def halo_dropped(q, k, v, cfg, *, window, impl):
        # the rank's block cut to its own slice: no keys before it
        n = q.shape[1] - S_loc
        out = attend(q[:, n:], k[:, n:], v[:, n:], cfg, window=window, impl=impl)
        return F.pad(out, (0, 0, 0, 0, n, 0))

    # planted faults, each read where it lands: RoPE restarted at each block's
    # start shifts every key of model rank 1 by W (rank 0's block starts at 0),
    # which moves k and barely moves y (random weights give near-uniform
    # attention over ~W keys); a block without its W halo keys moves y
    plants = {"rope_from_0": ("rope", lambda t, p, th: rope(t, p - p[..., :1], th), "k"),
              "halo_dropped": ("_causal_self_attention", halo_dropped, "y")}
    faults = {}
    for l in range(cfg.n_layers):
        lp = _layer(cparams["layers"], l)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        ys, (ks, vs) = attention_block(h, lp, cfg, positions=pos, window=W)
        with shd.set_mesh(mesh):
            ym, (km, vm) = attention_block(h, lp, cfg, positions=pos, window=W)
            for name, (attr, fn, _) in plants.items() if l == 0 else ():
                orig = getattr(TL, attr)
                setattr(TL, attr, fn)
                try:
                    yf, (kf, _) = attention_block(h, lp, cfg, positions=pos, window=W)
                finally:
                    setattr(TL, attr, orig)
                faults[name] = {"y": rel(yf.float(), ys.float()), "k": rel(kf.float(), ks.float())}
            x, _ = _decoder_layer(x, lp, cfg, positions=pos, window=W)
        for name, a, b in (("y", ym, ys), ("k", km, ks), ("v", vm, vs)):
            worst[name] = max(worst[name], rel(a.float(), b.float()))
    res["layer_parity"], res["faults"] = worst, faults
    print(f"{tag}: {steps} decode steps {res['decode_step_ms']:.1f} ms each; each layer's "
          f"attention (window path, flash on the rank's block) vs one process's (flash) on the "
          f"same input, worst over {cfg.n_layers} layers, max |d| / max |ref| "
          f"{json.dumps(worst)} (tol {MESH_TOL}); planted faults at layer 0, each held on the "
          f"output it lands on ({json.dumps({n: t for n, (_, _, t) in plants.items()})}): "
          f"{json.dumps(faults)}", flush=True)
    for name, e in worst.items():
        check(e <= MESH_TOL, f"window path {name} off by {e}")
    for name, (_, _, on) in plants.items():
        check(faults[name][on] > MESH_TOL, f"the planted fault {name} reads {faults[name]}")
    return res


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
# Phase 14: the CIMinus cost model, fed by this run's measurements
# ---------------------------------------------------------------------------

# the profile's three input kinds → the ops of lm_workload that read them
RATIO_OPS = {"attn_in": ("attn_q", "attn_k", "attn_v"), "mlp_in": ("mlp_up",),
             "down_in": ("mlp_down",)}
COST_SEQ = 512
# (latency cycles, speedup) of cost (a), row-aligned IntraBlock(4, 1, 0.5)
# on usecase_arch(4, input_sparsity=True) at COST_SEQ tokens, as the port's
# cim_cost_of_model gives them on a CPU (the cost model is host numpy)
CPU_COST = {"mamba2-130m": (2185728.0, 1.9940267041461701),
            "hymba-1.5b": (30054144.0, 1.9278358418725883)}


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


def cost_phase(samples: list, served: list):
    """Fit the card's profile, then cost each served model (see the
    module docstring, phase 14).  Runs on the host; returns the profile."""
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
        keys = pruned_keys(cfg)
        for key in keys:
            got, want = model["density"][f"layers/{key}"], spec.overall_density(model["shapes"][key])
            check(math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0),
                  f"{cfg.name} {key}: mask density {got}, spec {want}")
        print(f"[cost] {cfg.name}: the card's mask density of each pruned key equals "
              f"{spec.describe()}'s overall_density of its per-layer matrix: "
              + json.dumps({k: [model["density"][f"layers/{k}"], list(model["shapes"][k])]
                            for k in keys}), flush=True)
        wl = lm_workload(cfg, seq_len=COST_SEQ, batch=1).set_sparsity(spec)
        label = f"{cfg.name} {spec.describe()} on {arch.name}, seq_len {COST_SEQ}"
        rep_a, cmp_a = cim_cost_of_model(cfg, arch, spec, seq_len=COST_SEQ)
        check_report(f"{label} (a)", rep_a)
        report_line(f"{label} (a) no input sparsity", rep_a, cmp_a, card)
        if cfg.name in CPU_COST:
            got = (rep_a.latency_cycles, cmp_a["speedup"])
            print(f"[cost] {cfg.name} (a): latency cycles and speedup {got!r}; the port's "
                  f"cim_cost_of_model on a CPU gave {CPU_COST[cfg.name]!r}; its workload's "
                  f"ssm_in_proj is d -> 2*din ({2 * cfg.ssm_inner()}) where the served w_in is "
                  f"2*din + 2*N + H ({2 * cfg.ssm_inner() + 2 * cfg.ssm_state + cfg.ssm_heads}) "
                  f"wide, as in the reference", flush=True)
            check(got == CPU_COST[cfg.name], f"{cfg.name} (a): {got} != the CPU's "
                                             f"{CPU_COST[cfg.name]}")
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
        if cfg.name == EXPLORE_REPORT_OF:
            EXPLORE_REPORT.write_text(rep_c.to_json())
        check_report(f"{label} (c) dense baseline", dense_c)
        check_scaled(f"{label} (c)", rep_c, base, wl, prof)
        report_line(f"{label} (c) {'measured ratios + ' if ratios else ''}fitted profile",
                    rep_c, compare(rep_c, dense_c), card)
    print(f"[time] cost phase {time.perf_counter() - t0:.2f}s", flush=True)
    return prof


# ---------------------------------------------------------------------------
# Phase 15: the launch layer: cells counted on meta, qwen3-4b's executed
# ---------------------------------------------------------------------------

# qwen3-4b's three cells at the reference's global shapes, and one cell of
# each other family: the whole arch x cell matrix (``dryrun --all``, 33
# cells) counts for 144 s on a 2-core host, over the phase's budget
DRYRUN_COUNTED = (("qwen3-4b", "train_4k"), ("qwen3-4b", "prefill_32k"),
                  ("qwen3-4b", "decode_32k"), ("qwen3-moe-30b-a3b", "prefill_32k"),
                  ("mamba2-130m", "decode_32k"), ("hymba-1.5b", "decode_32k"),
                  ("whisper-medium", "decode_32k"), ("paligemma-3b", "decode_32k"))
# qwen3-4b's cells executed at full width and depth: (cell, batch), and
# the timed calls after one warmup
DRYRUN_EXECUTED = (("train_4k", 1), ("prefill_32k", 1), ("decode_32k", 8))
DRYRUN_REPEATS = 3
LONG_S = 32768          # flash at prefill_32k's length
LOGIT_LAYERS = 4        # depth of the prefill_32k logit check (the plain flash is slow)
PATH_TOL = 0.15         # the served paths' logit tolerance


def rows_plain(q, k, v, r0: int, h: int, rows: int = 128) -> torch.Tensor:
    """Plain causal attention of query rows r0..r0+rows of q head h over
    all keys of its kv head, in f32 (q (1, S, Hq, hd), k/v (1, S, Hkv, hd))."""
    hk = h // (q.shape[2] // k.shape[2])
    qs = q[0, r0:r0 + rows, h].float()
    ks, vs = k[0, :, hk].float(), v[0, :, hk].float()
    s = (qs @ ks.T) / math.sqrt(q.shape[-1])
    pos = r0 + torch.arange(rows, device=q.device)[:, None]
    s = s.masked_fill(torch.arange(ks.shape[0], device=q.device)[None, :] > pos, float("-inf"))
    return torch.softmax(s, dim=-1) @ vs


def long_flash_check(card: str) -> None:
    """Flash ``wgmma`` at S = 32768 (qwen3-4b's prefill_32k heads) held to
    the plain version on three 128-row query tiles (first, middle, last) of
    two heads, and timed from CUDA graphs beside SDPA (row 1e)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    Hq, Hkv, hd = 32, 8, 128
    q = torch.randn((1, LONG_S, Hq, hd), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn((1, LONG_S, Hkv, hd), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((1, LONG_S, Hkv, hd), generator=g, device="cuda").to(torch.bfloat16)
    before = ops.variant_counts()["flash_attention"]
    out = fa_mod.flash_attention_cuda(q, k, v, causal=True)
    variant = moved_variant("flash_attention", before)
    check(variant == "wgmma", f"flash at S={LONG_S}: ran the {variant} variant")
    err, tiles, heads = 0.0, (0, LONG_S // 2, LONG_S - 128), (0, Hq - 1)
    for r0 in tiles:
        for h in heads:
            want = rows_plain(q, k, v, r0, h)
            err = max(err, (out[0, r0:r0 + 128, h].float() - want).abs().max().item())
    check(err <= 3e-2, f"flash at S={LONG_S}: max_abs_err {err} > 3e-2 on the checked rows")
    lib_set = [(q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(Hq // Hkv, 1),
                v.transpose(1, 2).repeat_interleave(Hq // Hkv, 1))]
    # the causal pairs the function needs, as rows 1-1d count them (the
    # kernel's diagonal tiles also visit masked pairs: work.flash_attention)
    flops = 4 * hd * Hq * live_pairs(LONG_S)
    nbytes = 2 * LONG_S * (Hq + Hkv) * hd * q.element_size()      # q, k, v read; o written
    sets = [(q, k, v)]
    line = {"variant": variant, "max_abs_err": err, "tol": 3e-2,
            "checked": f"128 query rows from each of {tiles} of q heads {heads}, all keys",
            "ms": graph_ms(lambda a, b, c: fa_mod.flash_attention_cuda(a, b, c, causal=True),
                           sets, iters=5),
            "plain_ms": cuda_ms(lambda a, b, c: ops.flash_attention(a, b, c, impl="ref"), sets,
                                iters=1, warmup=1),
            "library_ms": graph_ms(lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, is_causal=True), lib_set, iters=5),
            "flops": flops, **bound(nbytes, flops, BF16_TC_FLOPS)}
    line.update(ratios(line))
    line["tflops"] = flops / (line["ms"] * 1e-3) / 1e12
    print(f"[dryrun] flash_attention B=1 S={LONG_S} Hq={Hq} Hkv={Hkv} hd={hd} bf16 causal "
          f"(row 1e): {json.dumps(line)} [{card}]", flush=True)


def logit_check(card: str) -> None:
    """prefill_32k's last-token logits at qwen3-4b's width and LOGIT_LAYERS
    layers, seed-0 random weights and tokens: flash against ``impl="ref"``
    (the plain flash in row blocks)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params, prefill
    cfg = dataclasses.replace(get_config("qwen3-4b"), n_layers=LOGIT_LAYERS)
    params = init_params(cfg, SEED, dtype=torch.bfloat16, device="cuda")
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size, size=(1, LONG_S))
    toks = torch.as_tensor(toks, device="cuda")
    ops.reset_launch_counts()
    with torch.no_grad():
        got, _ = prefill(params, toks, cfg)
        counts = ops.variant_counts()["flash_attention"]
        t0 = time.perf_counter()
        want, _ = prefill(params, toks, cfg, impl="ref")
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    check(counts["wgmma"] == LOGIT_LAYERS and counts["general"] == counts["f32"] == 0,
          f"the logit check's prefill launched {counts}")
    check(got.shape == want.shape == (1, 1, cfg.vocab_size), f"logits {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    err = (got - want).abs().max().item()
    print(f"[dryrun] prefill_32k last-token logits, qwen3-4b width, {LOGIT_LAYERS} layers, "
          f"seed {SEED}: flash wgmma against impl='ref' max_abs_err {err:.4f} (tol {PATH_TOL}); "
          f"the plain path took {ref_s:.1f}s [{card}]", flush=True)
    check(err <= PATH_TOL, f"prefill_32k logits: {err} > {PATH_TOL}")


def scores_bf16_cells(executed: dict, card: str) -> None:
    """qwen3-4b's three executed cells again with ``--scores-bf16``
    (``chunked_attention``'s score tiles in bf16; flash's never leave the
    chip), into a ledger of their own (``build/dryrun_bf16.jsonl``), each
    printed beside its f32 record: time, counted bytes, measured peak and
    flash launches, which must not move (prefill_32k 144 ``wgmma``, the
    others 0)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models import layers

    ledger = HERE / "build" / "dryrun_bf16.jsonl"
    ledger.unlink(missing_ok=True)
    for cell, batch in DRYRUN_EXECUTED:
        ops.reset_launch_counts()
        rc = dryrun.main(["--arch", "qwen3-4b", "--cell", cell, "--execute", str(DRYRUN_REPEATS),
                          "--batch", str(batch), "--out", str(ledger), "--scores-bf16",
                          "--tag", "bf16"])
        counts, variants = ops.launch_counts(), ops.variant_counts()
        gc.collect()
        torch.cuda.empty_cache()
        rec = json.loads(ledger.read_text().splitlines()[-1])
        check(rc == 0 and "error" not in rec, f"qwen3-4b {cell} with bf16 scores failed: {rec}")
        check(layers._SCORES_DTYPE == torch.float32, "--scores-bf16 left the scores dtype set")
        if cell == "prefill_32k":
            want = get_config("qwen3-4b").n_layers * (DRYRUN_REPEATS + 1)
            check(variants["flash_attention"] == {"wgmma": want, "general": 0, "f32": 0}
                  and sum(counts.values()) == want,
                  f"prefill_32k with bf16 scores launched {counts}, want {want} flash wgmma")
        else:
            check(sum(counts.values()) == 0, f"qwen3-4b {cell} with bf16 scores launched {counts}")
        f32 = executed[cell]
        line = {"cell": cell, "batch": batch, "flash_launches": counts["flash_attention"]}
        for key in ("time_s", "time_s_median", "bytes_accessed", "peak_bytes",
                    "measured_peak_bytes", "flops"):
            line[key] = {"f32": f32[key], "bf16": rec[key]}
        line["bytes_ratio"] = rec["bytes_accessed"] / f32["bytes_accessed"]
        line["time_ratio"] = rec["time_s"] / f32["time_s"]
        print(f"[dryrun] --scores-bf16 qwen3-4b {cell} B {batch}: {json.dumps(line)} [{card}]",
              flush=True)
        check(rec["flops"] == f32["flops"], f"{cell}: bf16 scores moved the counted flops")
        if cell == "prefill_32k":
            check(rec["bytes_accessed"] == f32["bytes_accessed"],
                  "prefill_32k (flash): bf16 scores moved the counted bytes")
        else:
            check(rec["bytes_accessed"] < f32["bytes_accessed"],
                  f"{cell}: bf16 scores did not cut the counted bytes")


SCORES_PROMPT, SCORES_BATCH = 2048, 4
# the decode logits' bound, bf16 scores against f32: about twice the first
# reading on an H100 (0.129, largest |logit| 4.8)
SCORES_LOGIT_TOL = 0.25


def scores_logit_check(card: str) -> None:
    """One full-width qwen3-4b decode step (seed-0 weights, all 36 layers)
    over a real cache, the prefill of 4 seeded prompts of 2048 tokens, with
    bf16 score tiles against f32: the largest logit difference, and how
    many next tokens move."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    from repro_torch.models.transformer import decode_step, init_cache, init_params, prefill
    cfg = get_config("qwen3-4b")
    params = init_params(cfg, SEED, dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(SEED + 3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(SCORES_BATCH, SCORES_PROMPT)),
                           device="cuda")
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(SCORES_BATCH,)), device="cuda")
    with torch.no_grad():
        _, filled = prefill(params, toks, cfg)
        cache = init_cache(cfg, SCORES_BATCH, SCORES_PROMPT + 8, device="cuda")
        for key in ("k", "v"):
            cache[key][:, :, :SCORES_PROMPT] = filled[key]
        cache["pos"] = filled["pos"]
        del filled
        check(bool(cache["k"][:, :, :SCORES_PROMPT].abs().amax() > 0), "the cache is zero")
        got = {}
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            with layers.scores_dtype(dtype):
                logits, _ = decode_step(params, nxt, cfg, dict(cache))
            got[name] = logits.float()
    check(all(bool(torch.isfinite(t).all()) for t in got.values()), "non-finite decode logits")
    err = (got["bf16"] - got["f32"]).abs().max().item()
    moved = int((got["bf16"].argmax(-1) != got["f32"].argmax(-1)).sum())
    scale = got["f32"].abs().max().item()
    print(f"[dryrun] --scores-bf16 decode logits, qwen3-4b full width, B {SCORES_BATCH} over a "
          f"cache of {SCORES_PROMPT} prefilled tokens, seed {SEED}: max_abs_diff {err!r} against "
          f"f32 scores (bound {SCORES_LOGIT_TOL}; largest |logit| {scale:.3f}), next tokens moved "
          f"{moved}/{SCORES_BATCH} [{card}]", flush=True)
    check(0 < err <= SCORES_LOGIT_TOL, f"bf16-scores decode logits: {err} outside (0, "
          f"{SCORES_LOGIT_TOL}]")
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()



TILED_TOL = 1e-2        # tiled vs generic attention output, bf16 (a few ulps at |out| < 2)


def tiled_attn_cell(executed: dict, card: str) -> None:
    """qwen3-4b's train_4k again with ``chunked_attention``'s tiled path
    switched off (``layers.set_tiled_attn(False)``: the generic loop, every
    query against every kv chunk), into a ledger of its own
    (``build/dryrun_untiled.jsonl``), printed beside the tiled record:
    time, counted flops and bytes, counted and measured peak.  The tiled
    flops must be below the generic loop's and neither may launch a
    kernel.  Then one layer's attention at train_4k's shape (B 1, S 4096,
    32 q heads over 8 kv heads of 128, seeded bf16) through both paths on
    the card: the largest output difference within TILED_TOL."""
    from repro_torch.configs import SHAPE_CELLS, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models import layers

    cell, batch = "train_4k", dict(DRYRUN_EXECUTED)["train_4k"]
    ledger = HERE / "build" / "dryrun_untiled.jsonl"
    ledger.unlink(missing_ok=True)
    ops.reset_launch_counts()
    prev = layers.set_tiled_attn(False)
    try:
        rc = dryrun.main(["--arch", "qwen3-4b", "--cell", cell, "--execute", str(DRYRUN_REPEATS),
                          "--batch", str(batch), "--out", str(ledger), "--tag", "untiled"])
    finally:
        layers.set_tiled_attn(prev)
    counts = ops.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    rec = json.loads(ledger.read_text().splitlines()[-1])
    check(rc == 0 and "error" not in rec, f"qwen3-4b {cell} untiled failed: {rec}")
    check(sum(counts.values()) == 0, f"qwen3-4b {cell} untiled launched {counts}")
    tiled = executed[cell]
    line = {"cell": cell, "batch": batch}
    for key in ("time_s", "time_s_median", "flops", "bytes_accessed", "peak_bytes",
                "measured_peak_bytes"):
        line[key] = {"tiled": tiled[key], "generic": rec[key]}
    line["time_ratio"] = tiled["time_s"] / rec["time_s"]
    line["flops_ratio"] = tiled["flops"] / rec["flops"]
    print(f"[dryrun] tiled attention, qwen3-4b {cell} B {batch}: {json.dumps(line)} [{card}]",
          flush=True)
    check(tiled["flops"] < rec["flops"], f"{cell}: the tiled path did not cut the counted flops")

    cfg = get_config("qwen3-4b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    S, hd = SHAPE_CELLS[cell].seq_len, cfg.resolved_head_dim
    q, k, v = (torch.randn(1, S, h, hd, generator=gen, device="cuda").bfloat16()
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    with torch.no_grad():
        on = layers.chunked_attention(q, k, v)
        prev = layers.set_tiled_attn(False)
        try:
            off = layers.chunked_attention(q, k, v)
        finally:
            layers.set_tiled_attn(prev)
    err = float((on.float() - off.float()).abs().max())
    print(f"[dryrun] tiled attention vs the generic loop on the card, q {tuple(q.shape)} k "
          f"{tuple(k.shape)} bf16: max_abs_err {err!r} (tol {TILED_TOL}), largest |out| "
          f"{float(off.float().abs().max())!r} [{card}]", flush=True)
    check(err <= TILED_TOL, f"tiled attention differs from the generic loop by {err}")
    del q, k, v, on, off
    torch.cuda.empty_cache()


def emitted_trace_check(rec: dict) -> None:
    """An executed dry-run record's ``--emit-trace`` fields: all five, the
    graph on disk reloading to the recorded digest and lowering to the
    recorded totals, and, for a prefill or train cell, MVM macs equal to
    ``lm_workload``'s at the record's shape."""
    from repro_torch.configs import get_config
    from repro_torch.core.workload import lm_workload
    from repro_torch.trace import TraceGraph, lower_graph, summarize

    keys = ("trace_path", "trace_digest", "trace_ops", "trace_mvm_macs", "trace_mvm_weights")
    check(all(k in rec for k in keys), f"{rec['cell']}: the record lacks a trace field")
    path = Path(rec["trace_path"])
    check(path.is_file(), f"{rec['cell']}: no trace graph at {path}")
    graph = TraceGraph.load(path)
    check(graph.digest() == rec["trace_digest"], f"{rec['cell']}: {path.name} reloads to "
          f"digest {graph.digest()[:16]}, the record has {rec['trace_digest'][:16]}")
    check((graph.meta["batch"], graph.meta["seq_len"]) == (rec["global_batch"], rec["seq_len"]),
          f"{rec['cell']}: traced at {graph.meta}, ran B {rec['global_batch']}")
    s = summarize(lower_graph(graph))
    check((s["mvm_macs"], s["mvm_weights"]) == (rec["trace_mvm_macs"], rec["trace_mvm_weights"]),
          f"{rec['cell']}: the graph lowers to {s}, not the record's totals")
    hand = None
    if rec["kind"] in ("train", "prefill"):
        hand = lm_workload(get_config(rec["arch"]), seq_len=rec["seq_len"],
                           batch=rec["global_batch"]).total_macs()
        check(rec["trace_mvm_macs"] == hand,
              f"{rec['cell']}: trace_mvm_macs {rec['trace_mvm_macs']} != lm_workload's {hand}")
    print(f"[dryrun] --emit-trace {rec['arch']} {rec['cell']} (B {rec['global_batch']}, S "
          f"{rec['seq_len']}): {path.relative_to(HERE)} digest {rec['trace_digest'][:16]}, "
          f"{rec['trace_ops']} ops, mvm macs {rec['trace_mvm_macs']!r}"
          + ("" if hand is None else " (= lm_workload's)")
          + f", mvm weights {rec['trace_mvm_weights']!r}", flush=True)


def dryrun_phase(micro_samples: list, micro_prof) -> None:
    """The launch layer on the card (module docstring, phase 15)."""
    from repro_torch.calibrate.fit import fit_profile
    from repro_torch.calibrate.harvest import from_ledger
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, hlo_histogram, roofline

    card = card_line()
    ledger = HERE / "build" / "dryrun.jsonl"
    ledger.unlink(missing_ok=True)
    times = {}

    t0 = time.perf_counter()
    for arch, cell in DRYRUN_COUNTED:
        check(dryrun.main(["--arch", arch, "--cell", cell, "--out", str(ledger)]) == 0,
              f"dry-run count of {arch} {cell} failed")
    counted = [json.loads(line) for line in ledger.read_text().splitlines()]
    for rec in counted:
        check("error" not in rec and rec["flops"] > 0 and rec["peak_bytes"] >= rec["argument_bytes"],
              f"counted record {rec}")
        print(f"[dryrun] counted {rec['arch']} {rec['cell']} (B {rec['global_batch']}, S "
              f"{rec['seq_len']}, meta): flops {rec['flops']!r}, bytes {rec['bytes_accessed']!r}, "
              f"peak {rec['peak_bytes'] / 2**30:.2f} GiB, count {rec['lower_s']}s", flush=True)
    times["count"] = time.perf_counter() - t0

    executed = {}
    for cell, batch in DRYRUN_EXECUTED:
        t0 = time.perf_counter()
        resident = torch.cuda.memory_allocated() / 2**30
        ops.reset_launch_counts()
        rc = dryrun.main(["--arch", "qwen3-4b", "--cell", cell, "--execute", str(DRYRUN_REPEATS),
                          "--batch", str(batch), "--out", str(ledger), "--emit-trace"])
        counts, variants = ops.launch_counts(), ops.variant_counts()
        gc.collect()
        torch.cuda.empty_cache()
        rec = json.loads(ledger.read_text().splitlines()[-1])
        check(rc == 0 and "error" not in rec, f"qwen3-4b {cell} execution failed: {rec}")
        peak = rec["measured_peak_bytes"] / 2**30
        print(f"[dryrun] executed qwen3-4b {cell} B {batch} (zeros, {rec['execute_repeats']} timed "
              f"after a warmup): time_s {rec['time_s']!r}, time_s_median {rec['time_s_median']!r}, "
              f"measured peak {peak:.2f} GiB ({resident:.2f} GiB resident before the cell), "
              f"counted peak {rec['peak_bytes'] / 2**30:.2f} GiB "
              f"(measured/counted {rec['measured_peak_bytes'] / rec['peak_bytes']:.3f}), "
              f"{rec['flops'] / rec['time_s'] / 1e12:.2f} TFLOP/s of {rec['flops']!r} counted "
              f"flops; launches {json.dumps(counts)} [{card}]", flush=True)
        check(peak < MEMORY_LIMIT_GIB, f"qwen3-4b {cell}: peak {peak:.2f} GiB")
        if cell == "prefill_32k":
            want = get_config("qwen3-4b").n_layers * (DRYRUN_REPEATS + 1)   # per layer and call
            check(variants["flash_attention"] == {"wgmma": want, "general": 0, "f32": 0},
                  f"prefill_32k launched flash {variants['flash_attention']}, want {want} wgmma")
            check(sum(counts.values()) == want, f"prefill_32k launched {counts}")
        elif cell == "decode_32k":
            want = get_config("qwen3-4b").n_layers * (DRYRUN_REPEATS + 1)   # per layer and step
            check(counts["decode_attention"] == want and sum(counts.values()) == want,
                  f"decode_32k launched {counts}, want {want} decode_attention")
        else:
            check(sum(counts.values()) == 0, f"qwen3-4b {cell} launched {counts}")
        emitted_trace_check(rec)
        executed[cell] = rec
        times[cell] = time.perf_counter() - t0

    t0 = time.perf_counter()
    scores_bf16_cells(executed, card)
    scores_logit_check(card)
    times["bf16 scores"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    tiled_attn_cell(executed, card)
    times["tiled attention"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    long_flash_check(card)
    logit_check(card)
    gc.collect()
    torch.cuda.empty_cache()
    times["flash and logits"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rep = from_ledger(ledger)
    classes = sorted(s.op_class for s in rep.samples)
    check(classes == ["step:decode", "step:prefill", "step:train"],
          f"harvested {classes} from {ledger.name}")
    check(rep.skipped_untimed == len(counted) and rep.skipped_malformed == 0,
          f"harvest skipped {rep.skipped_untimed} untimed, {rep.skipped_malformed} malformed")
    name = "".join(c if c.isalnum() else "-" for c in torch.cuda.get_device_name(0).lower())
    prof = fit_profile(list(micro_samples) + rep.samples, name=f"{name}-microbench-steps",
                       provenance={"source": "chip_smoke.py microbench_kernels + dry-run steps",
                                   "card": card})
    path = prof.save_addressed(HERE / "build" / "profiles")
    for label, p in (("microbench only", micro_prof), ("microbench + 3 steps", prof)):
        print(f"[dryrun] profile, {label}: peak_flops {p.peak_flops!r}, hbm_bw {p.hbm_bw!r}, "
              f"efficiency {json.dumps(p.efficiency)}, rel_rmse {p.residuals['rel_rmse']!r} over "
              f"{int(p.residuals['n_samples'])} samples [{card}]", flush=True)
    print(f"[dryrun] the microbench + steps profile saved as {path.relative_to(HERE)}",
          flush=True)
    for cell, rec in executed.items():
        a = roofline.analyze(rec, prof)
        print(f"[dryrun] roofline of qwen3-4b {cell} ({rec['tag']}) with that profile: compute "
              f"{a['t_compute_s']!r} s, memory {a['t_memory_s']!r} s, dominant {a['dominant']}, "
              f"useful {a['useful_ratio']!r}, measured time_s {rec['time_s']!r} [{card}]",
              flush=True)
    hlo_histogram.main(["--arch", "qwen3-4b", "--cell", "prefill_32k", "--layers", "2",
                        "--top", "10"])
    times["fit, roofline, histogram"] = time.perf_counter() - t0
    print(f"[time] dry-run phase {sum(times.values()):.1f}s: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in times.items()), flush=True)


# ---------------------------------------------------------------------------
# Phase 15b: the dry-run on a mesh, counted in a fake world (no card)
# ---------------------------------------------------------------------------

MESH_DRYRUN_DIR = HERE / "build" / "mesh_dryrun"
# (arch, cell, meshes, knobs, tag): every cell of the main path's two
# configs on both meshes, gemma's prefill on one, llama3-8b's train step
# under each sharding knob (--no-zero1 changes nothing: it is not run);
# qwen3-moe-30b-a3b's cells on both meshes, its train step under --fsdp and
# its prefill under --no-ep, dbrx-132b's prefill; every cell of mamba2-130m
# and hymba-1.5b (long_500k too) on the single-pod mesh, their prefill on the
# multi-pod one; whisper-medium's and paligemma-3b's cells on both meshes
# (paligemma's prefill, the longest count, one job a mesh), a train step of
# each under --fsdp and paligemma's prefill under --legacy-sharding; and
# seven cells whose attention passes one chunk, tagged "untiled", with
# chunked_attention's tiled path switched off
MESH_DRYRUN_JOBS = (
    *((arch, cell, "both", (), "") for arch in ("llama3-8b", "qwen3-4b")
      for cell in ("train_4k", "prefill_32k", "decode_32k")),
    ("gemma-7b", "prefill_32k", "single", (), ""),
    ("gemma2-9b", "prefill_32k", "single", (), ""),
    ("llama3-8b", "train_4k", "single", ("--fsdp",), "fsdp"),
    ("llama3-8b", "train_4k", "single", ("--legacy-sharding",), "legacy"),
    *(("qwen3-moe-30b-a3b", cell, "both", (), "")
      for cell in ("train_4k", "prefill_32k", "decode_32k")),
    ("qwen3-moe-30b-a3b", "train_4k", "single", ("--fsdp",), "fsdp"),
    ("qwen3-moe-30b-a3b", "prefill_32k", "single", ("--no-ep",), "noep"),
    ("dbrx-132b", "prefill_32k", "single", (), ""),
    *((arch, cell, "single", (), "") for arch in ("mamba2-130m", "hymba-1.5b")
      for cell in ("train_4k", "prefill_32k", "decode_32k", "long_500k")),
    *((arch, "prefill_32k", "multi", (), "") for arch in ("mamba2-130m", "hymba-1.5b")),
    *((arch, cell, "both", (), "") for arch, cell in (
        ("whisper-medium", "train_4k"), ("whisper-medium", "prefill_32k"),
        ("whisper-medium", "decode_32k"), ("paligemma-3b", "train_4k"),
        ("paligemma-3b", "decode_32k"))),
    *(("paligemma-3b", "prefill_32k", mesh, (), "") for mesh in ("single", "multi")),
    *((arch, "train_4k", "single", ("--fsdp",), "fsdp")
      for arch in ("whisper-medium", "paligemma-3b")),
    ("paligemma-3b", "prefill_32k", "single", ("--legacy-sharding",), "legacy"),
    # chunked_attention's tiled path switched off (the generic loop), beside
    # the tiled records of the same cells
    *((arch, cell, "single", (), "untiled") for arch, cell in (
        ("llama3-8b", "train_4k"), ("gemma2-9b", "prefill_32k"),
        ("qwen3-moe-30b-a3b", "train_4k"), ("hymba-1.5b", "train_4k"),
        ("whisper-medium", "train_4k"), ("paligemma-3b", "train_4k"),
        ("paligemma-3b", "prefill_32k"))),
)
# (kind, config, knob, flags): steps counted on a fake (2, 2) world and held
# to a hand count (:func:`hand_collectives`): llama3-8b ``.reduced()`` (heads
# whole) under each knob, and widened so that its query heads split;
# qwen3-moe-30b-a3b ``.reduced()``'s expert-parallel prefill and train step
# (default and --fsdp); hymba-1.5b ``.reduced()`` with 5 query heads, whose
# prefill at S 2048 takes the window path; whisper-medium widened (heads
# split) and paligemma-3b ``.reduced()``: prefill, train (default and
# --fsdp) and decode, paligemma's prefill also under --legacy-sharding and
# past one chunk ("tiled": the tiled prefix path)
MESH_HAND_JOBS = (
    *(("prefill", "reduced", knob, flags) for knob, flags in (
        ("default", ()), ("fsdp", ("--fsdp",)), ("legacy", ("--legacy-sharding",)))),
    *(("train", "reduced", knob, flags) for knob, flags in (
        ("default", ()), ("fsdp", ("--fsdp",)), ("fsdp", ("--fsdp", "--no-zero1")),
        ("legacy", ("--legacy-sharding",)))),
    ("train", "widened", "default", ()), ("train", "widened", "fsdp", ("--fsdp",)),
    *((kind, "moe", knob, flags) for kind in ("prefill", "train")
      for knob, flags in (("default", ()), ("fsdp", ("--fsdp",)))),
    ("prefill", "hymba", "default", ()),
    *((kind, variant, knob, flags) for variant in ("whisper", "paligemma")
      for kind, knob, flags in (("prefill", "default", ()), ("train", "default", ()),
                                ("train", "fsdp", ("--fsdp",)), ("decode", "default", ()))),
    ("prefill", "paligemma", "legacy", ("--legacy-sharding",)),
    ("prefill-tiled", "paligemma", "default", ()),
)
MESH_DRYRUN_WORKERS = 7
MESH_DRYRUN_TIMEOUT_S = 600


def start_mesh_dryrun() -> list:
    """Start the mesh dry-run: MESH_DRYRUN_WORKERS processes of this script
    with ``--mesh-dryrun I N``, each counting its share of the jobs on
    ``meta`` in fake worlds, on the host alone (the card hidden from
    them).  A fake world is its process's default group, which must not
    meet phase 12b's gloo worlds; they start after the card's last timed
    phase, so no timed phase shares the host with them."""
    MESH_DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    for f in MESH_DRYRUN_DIR.glob("*"):
        f.unlink()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for w in range(MESH_DRYRUN_WORKERS):
        with open(MESH_DRYRUN_DIR / f"worker{w}.log", "w") as log:   # the child keeps a copy
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--mesh-dryrun", str(w),
                 str(MESH_DRYRUN_WORKERS)], stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=HERE))
    return procs


def _hand_cfg(variant: str):
    from repro_torch.configs import get_config

    if variant == "moe":
        return get_config("qwen3-moe-30b-a3b").reduced()
    if variant == "hymba":
        return dataclasses.replace(get_config("hymba-1.5b").reduced(), n_heads=5, n_kv_heads=1)
    if variant == "whisper":
        return dataclasses.replace(get_config("whisper-medium").reduced(), d_model=512,
                                   n_heads=16, n_kv_heads=16, head_dim=32, d_ff=2048,
                                   enc_seq=40, vocab_size=520)
    if variant == "paligemma":
        return get_config("paligemma-3b").reduced()
    cfg = get_config("llama3-8b").reduced()
    if variant == "widened":
        cfg = dataclasses.replace(cfg, d_model=512, n_heads=16, head_dim=32, d_ff=2048)
    return cfg


def _hand_cell(kind: str, variant: str = "reduced"):
    from repro_torch.configs.base import ShapeCell

    if variant == "hymba":
        return ShapeCell("t", 2048, 2, kind)
    if variant == "moe":
        return ShapeCell("t", 128, 4, kind)
    if kind == "prefill-tiled":
        return ShapeCell("t", 1280, 4, "prefill")
    if kind == "decode":
        return ShapeCell("t", 128, 16, kind)
    return ShapeCell("t", 128 if kind == "prefill" else 64, 4, kind)


def _job_weight(job) -> float:
    """A rough count time of a MESH_DRYRUN_JOBS entry (a train cell several
    times a prefill or decode; a prefill whose attention is
    ``chunked_attention``'s tiled path over 32k keys, paligemma-3b's prefix
    or gemma2-9b's softcap, several times a train cell; both meshes twice
    one), to spread them."""
    arch, cell, mesh, _, tag = job
    weight = 4.0 if cell == "train_4k" else 1.0
    if cell == "prefill_32k" and arch in ("paligemma-3b", "gemma2-9b") and tag != "untiled":
        weight = 15.0
    return weight * (2 if mesh == "both" else 1)


def _jobs_of(w: int, n: int) -> list:
    """Worker ``w``'s share of MESH_DRYRUN_JOBS: the longest first, each to
    the worker with the least so far."""
    loads, share = [0.0] * n, [[] for _ in range(n)]
    for job in sorted(MESH_DRYRUN_JOBS, key=_job_weight, reverse=True):
        i = loads.index(min(loads))
        loads[i] += _job_weight(job)
        share[i].append(job)
    return share[w]


def mesh_dryrun_worker(w: int, n: int) -> int:
    """The ``--mesh-dryrun W N`` process: its share of MESH_DRYRUN_JOBS
    (:func:`_jobs_of`) through ``python -m repro_torch.launch.dryrun``'s
    ``main`` into ``build/mesh_dryrun/ledger<W>.jsonl``, and likewise of
    MESH_HAND_JOBS, each step's ``collective_bytes`` on a fake (2, 2)
    world into ``hand<W>.json``; then its seconds.  A job tagged
    "untiled" runs with ``chunked_attention``'s tiled path switched off."""
    sys.path.insert(0, str(HERE / "src"))
    torch.set_num_threads(1)
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.models import layers

    t0 = time.perf_counter()
    rc = 0
    for arch, cell, mesh, knobs, tag in _jobs_of(w, n):
        prev = layers.set_tiled_attn(tag != "untiled")
        try:
            rc |= dryrun.main(["--arch", arch, "--cell", cell, "--mesh", mesh, *knobs,
                               "--tag", tag, "--out", str(MESH_DRYRUN_DIR / f"ledger{w}.jsonl")])
        finally:
            layers.set_tiled_attn(prev)
    hand = []
    for kind, variant, knob, flags in MESH_HAND_JOBS[w::n]:
        opts = dryrun.knob_options(dryrun.parser().parse_args(list(flags)))
        with fake_world(4), shd.options(**opts):
            mesh = make_mesh((2, 2), ("data", "model"))
            c = dryrun.count_cell(_hand_cfg(variant), _hand_cell(kind, variant), mesh=mesh)
        hand.append({"kind": kind, "config": variant, "knob": knob, "flags": list(flags),
                     "collective_bytes": c.collective_bytes})
    (MESH_DRYRUN_DIR / f"hand{w}.json").write_text(json.dumps(hand))
    (MESH_DRYRUN_DIR / f"done{w}.json").write_text(json.dumps(
        {"rc": rc, "seconds": time.perf_counter() - t0}))
    return rc


def _hand_family_collectives(cfg, cell, knob: str) -> dict:
    """The collectives of a step of qwen3-moe-30b-a3b, hymba-1.5b or
    mamba2-130m at ``.reduced()`` on (2, 2), by hand: the copy of
    tests/test_torch_mesh_dryrun_families.py's ``_hand_collectives``, whose
    docstring gives the reckoning."""
    m = dp = 2
    B, S, d, L = cell.global_batch, cell.seq_len, cfg.d_model, cfg.n_layers
    B_loc = B // dp
    T = B_loc * S
    hd, Hq, Hkv, F, V = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, \
        cfg.vocab_size
    bf16, f32 = 2, 4
    train = cell.kind == "train"
    out = dict.fromkeys(("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                         "collective-permute", "count"), 0)

    def add(kind, nbytes, n=1):
        out[kind] += n * nbytes
        out["count"] += n

    def adamw(leaves):
        for w in leaves:
            add("all-reduce", w * bf16)
        add("all-reduce", f32)

    add("all-reduce", (B_loc if cell.kind == "decode" else T) * d * bf16)        # the lookup
    if cfg.ssm_state:
        din, N, H = cfg.ssm_inner(), cfg.ssm_state, cfg.ssm_heads
        e = 2 * din + 2 * N + H
    if cfg.family == "moe":
        E, K, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
        E_loc = E // m
        if knob == "noep":
            assert not train
            C = max(1, math.ceil(B * S * K / E * cf))
            add("all-gather", B * S * d * bf16, L)
            add("all-gather", E * C * d * bf16, L)
            return out
        Ts = -(-T // m)
        C = max(1, math.ceil(Ts * K / E * cf))
        add("all-to-all", m * E_loc * C * d * bf16, 2 * L * (3 if train else 1))
        add("all-gather", m * Ts * d * bf16, L)
        attn = (d * Hq * hd, d * Hkv * hd, d * Hkv * hd, Hq * hd * d)
        weights = (*attn, d * E, E_loc * d * F, E_loc * d * F, E_loc * F * d)
        tables = (V // m * d, d * V // m)
        if knob == "fsdp":
            for w in weights:
                add("all-gather", w * bf16, (2 if train else 1) * L)
            for w in tables:
                add("all-gather", w * bf16)
        if not train:
            return out
        add("all-reduce", T * f32, 3)                                   # the loss
        add("all-reduce", T * d * bf16)                                 # lm_head's input grad
        add("reduce-scatter", Ts * d * bf16, L)                         # the exit, transposed
        add("all-reduce", d * E * bf16, L)                              # the router's grad
        add("all-reduce", T * d * bf16, L)                              # the block's input grad
        norms = (d, L * d, L * d, L * hd, L * hd)
        if knob == "fsdp":
            for w in weights:
                add("reduce-scatter", w // dp * bf16, L)
            for w in tables:
                add("reduce-scatter", w // dp * bf16)
            for w in norms:
                add("all-reduce", w * bf16)
            add("all-reduce", f32, 3)
            return out
        adamw((*tables, *norms, *(L * w for w in weights)))
        return out
    if cfg.family == "hybrid":
        assert knob == "default"
        add("all-gather", T * d * bf16, L * (2 if train else 1))        # y over "model"
        add("all-reduce", T * d * bf16, L * (2 if train else 1))        # w_out
        add("all-reduce", T * d * bf16, L)                              # w_down
        if not train:
            add("all-gather", T * Hkv * hd * bf16, 2 * L)               # the cache's k, v
            return out
        attn = (d * Hq * hd, d * Hkv * hd, d * Hkv * hd, Hq * hd * d)
        add("all-reduce", T * f32, 3)
        add("all-reduce", T * d * bf16, 2 * L + 1)                      # w_gate, w_up, lm_head
        add("reduce-scatter", T // m * d * bf16, L)                     # y's gather, transposed
        add("all-reduce", T * d * bf16, 2 * L)                          # x's grad: window, mixer
        for w in (*attn, H, H, H, d * e):
            add("all-reduce", w * bf16, L)
        adamw((V // m * d, d * V // m, d, *(L * d,) * 4, *(L * H,) * 3, L * 4 * din // m,
               *(L * w for w in attn), L * d * e, L * d * F // m, L * d * F // m,
               L * F // m * d, L * din // m * d))
        return out
    # mamba2
    assert cfg.family == "ssm" and knob == "default"
    if cell.kind == "decode":
        if B >= 16:
            add("all-gather", B_loc * din * bf16, L)
            add("all-reduce", B_loc * din * f32, L)
            add("all-reduce", B_loc * d * bf16, L)
        else:
            add("all-gather", B * d * bf16, L)
            add("all-gather", 4 * din * bf16, L)
            add("all-reduce", B * d * bf16, L)
        return out
    add("all-reduce", T * d * bf16, L)                                  # w_out
    if not train:
        return out
    add("all-reduce", T * f32, 3)
    add("all-reduce", T * d * bf16, 1 + L)                              # unembed; x's grad
    for w in (H, H, H, d * e):
        add("all-reduce", w * bf16, L)
    adamw((V // m * d, d, L * d, *(L * H,) * 3, L * 4 * din // m, L * d * e,
           L * din // m * d))
    return out


def _hand_encdec_collectives(cfg, cell, knob: str) -> dict:
    """The collectives of a step of whisper-medium (widened, its heads
    split) or paligemma-3b ``.reduced()`` on (2, 2), by hand: the copy of
    tests/test_torch_mesh_dryrun_encdec.py's ``_hand_collectives``, whose
    docstring gives the reckoning."""
    m = dp = 2
    B, S, d, L = cell.global_batch, cell.seq_len, cfg.d_model, cfg.n_layers
    B_loc = B // dp
    hd, Hq, Hkv, F, V = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, \
        cfg.vocab_size
    P, Le = cfg.prefix_len, cfg.enc_layers
    rows = B_loc if cell.kind == "decode" else B_loc * S         # the token rows
    T = B_loc if cell.kind == "decode" else B_loc * (S + P)      # the decoder's rows
    Te = B_loc * cfg.enc_seq
    bf16, f32 = 2, 4
    train = cell.kind == "train"
    out = dict.fromkeys(("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                         "collective-permute", "count"), 0)
    out["count"] = 0

    def add(kind, nbytes, n=1):
        out[kind] += n * nbytes
        out["count"] += n

    h = Hq // m if Hq % 16 == 0 else Hq
    hkv = Hkv // m if Hkv % 16 == 0 else Hkv
    attn = (d * h * hd, d * hkv * hd, d * hkv * hd, h * hd * d)
    mlp = (d * F // m,) * (3 if cfg.gated_mlp else 2)
    if cfg.enc_dec:
        add("all-gather", rows * d * bf16)                               # the lookup
        if cell.kind != "decode":
            add("all-reduce", Te * d * bf16, 2 * Le)                     # encoder wo, w_down
        add("all-reduce", T * d * bf16, 3 * L)                           # wo, cross wo, w_down
        add("all-reduce", (B_loc if cell.kind == "prefill" else T) * V * f32)   # the logits
        if not train:
            return out
        add("all-reduce", T * d * bf16, 2 * L)                           # recomputed
        add("all-reduce", rows * f32, 3)                                 # the loss
        add("all-gather", T * V * f32)                                   # the logits' grad
        add("all-gather", T * d * f32)                                   # the unembedding's
        add("all-reduce", T * d * bf16, 5 * L)                           # input grads
        add("all-reduce", Te * d * bf16, 4 * Le + 2 * L)
        cross = (d * h * hd, d * h * hd)                                 # enc_cross wk, wv
        weights = [(w, L) for w in (*attn, *mlp, d * h * hd, h * hd * d)] + \
            [(w, Le) for w in (*attn, *mlp)] + [(w, L) for w in cross]
        norms = (L * d, L * d, L * d, Le * d, Le * d, d, d)
        tables = (V * d // m, d // m * V)
        if knob == "fsdp":
            for i, (w, n) in enumerate(weights):
                again = 2 if i < len(attn) + len(mlp) + 2 else 1         # the decoder's
                add("all-gather", w * bf16, again * n)
                add("reduce-scatter", w // dp * bf16, n)
            for w in (*norms, *tables):
                add("all-reduce", w * bf16)
            add("all-reduce", f32, 3)
            return out
        for w in (*(n * w for w, n in weights), *norms, *tables):
            add("all-reduce", w * bf16)
        add("all-reduce", f32)
        return out
    # the prefix-LM
    add("all-reduce", rows * d * bf16)                                   # the lookup
    if cell.kind == "decode":
        add("all-reduce", B_loc * Hq * f32, 2 * L)                       # the softmax's max, sum
        add("all-reduce", B_loc * Hq * hd * f32, L)                      # and accumulator
    add("all-reduce", T * d * bf16, L)                                   # w_down
    tables = (V // m * d, V // m * d)                                    # lookup, unembedding
    if knob == "legacy":
        for w in attn:
            add("all-gather", w * bf16, L)
    if knob == "fsdp":
        for w in (*attn, *mlp):
            add("all-gather", w * bf16, (2 if train else 1) * L)
        for w in tables:
            add("all-gather", w * bf16)
    if not train:
        return out
    add("all-reduce", rows * f32, 3)                                     # the loss
    add("all-reduce", T * d * bf16, 2 * L + 1)                           # w_gate, w_up, unembedding
    norms = (L * d, L * d, d)
    if knob == "fsdp":
        for w in (*attn, *mlp):
            add("reduce-scatter", w // dp * bf16, L)
        for w in tables:
            add("reduce-scatter", w // dp * bf16)
        for w in norms:
            add("all-reduce", w * bf16)
        add("all-reduce", f32, 3)
        return out
    for w in (*(L * w for w in (*attn, *mlp)), tables[0], *norms):
        add("all-reduce", w * bf16)
    add("all-reduce", f32)
    return out


def hand_collectives(cfg, cell, knob: str) -> dict:
    """The collectives of a prefill or a train step on a (2, 2) ("data",
    "model") mesh, by hand (the copy of tests/test_torch_mesh_dryrun.py's
    ``_hand_prefill_collectives`` / ``_hand_train_collectives``, whose
    docstrings give the reckoning).  The production specs split heads over
    a 16-wide "model" axis: ``.reduced()`` llama3-8b keeps its 4 query
    heads whole, the widened config splits its 16 (not its 2 kv heads).
    A train step is checkpointed (remat "minimal", the dry-run's default).
    The MoE, SSM and hybrid configs: :func:`_hand_family_collectives`; the
    encoder-decoder and the prefix-LM: :func:`_hand_encdec_collectives`."""
    if cfg.family in ("audio", "vlm"):
        return _hand_encdec_collectives(cfg, cell, knob)
    if cfg.family != "dense":
        return _hand_family_collectives(cfg, cell, knob)
    m = dp = 2
    B, S, d, L = cell.global_batch // dp, cell.seq_len, cfg.d_model, cfg.n_layers
    hd, Hq, Hkv, F, V = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, \
        cfg.vocab_size
    T, bf16, f32 = B * S, 2, 4
    q_split = Hq % 16 == 0
    out = dict.fromkeys(("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                         "collective-permute", "count"), 0)

    def add(kind, nbytes, k=1):
        out[kind] += k * nbytes
        out["count"] += k

    hq = Hq // m if q_split else Hq
    attn = {"wq": d * hq * hd, "wk": d * Hkv * hd, "wv": d * Hkv * hd, "wo": hq * hd * d}
    mlp = {"w_gate": d * F // m, "w_up": d * F // m, "w_down": F // m * d}
    tables = {"embed": V // m * d, "lm_head": d * V // m}
    if cell.kind == "prefill":
        assert not q_split
        add("all-reduce", T * d * bf16, 1 + L)                 # the lookup, w_down
        if knob == "fsdp":
            for w in (*attn.values(), *mlp.values()):
                add("all-gather", w * bf16, L)
            for w in tables.values():                         # the lookup, the logits
                add("all-gather", w * bf16)
        if knob == "legacy":
            for w in attn.values():
                add("all-gather", w * bf16, L)
        return out
    norms = (L * d, L * d, d)
    add("all-reduce", T * d * bf16)                                   # the lookup
    add("all-reduce", T * d * bf16, L * (2 if q_split else 1))        # w_down, wo
    add("all-reduce", T * d * bf16, L if q_split else 0)              # wo recomputed
    add("all-reduce", T * f32, 3)                                     # the loss
    add("all-reduce", T * d * bf16, L * (3 if q_split else 2) + 1)    # input grads
    add("all-reduce", B * S * Hkv * hd * bf16, 2 * L if q_split else 0)   # k, v grads
    if knob == "fsdp":
        for w in (*attn.values(), *mlp.values()):
            add("all-gather", w * bf16, 2 * L)
            add("reduce-scatter", w // dp * bf16, L)
        for w in tables.values():
            add("all-gather", w * bf16)
            add("reduce-scatter", w // dp * bf16)
        for w in norms:
            add("all-reduce", w * bf16)
        add("all-reduce", f32, 3)
        return out
    if knob == "legacy":
        for w in attn.values():
            add("all-gather", w * bf16, 2 * L)
        attn = {k: w // m for k, w in attn.items()}
    for w in (*(L * w for w in attn.values()), *(L * w for w in mlp.values()),
              *tables.values(), *norms):
        add("all-reduce", w * bf16)
    add("all-reduce", f32)
    return out


def mesh_argument_bytes(rec: dict, knobs: tuple) -> int:
    """Per-device argument bytes of a mesh record by reckoning: each leaf's
    global bytes over its spec's shard count on the production mesh, the
    optimizer's m/v (f32) as their params, the batch inputs' rows over the
    batch axes (an encoder's frames and a prefix too), the cache by
    ``cache_specs`` (an encoder-decoder's cross k/v too); a decode step's
    params without the encoder's, which it never reads."""
    from repro_torch.configs import SHAPE_CELLS, get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.dryrun import ENCODER_LEAVES, input_specs
    from repro_torch.models.transformer import param_struct
    from repro_torch.tree import leaves_with_paths

    cfg, cell = get_config(rec["arch"]), SHAPE_CELLS[rec["cell"]]
    multi = rec["mesh"] == "multi"
    sizes = {"pod": 2 if multi else 1, "data": 16, "model": 16}
    b = ("pod", "data") if multi else ("data",)

    def share(t, spec) -> int:
        n = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                n *= sizes[a]
        return t.numel() * t.element_size() // n

    fallback = "head_dim" if "--legacy-sharding" in knobs else "replicate"
    with shd.options(fsdp="--fsdp" in knobs, attn_kv_fallback=fallback):
        params = param_struct(cfg)
        if cell.kind == "decode":
            params = {k: v for k, v in params.items() if k not in ENCODER_LEAVES}
        total = sum(share(t, shd.spec_for_param(path[-1], tuple(t.shape)))
                    for path, t in leaves_with_paths(params))
        specs = input_specs(cfg, cell)
        if cell.kind == "train":
            total += 2 * sum(share(t.float(), shd.spec_for_param(path[-1], tuple(t.shape)))
                             for path, t in leaves_with_paths(params))
            total += 4                                                   # step, int32
            total += sum(share(t, (b,)) for t in specs["batch"].values())
        elif cell.kind == "prefill":
            total += sum(share(t, (b,)) for t in specs.values())
        else:
            batched = cell.global_batch >= 16 * (2 if multi else 1)
            total += share(specs["tokens"], (b,) if batched else (None,))
            cspecs = shd.cache_specs(cfg, cell, multi_pod=multi)
            total += sum(share(t, cspecs.get(k, ())) for k, t in specs["cache"].items())
    return total


def mesh_dryrun_phase(procs: list) -> None:
    """Wait for the mesh dry-run (:func:`start_mesh_dryrun`) and check its
    records: no ``error``; ``chips`` 256 / 512; per-device argument bytes
    equal to the reckoning (:func:`mesh_argument_bytes`); collective bytes
    above 0 on every train cell; all-to-all on every MoE record but the
    ``--no-ep`` one, whose flops must exceed the expert-parallel path's;
    on a prefill, flash counted once a layer at the per-device work of its
    ``wgmma`` plan (batch over the batch axes, q heads over "model"; the
    window path's block of rank 0 for hymba; whisper-medium's decoder
    alone, its encoder and cross step taking ``chunked_attention``), or not
    at all where the softcap (gemma2-9b) or the prefix (paligemma-3b)
    keeps prefill off flash or there is no attention (mamba2-130m).  Each
    record tagged ``untiled`` (the tiled path switched off) is printed
    beside its tiled record, whose flops must be the lower and whose
    collectives the same.  Each step of MESH_HAND_JOBS must issue the
    collectives of its hand count (:func:`hand_collectives`), kind by kind
    and in number.  The counts are of one rank, on ``meta``: no card time."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import plans, work

    t0 = time.perf_counter()
    deadline = t0 + MESH_DRYRUN_TIMEOUT_S
    rcs = []
    for proc in procs:
        try:
            rcs.append(proc.wait(timeout=max(1.0, deadline - time.perf_counter())))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            raise CheckFailed(f"the mesh dry-run ran past {MESH_DRYRUN_TIMEOUT_S} s")
    waited = time.perf_counter() - t0
    for w, rc in enumerate(rcs):
        log = (MESH_DRYRUN_DIR / f"worker{w}.log").read_text()
        check(rc == 0, f"mesh dry-run worker {w} exited {rc}: {log[-3000:]}")
    seconds = [json.loads((MESH_DRYRUN_DIR / f"done{w}.json").read_text())["seconds"]
               for w in range(len(procs))]
    recs = [json.loads(l) for w in range(len(procs))
            for l in (MESH_DRYRUN_DIR / f"ledger{w}.jsonl").read_text().splitlines()]
    hands = [h for w in range(len(procs))
             for h in json.loads((MESH_DRYRUN_DIR / f"hand{w}.json").read_text())]
    want = sum(2 if mesh == "both" else 1 for _, _, mesh, _, _ in MESH_DRYRUN_JOBS)
    check(len(recs) == want, f"the mesh dry-run wrote {len(recs)} records, want {want}")
    check(len(hands) == len(MESH_HAND_JOBS), f"{len(hands)} hand-counted steps")
    for h in hands:
        hand = hand_collectives(_hand_cfg(h["config"]), _hand_cell(h["kind"], h["config"]),
                                h["knob"])
        print(f"[mesh-dryrun] hand count on (2, 2): {h['kind']} {h['config']} "
              f"{' '.join(h['flags']) or 'default'}: counted {json.dumps(h['collective_bytes'])}"
              f", by hand {json.dumps(hand)}", flush=True)
        check(h["collective_bytes"] == hand,
              f"{h['kind']} {h['config']} {h['flags']}: collectives {h['collective_bytes']}, "
              f"by hand {hand}")
    knobs_of = {tag: knobs for _, _, _, knobs, tag in MESH_DRYRUN_JOBS}
    for rec in recs:
        check("error" not in rec, f"mesh dry-run record {rec}")
        check(rec["chips"] == {"single": 256, "multi": 512}[rec["mesh"]], f"chips of {rec}")
        args = mesh_argument_bytes(rec, knobs_of[rec["tag"]])
        check(rec["argument_bytes"] == args, f"{rec['arch']} {rec['cell']} {rec['mesh']} "
              f"{rec['tag']}: argument_bytes {rec['argument_bytes']}, reckoned {args}")
        coll = rec["collective_bytes"]
        if rec["kind"] == "train":
            check(sum(v for k, v in coll.items() if k != "count") > 0 and coll["count"] > 0,
                  f"{rec['arch']} {rec['cell']} {rec['mesh']}: no collective")
        cfg = get_config(rec["arch"])
        if cfg.family == "moe":
            # the expert-parallel path exchanges capacity blocks; --no-ep's
            # global dispatch none
            a2a = coll["all-to-all"]
            check(a2a == 0 if rec["tag"] == "noep" else a2a > 0,
                  f"{rec['arch']} {rec['cell']} {rec['mesh']} {rec['tag']}: all-to-all {a2a}")
        flash = {}
        if rec["kind"] == "prefill":
            calls = rec["kernel_calls"].get("flash_attention", 0)
            if cfg.attn_softcap > 0 or cfg.attention == "none" or cfg.prefix_len:
                check(calls == 0 and rec["kernel_flops"] == 0, f"{rec['arch']} prefill: flash")
            else:
                n_b = 16 * (2 if rec["mesh"] == "multi" else 1)
                B, S, hd = rec["global_batch"] // n_b, rec["seq_len"], cfg.resolved_head_dim
                window = None
                if cfg.attention == "sliding":
                    # the window path: rank 0's block, its S/16 queries and no
                    # key-only rows before them, every head
                    Hq, Hkv, S, window = cfg.n_heads, cfg.n_kv_heads, S // 16, cfg.window
                else:
                    Hq = cfg.n_heads // 16 if cfg.n_heads % 16 == 0 else cfg.n_heads
                    G = cfg.n_heads // cfg.n_kv_heads
                    Hkv = cfg.n_kv_heads // 16 if cfg.n_kv_heads % 16 == 0 else -(-Hq // G)
                q = torch.empty(B, S, Hq, hd, dtype=torch.bfloat16, device="meta")
                k = torch.empty(B, S, Hkv, hd, dtype=torch.bfloat16, device="meta")
                plan = plans.fa_plan(B, S, S, Hq, Hkv, hd, torch.bfloat16, True, window,
                                     work._align(q, k, k))
                per_call = work.flash_attention(q, k, k, causal=True, window=window)["flops"]
                flash = {"calls": calls, "variant": plan.variant, "local_q": [B, S, Hq, hd],
                         "local_kv_heads": Hkv, "window": window, "flops_per_call": per_call}
                check(plan.variant == "wgmma" and calls == cfg.n_layers
                      and rec["kernel_flops"] == cfg.n_layers * per_call,
                      f"{rec['arch']} prefill {rec['mesh']}: flash {rec['kernel_calls']} "
                      f"{rec['kernel_flops']}, want {cfg.n_layers} x {plan.variant} {per_call}")
        line = {k: rec[k] for k in ("arch", "cell", "mesh", "tag", "chips", "global_batch",
                                    "flops", "bytes_accessed", "argument_bytes", "temp_bytes",
                                    "peak_bytes", "collective_bytes", "kernel_calls",
                                    "kernel_flops", "lower_s")}
        if flash:
            line["flash_plan"] = flash
        print(f"[mesh-dryrun] {json.dumps(line)}", flush=True)
    by = {(r["arch"], r["cell"], r["mesh"], r["tag"]): r for r in recs}
    for (arch, cell, mesh, tag), generic in sorted(by.items()):
        if tag != "untiled":
            continue
        tiled = by[(arch, cell, mesh, "")]
        line = {k: {"tiled": tiled[k], "generic": generic[k]}
                for k in ("flops", "bytes_accessed", "peak_bytes", "collective_bytes")}
        line.update(flops_ratio=tiled["flops"] / generic["flops"],
                    bytes_ratio=tiled["bytes_accessed"] / generic["bytes_accessed"])
        print(f"[mesh-dryrun] tiled attention, {arch} {cell} {mesh}: {json.dumps(line)}",
              flush=True)
        check(tiled["flops"] < generic["flops"] and
              tiled["collective_bytes"] == generic["collective_bytes"],
              f"{arch} {cell}: the tiled path's flops {tiled['flops']} not below the generic "
              f"loop's {generic['flops']}, or its collectives moved")
    ep, noep = (by[("qwen3-moe-30b-a3b", "prefill_32k", "single", t)] for t in ("", "noep"))
    check(noep["flops"] > ep["flops"], f"--no-ep prefill flops {noep['flops']} not above the "
          f"expert-parallel path's {ep['flops']}")
    ratio = noep["flops"] / ep["flops"]
    print(f"[mesh-dryrun] qwen3-moe-30b-a3b prefill_32k single: --no-ep flops "
          f"{noep['flops']!r} / expert-parallel {ep['flops']!r} = {ratio:.3f}", flush=True)
    print(f"[time] mesh-dryrun phase: {len(recs)} records and {len(hands)} hand-counted steps "
          f"in {len(procs)} processes of their own (the card hidden) after the card's timed "
          f"phases, {max(seconds):.1f}s the longest ({sum(seconds):.1f}s in all); waited "
          f"{waited:.1f}s for them; counts of one rank on meta, no card time", flush=True)


TRACE_SEQ, TRACE_BATCH, TRACE_IMG = 128, 1, 32
CNNS = ("vgg16", "resnet18", "resnet50")


def trace_phase() -> None:
    """The modeling plane's front end (``repro_torch.trace``) on every
    config at published width and depth (module docstring, phase 16).  It
    runs on ``meta`` tensors and the host: it launches no kernel."""
    from repro_torch.analysis import preflight
    from repro_torch.configs import get_config, list_archs
    from repro_torch.core import SchedulePolicy, default_mapping, simulate, usecase_arch
    from repro_torch.core.schedule import POLICIES
    from repro_torch.core.workload import MODEL_BUILDERS, lm_workload
    from repro_torch.kernels import ops
    from repro_torch.trace import diff_workloads, lower_graph, summarize, trace_model
    from repro_torch.trace.capture import cnn_graph

    card = card_line()
    arch16 = usecase_arch(16)
    mapping = default_mapping(arch16, "spatial")
    ops.reset_launch_counts()
    t_phase = time.perf_counter()

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def report(label, graph, t_cap, hand=None):
        w, t_low = timed(lambda: lower_graph(graph))
        s = summarize(w)
        line = (f"[trace] {label}: {graph.n_eqns()} eqns, digest {graph.digest()[:16]}, "
                f"{s['n_mvm']} MVM nodes, mvm macs {s['mvm_macs']!r}")
        if hand is not None:
            d = diff_workloads(w, hand)
            check(d["mvm_match"] and d["total_weights_equal"], f"{label}: traced {d['traced']} "
                  f"against the hand DAG's {d['hand']}")
            line += f" (= hand's), elementwise surplus {d['elementwise_surplus']!r}"
        return w, line + f"; capture {t_cap:.3f}s, lower {t_low:.3f}s"

    def simulated(label, w, line):
        check(sorted(w.topo_order()) == sorted(w.nodes) and bool(w.levels()),
              f"{label}: no topological order")
        cycles, t0 = {}, time.perf_counter()
        for pol in POLICIES:
            rep = simulate(arch16, w, mapping, schedule=SchedulePolicy(pol))
            check(rep.latency_cycles > 0, f"{label}: {pol} gives {rep.latency_cycles} cycles")
            cycles[pol] = rep.latency_cycles
        return line + (f", simulate {time.perf_counter() - t0:.3f}s, cycles on usecase_arch(16) "
                       f"{json.dumps(cycles)}")

    for name in list_archs():
        cfg = get_config(name)
        hand = lm_workload(cfg, seq_len=TRACE_SEQ, batch=TRACE_BATCH)
        for step in ("forward", "prefill", "decode"):
            graph, t_cap = timed(lambda: trace_model(cfg, step=step, seq_len=TRACE_SEQ,
                                                     batch=TRACE_BATCH))
            label = f"{name} {step} (S {TRACE_SEQ}, B {TRACE_BATCH})"
            w, line = report(label, graph, t_cap, None if step == "decode" else hand)
            if step == "decode":
                line = simulated(label, w, line)
            print(line, flush=True)
    for model in CNNS:
        graph, t_cap = timed(lambda: cnn_graph(model, TRACE_IMG, 100))
        _, line = report(f"{model} (img {TRACE_IMG})", graph, t_cap,
                         MODEL_BUILDERS[model](TRACE_IMG, 100))
        print(line, flush=True)

    cfg = get_config("llama3-8b")
    digests = [trace_model(cfg, step="forward", seq_len=TRACE_SEQ).digest() for _ in range(2)]
    check(digests[0] == digests[1], f"two captures of llama3-8b forward differ: {digests}")
    print(f"[trace] llama3-8b forward captured twice: digest {digests[0][:16]} both times",
          flush=True)
    for S in (8, TRACE_SEQ):
        graph, t_cap = timed(lambda: trace_model(cfg, step="forward", seq_len=S,
                                                 source="model"))
        w = lower_graph(graph)
        preflight(w, strict=True, where="chip_smoke.trace")
        hand = lm_workload(cfg, seq_len=S, batch=1)
        t, h = summarize(w), summarize(hand)
        ratio = t["mvm_macs"] / h["mvm_macs"]
        check(t["mvm_weights"] == h["mvm_weights"],
              f"llama3-8b model source S {S}: mvm weights {t['mvm_weights']} != {h['mvm_weights']}")
        if S == 8:
            check(0.9 < ratio < 1.2, f"llama3-8b model source S 8: macs ratio {ratio!r}")
        print(f"[trace] llama3-8b forward, source=model (the port's forward on meta params), "
              f"S {S}: {graph.n_eqns()} eqns, {t['n_mvm']} MVM nodes, mvm macs {t['mvm_macs']!r}"
              f" = {ratio!r} x the hand DAG's, mvm weights equal; capture {t_cap:.3f}s",
              flush=True)
    launched = ops.launch_counts()
    check(sum(launched.values()) == 0, f"the trace phase launched {launched}")
    print(f"[time] trace phase {time.perf_counter() - t_phase:.1f}s on the host, no launch "
          f"[{card}]", flush=True)


# what the kernels line gives of each further variant of a kernel (None
# where a row has no such number)
VARIANT_KEYS = ("shape", "launches", "ms", "eager_ms", "general_ms", "general_contiguous_ms",
                "levers", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "share_of_bound", "x_library")


# ---------------------------------------------------------------------------
# Phase 16b: the exploration plane's CLIs, priced by this run's profile
# ---------------------------------------------------------------------------

EXPLORE_DIR = HERE / "build" / "explore"
EXPLORE_REPORT_OF = "qwen3-4b"
EXPLORE_REPORT = HERE / "build" / "qwen3-4b_cost.json"       # cost (c), written by cost_phase
EXPLORE_FAULTS = "seed=3,crash=0.2,exc=0.25,times=1"
EXPLORE_SWEEP = ("sparsity", "--model", "resnet18", "--ratios", "0.7,0.8", "--workers", "2",
                 "--pareto")
EXPLORE_LM_RATIOS = (0.5, 0.7, 0.8, 0.9)      # the CLI's default ratios
EXPLORE_LM_POLICIES = ("monolithic", "resident")
EXPLORE_CLI_LIMIT_S = 300


class CliChains:
    """Chains of CLI runs (``python -m <module> ...`` from the checkout's
    root), each chain on a thread of its own and each run in a session of
    its own, so that :meth:`stop` ends it with its fork server and
    workers.  A run is on the host with the card hidden unless it asks for
    the card."""

    def __init__(self, prof_path: str):
        import concurrent.futures
        import threading

        self.prof_path = prof_path                 # the cost phase's profile, repo-relative
        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=8)
        self.lock = threading.Lock()
        self.procs, self.futures, self.seconds = [], {}, {}
        self.stopped = False
        self.t0 = time.perf_counter()

    def run(self, label: str, args, *, card: bool = False, env=None, module: bool = True,
            phase: str = "explore") -> str:
        """One run's standard output (``python -m *args``, or ``python
        *args`` when not ``module``); a nonzero exit fails the run."""
        full = {**os.environ, "PYTHONPATH": str(HERE / "src"), "OMP_NUM_THREADS": "1",
                **(env or {})}
        if not card:
            full["CUDA_VISIBLE_DEVICES"] = ""
        argv = [sys.executable, *(["-m"] if module else []), *args]
        with self.lock:
            if self.stopped:
                raise CheckFailed(f"[{phase}] {label}: the phase was stopped")
            proc = subprocess.Popen(argv, cwd=HERE, env=full, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    start_new_session=True)
            self.procs.append(proc)
        t0 = time.perf_counter()
        try:
            out, err = proc.communicate(timeout=EXPLORE_CLI_LIMIT_S)
        except subprocess.TimeoutExpired:
            self._kill(proc)
            raise CheckFailed(f"[{phase}] {label}: no exit within {EXPLORE_CLI_LIMIT_S} s")
        self.seconds[label] = time.perf_counter() - t0
        check(proc.returncode == 0, f"[{phase}] {label} exited {proc.returncode}: "
                                    f"{' '.join(argv[1:])[:300]}\n{(err or out)[-3000:]}")
        return out

    def start(self, name: str, fn, *args) -> None:
        self.futures[name] = self.pool.submit(fn, self, *args)

    @staticmethod
    def _kill(proc) -> None:
        if proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()

    def stop(self) -> None:
        with self.lock:
            self.stopped = True
            procs = list(self.procs)
        for proc in procs:
            self._kill(proc)
        self.pool.shutdown(wait=True, cancel_futures=True)


def _explore_collect(ch):
    ch.run("calibrate collect", ["repro_torch.calibrate", "collect", "--kernels", "--sizes", "256",
                                 "--repeats", "1", "--fresh", "--out", "build/explore/calib.jsonl"],
           card=True)


def _explore_refit(ch, prof_path: str):
    ch.run("calibrate fit", ["repro_torch.calibrate", "fit", "--ledger",
                             "build/microbench_samples.jsonl", "--name", "refit", "--out",
                             "build/explore/refit.json"])
    show = ch.run("calibrate show", ["repro_torch.calibrate", "show", "build/explore/refit.json",
                                     "--check"])
    return show, ch.run("calibrate diff", ["repro_torch.calibrate", "diff",
                                           "build/explore/refit.json", prof_path])


def _explore_lm(ch, prof_path: str):
    out = ch.run("explore lm", [
        "repro_torch.explore", "lm", "--config", "qwen3-4b", "--workload", "traced:qwen3-4b",
        "--seq-len", "64", "--ratios", ",".join(map(str, EXPLORE_LM_RATIOS)), "--profile",
        prof_path, "--diff-analytic", "--schedule", ",".join(EXPLORE_LM_POLICIES),
        "--invocations", "16", "--top-k", "3", "--workers", "1",
        "--run-dir", "build/explore/lm", "--csv", "build/explore/lm.csv"])
    resume = ch.run("explore lm --resume", ["repro_torch.explore", "--resume", "build/explore/lm"])
    store = ch.run("explore --check-store", ["repro_torch.explore", "--check-store",
                                             "build/explore/lm"])
    return out, resume, store


def _explore_sweep(ch, faulted: bool):
    if not faulted:
        return ch.run("explore sparsity", ["repro_torch.explore", *EXPLORE_SWEEP, "--csv",
                                           "build/explore/clean.csv"])
    return ch.run("explore sparsity under faults", [
        "repro_torch.explore", *EXPLORE_SWEEP, "--run-dir", "build/explore/faults", "--timeout",
        "60", "--csv", "build/explore/faulted.csv"], env={"REPRO_FAULTS": EXPLORE_FAULTS})


def _explore_energy(ch):
    return ch.run("obs energy", ["repro_torch.obs", "energy", "--report", str(
        EXPLORE_REPORT.relative_to(HERE)), "--csv", "build/explore/energy.csv", "--json",
        "build/explore/energy.json"])


def _explore_timeline(ch):
    out = ch.run("obs timeline", ["repro_torch.obs", "timeline", "--report", str(
        EXPLORE_REPORT.relative_to(HERE)), "--out", "build/explore/timeline.json"])
    return out, ch.run("obs check", ["repro_torch.obs", "check", "build/explore/timeline.json"])


def start_explore(prof) -> CliChains:
    """Start the exploration plane's CLIs (module docstring, phase 16b):
    ``calibrate collect --kernels`` on the card, and on the host with the
    card hidden the refit of this run's microbench samples, the traced
    qwen3-4b sweep priced by the profile ``cost_phase`` fitted, the
    sparsity sweep with and without faults, and the energy table and
    timeline of qwen3-4b's cost report."""
    import shutil

    shutil.rmtree(EXPLORE_DIR, ignore_errors=True)
    EXPLORE_DIR.mkdir(parents=True)
    prof_path = str(prof.save_addressed(HERE / "build" / "profiles").relative_to(HERE))
    ch = CliChains(prof_path)
    ch.start("collect", _explore_collect)
    ch.start("refit", _explore_refit, prof_path)
    ch.start("lm", _explore_lm, prof_path)
    ch.start("clean", _explore_sweep, False)
    ch.start("faulted", _explore_sweep, True)
    ch.start("energy", _explore_energy)
    ch.start("timeline", _explore_timeline)
    ch.start("analysis", _analysis_chain)
    return ch


def _diff_ratios(out: str) -> list:
    """(row keys, latency ratio, energy ratio) of each row of the lm
    sweep's ``calibrated vs analytic`` table."""
    lines = out.split("== calibrated vs analytic (", 1)[1].splitlines()
    rows = []
    for line in lines[2:]:
        if not line.strip():
            break
        cells = line.split()
        rows.append((" ".join(cells[:-4]), float(cells[-2]), float(cells[-1])))
    return rows


def _top_rows(out: str, k: int) -> list:
    lines = out.split(f"== top-{k} by latency_ms", 1)[1].splitlines()
    return [" ".join(line.split()) for line in lines[1:k + 2]]


def explore_phase(ch: CliChains, waited_from: float) -> None:
    """Read and check the exploration plane's CLIs (phase 16b); every
    failure fails the run."""
    import csv

    from repro_torch.calibrate.harvest import read_samples
    from repro_torch.core import TABLE_II_PATTERNS
    from repro_torch.core.report import CostReport

    card = card_line()
    results = {name: fut.result() for name, fut in ch.futures.items()}
    done = time.perf_counter()

    samples = read_samples(EXPLORE_DIR / "calib.jsonl")
    check(sorted(s.op_class for s in samples) == ["attention", "intrablock", "matmul", "matmul"],
          f"[explore] collect: op classes {[s.op_class for s in samples]}")
    for s in samples:
        meta = dict(s.meta)
        check(meta["impl"] == "cuda" and s.time_s > 0 and meta["device"].startswith("cuda:"),
              f"[explore] collect: {s.op_class} {meta} is not a timed CUDA sample")
        print(f"[explore] calibrate collect --kernels (card): {s.op_class} {meta['shape']}: "
              f"{s.time_s * 1e3:.4f} ms ({meta['impl']}, {meta['device']}) [{card}]", flush=True)

    show, diff = results["refit"]
    check("OK: schema-valid, round-trips" in show, f"[explore] show --check:\n{show}")
    check("identical physical content (peaks + efficiencies)" in diff,
          f"[explore] the refit differs from the cost phase's profile:\n{diff}")
    print(f"[explore] calibrate fit over build/microbench_samples.jsonl, show --check, diff "
          f"against {ch.prof_path}: identical physical content (peaks + efficiencies)",
          flush=True)

    out, resume, store = results["lm"]
    check("calibrated mode: profile " in out and "traced workload 'traced-qwen3-4b-forward'" in out,
          f"[explore] lm: no calibrated traced sweep:\n{out[:2000]}")
    n_rows = len(EXPLORE_LM_POLICIES) * sum(len(TABLE_II_PATTERNS(r, c_in=16))
                                            for r in EXPLORE_LM_RATIOS)
    ratios = _diff_ratios(out)
    check(len(ratios) == n_rows, f"[explore] lm: {len(ratios)} diff rows, want {n_rows}")
    for keys, lat, en in ratios:
        check(math.isfinite(lat) and lat > 0 and math.isfinite(en) and en > 0,
              f"[explore] lm {keys}: calibrated/analytic ratios {lat}, {en}")
    with open(EXPLORE_DIR / "lm.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == n_rows and all(
        math.isfinite(float(r[c])) and float(r[c]) > 0 for r in rows
        for c in ("latency_ms", "energy_uj", "speedup")), "[explore] lm: a row not finite")
    engine = next(line for line in out.splitlines() if line.startswith("engine: "))
    print(f"[explore] lm qwen3-4b traced (seq 64) priced by {ch.prof_path}, schedules "
          f"monolithic,resident x 16 invocations: {len(rows)} rows; {engine}", flush=True)
    for row in _top_rows(out, 3):
        print(f"[explore] lm top-3 by latency_ms: {row}", flush=True)
    lat = [r[1] for r in ratios]
    en = [r[2] for r in ratios]
    print(f"[explore] lm calibrated/analytic over {len(ratios)} rows: latency ratio "
          f"{min(lat)}..{max(lat)}, energy ratio {min(en)}..{max(en)}", flush=True)
    for keys, l_r, e_r in ratios[:2] + ratios[-2:]:
        print(f"[explore] lm ratio {keys}: latency {l_r}, energy {e_r}", flush=True)
    check(" 0 evaluated on " in resume, f"[explore] lm --resume evaluated points:\n{resume}")
    check("store check: ok" in store, f"[explore] --check-store:\n{store}")
    print(f"[explore] lm --resume: "
          f"{next(x for x in resume.splitlines() if x.startswith('engine: '))}; --check-store: "
          f"{' | '.join(store.strip().splitlines())}", flush=True)

    clean, faulted = (EXPLORE_DIR / "clean.csv").read_bytes(), \
        (EXPLORE_DIR / "faulted.csv").read_bytes()
    check(clean == faulted and clean.count(b"\n") == 16,
          "[explore] the CSV under faults differs from the fault-free one")
    f_engine = next(x for x in results["faulted"].splitlines() if x.startswith("engine: "))
    check(" retried" in f_engine and " 0 failed" in f_engine, f"[explore] faults: {f_engine}")
    print(f"[explore] sparsity resnet18 under REPRO_FAULTS={EXPLORE_FAULTS}: CSV byte-identical "
          f"to the fault-free run ({len(clean)} bytes); {f_engine}", flush=True)

    rep = CostReport.from_dict(json.loads(EXPLORE_REPORT.read_text()))
    with open(EXPLORE_DIR / "energy.csv", newline="") as f:
        comps = list(csv.DictReader(f))
    total = sum(float(r["energy_pj"]) for r in comps) / 1e6
    err = abs(total - rep.total_energy_uj) / rep.total_energy_uj
    check(len(comps) == len(rep.energy_pj) and err <= 1e-9,
          f"[explore] energy rows sum to {total} uJ, the report {rep.total_energy_uj} uJ")
    print(f"[explore] obs energy --report (qwen3-4b cost (c)): {len(comps)} components sum to "
          f"{total!r} uJ, the report's total {rep.total_energy_uj!r} uJ (rel err {err:.3g})",
          flush=True)
    tl_out, tl_check = results["timeline"]
    check(tl_check.startswith("ok: "), f"[explore] obs check: {tl_check}")
    print(f"[explore] obs timeline: {' '.join(tl_out.split())[:300]}; check: {tl_check.strip()}",
          flush=True)
    print("[explore] CLI seconds (host, card hidden but for collect), each beside its seconds "
          "when every process of the port imported torch: "
          + json.dumps({k: [round(v, 2), EXPLORE_SECONDS_WITH_TORCH.get(k)]
                        for k, v in ch.seconds.items() if k not in ANALYSIS_LABELS}), flush=True)
    print(f"[time] explore phase {done - ch.t0:.1f}s from its start, "
          f"{max(0.0, done - waited_from):.1f}s past the mesh dry-run; checks "
          f"{time.perf_counter() - done:.2f}s", flush=True)


# ---------------------------------------------------------------------------
# Phase 16c: the static checker, and the host plane with torch blocked
# ---------------------------------------------------------------------------

# Each CLI's seconds in a whole run of this script when every process of
# the port imported torch (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).
EXPLORE_SECONDS_WITH_TORCH = {
    "calibrate collect": 18.11, "calibrate fit": 21.15, "calibrate show": 15.04,
    "calibrate diff": 10.66, "explore lm": 56.19, "explore lm --resume": 20.29,
    "explore --check-store": 8.42, "explore sparsity": 34.79,
    "explore sparsity under faults": 36.19, "obs energy": 16.58, "obs timeline": 16.35,
    "obs check": 16.02}
ANALYSIS_OUT = HERE / "build" / "analysis.json"
ANALYSIS_PASSES = {"import-boundary", "cache-key", "model-plane", "determinism"}
ANALYSIS_LABELS = ("host plane imports, torch blocked", "analysis --all")
HOST_PLANE = ("core", "explore", "trace", "configs", "calibrate", "analysis", "obs")
# imports repro_torch and every module of its host plane; prints how many,
# the torch/triton/jax modules loaded and the seconds it took
HOST_PLANE_IMPORTS = f"""
import importlib, json, pkgutil, sys, time
t0 = time.perf_counter()
names = ["repro_torch"]
for sub in {HOST_PLANE!r}:
    pkg = importlib.import_module("repro_torch." + sub)
    names.append(pkg.__name__)
    names += [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "triton", "jax"))
print(json.dumps({{"modules": len(names), "loaded": loaded,
                  "seconds": time.perf_counter() - t0}}))
"""


def _analysis_chain(ch):
    """Phase 16c's processes, one after the other, each with torch,
    triton and jax shadowed: the host plane's imports, then the checker."""
    t0 = time.perf_counter()
    shadow = HERE / "build" / "analysis_shadow"
    shadow.mkdir(parents=True, exist_ok=True)
    for name in ("torch", "triton", "jax"):
        (shadow / f"{name}.py").write_text(f"raise ImportError('{name} is shadowed')\n")
    env = {"PYTHONPATH": f"{shadow}{os.pathsep}{HERE / 'src'}"}
    imports = ch.run(ANALYSIS_LABELS[0], ["-c", HOST_PLANE_IMPORTS], module=False, env=env,
                     phase="analysis")
    ANALYSIS_OUT.unlink(missing_ok=True)
    ch.run(ANALYSIS_LABELS[1], ["repro_torch.analysis", "--all", "--format", "json", "--out",
                                str(ANALYSIS_OUT.relative_to(HERE))], env=env, phase="analysis")
    return json.loads(imports), time.perf_counter() - t0


def analysis_phase(ch: CliChains) -> None:
    """Read and check phase 16c; every failure fails the run."""
    imports, seconds = ch.futures["analysis"].result()
    check(imports["loaded"] == [],
          f"[analysis] importing the host plane loaded {imports['loaded'][:10]}")
    check(imports["modules"] > 50, f"[analysis] only {imports['modules']} host-plane modules")
    report = json.loads(ANALYSIS_OUT.read_text())
    check(set(report["passes"]) == ANALYSIS_PASSES and len(report["passes"]) == 4,
          f"[analysis] passes {report['passes']}")
    check(report["ok"] and report["counts"]["error"] == 0,
          f"[analysis] {report['counts']}: {report['diagnostics'][:5]}")
    print(f"[analysis] host plane with torch, triton and jax shadowed: {imports['modules']} "
          f"modules imported in {imports['seconds']:.2f}s, none of the three loaded", flush=True)
    print(f"[analysis] python -m repro_torch.analysis --all (shadowed too): exit 0, passes "
          f"{report['passes']}, counts {json.dumps(report['counts'])}", flush=True)
    print(f"[analysis] seconds (host, beside the explore chains): phase {seconds:.2f}; "
          + json.dumps({k: round(ch.seconds[k], 2) for k in ANALYSIS_LABELS}), flush=True)


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
    mesh_dryrun, explore = [], None

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
                                          f"{kdir}/bitserial_profile.py:41"),
               "decode_attention": ("cuda", f"{csrc}/decode_attention.cu",
                                    "none (jnp chunked_attention over the cache)")}
    try:
        ptxas_phase()
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
        t0 = time.perf_counter()
        train_phase(get_config("qwen3-4b"), rows)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[time] qwen3-4b train phase {time.perf_counter() - t0:.1f}s; device memory "
              f"after freeing it {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
        later = []
        for name, path in (("gemma-7b", gemma7b_path), ("gemma2-9b", gemma2_path),
                           ("qwen3-moe-30b-a3b", moe_path), ("mamba2-130m", mamba2_path),
                           ("hymba-1.5b", hymba_path), ("whisper-medium", whisper_path),
                           ("paligemma-3b", paligemma_path)):
            t0 = time.perf_counter()
            later.append(path(get_config(name), rows))
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[time] {name} path {time.perf_counter() - t0:.1f}s; device memory after "
                  f"freeing it {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
        t0 = time.perf_counter()
        mesh_phase(rows)
        print(f"[time] mesh phase {time.perf_counter() - t0:.1f}s", flush=True)
        samples = microbench_phase()
        prof = cost_phase(samples, [qwen, llama, *later])
        dryrun_phase(samples, prof)
        mesh_dryrun = start_mesh_dryrun()          # the last timed card phase is done
        explore = start_explore(prof)
        trace_phase()
        mesh_dryrun_phase(mesh_dryrun)
        explore_phase(explore, time.perf_counter())
        analysis_phase(explore)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for proc in mesh_dryrun:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if explore is not None:
            explore.stop()

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
                        "launches_by_path": r.get("launches_by_path", {}),
                        **({"variants": {v: {k: l.get(k) for k in VARIANT_KEYS}
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
    if "--mesh-dryrun" in sys.argv:
        at = sys.argv.index("--mesh-dryrun")
        sys.exit(mesh_dryrun_worker(int(sys.argv[at + 1]), int(sys.argv[at + 2])))
    if "--mesh-rank" in sys.argv:
        sys.exit(mesh_rank(int(sys.argv[sys.argv.index("--mesh-rank") + 1]),
                           sys.argv[sys.argv.index("--mesh-case") + 1]))
    sys.exit(main())
