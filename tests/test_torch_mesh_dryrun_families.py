"""The dry-run on a mesh of the MoE, SSM and hybrid families
(``repro_torch.launch.dryrun --mesh``): the expert-parallel MoE block, the
global dispatch of ``--no-ep``, the Mamba-2 mixer and the sequence-parallel
window attention, each on its local shards
(:mod:`repro_torch.distributed.partition`).

* (d) the live oracle: the reference's own ``lower_cell`` on a (2, 2)
  ("data", "model") mesh of 4 virtual devices (tests/_jax_mesh_reference.py)
  against the port on a fake 4-rank (2, 2) world, for qwen3-moe-30b-a3b
  ``.reduced()`` (prefill, train, under ``--fsdp`` and ``--no-ep``),
  hymba-1.5b ``.reduced()`` with 5 query heads (the window path: prefill
  and train at S 2048) and mamba2-130m ``.reduced()`` (prefill and decode;
  8 SSM heads, which divide 2, and widened to 3, which do not, as
  mamba2's 24 and hymba's 50 do not divide 16).  Per-device argument
  bytes equal.  Flops: the port's matmul flops equal XLA's dot flops
  (2·M·N·K each, as both count them) within ``XLA_FLOPS_TOL``, once the op
  classes the two split apart are taken off by the port's own reckoning
  (:func:`_beyond_xla`).  The totals (converts off) are printed, not
  held: at these widths the elementwise share is large, and XLA's CPU
  module counts 1 an element on ops the port's counter does not see as
  XLA lays them out (PERF.md gives both).  Split apart: the flash
  kernel's work put on the reference's attention tiles; the Mamba-2
  mixer's ``w_in`` columns (the port projects B and C whole on every
  rank, XLA an even 1/M of the columns it then permutes) and its
  ``C·B`` scores (whole N here, split N and all-reduced there); the
  window path's first rank, whose block has no key-only rows (the
  reference pads W zero rows before every rank's block);
* (e) every collective of each (2, 2) step equals a hand count
  (:func:`_hand_collectives`, of which ``chip_smoke.py::hand_collectives``
  is a copy), kind by kind and in number;
* the production records: every cell of the four configs on both meshes
  in the acceptance run; here the ones that read a layout decision
  (hymba's flash calls in prefill, mamba2's long_500k, ``--no-ep``'s
  inflation).

The partitioned view's values (qwen3-moe and hymba in the 4-rank gloo
world) are held in tests/test_torch_mesh_dryrun.py with the dense ones.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import work
from repro_torch.launch import counting, dryrun
from repro_torch.launch.mesh import fake_world, make_mesh
from test_torch_launch import XLA_FLOPS_TOL

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"


@pytest.fixture(autouse=True)
def no_world_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _cfg(arch: str):
    """The ``.reduced()`` config of a case: hymba with 5 query heads and 1
    kv head (5 does not divide 2: the window path), mamba2 ``widened`` to
    d 96 with SSM head dim 64 (3 heads, which do not divide 2)."""
    if arch == "hymba":
        return dataclasses.replace(get_config("hymba-1.5b").reduced(), n_heads=5, n_kv_heads=1)
    if arch == "mamba2-widened":
        return dataclasses.replace(get_config("mamba2-130m").reduced(), d_model=96,
                                   ssm_head_dim=64)
    return get_config({"moe": "qwen3-moe-30b-a3b", "mamba2": "mamba2-130m"}[arch]).reduced()


KNOBS = {"default": dict(fsdp=False, attn_kv_fallback="replicate", ep_shardmap=True),
         "fsdp": dict(fsdp=True, attn_kv_fallback="replicate", ep_shardmap=True),
         "noep": dict(fsdp=False, attn_kv_fallback="replicate", ep_shardmap=False)}
# name -> (config, cell, knob)
CASES = {
    "moe-prefill": ("moe", ShapeCell("t", 128, 4, "prefill"), "default"),
    "moe-prefill-fsdp": ("moe", ShapeCell("t", 128, 4, "prefill"), "fsdp"),
    "moe-prefill-noep": ("moe", ShapeCell("t", 128, 4, "prefill"), "noep"),
    "moe-train": ("moe", ShapeCell("t", 128, 4, "train"), "default"),
    "moe-train-fsdp": ("moe", ShapeCell("t", 128, 4, "train"), "fsdp"),
    "hymba-prefill": ("hymba", ShapeCell("t", 2048, 2, "prefill"), "default"),
    "hymba-train": ("hymba", ShapeCell("t", 2048, 2, "train"), "default"),
    "mamba2-prefill": ("mamba2", ShapeCell("t", 512, 4, "prefill"), "default"),
    "mamba2-decode": ("mamba2", ShapeCell("t", 256, 16, "decode"), "default"),
    "mamba2-widened-prefill": ("mamba2-widened", ShapeCell("t", 512, 4, "prefill"), "default"),
    "mamba2-widened-decode": ("mamba2-widened", ShapeCell("t", 256, 16, "decode"), "default"),
    "mamba2-widened-train": ("mamba2-widened", ShapeCell("t", 256, 4, "train"), "default"),
}
# a decode over a cache whole over the batch axes and "model" (B below the
# data axis: long_500k's layout), counted only
HAND_ONLY = {"mamba2-decode-whole": ("mamba2", ShapeCell("t", 256, 4, "decode"), "default"),
             "mamba2-widened-decode-whole": ("mamba2-widened", ShapeCell("t", 256, 4, "decode"),
                                             "default")}


def _count(name, *, remat=True):
    arch, cell, knob = {**CASES, **HAND_ONLY}[name]
    with fake_world(4), shd.options(**KNOBS[knob]):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        return dryrun.count_cell(_cfg(arch), cell, mesh=mesh, remat=remat)


# ---------------------------------------------------------------------------
# (d) the live oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_oracle_families")
    cases = [dict(name=name, cfg=dataclasses.asdict(_cfg(arch)), cell=dataclasses.asdict(cell),
                  options=dict(KNOBS[knob], zero1=KNOBS[knob]["fsdp"]))
             for name, (arch, cell, knob) in CASES.items()]
    (tmp / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]),
               JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, str(TESTS / "_jax_mesh_reference.py"),
                        str(tmp / "cases.json"), str(tmp / "out.json")],
                       env=env, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads((tmp / "out.json").read_text())


def _reference_attention_pairs(S, chunk=1024):
    """(query, key) pairs one head of the reference's causal attention
    computes: query tile i against kv chunks 0..i, or, below one chunk,
    every query against the one chunk its keys are padded to."""
    if S < chunk:
        return S * chunk
    return sum(chunk * chunk * (i + 1) for i in range(S // chunk))


def _ssm_extra(cfg, B_loc, S, kind, m=2):
    """The Mamba-2 mixer's matmul flops one rank of the port does beyond
    XLA's, per layer forward.  ``w_in``: the port projects its channels'
    z and x, B and C whole and its heads' dt (decode: its channels' z and
    x, its slice of N's B and C, every dt), XLA an even ceil(e / M) of the
    e columns; prefill's ``C·B`` scores: the port over the whole N, XLA
    over N / M (then all-reduced)."""
    d, din, N, H = cfg.d_model, cfg.ssm_inner(), cfg.ssm_state, cfg.ssm_heads
    Pd, e = din // H, 2 * din + 2 * N + H
    on = din // m if din % 16 == 0 else din
    xla_cols = -(-e // m)
    if kind == "decode":
        return 2 * B_loc * d * (2 * on + 2 * (N // m) + H - xla_cols)
    cols = 2 * on + 2 * N + -(-on // Pd)
    S_pad = -(-S // cfg.ssm_chunk) * cfg.ssm_chunk
    Q = min(cfg.ssm_chunk, S_pad)
    cb = 2 * B_loc * S_pad * Q * N
    return 2 * B_loc * S * d * (cols - xla_cols) + cb - cb // m


def _beyond_xla(cfg, cell, counted, m=2):
    """(matmul, total): what to take off the port's matmul flops and its
    total flops to compare them with XLA's dot flops and flops, by the
    port's own reckoning of the op classes the two split apart (module
    docstring).  Forward work x 3 in a train step (remat off: each matmul
    and its two grads)."""
    L, B_loc, S = cfg.n_layers, cell.global_batch // m, cell.seq_len
    hd, Hq, Hkv, d = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    passes = 3 if cell.kind == "train" else 1
    extra = 0
    if cfg.ssm_state:
        extra += passes * L * _ssm_extra(cfg, B_loc, S, cell.kind, m)
    attention = 0
    if cfg.family == "hybrid" and cell.kind != "decode":
        # the window path on rank 0, its block [0, S/M): the reference's k/v
        # projections run over W more rows, and its tiles of tq queries
        # against W + tq keys
        W, S_loc = cfg.window, S // m
        n_tiles = max(1, S_loc // 1024)
        tq = S_loc // n_tiles
        extra -= passes * L * 4 * B_loc * W * d * Hkv * hd
        ref = 4 * hd * Hq * B_loc * L * n_tiles * tq * (W + tq)
        if cell.kind == "train":        # chunked_attention: S_loc queries, keys in chunks of 1024
            extra += passes * (4 * hd * Hq * B_loc * L * S_loc * 1024 * -(-S_loc // 1024) - ref)
        else:                           # flash, off the matmuls: its tiles put on the reference's
            attention = ref
    elif cell.kind == "prefill" and cfg.attention != "none":
        H_loc = Hq // m if Hq % 16 == 0 else Hq
        attention = 4 * hd * B_loc * H_loc * L * _reference_attention_pairs(S)
    matmul = extra - attention
    return matmul, matmul + counted.flops_by_kind["kernel"]


@pytest.mark.parametrize("name", list(CASES))
def test_per_device_counts_match_the_references_lower_cell(oracle, name):
    arch, cell, knob = CASES[name]
    cfg = _cfg(arch)
    counted = _count(name, remat=False)
    xla = oracle[name]
    assert counted.argument_bytes == xla["argument_bytes"]
    mm_off, total_off = _beyond_xla(cfg, cell, counted)
    mm = counted.flops_by_kind["matmul"] - mm_off
    total = counted.flops - total_off
    xla_total = xla["flops"] - xla["converts"]
    rel_mm = (mm - xla["dot_flops"]) / xla["dot_flops"]
    rel = (total - xla_total) / xla_total
    print(f"{name}: argument bytes {counted.argument_bytes}; matmul port "
          f"{counted.flops_by_kind['matmul']} - {mm_off} vs XLA dots {xla['dot_flops']} "
          f"({rel_mm:+.5f}); flops port {counted.flops} - {total_off} vs XLA {xla_total} "
          f"({rel:+.4f}); collective bytes port {counted.collective_bytes} xla "
          f"{xla['collective_bytes']}")
    assert abs(rel_mm) <= XLA_FLOPS_TOL
    if knob == "default" and arch == "moe":
        assert counted.collective_bytes["all-to-all"] > 0 and \
            xla["collective_bytes"]["all-to-all"] > 0


# ---------------------------------------------------------------------------
# (e) collective bytes by hand
# ---------------------------------------------------------------------------

def _hand_collectives(cfg, cell, knob):
    """The collectives of a step of a MoE, SSM or hybrid config at
    ``.reduced()`` on (2, 2), by hand; a train step checkpointed as the
    dry-run's default (remat "minimal": products saved, the rest
    recomputed, as far as the backward needs).  The production specs
    divide by 16, so at these widths the attention heads, the router's 4
    experts and ``w_in``'s width are whole, the vocab, d_ff, the experts
    and din split over "model".

    Every step: the vocab-split lookup's partial sum, all-reduced (T·d).

    MoE, expert-parallel, per layer: two all-to-alls of the (M, E/M, C, d)
    capacity blocks (C from the rank's Ts = T/M tokens), again in the
    recompute and in the backward; the exit's all-gather over "model" of
    the M·Ts rows; in the backward its transpose, a reduce-scatter to Ts
    rows, the router's grad all-reduced over "model" (d·E) and the
    input's (each model rank routed a slice of it, T·d).  ``--no-ep``
    (prefill): the tokens all-gathered over "data" (B·S·d) and the
    capacity slabs over "model" (E·C·d, C from all B·S tokens).

    Hybrid, the window path: per layer y all-gathered over "model" (T·d),
    the mixer's ``w_out`` (a row-parallel product, T·d) and ``w_down``
    all-reduced; prefill gathers the cache's k and v (T·Hkv·hd each); a
    train step does not, recomputes y's gather and ``w_out``'s all-reduce
    (the branch norms read them), and in the backward reduce-scatters y's
    grad (T/M rows), all-reduces the input grads of ``w_gate``, ``w_up``
    and ``lm_head``, x's grad over "model" in the window path and in the
    mixer, and over "model" the grads of the window's weights (every rank
    read them for its block), of dt_bias, A_log, D_skip (H) and of
    ``w_in`` (d·e, whole).

    Mamba-2 prefill / train: per layer ``w_out``'s all-reduce (no
    recompute: the residual add reads nothing back); a train step's
    backward all-reduces x's grad in the mixer, the tied unembedding's
    input grad, and the mixer's whole leaves over "model".  Decode over a
    cache split by N and channels (B >= 16): the conv's output gathered
    over "model" (B/2·din), y = C·h's partial sum (B/2·din, f32) and
    ``w_out`` all-reduced; over a cache whole (B < 16): the token's rows
    gathered over "data" to the cache's batch (B·d), ``conv_w`` over
    "model" (4·din) and ``w_out`` all-reduced (B·d).

    A train step's loss, AdamW and global norm as the dense decoders'
    (tests/test_torch_mesh_dryrun.py): three (T) f32 all-reduces; each
    leaf's grad not split over "data" all-reduced at its local size, and
    one f32 scalar per group of leaves split alike; ``fsdp``: each weight
    gathered over "data" at each use (forward and recompute), its grad
    reduce-scattered back, the norms all-reduced, three scalars."""
    m = dp = 2
    B, S, d, L = cell.global_batch, cell.seq_len, cfg.d_model, cfg.n_layers
    B_loc = B // dp
    T = B_loc * S
    hd, Hq, Hkv, F, V = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, \
        cfg.vocab_size
    bf16, f32 = 2, 4
    train = cell.kind == "train"
    out = dict.fromkeys(counting.COLLECTIVES, 0)
    out["count"] = 0

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


@pytest.mark.parametrize("name", [n for n in (*CASES, *HAND_ONLY)])
def test_collectives_equal_a_hand_count(name):
    arch, cell, knob = {**CASES, **HAND_ONLY}[name]
    counted = _count(name)
    assert counted.collective_bytes == _hand_collectives(_cfg(arch), cell, knob)


# ---------------------------------------------------------------------------
# The production records
# ---------------------------------------------------------------------------

def _records(tmp_path, arch, cell, *flags, mesh="single"):
    out = tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", arch, "--cell", cell, "--mesh", mesh, *flags,
                        "--out", str(out)]) == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    out.unlink()
    assert recs and all("error" not in r for r in recs)
    return recs


def test_hymba_prefill_counts_flash_once_a_layer_on_the_ranks_block(tmp_path):
    """hymba-1.5b prefill_32k takes the window path (25 heads do not divide
    16, 32768 = 2 x 16 x 1024): flash once a layer on rank 0's block, the
    queries [0, 2048) (the rank at "model" coordinate 0 has no key-only
    rows before its slice; any other has W = 1024), 25 heads of 64."""
    cfg = get_config("hymba-1.5b")
    rec, = _records(tmp_path, "hymba-1.5b", "prefill_32k")
    assert rec["chips"] == 256
    assert rec["kernel_calls"] == {"flash_attention": cfg.n_layers}
    B_loc, S_loc = 32 // 16, 32768 // 16
    q = torch.empty(B_loc, S_loc, cfg.n_heads, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B_loc, S_loc, cfg.n_kv_heads, 64, dtype=torch.bfloat16, device="meta")
    per_call = work.flash_attention(q, k, k, causal=True, window=cfg.window)["flops"]
    assert rec["kernel_flops"] == cfg.n_layers * per_call
    # y, k and v gathered over "model" a layer, the mixer's and the MLP's
    # row-parallel products all-reduced: no all-to-all
    coll = rec["collective_bytes"]
    assert coll["all-to-all"] == 0 and coll["all-gather"] > 0


def test_no_ep_runs_the_experts_data_times_over(tmp_path):
    """``--no-ep`` reaches the MoE block: the global dispatch on every rank,
    no all-to-all, and per-device flops above the expert-parallel path's."""
    ep, = _records(tmp_path, "qwen3-moe-30b-a3b", "prefill_32k")
    noep, = _records(tmp_path, "qwen3-moe-30b-a3b", "prefill_32k", "--no-ep")
    assert ep["collective_bytes"]["all-to-all"] > 0
    assert noep["collective_bytes"]["all-to-all"] == 0
    assert noep["flops"] > 2 * ep["flops"]
    assert noep["argument_bytes"] == ep["argument_bytes"]


def test_mamba2_long_500k_on_both_meshes(tmp_path):
    """long_500k (B 1): the state and conv cache whole on every rank, the
    token's row gathered to them; one record a mesh, no error."""
    single, multi = _records(tmp_path, "mamba2-130m", "long_500k", mesh="both")
    assert (single["chips"], multi["chips"]) == (256, 512)
    for rec in (single, multi):
        assert rec["collective_bytes"]["all-gather"] > 0
        assert rec["kernel_calls"] == {}
