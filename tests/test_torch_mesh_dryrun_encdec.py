"""The dry-run on a mesh of the encoder-decoder and prefix-LM families
(``repro_torch.launch.dryrun --mesh``): whisper-medium's bidirectional
encoder, cross k/v and cross step, and paligemma-3b's prefix, each on its
local shards (:mod:`repro_torch.distributed.partition`).

* (d) the live oracle: the reference's own ``lower_cell`` on a (2, 2)
  ("data", "model") mesh of 4 virtual devices (tests/_jax_mesh_reference.py)
  against the port on a fake 4-rank (2, 2) world, for whisper-medium
  widened so that its heads split (d 512, 16 query and 16 kv heads of 32,
  d_ff 2048; 40 encoder frames, which no chunk tiles; a vocab of 520, which
  16 does not divide: the embedding split by width, ``lm_head`` by rows)
  and paligemma-3b ``.reduced()`` (4 query heads and 1 kv head, whole;
  prefix 8; the tied vocab of 512 split): prefill (also ``--legacy-sharding``
  for paligemma, and at S + P > 1024, where both packages tile the prefix
  attention), train (also ``--fsdp``) and decode over a batch of 16, which
  takes ``cache_specs``' batched layout (decode_32k's).  Per-device
  argument bytes equal; the port's matmul flops equal XLA's dot flops
  within ``XLA_FLOPS_TOL`` once the op classes the two split apart are
  taken off by the port's reckoning (:func:`_beyond_xla`): flash's work on
  whisper's decoder prefill put on the reference's attention tiles, and,
  under ``--legacy-sharding``, paligemma's attention and its projections,
  which the port computes whole on every model rank from the weights
  gathered by head dim where XLA splits them by head dim (partial scores
  all-reduced).  The decode cache is 128 long: the reference's measurement
  mode pads the keys of a shorter cache to a multiple of 128;
* (e) every collective of each (2, 2) step equals a hand count
  (:func:`_hand_collectives`, of which ``chip_smoke.py::
  _hand_encdec_collectives`` is a copy), kind by kind and in number;
* the production records that read a layout decision: whisper
  prefill_32k (flash once a decoder layer at its per-device plan, none in
  the encoder or the cross step, the cross cache returned in
  ``cache_specs``' layout), paligemma decode_32k (the cache split by
  sequence over "model") and paligemma prefill_32k under
  ``--legacy-sharding`` (the attention weights split by head dim, gathered
  at each use; counted at one layer of the production width: the 18
  layers take the tiled path's 561 tile pairs each, minutes on ``meta``).

The partitioned view's values (whisper and paligemma in the 4-rank gloo
world) are held in tests/test_torch_mesh_dryrun.py with the other families.
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

from repro_torch.configs import SHAPE_CELLS, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import plans, work
from repro_torch.launch import counting, dryrun
from repro_torch.launch.mesh import fake_world, make_mesh, make_production_mesh
from repro_torch.models.transformer import param_struct
from repro_torch.tree import leaves_with_paths
from test_torch_launch import XLA_FLOPS_TOL

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"


@pytest.fixture(autouse=True)
def no_world_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _cfg(arch: str):
    """whisper-medium widened so that its heads split over "model" as at
    full width, with 40 frames and a vocab that 16 does not divide;
    paligemma-3b ``.reduced()``."""
    if arch == "whisper":
        return dataclasses.replace(get_config("whisper-medium").reduced(), d_model=512,
                                   n_heads=16, n_kv_heads=16, head_dim=32, d_ff=2048,
                                   enc_seq=40, vocab_size=520)
    return get_config("paligemma-3b").reduced()


KNOBS = {"default": dict(fsdp=False, attn_kv_fallback="replicate"),
         "fsdp": dict(fsdp=True, attn_kv_fallback="replicate"),
         "legacy": dict(fsdp=False, attn_kv_fallback="head_dim")}
PREFILL, TRAIN, DECODE = (ShapeCell("t", 128, 4, "prefill"), ShapeCell("t", 64, 4, "train"),
                          ShapeCell("t", 128, 16, "decode"))
# name -> (config, cell, knob)
CASES = {
    "whisper-prefill": ("whisper", PREFILL, "default"),
    "whisper-train": ("whisper", TRAIN, "default"),
    "whisper-train-fsdp": ("whisper", TRAIN, "fsdp"),
    "whisper-decode": ("whisper", DECODE, "default"),
    "paligemma-prefill": ("paligemma", PREFILL, "default"),
    "paligemma-prefill-legacy": ("paligemma", PREFILL, "legacy"),
    "paligemma-prefill-tiled": ("paligemma", ShapeCell("t", 1280, 4, "prefill"), "default"),
    "paligemma-train": ("paligemma", TRAIN, "default"),
    "paligemma-train-fsdp": ("paligemma", TRAIN, "fsdp"),
    "paligemma-decode": ("paligemma", DECODE, "default"),
}


def _count(name, *, remat=True):
    arch, cell, knob = CASES[name]
    with fake_world(4), shd.options(**KNOBS[knob]):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        return dryrun.count_cell(_cfg(arch), cell, mesh=mesh, remat=remat)


# ---------------------------------------------------------------------------
# (d) the live oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_oracle_encdec")
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


def _reference_pairs(S, chunk=1024):
    """(query, key) pairs one head of the reference's causal attention
    computes below one chunk: every query against the chunk its keys are
    padded to."""
    assert S <= chunk
    return S * chunk


def _beyond_xla(cfg, cell, knob, m=2):
    """What to take off the port's matmul flops to compare them with XLA's
    dot flops, by the port's own reckoning (module docstring).  Flash:
    its work is off the matmuls, and XLA's dots hold the reference's
    attention tiles over the decoder's local heads.  ``legacy`` with query
    heads that do not divide "model" (paligemma): the port's q/k/v/o
    projections and attention run whole on every model rank, XLA's 1/M of
    each by head dim."""
    L, B_loc = cfg.n_layers, cell.global_batch // m
    hd, Hq, Hkv, d = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    S = cell.seq_len + cfg.prefix_len
    if cfg.enc_dec and cell.kind == "prefill":
        H_loc = Hq // m if Hq % 16 == 0 else Hq
        return -4 * hd * B_loc * H_loc * L * _reference_pairs(S)
    if knob == "legacy" and Hq % 16:
        assert cell.kind == "prefill"
        T = B_loc * S
        proj = 2 * T * d * (Hq + 2 * Hkv) * hd + 2 * T * Hq * hd * d
        attention = 4 * hd * B_loc * Hq * _reference_pairs(S)
        return (m - 1) * L * (proj + attention) // m
    return 0


@pytest.mark.parametrize("name", list(CASES))
def test_per_device_counts_match_the_references_lower_cell(oracle, name):
    arch, cell, knob = CASES[name]
    cfg = _cfg(arch)
    counted = _count(name, remat=False)
    xla = oracle[name]
    assert counted.argument_bytes == xla["argument_bytes"]
    off = _beyond_xla(cfg, cell, knob)
    mm = counted.flops_by_kind["matmul"] - off
    rel_mm = (mm - xla["dot_flops"]) / xla["dot_flops"]
    xla_total = xla["flops"] - xla["converts"]
    print(f"{name}: argument bytes {counted.argument_bytes}; matmul port "
          f"{counted.flops_by_kind['matmul']} - {off} vs XLA dots {xla['dot_flops']} "
          f"({rel_mm:+.5f}); flops port {counted.flops} vs XLA {xla_total} "
          f"({(counted.flops - xla_total) / xla_total:+.4f}); collective bytes port "
          f"{counted.collective_bytes} xla {xla['collective_bytes']}")
    assert abs(rel_mm) <= XLA_FLOPS_TOL
    assert (counted.flops_by_kind["kernel"] > 0) == (name == "whisper-prefill")


# ---------------------------------------------------------------------------
# (e) collective bytes by hand
# ---------------------------------------------------------------------------

def _hand_collectives(cfg, cell, knob):
    """The collectives of a step of whisper-medium (widened) or
    paligemma-3b ``.reduced()`` on (2, 2), by hand; a train step
    checkpointed as the dry-run's default (remat "minimal": products
    saved, the rest recomputed as far as the backward needs).  The
    production specs divide by 16: whisper's 16 heads split over "model",
    paligemma's 4 and 1 stay whole; whisper's vocab (520) is split by
    width in the embedding and by rows in ``lm_head``, paligemma's tied
    table by vocab.  T = B/2 (S + P) rows run through the decoder layers,
    Te = B/2 Se through the encoder's; bf16 activations.

    Prefill / forward: the lookup (whisper: its width-split rows gathered
    over "model", T·d; paligemma: its partial sum all-reduced, over the
    tokens alone); per layer each row-parallel product all-reduced:
    whisper's encoder wo and w_down (Te·d), its decoder's self-attention
    wo, cross wo and w_down, paligemma's w_down (T·d); whisper's logits, a
    row-parallel product in f32 (prefill: its last token).  Decode: the
    same per token; paligemma's cache is split by sequence over "model"
    (1 kv head), so each layer all-reduces the softmax's max, sum and
    accumulator (f32).

    Train, forward as above, then the recompute of the products whose
    outputs a norm reads (whisper's wo and cross wo), the loss over the
    vocab split (three (B/2·S) f32 all-reduces: its max, its sum of
    exponentials and its gold logit; the prefix rows sliced off first);
    backward: each column-parallel product's input grad all-reduced
    (whisper: per decoder layer wq, wk, wv, the cross wq and w_up, T·d;
    per encoder layer wq, wk, wv and w_up, and per decoder layer the cross
    wk and wv on the encoder's output, Te·d; paligemma: w_gate, w_up and
    the tied unembedding's input), whisper's logits grad (T·V f32) and
    the unembedding's input grad (T·d f32) gathered over "model" (the
    transposes of its vocab and row splits).  AdamW as the dense
    decoders' (tests/test_torch_mesh_dryrun.py): each leaf's grad not
    split over "data" all-reduced at its local size, and one f32 scalar
    per group of leaves split alike; ``fsdp``: each weight gathered over
    "data" at each use (forward and recompute; paligemma's table at the
    lookup and at the unembedding; whisper's tables are not split over
    "data": their one free dim is the vocab, 520, which 16 does not
    divide), its grad reduce-scattered back, the rest all-reduced, three
    scalars.  ``legacy`` (paligemma prefill): wq, wk, wv and wo,
    split by head dim over "model", gathered at each use."""
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
    out = dict.fromkeys(counting.COLLECTIVES, 0)
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


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_equal_a_hand_count(name):
    arch, cell, knob = CASES[name]
    assert _count(name).collective_bytes == _hand_collectives(_cfg(arch), cell, knob)


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


def _share(shape, spec, sizes):
    """Per-device elements of a ``shape`` placed by ``spec`` on a mesh of
    ``sizes``, each split rounded up (rank 0's share where it is uneven)."""
    n = list(shape)
    for i, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n[i] = -(-n[i] // sizes[a])
    return math.prod(n)


def test_whisper_prefill_counts_flash_once_a_decoder_layer_and_returns_the_cross_cache(tmp_path):
    """whisper-medium prefill_32k: flash once a decoder layer at its
    per-device plan (2 rows of 32768 over "data", 1 of 16 heads over
    "model", head dim 64), none in the encoder or the cross step; the
    returned cache in ``cache_specs``' layout (the cross k/v split by
    batch and heads: ``torch.stack`` of the layers' DTensors gathers
    nothing), the last token's logits split by vocab, rows over "data"."""
    cfg, cell = get_config("whisper-medium"), SHAPE_CELLS["prefill_32k"]
    rec, = _records(tmp_path, "whisper-medium", "prefill_32k")
    assert rec["chips"] == 256
    assert rec["kernel_calls"] == {"flash_attention": cfg.n_layers}
    B_loc, S, hd = cell.global_batch // 16, cell.seq_len, cfg.resolved_head_dim
    q = torch.empty(B_loc, S, cfg.n_heads // 16, hd, dtype=torch.bfloat16, device="meta")
    assert plans.fa_plan(B_loc, S, S, 1, 1, hd, torch.bfloat16, True, None,
                         work._align(q, q, q)).variant == "wgmma"
    assert rec["kernel_flops"] == cfg.n_layers * work.flash_attention(q, q, q)["flops"]
    sizes = {"data": 16, "model": 16}
    specs = shd.cache_specs(cfg, dataclasses.replace(cell, kind="decode"))
    L, Hkv = cfg.n_layers, cfg.n_kv_heads
    kv = (L, cell.global_batch, S, Hkv, hd)
    cross = (L, cell.global_batch, cfg.enc_seq, Hkv, hd)
    assert specs["cross_k"] == shd.P(None, "data", None, "model", None)
    want = (_share((cell.global_batch, 1, cfg.vocab_size), ("data", None, "model"), sizes) * 4
            + 2 * _share(kv, ("data" if i == 1 else "model" if i == 3 else None
                              for i in range(5)), sizes) * 2
            + 2 * _share(cross, specs["cross_k"], sizes) * 2 + 4)
    assert rec["output_bytes"] == want


def test_paligemma_decode_reads_a_cache_split_by_sequence(tmp_path):
    """paligemma-3b decode_32k: 1 kv head does not divide "model", so the
    cache is split by sequence over it (and its batch over the batch axes)
    and each layer combines its softmax over "model" (three all-reduces);
    the params as their specs place them, the tied table split by vocab;
    no flash."""
    cfg, cell = get_config("paligemma-3b"), SHAPE_CELLS["decode_32k"]
    single, multi = _records(tmp_path, "paligemma-3b", "decode_32k", mesh="both")
    for rec, multi_pod in ((single, False), (multi, True)):
        b = ("pod", "data") if multi_pod else ("data",)
        specs = shd.cache_specs(cfg, cell, multi_pod=multi_pod)
        assert specs["k"] == shd.P(None, b, "model", None, None)
        sizes = {"pod": 2, "data": 16, "model": 16}
        inputs = dryrun.input_specs(cfg, cell)
        want = sum(_share(t.shape, shd.spec_for_param(path[-1], tuple(t.shape)), sizes) * 2
                   for path, t in leaves_with_paths(param_struct(cfg)))
        want += _share(inputs["tokens"].shape, (b,), sizes) * 4
        want += sum(_share(t.shape, specs[k], sizes) * t.element_size()
                    for k, t in inputs["cache"].items())
        assert rec["argument_bytes"] == want
        assert rec["kernel_calls"] == {}
        coll = rec["collective_bytes"]
        assert coll["all-gather"] == 0
        # the lookup, per layer the softmax's max, sum and accumulator and w_down
        assert coll["count"] == 1 + 4 * cfg.n_layers


def test_paligemma_legacy_prefill_gathers_the_head_dim_split_weights():
    """paligemma-3b prefill_32k under ``--legacy-sharding`` at the production
    width (one layer): 8 query heads and 1 kv head do not divide 16, so
    wq, wk, wv and wo are split by head dim over "model" and gathered at
    each use (the default replicates them); the prefix keeps flash off."""
    cfg = dataclasses.replace(get_config("paligemma-3b"), n_layers=1)
    d, hd, Hq, Hkv = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    counts = {}
    for knob in ("default", "legacy"):
        with fake_world(256), shd.options(**KNOBS[knob]):
            counts[knob] = dryrun.count_cell(cfg, SHAPE_CELLS["prefill_32k"],
                                             mesh=make_production_mesh())
    default, legacy = counts["default"], counts["legacy"]
    assert default.collective_bytes["all-gather"] == 0
    assert legacy.collective_bytes["all-gather"] == (2 * d * Hq * hd + 2 * d * Hkv * hd) * 2
    assert legacy.collective_bytes["count"] == default.collective_bytes["count"] + 4
    assert "flash_attention" not in default.oplog and "flash_attention" not in legacy.oplog
    # the gathered weights run the same attention as the replicated ones
    assert legacy.flops_by_kind["matmul"] == default.flops_by_kind["matmul"]
    assert legacy.argument_bytes < default.argument_bytes
