"""The dry-run on a mesh (``repro_torch.launch.dryrun --mesh``): the dense
decoders counted per device on DTensors placed by the reference's specs,
in a fake world (``launch/mesh.py::fake_world``) whose local shards live
on ``meta``.

* (a) every leaf's local shape is its global shape over its spec's shard
  counts, on the production (16, 16) mesh, with and without FSDP;
* (b) a (1, 1) mesh counts what one card counts, exactly;
* (c) the counter reads a hand-built DTensor program's local work once,
  none of DTensor's sharding propagation, and its one all-reduce;
* (d) the live oracle: the reference's own ``lower_cell`` on a (2, 2)
  ("data", "model") mesh of 4 virtual devices (a subprocess,
  tests/_jax_mesh_reference.py) against the port on a fake 4-rank (2, 2)
  world — per-device argument bytes equal, per-device flops within the
  launch tests' ``XLA_FLOPS_TOL`` (flash's tiles and XLA's converts taken
  off as there), collective bytes by kind printed beside XLA's: GSPMD and
  DTensor choose their collectives apart;
* (e) the collective bytes of a prefill and of a train step at
  ``.reduced()`` equal a hand count for the default knobs, ``--fsdp``,
  ``--fsdp --no-zero1`` (the same: it changes nothing) and
  ``--legacy-sharding``, and a train step's for the widened config whose
  query heads split;
* (f) the encoder-decoder and prefix-LM families write a record on a
  mesh, and ``--execute`` on a mesh an ``error`` record (the MoE, SSM and
  hybrid families are tests/test_torch_mesh_dryrun_families.py's, the
  encoder-decoder and prefix-LM families' counts
  tests/test_torch_mesh_dryrun_encdec.py's);
* the partitioned view on values: a real 4-rank gloo world on the CPU
  (tests/_torch_partition_worker.py, cases in tests/_partition_cases.py)
  runs prefill, a decode step over a sequence-split cache and a train
  step with AdamW on DTensors, and every rank reads back what one process
  computes; the kernel ops on DTensors run on their shards.

Every fake world is opened and closed inside one test (or one
subprocess), so no default group outlives it.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.launch import counting, dryrun
from repro_torch.launch.mesh import fake_world, make_mesh, make_production_mesh
from repro_torch.models.transformer import param_struct
from repro_torch.tree import leaves_with_paths
from test_torch_launch import XLA_FLOPS_TOL

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
DENSE = ("llama3-8b", "qwen3-4b", "gemma-7b", "gemma2-9b")


@pytest.fixture(autouse=True)
def no_world_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _spec_leaves(tree):
    return dict(leaves_with_paths(tree))


# ---------------------------------------------------------------------------
# (a) placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_each_leaf_holds_its_specs_share(arch, fsdp):
    params = param_struct(get_config(arch))
    specs = shd.tree_specs(params, fsdp=fsdp)
    with fake_world(256):
        mesh = make_production_mesh()
        placed = shd.distribute(params, mesh, specs)
        flat_specs = _spec_leaves(specs)
        split = 0
        for path, t in leaves_with_paths(placed):
            g = _spec_leaves(params)[path]
            spec = flat_specs[path]
            n = [math.prod(16 for a in ((e,) if isinstance(e, str) else (e or ())))
                 for e in spec]
            assert tuple(t.shape) == tuple(g.shape)
            assert tuple(t.to_local().shape) == tuple(s // k for s, k in zip(g.shape, n)), path
            assert t.to_local().device.type == "meta" and t.dtype == g.dtype
            assert tuple(t.placements) == shd.placements(mesh, spec)
            split += math.prod(n) > 1
        assert split > 0
        if fsdp:          # every weight matrix takes "data" on one more dim
            assert any("data" in spec for spec in flat_specs.values())


# ---------------------------------------------------------------------------
# (b) one rank equals one card
# ---------------------------------------------------------------------------

SMALL = {"train": ShapeCell("t", 64, 2, "train"), "prefill": ShapeCell("t", 256, 2, "prefill"),
         "decode": ShapeCell("t", 256, 2, "decode")}


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-9b"])
def test_a_one_rank_mesh_counts_what_one_card_counts(arch, kind):
    cfg = get_config(arch).reduced()
    local = dryrun.count_cell(cfg, SMALL[kind])
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        one = dryrun.count_cell(cfg, SMALL[kind], mesh=mesh)
    fields = ("flops", "bytes_accessed", "peak_bytes", "argument_bytes", "output_bytes")
    assert {f: getattr(one, f) for f in fields} == {f: getattr(local, f) for f in fields}
    assert one.flops_by_kind == local.flops_by_kind
    assert one.collective_bytes == dict.fromkeys(counting.COLLECTIVES + ("count",), 0)


# ---------------------------------------------------------------------------
# (c) the counter on a hand-built program
# ---------------------------------------------------------------------------

def test_the_counter_reads_local_shards_once_and_the_all_reduce():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    B, d, f = 8, 16, 32
    counted, fakes = [], []
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")

        def placed(local, pl, shape):
            return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                                      stride=(shape[1], 1))

        x = placed(torch.empty(B // 2, d, device="meta"), (Shard(0), Replicate()), (B, d))
        w1 = placed(torch.empty(d, f // 2, device="meta"), (Replicate(), Shard(1)), (d, f))
        w2 = placed(torch.empty(f // 2, d, device="meta"), (Replicate(), Shard(0)), (f, d))

        class Spy(counting.Counter):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                calls = sum(n for _, n in self.oplog.values())
                out = super().__torch_dispatch__(func, types, args, kwargs)
                names = [type(t).__name__ for t in counting._tensors((args, kwargs, out))]
                if sum(n for _, n in self.oplog.values()) > calls:
                    counted.append((func.__name__, names))
                elif "FakeTensor" in names:
                    fakes.append(func.__name__)
                return out

        spy = Spy((x, w1, w2))
        with spy:
            y = (x @ w1) @ w2                                  # a partial sum over "model"
            y = y.redistribute(mesh, (Shard(0), Replicate()))  # its all-reduce
        assert tuple(y.to_local().shape) == (B // 2, d)
    assert spy.flops_by_kind["matmul"] == 2 * (2 * (B // 2) * d * (f // 2))
    assert spy.collective_bytes["all-reduce"] == (B // 2) * d * 4
    assert spy.collective_bytes["count"] == 1
    assert sum(v for k, v in spy.collective_bytes.items() if k != "count") == (B // 2) * d * 4
    assert spy.argument_bytes == 4 * ((B // 2) * d + 2 * d * (f // 2))
    # two local matmuls' operands and results; no FakeTensor was counted
    assert spy.bytes_accessed == 4 * ((B // 2) * d + d * (f // 2) + (B // 2) * (f // 2)
                                      + (B // 2) * (f // 2) + (f // 2) * d + (B // 2) * d)
    # the propagation ran on FakeTensors of the global shapes, and none was counted
    assert fakes and counted
    assert not any("FakeTensor" in names for _, names in counted)
    assert [op for op, _ in counted if op.startswith("mm")] == ["mm.default"] * 2


def test_the_kernel_ops_run_on_local_shards():
    """Flash on DTensors runs once on this rank's shards and hands back a
    DTensor laid out as its queries, by batch and q heads (each rank
    taking the kv head of its q heads' group where k/v are replicated);
    keys split by sequence raise, naming the op, and so does a kernel no
    cell on a mesh reaches (the block-sparse matmul)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import partition as part
    from repro_torch.kernels import ops, work

    bf16 = dict(dtype=torch.bfloat16, device="meta")
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        q = part.from_local(torch.empty(1, 256, 4, 64, **bf16), mesh, (Shard(0), Shard(2)),
                            (2, 256, 8, 64))
        k = part.from_local(torch.empty(1, 256, 2, 64, **bf16), mesh, (Shard(0), Replicate()),
                            (2, 256, 2, 64))
        with counting.count() as c:
            out = ops.flash_attention(q, k, k)
        assert tuple(out.placements) == tuple(q.placements) and out.shape == q.shape
        assert tuple(out.to_local().shape) == (1, 256, 4, 64)
        assert c.oplog["flash_attention"][1] == 1
        local_k = torch.empty(1, 256, 1, 64, **bf16)         # q heads 4..7 read kv head 1
        assert c.flops_by_kind["kernel"] == work.flash_attention(
            q.to_local(), local_k, local_k, causal=True)["flops"]
        by_seq = part.from_local(torch.empty(2, 128, 2, 64, **bf16), mesh,
                                 (Replicate(), Shard(1)), (2, 256, 2, 64))
        with pytest.raises(ValueError, match="flash_attention: keys split by sequence"):
            ops.flash_attention(q, by_seq, by_seq)

        # the other kernels run on pruned params, which no cell on a mesh builds
        x = part.from_local(torch.empty(4, 256, **bf16), mesh, (Shard(0), Replicate()), (8, 256))
        w_comp = part.from_local(torch.empty(2, 2, 128, 128, **bf16), mesh,
                                 (Replicate(), Replicate()), (2, 2, 128, 128))
        idx = part.from_local(torch.empty(2, 2, dtype=torch.int32, device="meta"), mesh,
                              (Replicate(), Replicate()), (2, 2))
        with pytest.raises(NotImplementedError, match="block_sparse_matmul on DTensors"):
            ops.block_sparse_matmul(x, w_comp, idx)


# ---------------------------------------------------------------------------
# (d) the live oracle: the reference's lower_cell on a (2, 2) mesh
# ---------------------------------------------------------------------------

def _oracle_cfg():
    """llama3-8b reduced, widened so that its 16 query heads, d_ff and
    vocab split over the production "model" axis (the specs divide by 16)
    while its 2 kv heads do not."""
    return dataclasses.replace(get_config("llama3-8b").reduced(), d_model=512, n_heads=16,
                               head_dim=32, d_ff=2048)


ORACLE_CELLS = {"train": ShapeCell("t", 128, 2, "train"),
                "prefill": ShapeCell("t", 2048, 2, "prefill"),
                "decode": ShapeCell("t", 2048, 2, "decode")}
ORACLE_KNOBS = {"": dict(fsdp=False, attn_kv_fallback="replicate"),
                "-fsdp": dict(fsdp=True, attn_kv_fallback="replicate"),
                "-legacy": dict(fsdp=False, attn_kv_fallback="head_dim")}
ORACLE_CASES = {f"{kind}{knob}": (kind, knob) for kind in ORACLE_CELLS for knob in ORACLE_KNOBS
                if not knob or kind == "train"}


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_oracle")
    cfg = dataclasses.asdict(_oracle_cfg())
    # the reference's options as its dry-run sets them: ZeRO-1 rides with FSDP
    cases = [dict(name=name, cfg=cfg, cell=dataclasses.asdict(ORACLE_CELLS[kind]),
                  options=dict(ORACLE_KNOBS[knob], zero1=ORACLE_KNOBS[knob]["fsdp"]))
             for name, (kind, knob) in ORACLE_CASES.items()]
    (tmp / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]),
               JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, str(TESTS / "_jax_mesh_reference.py"),
                        str(tmp / "cases.json"), str(tmp / "out.json")],
                       env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads((tmp / "out.json").read_text())


def _reference_tile_pairs(S, chunk=1024):
    """(query, key) pairs one head of the reference's tiled causal attention
    computes (query tile i against kv chunks 0..i)."""
    return sum(chunk * chunk * (i + 1) for i in range(S // chunk))


@pytest.mark.parametrize("name", list(ORACLE_CASES))
def test_per_device_counts_match_the_references_lower_cell(oracle, name):
    kind, knob = ORACLE_CASES[name]
    cfg, cell = _oracle_cfg(), ORACLE_CELLS[kind]
    with fake_world(4), shd.options(**ORACLE_KNOBS[knob]):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        counted = dryrun.count_cell(cfg, cell, mesh=mesh, remat=False)
    xla = oracle[name]
    assert counted.argument_bytes == xla["argument_bytes"]
    xla_flops = xla["flops"] - xla["converts"]
    port = counted.flops
    if counted.flops_by_kind["kernel"]:
        # flash's tiles, per device (batch over "data", heads over "model"),
        # put on the reference's tiling
        assert kind == "prefill"
        B_loc, H_loc = cell.global_batch // 2, cfg.n_heads // 2
        port += (4 * cfg.resolved_head_dim * B_loc * H_loc * cfg.n_layers
                 * _reference_tile_pairs(cell.seq_len)) - counted.flops_by_kind["kernel"]
    rel = (port - xla_flops) / xla_flops
    print(f"{name}: per-device flops rel {rel:+.4f}; collective bytes port "
          f"{counted.collective_bytes} xla {xla['collective_bytes']}")
    assert abs(rel) <= XLA_FLOPS_TOL
    if kind == "train":
        assert counted.collective_bytes["all-reduce"] > 0 and \
            xla["collective_bytes"]["all-reduce"] > 0


# ---------------------------------------------------------------------------
# The partitioned view computes one process's values
# ---------------------------------------------------------------------------

WORLD_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def partitioned(tmp_path_factory):
    """Every rank's results of tests/_torch_partition_worker.py: a real
    4-rank gloo world on the CPU, (data 2, model 2), DTensors holding
    values; the ranks joined within WORLD_TIMEOUT_S and killed past it."""
    import time

    out = tmp_path_factory.mktemp("partitioned")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(TESTS / "_torch_partition_worker.py"),
                               str(r), str(out / "store"), str(out)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    deadline, logs = time.monotonic() + WORLD_TIMEOUT_S, []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, f"ranks failed: {bad}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("arch,knob", [("llama3-8b", "default"), ("llama3-8b", "fsdp"),
                                       ("llama3-8b", "legacy"), ("gemma2-9b", "default"),
                                       ("qwen3-moe-30b-a3b", "default"),
                                       ("hymba-1.5b", "default"), ("whisper-medium", "default"),
                                       ("paligemma-3b", "default")])
def test_the_partitioned_view_computes_what_one_process_does(partitioned, arch, knob):
    """prefill and decode logits (the decode over a cache split by sequence
    over both axes: the split softmax), the train step's loss and grads,
    and the params after AdamW, on every rank, against the same f32 run in
    one process: to 1e-5 of the largest entry (grads 5e-5: four shards sum
    in another order), params where the grad is above 1e-3 of the leaf's
    largest (a first AdamW step moves each by ±lr, whose sign a grad near
    0 leaves to rounding).  qwen3-moe runs the expert-parallel block,
    hymba the window path and the Mamba-2 mixer on local shards, whisper
    the encoder, the cross k/v and the cross step (its decode over the
    cross cache), paligemma the prefix."""
    import _partition_cases as cases

    cfg = cases.cfg_of(arch)
    tokens, labels, nxt = cases.tokens_of(cfg)
    with shd.options(**cases.KNOBS[knob]):
        want = cases.run(cfg, cases.params_of(cfg), tokens, labels, nxt,
                         extra=cases.extra_of(cfg))
    for key, w in want.items():
        got = [rank[f"{arch}/{knob}/{key}"] for rank in partitioned]
        assert all(np.array_equal(got[0], g) for g in got[1:]), key
        tol = (5e-5 if key.startswith("grad/") else 1e-5) * float(np.abs(w).max())
        held = np.ones(w.shape, bool)
        if key.startswith("param/"):
            g = np.abs(want["grad/" + key[len("param/"):]])
            held = g > 1e-3 * g.max()
            assert held.any()
        assert float(np.abs(got[0] - w)[held].max()) <= tol, key


# ---------------------------------------------------------------------------
# (e) collective bytes by hand
# ---------------------------------------------------------------------------

def _hand_prefill_collectives(cfg, cell, knob):
    """The collectives of a prefill at ``.reduced()`` on (2, 2), by hand.

    Every knob: the vocab-split embedding lookup and each layer's w_down
    (split by rows over "model") leave a partial sum of the residual
    (B/2, S, d) bf16, all-reduced where the reference constrains it: 1 + L
    all-reduces.  The attention is not split (4 heads do not divide 16).
    ``fsdp``: each weight whose spec takes "data" is gathered over it at
    each use, an all-gather whose result is the weight's "model" shard:
    per layer wq, wk, wv, wo, w_gate, w_up and w_down, the table (the
    lookup) and lm_head (the logits).  ``legacy``: wq, wk, wv and wo,
    split by head dim over "model", are gathered over it at each use, so
    q, k and v come out whole."""
    B, S, d, L = cell.global_batch // 2, cell.seq_len, cfg.d_model, cfg.n_layers
    hd, Hq, Hkv, F, V = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, \
        cfg.vocab_size
    bf16 = 2
    out = dict.fromkeys(counting.COLLECTIVES, 0)
    out["all-reduce"] = (1 + L) * B * S * d * bf16
    count = 1 + L
    if knob == "fsdp":
        layer = (d * Hq * hd + 2 * d * Hkv * hd + Hq * hd * d          # wq, wk, wv, wo
                 + 3 * d * (F // 2)) * bf16                             # w_gate, w_up, w_down
        out["all-gather"] = L * layer + 2 * (V // 2) * d * bf16
        count += 7 * L + 2
    if knob == "legacy":
        out["all-gather"] = L * (d * Hq * hd + 2 * d * Hkv * hd + Hq * hd * d) * bf16
        count += 4 * L
    out["count"] = count
    return out


# the dry-run's flags of each knob; --no-zero1 changes nothing in either package
KNOB_FLAGS = [("default", []), ("fsdp", ["--fsdp"]), ("fsdp", ["--fsdp", "--no-zero1"]),
              ("legacy", ["--legacy-sharding"])]


def _options(flags):
    return dryrun.knob_options(dryrun.parser().parse_args(flags))


@pytest.mark.parametrize("knob,options", KNOB_FLAGS)
def test_prefill_collectives_equal_a_hand_count(knob, options):
    cfg, cell = get_config("llama3-8b").reduced(), ShapeCell("t", 128, 4, "prefill")
    with fake_world(4), shd.options(**_options(options)):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        counted = dryrun.count_cell(cfg, cell, mesh=mesh)
    assert counted.collective_bytes == _hand_prefill_collectives(cfg, cell, knob)


def _hand_train_collectives(cfg, cell, knob):
    """The collectives of a train step on (2, 2) by hand, checkpointed as
    the dry-run's default (``remat`` "minimal": each layer's products
    saved, the rest recomputed in the backward).  The production specs
    split heads over a 16-wide "model" axis, so ``.reduced()`` llama3-8b
    (4 query heads) keeps its heads whole and the widened config (16)
    splits its query heads but not its 2 kv heads.

    Forward, over "model", as prefill: the vocab-split lookup's partial
    sum (B/2, S, d) bf16, each row-parallel product (w_down, and wo where
    the query heads split), and the loss over the vocab split: its max,
    its sum of exponentials and its gold logit, (B/2, S) f32 each.  The
    recompute issues wo's all-reduce again (its result feeds ln2, whose
    backward reads it; w_down's feeds only the residual add).

    Backward, over "model": the input grad of each column-parallel product
    (w_gate, w_up, wq where the query heads split, lm_head), (B/2 S, d)
    bf16; where the query heads split and the kv heads do not, the grads
    of k and v, which each rank read a slice of, (B/2, S, Hkv, hd) bf16.

    AdamW, over "data": the grad of each leaf not split over "data" is
    all-reduced at its local size (bf16); the global norm all-reduces one
    f32 scalar per mesh dim of each group of leaves split alike (one group
    split over "model"; under fsdp one over "data" and one over both).

    ``fsdp``: each weight is gathered over "data" at each use, its
    "model" shard whole (per layer wq, wk, wv, wo, w_gate, w_up and
    w_down in the forward and again in the recompute, the table and
    lm_head once), and its grad reduce-scattered back to its shard; AdamW
    all-reduces the norms' grads only.  ``legacy``: wq, wk, wv and wo,
    split by head dim over "model", are gathered over it at each use
    (forward and recompute) and their grads sliced back to the shard
    before AdamW's all-reduce."""
    m = dp = 2
    B, S, d, L = cell.global_batch // dp, cell.seq_len, cfg.d_model, cfg.n_layers
    hd, Hq, Hkv, F, V = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, \
        cfg.vocab_size
    T, bf16, f32 = B * S, 2, 4
    q_split = Hq % 16 == 0
    assert Hkv % 16 != 0
    out = dict.fromkeys(counting.COLLECTIVES, 0)
    out["count"] = 0

    def add(kind, nbytes, n=1):
        out[kind] += n * nbytes
        out["count"] += n

    add("all-reduce", T * d * bf16)                                   # the lookup
    add("all-reduce", T * d * bf16, L * (2 if q_split else 1))        # w_down, wo
    add("all-reduce", T * d * bf16, L if q_split else 0)              # wo recomputed
    add("all-reduce", T * f32, 3)                                     # the loss
    add("all-reduce", T * d * bf16, L * (3 if q_split else 2) + 1)    # input grads
    add("all-reduce", B * S * Hkv * hd * bf16, 2 * L if q_split else 0)   # k, v grads
    hq = Hq // m if q_split else Hq
    attn = {"wq": d * hq * hd, "wk": d * Hkv * hd, "wv": d * Hkv * hd, "wo": hq * hd * d}
    mlp = {"w_gate": d * F // m, "w_up": d * F // m, "w_down": F // m * d}
    tables = {"embed": V // m * d, "lm_head": d * V // m}
    norms = (L * d, L * d, d)
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


@pytest.mark.parametrize("arch,knob,options", [
    ("reduced", knob, flags) for knob, flags in KNOB_FLAGS] + [
    ("widened", "default", []), ("widened", "fsdp", ["--fsdp"])])
def test_train_collectives_equal_a_hand_count(arch, knob, options):
    """Every collective of a train step, forward, recompute, backward and
    AdamW, by kind and count; on the widened config, the query heads split
    over "model" as at full width."""
    cfg = get_config("llama3-8b").reduced() if arch == "reduced" else _oracle_cfg()
    cell = ShapeCell("t", 64, 4, "train")
    with fake_world(4), shd.options(**_options(options)):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        counted = dryrun.count_cell(cfg, cell, mesh=mesh)
    assert counted.collective_bytes == _hand_train_collectives(cfg, cell, knob)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_counts_a_cell_on_both_meshes_and_resumes(tmp_path, capsys):
    out = tmp_path / "d.jsonl"
    args = ["--arch", "qwen3-4b", "--cell", "decode_32k", "--mesh", "both", "--out", str(out)]
    assert dryrun.main(args) == 0
    single, multi = [json.loads(l) for l in out.read_text().splitlines()]
    assert (single["mesh"], single["chips"], multi["mesh"], multi["chips"]) == \
        ("single", 256, "multi", 512)
    for rec in (single, multi):
        assert "error" not in rec
        assert set(rec["collective_bytes"]) == set(counting.COLLECTIVES) | {"count"}
        assert rec["collective_bytes"]["count"] > 0
        assert 0 < rec["argument_bytes"] <= rec["peak_bytes"]
    # multi halves the batch of each device: about half the work
    assert 0.4 < multi["flops"] / single["flops"] < 0.6
    capsys.readouterr()
    assert dryrun.main(args + ["--skip-done"]) == 0
    assert capsys.readouterr().out.count("skip (done)") == 2
    assert len(out.read_text().splitlines()) == 2
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,flash", [("whisper-medium", 24), ("paligemma-3b", 0)])
def test_the_encoder_decoder_and_prefix_lm_families_write_a_record_on_a_mesh(arch, flash,
                                                                              tmp_path):
    """whisper-medium's decoder self-attention takes flash once a layer;
    its encoder and cross step and paligemma-3b's prefix attention take
    ``chunked_attention``."""
    out = tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", arch, "--cell", "prefill_32k", "--mesh", "single",
                        "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert "error" not in rec and (rec["mesh"], rec["chips"]) == ("single", 256)
    assert rec["kernel_calls"].get("flash_attention", 0) == flash
    assert rec["collective_bytes"]["count"] > 0
    assert not dist.is_initialized()


def test_execute_on_a_mesh_writes_an_error_record(tmp_path):
    out = tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", "llama3-8b", "--cell", "decode_32k", "--mesh", "multi",
                        "--execute", "1", "--out", str(out)]) == 1
    rec = json.loads(out.read_text())
    assert rec["mesh"] == "multi" and "--execute" in rec["error"]


def test_the_knobs_hold_for_one_run(tmp_path):
    before = shd.get_options()
    assert dryrun.main(["--arch", "llama3-8b", "--cell", "long_500k", "--fsdp",
                        "--legacy-sharding", "--no-ep", "--out", str(tmp_path / "d.jsonl")]) == 0
    assert shd.get_options() == before
