"""The port's launch layer (``repro_torch.launch``) against the reference's
``repro.launch`` and against an analytic reckoning of the port's program.

The reference is loaded through ``tests/_jax_reference.py``; a reference
cell is lowered on a one-device mesh inside ``R.active()``.  Every count
here runs on the ``meta`` device or the CPU.
"""
import ast
import dataclasses
import inspect
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _jax_reference
from repro_torch.calibrate import harvest
from repro_torch.configs import SHAPE_CELLS, all_configs, cells_for, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels import ops
from repro_torch.launch import counting, dryrun, hlo_histogram, roofline
from repro_torch.tree import leaves_with_paths

R = _jax_reference.load()
ARCHS = list(all_configs())

# the reference's dtypes by name → the port's
DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _ref_cfg(cfg):
    return R.configs.base.ArchConfig(**dataclasses.asdict(cfg))


def _ref_cell(cell):
    return R.configs.base.ShapeCell(**dataclasses.asdict(cell))


def _jax_leaves(tree):
    """(key path, shape, dtype) of each leaf of a reference struct tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(k.key for k in path), tuple(s.shape), DTYPES[str(s.dtype)])
            for path, s in flat]


def _torch_leaves(tree):
    return [(path, tuple(t.shape), t.dtype) for path, t in leaves_with_paths(tree)]


# ---------------------------------------------------------------------------
# Configs and shape cells
# ---------------------------------------------------------------------------

def test_shape_cells_and_config_registry_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPE_CELLS.items()} == \
        {k: dataclasses.asdict(v) for k, v in R.configs.SHAPE_CELLS.items()}
    assert {k: dataclasses.asdict(v) for k, v in all_configs().items()} == \
        {k: dataclasses.asdict(v) for k, v in R.configs.all_configs().items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_cells_match_reference(arch):
    cfg, rcfg = get_config(arch), R.configs.get_config(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert cfg.reduced().param_count() == rcfg.reduced().param_count()
    assert list(cells_for(cfg)) == list(R.configs.cells_for(rcfg))


# ---------------------------------------------------------------------------
# Meta-tensor structs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_struct_matches_reference(arch):
    cfg = get_config(arch)
    with R.active():
        want = _jax_leaves(R.dryrun.param_struct(R.configs.get_config(arch)))
    got = _torch_leaves(dryrun.param_struct(cfg))
    assert got == want
    assert all(t.is_meta for _, t in leaves_with_paths(dryrun.param_struct(cfg)))


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-30b-a3b", "hymba-1.5b",
                                  "whisper-medium", "gemma2-9b"])
def test_param_struct_matches_init_params(arch):
    """The struct walks the layer shapes and the cross leaves itself, so
    hold it to the port's own init at a size the CPU can build."""
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch).reduced()
    want = _torch_leaves(init_params(cfg, dtype=torch.float32, device="cpu"))
    assert _torch_leaves(dryrun.param_struct(cfg, dtype=torch.float32)) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Same key paths and shapes for every cell; dtypes map int32 → int32,
    bfloat16 → bfloat16, float32 → float32 (the SSM state)."""
    cfg = get_config(arch)
    for name, cell in cells_for(cfg).items():
        with R.active():
            want = _jax_leaves(R.dryrun.input_specs(R.configs.get_config(arch),
                                                    R.configs.SHAPE_CELLS[name]))
        assert _torch_leaves(dryrun.input_specs(cfg, cell)) == want, name


def test_input_specs_pinned_shapes():
    """The numbers ``tests/test_launch.py`` pins for the reference."""
    cfg = get_config("llama3-8b")
    assert dryrun.input_specs(cfg, SHAPE_CELLS["train_4k"])["batch"]["tokens"].shape == (256, 4096)
    sd = dryrun.input_specs(cfg, SHAPE_CELLS["decode_32k"])
    assert sd["tokens"].shape == (128,)
    assert sd["cache"]["k"].shape == (32, 128, 32768, 8, 128)
    sw = dryrun.input_specs(get_config("whisper-medium"), SHAPE_CELLS["prefill_32k"])
    assert sw["enc_embed"].shape == (32, 1500, 1024)
    sp = dryrun.input_specs(get_config("paligemma-3b"), SHAPE_CELLS["train_4k"])
    assert sp["batch"]["prefix_embed"].shape == (256, 256, 2048)
    assert "long_500k" not in cells_for(cfg)
    assert "long_500k" in cells_for(get_config("mamba2-130m"))


# ---------------------------------------------------------------------------
# _timed_execute
# ---------------------------------------------------------------------------

def test_timed_execute_matches_reference():
    """The reference's fake-compiled case under one injected clock: the
    same result, and the same chain of calls (params/opt re-fed from the
    outputs, the batch untouched, one warmup)."""
    def run(fn):
        calls = []

        def fake_compiled(params, opt, batch):
            calls.append((params, opt, batch))
            return (params + 1, opt + 10, {"loss": 0.0})

        ticks = iter([0.0, 1.0, 1.0, 3.5, 3.5, 4.0, 4.0, 7.0])
        out = fn(fake_compiled, [0, 0, "batch"], repeats=3, refeed=((0, 0), (1, 1)),
                 block=lambda o: None, clock=lambda: next(ticks))
        return out, calls

    got, got_calls = run(dryrun._timed_execute)
    want, want_calls = run(R.dryrun._timed_execute)
    assert got == want == {"time_s": 0.5, "time_s_median": 2.5, "execute_repeats": 3}
    assert got_calls == want_calls == [(0, 0, "batch"), (1, 10, "batch"), (2, 20, "batch"),
                                       (3, 30, "batch")]
    assert dryrun._REFEED == R.dryrun._REFEED


def test_zeros_like_structs_and_execute_on_cpu():
    structs = {"a": torch.empty((3, 4), dtype=torch.bfloat16, device="meta"),
               "b": (torch.empty((), dtype=torch.int32, device="meta"),)}
    z = dryrun._zeros_like_structs(structs, torch.device("cpu"))
    assert z["a"].dtype == torch.bfloat16 and z["a"].shape == (3, 4) and not z["a"].any()
    assert isinstance(z["b"], tuple) and z["b"][0].dtype == torch.int32
    step, structs = dryrun._cell_step(get_config("qwen3-4b").reduced(),
                                      ShapeCell("t", 8, 2, "decode"))
    out = dryrun._execute_cell(step, structs, "decode", 2, torch.device("cpu"))
    assert out["execute_repeats"] == 2 and out["time_s"] > 0
    assert out["device"] == "cpu" and out["measured_peak_bytes"] is None


# ---------------------------------------------------------------------------
# Counts
# ---------------------------------------------------------------------------

def test_live_bytes_give_the_exact_peak_of_a_hand_built_program():
    for dev in ("meta", "cpu"):
        arg = torch.empty(100, device=dev)                       # 400 bytes, an argument
        with counting.count((arg,)) as c:
            a = torch.empty(1000, device=dev)                    # +4000 → 4400
            b = a * 2                                            # +4000 → 8400 (peak)
            del a                                                # 4400
            v = b.view(10, 100)                                  # a view: nothing new
            s = v.sum(0)                                         # +400 → 4800
            arg.add_(1)                                          # in place: nothing new
            del b, v                                             # 800
            t = torch.ones(1500, device=dev)                     # +6000 → 6800
            c.returned((s, arg))
        assert c.argument_bytes == 400
        assert c.peak_bytes == 8400
        assert c.live_bytes == 6800
        assert c.output_bytes == 800
        # mul 1000 + ones 1500 pointwise... sum reduces 1000, add_ 100
        assert c.flops_by_kind == {"matmul": 0, "pointwise": 1000 + 100,
                                   "reduction": 1000, "kernel": 0}
        # mul 4000 + 4000, sum 4000 + 400, add_ 400 + 400 (+ its scalar), ones 6000
        assert c.bytes_accessed == 8000 + 4400 + 800 + 6000
        assert c.oplog["view"] == [4000, 1] and c.oplog["empty"] == [4000, 1]
        del t, s


def test_a_kernel_counts_its_work_and_none_of_its_stand_ins_ops():
    """Under a counter the flash op is one launch of work.flash_attention;
    the plain version's einsums, masks and softmax are not counted, its
    output is the same and no CUDA launch is counted."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 256, 4, 64, generator=g).to(torch.bfloat16) for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    want = ops.flash_attention(q, k, v)
    launches = ops.launch_counts()
    with counting.count((q, k, v)) as c:
        out = ops.flash_attention(q, k, v)
    assert torch.equal(out, want)
    assert ops.launch_counts() == launches
    assert list(c.oplog) == ["flash_attention"]
    assert c.oplog["flash_attention"] == [out.numel() * 2, 1]
    # wgmma at hd 64: 64 rows, 64-key tiles: query tile t sees tiles 0..t
    pairs = sum(64 * (t + 1) * 64 for t in range(256 // 64))
    assert c.flops_by_kind == {"matmul": 0, "pointwise": 0, "reduction": 0,
                               "kernel": 4 * 64 * 1 * 4 * pairs}
    assert c.bytes_accessed == 2 * (2 * q.numel() + 2 * k.numel())
    assert c.peak_bytes == c.argument_bytes + out.numel() * 2


def _op_cases(dev, long=False):
    """(name, call) of each public op at small shapes on ``dev`` (flash at
    qwen3-4b's prefill_32k shape with ``long``, on ``meta`` only)."""
    g = torch.Generator().manual_seed(0)

    def t(*shape, dtype=torch.float32):
        if dev == "meta":
            return torch.empty(shape, dtype=dtype, device="meta")
        return torch.randn(shape, generator=g).to(dtype)

    S, Hq, Hkv, hd = (32768, 32, 8, 128) if long else (256, 4, 2, 64)
    q, k, v = (t(1, S, Hq, hd, dtype=torch.bfloat16), t(1, S, Hkv, hd, dtype=torch.bfloat16),
               t(1, S, Hkv, hd, dtype=torch.bfloat16))
    idx = torch.tensor([[0, 1, -1], [2, -1, -1]], dtype=torch.int32, device=dev)
    rows = torch.arange(0, 256, 4, dtype=torch.int32, device=dev)
    q8 = torch.zeros((256, 128), dtype=torch.int8, device=dev)
    return [("flash_attention", lambda: ops.flash_attention(q, k, v)),
            ("block_sparse_matmul", lambda: ops.block_sparse_matmul(t(4, 384), t(2, 3, 128, 128),
                                                                     idx)),
            ("intrablock_gather_matmul", lambda: ops.intrablock_gather_matmul(
                t(4, 256, dtype=torch.bfloat16), t(64, 96, dtype=torch.bfloat16), rows)),
            ("bitserial_zero_profile", lambda: ops.bitserial_zero_profile(q8, 8)),
            ("quantized_zero_profile", lambda: ops.quantized_zero_profile(t(256, 128), 8)),
            ("block_importance", lambda: ops.block_importance(t(256, 128), 64, 32))]


def test_on_meta_each_op_returns_its_kernels_output_and_runs_no_stand_in():
    """On ``meta`` every op returns an empty contiguous tensor of the shape
    and dtype its kernel (and its plain version) returns, with or without
    a counter, and under one the kernel is all that is counted: flash at
    S 32768 included, whose plain version would hold every score."""
    for (name, on_meta), (_, on_cpu) in zip(_op_cases("meta"), _op_cases("cpu")):
        got, want = on_meta(), on_cpu()
        assert got.is_meta and got.is_contiguous(), name
        assert (got.shape, got.dtype) == (want.shape, want.dtype), name
    flash = _op_cases("meta", long=True)[0][1]
    with counting.count() as c:
        out = flash()
    assert out.shape == (1, 32768, 32, 128) and out.is_contiguous()
    assert list(c.oplog) == ["flash_attention"]
    assert c.flops_by_kind["kernel"] > 0 == c.flops_by_kind["matmul"]


def test_copies_and_casts_move_bytes_but_count_no_flops():
    """XLA counts a copy 0 flops; the port counts its copies and casts so
    (see the counting module on XLA's CPU converts)."""
    x = torch.empty(1000, device="meta")
    with counting.count((x,)) as c:
        x.clone()
        x.to(torch.bfloat16)
        x.view(10, 100).t().contiguous()                 # a clone of the view
    assert c.flops == 0
    assert c.bytes_accessed == 2 * (4000 + 4000) + (4000 + 2000)


def test_the_kernels_layer_imports_nothing_of_the_launch_layer():
    """The kernels report to a count through ``kernels/hook.py``, which the
    launch layer fills: the lower layer never imports the higher one."""
    kernels = Path(ops.__file__).parent
    for path in kernels.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                mod = "." * node.level + (node.module or "")
                assert "launch" not in mod, f"{path.name} imports {mod}"


def test_block_sparse_work_counts_live_blocks():
    w = torch.zeros(2, 3, 128, 128)
    idx = torch.tensor([[0, 1, -1], [2, -1, -1]], dtype=torch.int32)
    x = torch.randn(4, 384)
    with counting.count() as c:
        ops.block_sparse_matmul(x, w, idx)
    assert c.flops_by_kind["kernel"] == 2 * 4 * 128 * 128 * 3
    assert c.bytes_accessed == (4 * 384 * 4 + 6 * 4 + 3 * 128 * 128 * 4 + 4 * 256 * 4)
    assert list(c.oplog) == ["block_sparse_matmul"]


def _qwen_matmul_flops(kind, S, B, remat):
    """The port's matmul flops, reckoned by hand for qwen3-4b.reduced() (bf16):
    each projection 2·T·K·N; prefill attention by flash's ``general``
    variant (head dim 16 has no wgmma build): 64-row query tiles over the
    prompt padded to 128, each seeing its 64-key tiles up to its own, 4·hd
    flops a (row, key) pair; decode attention by ``chunked_attention`` over
    the whole cache, train attention over keys padded to its 1024 chunk;
    the tied unembedding 2·d·V a token (the last token in prefill);
    training 3x the forward, the checkpoint recomputing the attention
    einsums once more under ``minimal``."""
    cfg = get_config("qwen3-4b").reduced()
    d, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    F, V, L = cfg.d_ff, cfg.vocab_size, cfg.n_layers
    per_token = 2 * (d * Hq * hd + 2 * d * Hkv * hd + Hq * hd * d + 3 * d * F)
    if kind == "prefill":
        S_pad = -(-S // 128) * 128
        pairs = sum(64 * (t + 1) * 64 for t in range(S_pad // 64))
        return L * B * S * per_token + L * 4 * hd * B * Hq * pairs + 2 * B * d * V
    if kind == "decode":
        return L * B * per_token + L * 4 * B * Hq * S * hd + 2 * B * d * V
    keys = 1024 * -(-S // 1024)
    mm = L * B * S * per_token + 2 * B * S * d * V
    bmm = L * 4 * B * Hq * S * keys * hd
    return 3 * mm + (4 if remat else 3) * bmm


@pytest.mark.parametrize("kind,S,B,remat", [("train", 64, 2, True), ("train", 64, 2, False),
                                            ("prefill", 64, 2, True), ("decode", 256, 2, True),
                                            ("prefill", 1280, 1, True)])
def test_matmul_flops_equal_an_analytic_reckoning(kind, S, B, remat):
    counted = dryrun.count_cell(get_config("qwen3-4b").reduced(), ShapeCell("t", S, B, kind),
                                remat=remat)
    by = counted.flops_by_kind
    assert by["matmul"] + by["kernel"] == _qwen_matmul_flops(kind, S, B, remat)
    assert (by["kernel"] > 0) == (kind == "prefill")
    assert counted.peak_bytes >= counted.argument_bytes > 0


# Total flops against the reference's XLA count (its ``cost_analysis()`` of
# the cell lowered with every layer and attention tile unrolled) for one
# train step (B 2, S 128, no remat), one prefill (B 1, S 2048) and one
# decode step (B 2 against a 2048-token cache) at d_model 512, 8 heads of
# 64, d_ff 2048 (0 for the SSM).  Two differences are reckoned before the
# comparison:
# * XLA's CPU backend computes bf16 in f32: it converts every weight and
#   the cache to f32, 1 flop an element (``convert``), which the card never
#   does; the port counts no casts.  So XLA's converts are taken off its
#   count, summed from the compiled HLO.  They are half of a decode step's.
# * Prefill attention: the reference's tiled causal path skips masked
#   tiles at its 1024-key chunk (at S 2048: 3 tiles of 1024 x 1024 pairs a
#   head), flash at its 64 x 64 tiles (wgmma at head dim 64: 528 tiles of
#   64 x 64).  The difference, 4·hd flops a pair, is added to the port's.
# The rest is elementwise, which ATen and XLA's fusions count differently.
# Readings of (port - XLA) / XLA (CPU, jax 0.9.0, torch 2.13), train /
# prefill / decode: qwen3-4b -0.0076 -0.0100 -0.0024, qwen3-moe-30b-a3b
# -0.0037 -0.0039 -0.0024, mamba2-130m -0.0159 -0.0050 -0.0166,
# whisper-medium -0.0090 -0.0101 -0.0026; with one layer's w_down (mamba2:
# w_out) left out of the count: -0.110 -0.107 -0.088, -0.157 -0.156
# -0.151, -0.123 -0.138 -0.160, -0.102 -0.106 -0.088.  So 0.05: above
# every correct reading, below every planted one.  Bytes have no parity
# (unfused ATen traffic against XLA's fused traffic); their ratio is only
# printed.
XLA_FLOPS_TOL = 0.05
XLA_CELLS = {"train": ShapeCell("t", 128, 2, "train"), "prefill": ShapeCell("t", 2048, 1, "prefill"),
             "decode": ShapeCell("t", 2048, 2, "decode")}
_HLO_CONVERT = re.compile(r"^\s*(?:ROOT )?%[\w.\-]+ = \w+\[([\d,]*)\]\S* convert\(", re.M)


def _wide(cfg):
    return dataclasses.replace(cfg, d_model=512, n_heads=8, head_dim=64,
                               d_ff=2048 if cfg.d_ff else 0)


def _hlo_converts(hlo_text):
    """Elements of every ``convert`` in an HLO module (fused ones too)."""
    return sum(int(np.prod([int(d) for d in m.group(1).split(",") if d]))
               for m in _HLO_CONVERT.finditer(hlo_text))


def _reference_causal_pairs(S, chunk=1024):
    """(query, key) pairs a head of the reference's tiled causal attention
    computes: query tile i (of ``chunk`` rows) against kv chunks 0..i."""
    assert S > chunk and S % chunk == 0
    return sum(chunk * chunk * (i + 1) for i in range(S // chunk))


def _flash_pairs(S, tile=64):
    """The same for flash's wgmma variant at head dim 64: 64-row query
    tiles against their 64-key tiles up to their own."""
    return sum(tile * tile * (t + 1) for t in range(S // tile))


def _down_flops(cfg, kind, B, S):
    """Flops of one layer's down projection (w_down, or the SSM's w_out)
    over the cell's tokens, forward + backward in training: 2·T·K·d a
    pass, each expert over its capacity slab in an MoE."""
    T = B if kind == "decode" else B * S
    passes = 3 if kind == "train" else 1
    if cfg.n_experts > 1:
        C = max(1, int(np.ceil(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))
        return passes * 2 * cfg.n_experts * C * cfg.d_ff * cfg.d_model
    return passes * 2 * T * (cfg.d_ff or cfg.ssm_inner()) * cfg.d_model


@pytest.mark.parametrize("kind", list(XLA_CELLS))
@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-30b-a3b", "mamba2-130m",
                                  "whisper-medium"])
def test_total_flops_near_the_references_xla_count(arch, kind):
    cfg = _wide(get_config(arch).reduced())
    cell = XLA_CELLS[kind]
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with R.active(), R.transformer.scan_unroll(cfg.n_layers), R.layers.chunk_unroll(8):
        compiled = R.dryrun.lower_cell(_ref_cfg(cfg), _ref_cell(cell), mesh, multi_pod=False,
                                       remat=False).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    xla_flops = float(cost["flops"]) - _hlo_converts(compiled.as_text())
    counted = dryrun.count_cell(cfg, cell, remat=False)
    port = counted.flops
    if counted.flops_by_kind["kernel"]:          # flash: the causal self-attention of prefill
        assert kind == "prefill" and cfg.family != "ssm"
        tiles = _reference_causal_pairs(cell.seq_len) - _flash_pairs(cell.seq_len)
        port += 4 * cfg.resolved_head_dim * cell.global_batch * cfg.n_heads * cfg.n_layers * tiles
    rel = (port - xla_flops) / xla_flops
    planted = (port - _down_flops(cfg, kind, cell.global_batch, cell.seq_len)
               - xla_flops) / xla_flops
    print(f"{arch} {kind}: flops rel {rel:+.4f}, missing w_down {planted:+.4f}, "
          f"bytes ratio {counted.bytes_accessed / float(cost['bytes accessed']):.3f}")
    assert abs(rel) <= XLA_FLOPS_TOL
    assert abs(planted) > XLA_FLOPS_TOL


# ---------------------------------------------------------------------------
# The CLI and its ledger
# ---------------------------------------------------------------------------

def _reference_record_keys():
    """The keys of the record the reference's run_cell builds, read from
    its source, and the fields an execution adds."""
    tree = ast.parse(inspect.getsource(R.dryrun.run_cell).lstrip())
    keys = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets] == ["rec"]):
            keys = {k.value for k in node.value.keys}
    assert keys and "flops" in keys
    return keys, {"executed", "time_s", "time_s_median", "execute_repeats"}


def test_cli_writes_the_references_keys_skips_done_and_records_failures(tmp_path, capsys,
                                                                         monkeypatch):
    out = tmp_path / "d.jsonl"
    args = ["--arch", "mamba2-130m", "--cell", "decode_32k", "--out", str(out)]
    assert dryrun.main(args) == 0
    assert dryrun.main(args + ["--execute", "1", "--batch", "2", "--device", "cpu"]) == 0
    counted, executed = [json.loads(l) for l in out.read_text().splitlines()]
    keys, timed = _reference_record_keys()
    assert set(counted) == keys
    assert set(executed) == keys | timed | {"measured_peak_bytes", "device"}
    assert (counted["mesh"], counted["chips"], counted["compile_s"]) == ("local", 1, 0.0)
    assert counted["flops_raw"] == counted["flops"] > 0
    assert counted["collective_bytes"] == dict.fromkeys(
        ["all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
         "count"], 0)
    assert (executed["tag"], executed["global_batch"]) == ("b2", 2)
    assert counted["global_batch"] == 128 and counted["tag"] == ""
    assert counted["peak_bytes"] >= counted["argument_bytes"]

    capsys.readouterr()
    assert dryrun.main(args + ["--skip-done"]) == 0
    assert "skip (done)" in capsys.readouterr().out
    assert len(out.read_text().splitlines()) == 2

    def planted(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "param_struct", planted)
    assert dryrun.main(["--arch", "qwen3-4b", "--cell", "prefill_32k", "--out", str(out)]) == 1
    err = json.loads(out.read_text().splitlines()[-1])
    assert err == {"arch": "qwen3-4b", "cell": "prefill_32k", "mesh": "local", "tag": "",
                   "error": "RuntimeError: planted"}


def test_cli_skips_cells_the_arch_does_not_run(tmp_path, capsys):
    out = tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", "qwen3-4b", "--cell", "long_500k", "--out", str(out)]) == 0
    assert "SKIP" in capsys.readouterr().out and not out.exists()


@pytest.fixture(scope="module")
def ledger(tmp_path_factory):
    """A port-written ledger: a counted record, an executed one, an error row."""
    path = tmp_path_factory.mktemp("ledger") / "d.jsonl"
    recs = [dryrun.run_cell("mamba2-130m", "decode_32k"),
            dryrun.run_cell("mamba2-130m", "decode_32k", execute=2, batch=2, device="cpu"),
            {"arch": "qwen3-4b", "cell": "train_4k", "mesh": "local", "tag": "",
             "error": "RuntimeError: planted"}]
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return path, recs


def test_harvest_reads_port_records_as_the_reference_does(ledger):
    path, recs = ledger
    got, want = harvest.from_ledger(path), R.harvest.from_ledger(path)
    assert [s.to_record() for s in got.samples] == [s.to_record() for s in want.samples]
    assert (got.skipped_untimed, got.skipped_malformed) == \
        (want.skipped_untimed, want.skipped_malformed) == (2, 0)
    (s,) = got.samples
    assert s.op_class == "step:decode" and s.time_s == recs[1]["time_s"]
    assert dict(s.meta) == {"arch": "mamba2-130m", "cell": "decode_32k", "mesh": "local",
                            "tag": "b2", "chips": 1}


REFERENCE_RECORD = {
    "arch": "x", "cell": "train_4k", "mesh": "single", "tag": "",
    "chips": 256, "kind": "train", "seq_len": 4096, "global_batch": 256,
    "flops": 1.97e14, "bytes_accessed": 8.19e11,
    "collective_bytes": {"all-reduce": 5e10, "count": 3},
    "peak_bytes": 2 ** 30, "params": 8e9, "active_params": 8e9,
}


def test_roofline_matches_reference(ledger, tmp_path, capsys):
    path, recs = ledger
    for rec in [REFERENCE_RECORD, *recs]:
        assert roofline.analyze(rec) == R.roofline.analyze(rec)
    from repro_torch.calibrate.profile import CalibrationProfile
    fitted = CalibrationProfile(name="fitted", device="card", peak_flops=5e14, hbm_bw=2e12,
                                ici_bw=1.0)
    assert roofline.analyze(recs[1], fitted) == R.roofline.analyze(
        recs[1], R.profile.CalibrationProfile(**dataclasses.asdict(fitted)))
    assert list(roofline.load_ledger(str(path))) == list(R.roofline.load_ledger(str(path)))
    ref_path = tmp_path / "ref.jsonl"
    ref_path.write_text(json.dumps(REFERENCE_RECORD) + "\n" + path.read_text() + "{broken\n")
    for ledger_path in (path, ref_path):
        assert roofline.main(["--ledger", str(ledger_path), "--json"]) == 0
        got = capsys.readouterr()
        assert R.roofline.main(["--ledger", str(ledger_path), "--json"]) == 0
        want = capsys.readouterr()
        assert (got.out, got.err) == (want.out, want.err)
        assert json.loads(got.out)


def test_histogram_ranks_the_op_log_by_result_bytes(capsys):
    oplog = {"mm": [300, 2], "view": [500, 9], "flash_attention": [100, 1], "mul": [50, 3],
             "sum": [20, 1]}
    assert hlo_histogram.histogram(oplog, top=3) == {"view": (500, 9), "mm": (300, 2),
                                                     "flash_attention": (100, 1)}
    # views, pointwise ops and copies fuse; matmuls, reductions and kernels do not
    assert [op for op in oplog if hlo_histogram.fusible(op)] == ["view", "mul"]
    assert hlo_histogram.fused_bytes_estimate(oplog) == (970, 420)
    # allocations move no bytes: fusible, so the estimate holds only traffic
    assert hlo_histogram.fusible("empty") and hlo_histogram.fusible("_unsafe_view")
    assert hlo_histogram.fused_bytes_estimate({**oplog, "empty": [800, 2]}) == (1770, 420)
    assert hlo_histogram.main(["--arch", "qwen3-4b", "--cell", "prefill_32k", "--layers", "1",
                               "--top", "40"]) == 0
    out = capsys.readouterr().out
    assert "qwen3-4b × prefill_32k (L=1) — top 40 ops" in out
    assert " flash_attention " in out and " mm " in out


def test_roofline_defaults_to_the_references_analytic_profile():
    """Read without --profile, a record is priced with the reference's
    analytic peaks (kept for parity); a card's records need a fitted one."""
    assert roofline._DEFAULT_PROFILE.name == "tpu-v5e-analytic"
    assert roofline.PEAK_FLOPS == R.roofline.PEAK_FLOPS
