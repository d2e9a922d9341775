"""Dry-run of every (arch x shape) cell, on one card or on a mesh: the
port's counterpart of ``repro/launch/dryrun.py``.

For each cell this builds the cell's step (a train step, ``prefill`` or
``decode_step``) over tensors on the ``meta`` device, which hold shapes
and dtypes and allocate nothing, runs it once under
:func:`~repro_torch.launch.counting.count` and records what the
reference reads from XLA:

* ``flops`` / ``bytes_accessed`` — the counting mode's, of the route the
  card takes (each CUDA kernel by its analytic work, :mod:`repro_torch.
  kernels.work`).  Unlike XLA's rolled scan, the eager layer loop counts
  every layer, so ``flops_raw`` / ``bytes_raw`` equal them and no
  L = 1 / L = 2 extrapolation is needed;
* ``argument_bytes`` / ``output_bytes`` / ``temp_bytes`` / ``peak_bytes``
  — the counting mode's live-byte tracker (``temp_bytes`` is the peak
  beyond the arguments);
* ``collective_bytes`` — the reference's five kinds and ``count``: all 0
  on one card (``--mesh local``, the default).

``--mesh single|multi|both`` counts one rank of the production mesh (16 x
16 over ("data", "model"), or 2 x 16 x 16 over ("pod", "data", "model"))
in a fake world of 256 / 512 ranks started for the cell and closed after
it (:func:`~repro_torch.launch.mesh.fake_world`; no device, no peer).
The arguments are DTensors with ``meta`` local shards, placed as the
reference's ``lower_cell`` places them (:func:`place_structs`): params
and m/v by the sharding options' specs, batch rows over the batch axes,
the decode cache by ``cache_specs``.  The
step runs partitioned (:mod:`repro_torch.distributed.partition`), and the
record's flops, bytes and memory are the rank's, ``collective_bytes`` the
result bytes of the collectives it issued, by kind, and ``chips`` 256 or
512; it adds ``kernel_calls`` and ``kernel_flops``, the rank's CUDA
kernels counted (not launched).  ``--fsdp``, ``--no-ep`` and
``--legacy-sharding`` set the options as the reference's flags do, for
the run only.  ``--no-zero1`` is accepted and changes nothing, in the
reference as here: ZeRO-1 rides with FSDP there, and FSDP's params already
take the specs it gives m/v.  ``--no-ep`` reaches no dense decoder.  GSPMD and DTensor pick their
collectives each its own way, so these bytes are the port's program's,
not the reference's.  A mesh takes the dense decoders only (llama3-8b,
qwen3-4b, gemma-7b, gemma2-9b), and no ``--execute``: any other family
on a mesh, or an execution, writes an ``error`` record.

``--scores-bf16`` materialises ``chunked_attention``'s score tiles in bf16
(:func:`repro_torch.models.layers.set_scores_dtype`) for the run, and puts
f32 back when :func:`main` returns, where the reference leaves it set.

With ``--execute N`` the same step also *runs* N times (after one warmup
call) on zero-filled tensors on the execution device (the card by
default), re-fed as the reference re-feeds donated buffers, and the
record gains ``time_s`` (best wall-clock), ``time_s_median``,
``execute_repeats``, ``measured_peak_bytes``
(``torch.cuda.max_memory_allocated`` after a reset) and ``device``; the
port's calibration harvest reads such records as ``step:<kind>`` samples.
Execution allocates the cell's real footprint, so ``--batch`` overrides
the cell's global batch (one H100 cannot hold the reference's global
shapes: a decode_32k cache of 128 sequences of llama3-8b is 4.4 TB); the
record's ``global_batch`` is then the batch that ran and its ``tag`` gains
``b<batch>``.  ``compile_s`` is 0.0: eager PyTorch compiles nothing, and
``lower_s`` is the time to build and count the ``meta`` step.

Results append to a JSONL ledger (``--out``), one record per cell and one
``error`` record per failed cell (exit 1 on any), so an interrupted
matrix run resumes where it stopped (``--skip-done``).

Not ported here: the dry-run on a mesh of the MoE, SSM / hybrid,
encoder-decoder and prefix-LM families, whose mesh paths
(``_moe_block_ep``, ``_swa_seqpar_attention``) run the global view of
:mod:`repro_torch.distributed.sharding`, not on DTensors.

``--emit-trace`` also captures each cell's modeling-plane DAG
(:mod:`repro_torch.trace`, on ``meta``: a train cell as the forward trace)
at the record's shape, its ``global_batch`` included, saves the graph under
``<out dir>/trace/<arch>_<cell>.json``, pre-flights the lowered DAG
strictly and adds ``trace_path``, ``trace_digest``, ``trace_ops``,
``trace_mvm_macs`` and ``trace_mvm_weights`` to the record.

Usage (from the repository root, with ``PYTHONPATH=src``):
  python -m repro_torch.launch.dryrun --arch qwen3-4b --cell prefill_32k --out d.jsonl
  python -m repro_torch.launch.dryrun --arch llama3-8b --cell train_4k --mesh both --fsdp
  python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
  python -m repro_torch.launch.dryrun --arch qwen3-4b --cell decode_32k \\
      --execute 3 --batch 8 --tag calib
  python -m repro_torch.launch.dryrun --arch qwen3-4b --cell prefill_32k --emit-trace
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import obs, resolve_device
from ..configs import all_configs, cells_for, get_config
from ..configs.base import SHAPE_CELLS, ArchConfig, ShapeCell
from ..distributed import sharding as shd
from ..models import layers
from ..models.transformer import decode_step, init_cache, param_struct, prefill
from ..train.optimizer import AdamWConfig, adamw_init, adamw_update
from ..train.step import make_train_step
from .counting import Counter, count
from .mesh import fake_world, make_production_mesh

__all__ = ["param_struct", "input_specs", "place_structs", "count_cell", "run_cell", "main"]

META = torch.device("meta")
# the families whose dry-run on a mesh is ported: the dense decoders, which
# take no shard_map path in the reference
MESH_FAMILIES = ("dense",)
MESH_CHIPS = {"single": 256, "multi": 512}
# the port's CUDA kernels, as the counter logs them
KERNELS = ("flash_attention", "block_sparse_matmul", "block_importance",
           "intrablock_gather_matmul", "bitserial_zero_profile")


# ---------------------------------------------------------------------------
# Meta-tensor inputs (shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of a cell, shaped as the
    reference's structs: int32 tokens/labels, bf16 ``prefix_embed`` and
    ``enc_embed``, and for decode the ``init_cache(cfg, B, S)`` tree."""
    B, S, d = cell.global_batch, cell.seq_len, cfg.d_model
    extra = {}
    if cfg.prefix_len:
        extra["prefix_embed"] = _meta((B, cfg.prefix_len, d), torch.bfloat16)
    if cfg.enc_dec:
        extra["enc_embed"] = _meta((B, cfg.enc_seq, d), torch.bfloat16)
    if cell.kind == "train":
        return {"batch": {"tokens": _meta((B, S), torch.int32),
                          "labels": _meta((B, S), torch.int32), **extra}}
    if cell.kind == "prefill":
        return {"tokens": _meta((B, S), torch.int32), **extra}
    # decode: one new token against a cache of length S
    return {"tokens": _meta((B,), torch.int32),
            "cache": init_cache(cfg, B, S, dtype=torch.bfloat16, device=META)}


# ---------------------------------------------------------------------------
# The step of a cell, counted
# ---------------------------------------------------------------------------

def _cell_step(cfg: ArchConfig, cell: ShapeCell, *, remat: bool = True,
               microbatches: int = 1, remat_policy: str = "minimal"
               ) -> Tuple[Callable, Tuple]:
    """(step, structs): the cell's step and its ``meta`` arguments, so that
    ``step(*structs)`` is the counted run and ``step(*zeros)`` the executed
    one.  A train step is ``TrainStep.grads`` then ``adamw_update`` (no
    loss read back, which a ``meta`` tensor cannot give); it writes params
    and optimizer state in place and returns them, as ``decode_step``
    returns the cache it wrote."""
    params = param_struct(cfg)
    specs = input_specs(cfg, cell)
    if cell.kind == "train":
        step = make_train_step(cfg, AdamWConfig(), remat=remat, microbatches=microbatches,
                               remat_policy=remat_policy)

        def train_step(params, opt_state, batch):
            loss, grads = step.grads(params, batch)
            params, opt_state, metrics = adamw_update(grads, opt_state, params, step.opt_cfg)
            return params, opt_state, dict(metrics, loss=loss)

        return train_step, (params, adamw_init(params), specs["batch"])

    if cell.kind == "prefill":
        def prefill_step(params, inputs):
            kw = {k: v for k, v in inputs.items() if k != "tokens"}
            with torch.no_grad():
                return prefill(params, inputs["tokens"], cfg, **kw)

        return prefill_step, (params, specs)

    def serve_step(params, tokens, cache):
        with torch.no_grad():
            return decode_step(params, tokens, cfg, cache)

    return serve_step, (params, specs["tokens"], specs["cache"])


def _count(step: Callable, structs: Tuple) -> Counter:
    with count(structs) as counter:
        counter.returned(step(*structs))
    return counter


def place_structs(cfg: ArchConfig, cell: ShapeCell, structs: Tuple, mesh, *,
                  multi_pod: bool = False) -> Tuple:
    """The cell's ``meta`` arguments as DTensors on ``mesh``, placed as the
    reference's ``lower_cell`` places them: params, and a train cell's
    optimizer ``m``/``v``, by their specs (under the sharding options'
    ``fsdp``), batch inputs by their rows over
    the batch axes, decode tokens likewise when the batch fills the data
    axis (else replicated) and the cache by ``cache_specs``."""
    b = shd.batch_spec(multi_pod=multi_pod)[0]

    def rows(t):
        return shd.P(b, *([None] * (t.dim() - 1)))

    params = shd.distribute(structs[0], mesh, shd.tree_specs(structs[0]))
    if cell.kind == "train":
        _, opt, batch = structs
        opt = {"step": shd.distribute(opt["step"], mesh, shd.P()),
               **{k: shd.distribute(opt[k], mesh, shd.tree_specs(opt[k])) for k in ("m", "v")}}
        return params, opt, {k: shd.distribute(v, mesh, rows(v)) for k, v in batch.items()}
    if cell.kind == "prefill":
        return params, {k: shd.distribute(v, mesh, rows(v)) for k, v in structs[1].items()}
    tokens, cache = structs[1:]
    data_size = 16 * (2 if multi_pod else 1)
    tok = shd.P(b) if cell.global_batch >= data_size else shd.P(None)
    cspecs = shd.cache_specs(cfg, cell, multi_pod=multi_pod)
    return (params, shd.distribute(tokens, mesh, tok),
            {k: shd.distribute(v, mesh, cspecs.get(k, shd.P())) for k, v in cache.items()})


def count_cell(cfg: ArchConfig, cell: ShapeCell, *, remat: bool = True,
               microbatches: int = 1, remat_policy: str = "minimal", mesh=None,
               multi_pod: bool = False) -> Counter:
    """One step of the cell on ``meta`` under the counting mode: the
    counterpart of the reference's ``lower_cell`` + ``_cost_of``.  With
    ``mesh`` (a ``DeviceMesh`` with named dims, over a fake world) the
    arguments are placed on it (:func:`place_structs`) and the counts are
    one rank's."""
    step, structs = _cell_step(cfg, cell, remat=remat, microbatches=microbatches,
                               remat_policy=remat_policy)
    if mesh is None:
        return _count(step, structs)
    structs = place_structs(cfg, cell, structs, mesh, multi_pod=multi_pod)
    with shd.set_mesh(mesh):
        return _count(step, structs)


# ---------------------------------------------------------------------------
# Cell execution + ledger
# ---------------------------------------------------------------------------

def _timed_execute(compiled, args, *, repeats: int = 3,
                   refeed: Tuple[Tuple[int, int], ...] = (),
                   block=None, clock=time.perf_counter) -> Dict[str, float]:
    """Run ``compiled(*args)`` ``repeats`` times and report wall seconds.

    ``refeed`` maps output positions back onto argument slots (``(arg_idx,
    out_idx)``), as the reference re-feeds donated buffers: the port's
    train step and ``decode_step`` write in place and return the same
    objects, so re-feeding them is an identity, and the contract stays the
    reference's.  One extra warmup call absorbs dispatch warmup and is
    excluded from the stats.  ``block(out)`` waits for the call's work
    (``torch.cuda.synchronize`` on the card).
    """
    if block is None:
        block = lambda out: None     # noqa: E731  (the CPU finishes before returning)
    args = list(args)
    times = []
    for _ in range(max(1, repeats) + 1):
        t0 = clock()
        out = compiled(*args)
        block(out)
        times.append(clock() - t0)
        for arg_idx, out_idx in refeed:
            args[arg_idx] = out[out_idx]
        del out            # (a prefill's cache would stand twice during the next call)
    timed = times[1:]
    timed_sorted = sorted(timed)
    mid = len(timed_sorted) // 2
    median = (timed_sorted[mid] if len(timed_sorted) % 2
              else 0.5 * (timed_sorted[mid - 1] + timed_sorted[mid]))
    return {"time_s": min(timed), "time_s_median": median,
            "execute_repeats": len(timed)}


# argument slot <- output position, per cell kind (train returns params and
# optimizer state first; decode returns the cache second)
_REFEED = {"train": ((0, 0), (1, 1)), "prefill": (), "decode": ((2, 1),)}


def _zeros_like_structs(structs, device: torch.device):
    """Zero-filled tensors on ``device`` for a tree of ``meta`` tensors."""
    if isinstance(structs, dict):
        return {k: _zeros_like_structs(v, device) for k, v in structs.items()}
    if isinstance(structs, (tuple, list)):
        return type(structs)(_zeros_like_structs(v, device) for v in structs)
    return torch.zeros(structs.shape, dtype=structs.dtype, device=device)


def _execute_cell(step: Callable, structs: Tuple, kind: str, repeats: int,
                  device: torch.device) -> Dict[str, Any]:
    """Run the cell's step on zero inputs on ``device``; returns the timing
    fields, the measured peak memory on a card, and the device's name."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    args = _zeros_like_structs(structs, device)
    block = (lambda out: torch.cuda.synchronize(device)) if cuda else None
    timing = _timed_execute(step, args, repeats=repeats, refeed=_REFEED.get(kind, ()),
                            block=block)
    timing["measured_peak_bytes"] = (int(torch.cuda.max_memory_allocated(device)) if cuda
                                     else None)
    timing["device"] = torch.cuda.get_device_name(device) if cuda else device.type
    return timing


def _tag(extra_tag: str, batch: Optional[int]) -> str:
    if batch is None:
        return extra_tag
    return f"{extra_tag}-b{batch}" if extra_tag else f"b{batch}"


def run_cell(arch: str, cell_name: str, mesh_kind: str = "local", *,
             remat: bool = True, microbatches: int = 1, extra_tag: str = "",
             remat_policy: str = "minimal", ffn_compress: float = 0.0, execute: int = 0,
             batch: Optional[int] = None,
             device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Count one cell (and, with ``execute``, run it on ``device``, the card
    by default); returns its ledger record, with the reference's keys.

    ``mesh_kind`` "local" counts one card; "single" / "multi" count one
    rank of the production mesh (16 x 16 / 2 x 16 x 16) in a fake world of
    256 / 512 ranks started for the cell and closed after it, the
    arguments placed by the sharding options of
    :mod:`repro_torch.distributed.sharding`: per-device flops, bytes and
    memory, and ``collective_bytes`` by kind.  A mesh takes the dense
    decoders only (:data:`MESH_FAMILIES`), and no ``execute``."""
    cfg = get_config(arch)
    if mesh_kind not in ("local", *MESH_CHIPS):
        raise ValueError(f"mesh {mesh_kind!r}: one of local, single, multi")
    if mesh_kind != "local":
        if cfg.family not in MESH_FAMILIES:
            raise NotImplementedError(
                f"mesh {mesh_kind!r}: the dry-run on a mesh of the {cfg.family} family "
                f"({arch}) is not ported; only {', '.join(MESH_FAMILIES)} decoders are")
        if execute:
            raise NotImplementedError(f"mesh {mesh_kind!r}: --execute on a mesh is not ported "
                                      "(the fake world has no devices)")
    if ffn_compress > 0:
        # FullBlock row-compressed FFN: pruned rows of w_up/w_gate (and
        # cols of w_down) removed entirely, so the FFN is a smaller dense
        # matmul, as the reference counts it
        keep = 1.0 - ffn_compress
        cfg = dataclasses.replace(
            cfg, d_ff=max(256, int(round(cfg.d_ff * keep / 256)) * 256))
    cell = SHAPE_CELLS[cell_name]
    if batch is not None:
        cell = dataclasses.replace(cell, global_batch=batch)

    t0 = time.time()
    with obs.span("dryrun.count", arch=arch, cell=cell_name, mesh=mesh_kind):
        if mesh_kind == "local":
            step, structs = _cell_step(cfg, cell, remat=remat, microbatches=microbatches,
                                       remat_policy=remat_policy)
            counted = _count(step, structs)
        else:
            multi_pod = mesh_kind == "multi"
            with fake_world(MESH_CHIPS[mesh_kind]):
                mesh = make_production_mesh(multi_pod=multi_pod)
                counted = count_cell(cfg, cell, remat=remat, microbatches=microbatches,
                                     remat_policy=remat_policy, mesh=mesh, multi_pod=multi_pod)
    t_lower = time.time() - t0

    timing: Dict[str, Any] = {}
    if execute > 0:
        dev = resolve_device(device)
        with obs.span("dryrun.execute", arch=arch, cell=cell_name, mesh=mesh_kind,
                      repeats=execute):
            timing = _execute_cell(step, structs, cell.kind, execute, dev)

    coll = dict(counted.collective_bytes)
    rec = {
        "arch": arch,
        "cell": cell_name,
        "mesh": mesh_kind,
        "tag": _tag(extra_tag, batch),
        "chips": MESH_CHIPS.get(mesh_kind, 1),
        "kind": cell.kind,
        "seq_len": cell.seq_len,
        "global_batch": cell.global_batch,
        "flops": float(counted.flops),
        "bytes_accessed": float(counted.bytes_accessed),
        "collective_bytes": coll,
        "flops_raw": float(counted.flops),
        "bytes_raw": float(counted.bytes_accessed),
        "collective_raw": dict(coll),
        "argument_bytes": counted.argument_bytes,
        "output_bytes": counted.output_bytes,
        "temp_bytes": counted.peak_bytes - counted.argument_bytes,
        "peak_bytes": counted.peak_bytes,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "lower_s": round(t_lower, 2),
        "compile_s": 0.0,
    }
    if mesh_kind != "local":
        # one rank's CUDA kernels, counted (none launched): calls by name and their flops
        rec["kernel_calls"] = {name: counted.oplog[name][1] for name in KERNELS
                               if name in counted.oplog}
        rec["kernel_flops"] = counted.flops_by_kind["kernel"]
    if timing:
        rec["executed"] = True
        rec.update(timing)
    return rec


def _emit_trace(arch: str, cell: ShapeCell, out: str) -> Dict[str, Any]:
    """Capture the cell's modeling-plane DAG (a train cell as the forward
    trace, as the reference maps it) and save it beside the ledger
    (``<out dir>/trace/<arch>_<cell>.json``); returns the record's
    ``trace_*`` fields: the graph's content digest, which keys the
    explore cache, and the lowered MVM totals, the analytic counterpart of
    the record's ``flops``.  A broken lowered DAG raises (strict
    pre-flight), which fails the cell's record."""
    from ..analysis import preflight
    from ..trace import lower_graph, summarize, trace_model

    step = {"train": "forward"}.get(cell.kind, cell.kind)
    graph = trace_model(get_config(arch), step=step, seq_len=cell.seq_len,
                        batch=cell.global_batch)
    tdir = os.path.join(os.path.dirname(out) or ".", "trace")
    os.makedirs(tdir, exist_ok=True)
    path = os.path.join(tdir, f"{arch}_{cell.name}.json")
    graph.save(path)
    wl = lower_graph(graph)
    preflight(wl, strict=True, where="dryrun.emit_trace")
    s = summarize(wl)
    return {"trace_path": path, "trace_digest": graph.digest(), "trace_ops": len(wl),
            "trace_mvm_macs": s["mvm_macs"], "trace_mvm_weights": s["mvm_weights"]}


def parser() -> argparse.ArgumentParser:
    """The command line of :func:`main`."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--cell", default=None, choices=list(SHAPE_CELLS))
    ap.add_argument("--mesh", default="local", choices=["local", "single", "multi", "both"],
                    help="local: one card; single / multi: one rank of the 16x16 / 2x16x16 "
                         "production mesh in a fake world of 256 / 512 ranks; both: single "
                         "then multi")
    ap.add_argument("--all", action="store_true", help="run the full arch × cell matrix")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--execute", type=int, default=0, metavar="N",
                    help="also RUN each cell's step N times on zero inputs and record the "
                         "best wall-clock as time_s (allocates the real footprint; feeds "
                         "repro_torch.calibrate; mesh local only)")
    ap.add_argument("--tag", default="")
    # sharding-strategy knobs (the reference's)
    ap.add_argument("--fsdp", action="store_true",
                    help="shard params over 'data' too (FSDP/ZeRO-3)")
    ap.add_argument("--no-zero1", action="store_true",
                    help="the reference's flag; no effect in either package (ZeRO-1 rides "
                         "with --fsdp, whose params already take its specs)")
    ap.add_argument("--no-ep", action="store_true",
                    help="disable the expert-parallel MoE path (no dense decoder takes it)")
    ap.add_argument("--legacy-sharding", action="store_true",
                    help="legacy head_dim attention fallback sharding")
    ap.add_argument("--remat-policy", default="minimal", choices=["minimal", "dots", "nothing"],
                    help="activation-checkpoint policy for train cells")
    ap.add_argument("--scores-bf16", action="store_true",
                    help="materialise chunked attention's score tiles in bf16 (the flash "
                         "kernel's are never materialised); f32 again when the run ends")
    ap.add_argument("--ffn-compress", type=float, default=0.0,
                    help="count with a FullBlock row-compressed FFN at this sparsity ratio: "
                         "d_ff -> (1-r)·d_ff")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the cell's (tag gains b<batch>)")
    ap.add_argument("--device", default=None,
                    help="execution device (default: the card; 'cpu' for the plain path)")
    ap.add_argument("--emit-trace", action="store_true",
                    help="also capture each cell's modeling-plane DAG (repro_torch.trace) at "
                         "the record's shape, save the graph JSON under <out dir>/trace/, and "
                         "add its content digest and MVM totals to the record")
    return ap


def knob_options(args: argparse.Namespace) -> Dict[str, Any]:
    """The sharding options the parsed flags set, as the reference's dry-run
    sets them (its ``zero1``, which ``--no-zero1`` clears, aside)."""
    return dict(fsdp=args.fsdp, ep_shardmap=not args.no_ep,
                attn_kv_fallback="head_dim" if args.legacy_sharding else "replicate")


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    # the knobs hold for this run only: the defaults come back when it ends
    with layers.scores_dtype(torch.bfloat16 if args.scores_bf16 else layers._SCORES_DTYPE), \
            shd.options(**knob_options(args)):
        return _run(ap, args)


def _run(ap: argparse.ArgumentParser, args) -> int:
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    tag = _tag(args.tag, args.batch)
    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["cell"], r["mesh"], r.get("tag", "")))
                except (json.JSONDecodeError, KeyError):
                    pass

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        jobs = [(arch, cell_name, mk) for arch, cfg in all_configs().items()
                for cell_name in cells_for(cfg) for mk in meshes]
    else:
        if not args.arch or not args.cell:
            ap.error("--arch and --cell required unless --all")
        if args.cell not in cells_for(get_config(args.arch)):
            print(f"SKIP {args.arch}/{args.cell}: long_500k needs sub-quadratic attention")
            return 0
        jobs = [(args.arch, args.cell, mk) for mk in meshes]

    failures = 0
    for arch, cell_name, mk in jobs:
        if (arch, cell_name, mk, tag) in done:
            print(f"skip (done): {arch} {cell_name} {mk}")
            continue
        print(f"=== {arch} × {cell_name} × {mk} ===", flush=True)
        try:
            rec = run_cell(arch, cell_name, mk, remat=not args.no_remat, extra_tag=args.tag,
                           remat_policy=args.remat_policy, ffn_compress=args.ffn_compress,
                           execute=args.execute, batch=args.batch, device=args.device)
            if args.emit_trace:
                cell = dataclasses.replace(SHAPE_CELLS[cell_name],
                                           global_batch=rec["global_batch"])
                rec.update(_emit_trace(arch, cell, args.out))
                print(f"    trace: {rec['trace_path']} digest={rec['trace_digest'][:16]} "
                      f"mvm_macs={rec['trace_mvm_macs']:.3e}", flush=True)
            timed = f" time={rec['time_s']:.3f}s" if "time_s" in rec else ""
            coll = sum(v for k, v in rec["collective_bytes"].items() if k != "count")
            print(f"    flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
                  f"coll={coll:.3e} peak/device={rec['peak_bytes'] / 2**30:.2f} GiB "
                  f"count={rec['lower_s']}s{timed}", flush=True)
        except Exception as e:  # noqa: BLE001 — the ledger records failures
            rec = {"arch": arch, "cell": cell_name, "mesh": mk, "tag": tag,
                   "error": f"{type(e).__name__}: {e}"}
            failures += 1
            print(f"    FAILED: {rec['error'][:300]}", flush=True)
        obs.event("dryrun.cell.done", arch=arch, cell=cell_name, mesh=mk,
                  ok="error" not in rec, compile_s=rec.get("compile_s"),
                  time_s=rec.get("time_s"))
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
