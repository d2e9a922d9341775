"""Dry-run of every (arch x shape) cell on one card: the port's counterpart
of ``repro/launch/dryrun.py``.

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
* ``collective_bytes`` — the reference's five kinds and ``count``, all 0:
  one card has no collectives.

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

Not ported here: the sharding knobs (``--fsdp``, ``--no-zero1``,
``--no-ep``, ``--legacy-sharding``) and ``--mesh multi|both`` (one card,
mesh ``local``), ``--scores-bf16`` and ``--emit-trace``.

Usage (from the repository root, with ``PYTHONPATH=src``):
  python -m repro_torch.launch.dryrun --arch qwen3-4b --cell prefill_32k --out d.jsonl
  python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
  python -m repro_torch.launch.dryrun --arch qwen3-4b --cell decode_32k \\
      --execute 3 --batch 8 --tag calib
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
from ..models.transformer import _layer_shapes, decode_step, init_cache, prefill
from ..train.optimizer import AdamWConfig, adamw_init, adamw_update
from ..train.step import make_train_step
from .counting import Counter, count

__all__ = ["param_struct", "input_specs", "count_cell", "run_cell", "main"]

META = torch.device("meta")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


# ---------------------------------------------------------------------------
# Meta-tensor inputs (shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def param_struct(cfg: ArchConfig, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The tree of ``init_params(cfg, dtype=dtype)`` as ``meta`` tensors:
    the same key paths, shapes and dtypes.  (``init_params`` cannot build
    it: a ``meta`` generator does not exist, and it writes each layer into
    a preallocated stack.)"""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    hd, Hq, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads

    def stacked(shapes, n):
        return {name: _meta((n,) + shp, dtype) for name, shp in shapes.items()}

    params = {"embed": _meta((V, d), dtype), "final_norm": _meta((d,), dtype),
              "layers": stacked(_layer_shapes(cfg), L)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _meta((d, V), dtype)
    if cfg.enc_dec:
        params["enc_layers"] = stacked(_layer_shapes(cfg, encoder=True), cfg.enc_layers)
        params["enc_final_norm"] = _meta((d,), dtype)
        params["enc_cross"] = {"wk": _meta((L, d, Hkv, hd), dtype),
                               "wv": _meta((L, d, Hkv, hd), dtype)}
        params["dec_cross"] = {"wq": _meta((L, d, Hq, hd), dtype),
                               "wo": _meta((L, Hq, hd, d), dtype),
                               "ln": _meta((L, d), dtype)}
    return params


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


def count_cell(cfg: ArchConfig, cell: ShapeCell, *, remat: bool = True,
               microbatches: int = 1, remat_policy: str = "minimal") -> Counter:
    """One step of the cell on ``meta`` under the counting mode: the
    counterpart of the reference's ``lower_cell`` + ``_cost_of``."""
    step, structs = _cell_step(cfg, cell, remat=remat, microbatches=microbatches,
                               remat_policy=remat_policy)
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
    by default); returns its ledger record, with the reference's keys."""
    if mesh_kind != "local":
        raise ValueError(f"mesh {mesh_kind!r}: the port's dry-run runs on one card "
                         "(mesh 'local')")
    cfg = get_config(arch)
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
        step, structs = _cell_step(cfg, cell, remat=remat, microbatches=microbatches,
                                   remat_policy=remat_policy)
        counted = _count(step, structs)
    t_lower = time.time() - t0

    timing: Dict[str, Any] = {}
    if execute > 0:
        dev = resolve_device(device)
        with obs.span("dryrun.execute", arch=arch, cell=cell_name, mesh=mesh_kind,
                      repeats=execute):
            timing = _execute_cell(step, structs, cell.kind, execute, dev)

    coll = {k: 0 for k in _COLLECTIVES}
    coll["count"] = 0
    rec = {
        "arch": arch,
        "cell": cell_name,
        "mesh": mesh_kind,
        "tag": _tag(extra_tag, batch),
        "chips": 1,
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
    if timing:
        rec["executed"] = True
        rec.update(timing)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--cell", default=None, choices=list(SHAPE_CELLS))
    ap.add_argument("--all", action="store_true", help="run the full arch × cell matrix")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--execute", type=int, default=0, metavar="N",
                    help="also RUN each cell's step N times on zero inputs and record the "
                         "best wall-clock as time_s (allocates the real footprint; feeds "
                         "repro_torch.calibrate)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--remat-policy", default="minimal", choices=["minimal", "dots", "nothing"],
                    help="activation-checkpoint policy for train cells")
    ap.add_argument("--ffn-compress", type=float, default=0.0,
                    help="count with a FullBlock row-compressed FFN at this sparsity ratio: "
                         "d_ff -> (1-r)·d_ff")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the cell's (tag gains b<batch>)")
    ap.add_argument("--device", default=None,
                    help="execution device (default: the card; 'cpu' for the plain path)")
    args = ap.parse_args(argv)

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

    if args.all:
        jobs = [(arch, cell_name) for arch, cfg in all_configs().items()
                for cell_name in cells_for(cfg)]
    else:
        if not args.arch or not args.cell:
            ap.error("--arch and --cell required unless --all")
        if args.cell not in cells_for(get_config(args.arch)):
            print(f"SKIP {args.arch}/{args.cell}: long_500k needs sub-quadratic attention")
            return 0
        jobs = [(args.arch, args.cell)]

    failures = 0
    for arch, cell_name in jobs:
        if (arch, cell_name, "local", tag) in done:
            print(f"skip (done): {arch} {cell_name} local")
            continue
        print(f"=== {arch} × {cell_name} × local ===", flush=True)
        try:
            rec = run_cell(arch, cell_name, remat=not args.no_remat, extra_tag=args.tag,
                           remat_policy=args.remat_policy, ffn_compress=args.ffn_compress,
                           execute=args.execute, batch=args.batch, device=args.device)
            timed = f" time={rec['time_s']:.3f}s" if "time_s" in rec else ""
            print(f"    flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
                  f"peak={rec['peak_bytes'] / 2**30:.2f} GiB count={rec['lower_s']}s{timed}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — the ledger records failures
            rec = {"arch": arch, "cell": cell_name, "mesh": "local", "tag": tag,
                   "error": f"{type(e).__name__}: {e}"}
            failures += 1
            print(f"    FAILED: {rec['error'][:300]}", flush=True)
        obs.event("dryrun.cell.done", arch=arch, cell=cell_name, mesh="local",
                  ok="error" not in rec, compile_s=rec.get("compile_s"),
                  time_s=rec.get("time_s"))
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
