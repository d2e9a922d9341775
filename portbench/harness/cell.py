"""One run of one cell: everything ``portbench/run.py`` does once the
arguments are read and a card is found.

A cell is found by its name in ``BENCHMARK.json``: its configuration
(``configs[].file``), its traffic mix (``portbench/traffic/<traffic>.json``),
its end-to-end metrics (``--trace 0``) or per-layer metrics
(``--trace 1``), each read by ``portbench/metrics/<name>.py``, and, for a
``<kernel>_roofline`` metric, the kernel's work in
``portbench/work/<kernel>.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Optional

from . import check, loop, program, traffic, weights
from .rundata import RunData, kernel_of, read_metric
from .tracing import Tracer

__all__ = ["Cell", "find_cell", "run_cell"]

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
# the profiler runs over the last part of a traced run's window
TRACE_SECONDS, TRACE_SHARE = 5.0, 0.4


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # the configuration file's contents
    mix: traffic.Mix
    chips: int
    end_to_end: list        # metric names, --trace 0
    per_layer: list         # metric names, --trace 1


def _for_cell(metrics: list, cell: str, reported: set) -> list:
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m.get("moves") is None or m["moves"] in reported:
            out.append(m)
    return out


def find_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{[x['name'] for x in bench['workloads']]}")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / c["file"]).read_text())
    mix = traffic.load_mix(BENCH / "traffic" / f"{w['traffic']}.json")
    e2e = _for_cell(bench["end_to_end"], name, set())
    reported = {m["name"] for m in e2e}
    per_layer = _for_cell(bench["per_layer"], name, reported)
    return Cell(name, config, mix, int(w["chips"]), e2e, per_layer)


def _log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _power_limit() -> Optional[float]:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda", limits: Optional[dict] = None,
             keep: Optional[dict] = None) -> dict:
    """Set up, run the window, read the metrics, check the outputs.
    Returns the result object ``run.py`` prints.  ``limits`` replaces the
    configuration's ``check``; ``keep``, when given, receives the checked
    sample and its reference logits."""
    import torch

    cfg, mix = cell.config, cell.mix
    arch = cfg["arch"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from repro_torch.kernels import _build
        _build.build()
    params = weights.make_params(arch, cfg["init"], seed, device)
    cparams, prune_s = program.prune_and_compress(params, arch, cfg["pruning"], device)
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    engine = program.engine(arch, cparams, mix, device)
    _log(f"{cell.name}: set up to the engine in {time.perf_counter() - t_start:.1f}s "
         f"(prune + compress {prune_s:.2f}s)")

    tracer = None
    if trace:
        kernels = {kernel_of(m["name"]) for m in cell.per_layer} - {None}
        work = {k: importlib.import_module(f"portbench.work.{k}") for k in sorted(kernels)}
        tracer = Tracer(engine, work)
        tracer.install()
        tracer.warm()
    trace_len = min(TRACE_SECONDS, TRACE_SHARE * seconds)
    state = {"w0": None}

    def on_open(now):
        state["w0"] = now

    def on_step(now):
        if (tracer is not None and state["w0"] is not None and tracer.span_start is None
                and now - state["w0"] >= seconds - trace_len):
            tracer.start()

    records, w0, w1 = loop.run(engine, traffic.stream(mix, seed, arch["vocab_size"]),
                               clients=mix.clients, warmup_completions=mix.warmup_completions,
                               seconds=seconds, on_open=on_open, on_step=on_step)
    if tracer is not None and tracer.span_start is not None:
        tracer.stop()
        t = tracer.summary or {}
        _log(f"{cell.name}: traced {t.get('window_s')}s, busy {t.get('busy_s')}s, "
             f"{t.get('device_events')} device events, {t.get('launches_matched')} put down to "
             f"their launch, {t.get('decode_steps')} decode steps")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    peaks = None
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    if cuda:
        peaks = json.loads((HERE / "peaks.json").read_text()).get(kind)
    run = RunData(cfg=cfg, records=records, t_start=t_start, w0=w0, w1=w1, prune_s=prune_s,
                  spans=tracer.spans if tracer else [],
                  span_end=tracer.span_start if tracer else None,
                  trace=tracer.summary if tracer else None,
                  calls=tracer.calls if tracer else [], peaks=peaks)
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in names:
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # free the program's state before the reference runs
    if tracer is not None:
        tracer.uninstall()
    summary = run.trace
    del engine, cparams, tracer, run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = check.judge(cfg, seed, records, w0, w1, mix, device,
                          cfg["check"] if limits is None else limits, keep=keep)
    _log(f"{cell.name}: window {w1 - w0:.2f}s, reference check "
         f"{time.perf_counter() - t_check:.1f}s, {verdict['numbers']['tokens_compared']['value']} "
         f"tokens of {verdict['requests']} requests, widest gap {verdict['max_gap']}, mean gap "
         f"{verdict['mean_gap']}, {verdict['flipped']} tokens not the reference's first")

    done = [r for r in records if r.end is not None and w0 < r.end <= w1]
    failed = sum(1 for r in done if r.rejected or len(r.output) != r.new_tokens)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": peak}
    result = {"correct": bool(verdict["correct"]), "attempted": len(done), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and summary:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    if cuda:
        dev["power_limit_w"] = _power_limit()
    result["check"] = verdict["numbers"]
    return result
