"""The metric readers' arithmetic on fixed timestamps, spans and a
synthetic device trace."""
from __future__ import annotations

import types

import numpy as np
import pytest
from _tiny import tiny_cell

from portbench.harness import modelflops
from portbench.harness.loop import Record
from portbench.harness.rundata import RunData, read_metric, reader
from portbench.harness.tracing import WINDOW, summarize

PEAKS = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}


def _run(**kw):
    r1 = Record(0, np.zeros(10, np.int32), 3, sent=0.0, stamps=[1.0, 1.5, 2.0], end=2.0,
                output=[1, 2, 3])
    r2 = Record(1, np.zeros(20, np.int32), 3, sent=0.5, stamps=[1.2, 2.2, 3.2], end=3.2,
                output=[4, 5, 6])
    spans = [("prefill", 1.0, 1.2, 100), ("decode", 1.25, 1.4, None), ("step", 1.0, 1.5, 2),
             ("decode", 1.55, 1.9, None), ("step", 1.5, 2.0, 2),
             ("decode", 3.0, 3.4, None), ("step", 3.0, 3.5, 2)]
    base = dict(cfg=tiny_cell().config, records=[r1, r2], t_start=-4.0, w0=1.1, w1=3.0,
                prune_s=0.25, spans=spans, peaks=PEAKS)
    base.update(kw)
    return RunData(**base)


@pytest.mark.parametrize("base", ["output_tokens_per_s", "decode_step_ms", "step_mfu",
                                  "flash_attention_roofline"])
def test_a_variant_without_a_file_is_read_by_its_metrics_reader(base):
    assert reader(f"{base}.single_stream") is reader(base)
    run = _run()
    assert read_metric(f"{base}.single_stream", run) == read_metric(base, run)


def test_a_name_with_no_reader_is_refused():
    with pytest.raises(FileNotFoundError):
        reader("no_such_metric")


def test_end_to_end_metrics():
    run = _run()
    assert read_metric("setup_s", run) == pytest.approx(5.1)
    assert read_metric("output_tokens_per_s", run) == pytest.approx(4 / 1.9)
    assert read_metric("ttft_p90_ms", run) == pytest.approx(700.0)
    # gaps ending in the window: 0.5, 0.5 (r1), 1.0 (r2); numpy's linear p95
    assert read_metric("itl_p95_ms", run) == pytest.approx(950.0)
    assert read_metric("prune_s", run) == 0.25


def test_span_metrics():
    run = _run()
    assert read_metric("decode_step_ms", run) == pytest.approx(1e3 * (0.3 + 0.5) / 2)
    assert read_metric("decode_issue_share", run) == pytest.approx(100 * 0.5 / 0.8)
    assert read_metric("prefill_ms_per_ktok", run) == pytest.approx(200.0 / 0.1)
    # spans are read up to the profiler's start only
    assert read_metric("decode_step_ms", _run(span_end=1.6)) == pytest.approx(300.0)


def test_step_mfu_counts_prefills_and_decode_tokens_in_the_window():
    run = _run()
    arch, pruning = run.cfg["arch"], run.cfg["pruning"]
    flops = (modelflops.decode_flops(arch, pruning, 10) + modelflops.decode_flops(arch, pruning, 11)
             + modelflops.prefill_flops(arch, pruning, 20)
             + modelflops.decode_flops(arch, pruning, 20))
    assert read_metric("step_mfu", run) == pytest.approx(100 * flops / (1.9 * 1e12))
    assert read_metric("step_mfu", _run(peaks=None)) is None


def test_trace_metrics_and_rooflines():
    trace = {"window_s": 2.0, "busy_s": 1.5, "decode_kernels": 300, "decode_steps": 3,
             "op_device_s": {"intrablock_matmul": 0.004}}
    call = {"B": 4, "K": 64, "Kc": 32, "N": 100, "elt": 2, "idx_elt": 4}
    run = _run(trace=trace, calls=[("intrablock_matmul", call)] * 2)
    assert read_metric("device_idle_share", run) == pytest.approx(25.0)
    assert read_metric("device_launches_per_decode_step", run) == pytest.approx(100.0)
    nbytes = 2 * (4 * 32 + 32 * 100 + 4 * 100) + 4 * 32
    least = max(2 * 4 * 32 * 100 / 1e12, nbytes / 1e9)
    assert read_metric("intrablock_matmul_roofline", run) == pytest.approx(100 * 2 * least / 0.004)
    # nothing to read: no calls of the kernel, or no trace
    assert read_metric("flash_attention_roofline", run) is None
    assert read_metric("device_idle_share", _run()) is None


class _Ev:
    def __init__(self, name, start, dur, device="CPU", corr=0, linked=0, kind=None):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._c, self._l = device, corr, linked
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def _events(kinds: bool):
    k = (lambda x: x) if kinds else (lambda x: None)
    return [
        _Ev(WINDOW, 0, 1000, kind=k("user_annotation")),
        _Ev("portbench.decode_step", 100, 200, kind=k("user_annotation")),
        _Ev("portbench.op.intrablock_matmul", 120, 30, kind=k("user_annotation")),
        _Ev("aten::mm", 130, 5, corr=7, kind=k("cpu_op")),
        _Ev("cudaLaunchKernel", 130, 5, corr=11, kind=k("cuda_runtime")),
        _Ev("cudaLaunchKernel", 250, 5, corr=12, kind=k("cuda_runtime")),
        _Ev("cudaMemsetAsync", 600, 5, corr=13, kind=k("cuda_runtime")),
        _Ev("igm_decode_kernel", 200, 100, device="CUDA", corr=11, kind=k("kernel")),
        _Ev("elementwise", 310, 90, device="CUDA", corr=12, kind=k("kernel")),
        _Ev("Memset (Device)", 650, 50, device="CUDA", corr=13, kind=k("gpu_memset")),
        _Ev("portbench.decode_step", 100, 200, device="CUDA", kind=k("gpu_user_annotation")),
    ]


@pytest.mark.parametrize("kinds", [True, False])
def test_summarize_a_synthetic_trace(kinds):
    s = summarize(_events(kinds))
    assert s["window_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx(240e-9)
    assert s["op_device_s"] == {"intrablock_matmul": pytest.approx(100e-9)}
    assert s["decode_kernels"] == 2 and s["decode_steps"] == 1
    assert s["device_ops"][0] == ["igm_decode_kernel", pytest.approx(100e-9)]
    gaps = dict(s["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(760e-9)
    # 0..200 (its middle inside the decode range), then 10, 250 and 300 between steps
    assert gaps["decode_step"] == pytest.approx(200e-9)
    assert gaps["harness loop (between steps)"] == pytest.approx(560e-9)
    assert types.SimpleNamespace(**s).launches_matched == 3
