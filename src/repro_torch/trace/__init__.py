"""The modeling plane's front end in the port (counterpart of
``repro.trace``): programs captured into a jax-free trace IR and lowered
into :class:`~repro_torch.core.workload.Workload` DAGs, so every config of
:mod:`repro_torch.configs` becomes a CIM scenario without hand modeling.

* :mod:`.ir` — the serialisable, content-digested graph (a copy of the
  reference's: the same canonical JSON, so the same digest on the same
  graph).
* :mod:`.capture` — a PyTorch program run on ``meta`` tensors under a
  ``TorchDispatchMode`` → TraceGraph (ATen ops named by the jaxpr
  primitives the lowering consumes); :func:`~.capture.scan` records a
  layer loop once.
* :mod:`.reference` — the shape-faithful cost mirrors of the hand DAGs.
* :mod:`.lower` — TraceGraph → Workload (a copy of the reference's).
* :mod:`.diff` — traced-vs-hand differential reports (a copy).

``python -m repro_torch.trace lower|diff|fixture`` drives it from the
shell.
"""
from .capture import TRACE_STEPS, capture, trace_model, traced_cnn, traced_workload
from .diff import diff_table, diff_workloads, summarize
from .ir import TraceEqn, TraceGraph, TraceVar
from .lower import LowerError, lower_graph

__all__ = [
    "TraceVar", "TraceEqn", "TraceGraph",
    "lower_graph", "LowerError",
    "capture", "trace_model", "traced_workload", "traced_cnn",
    "TRACE_STEPS",
    "summarize", "diff_workloads", "diff_table",
]
