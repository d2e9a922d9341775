"""Observability of the port (copy of ``repro.obs``'s core and serve
metrics): spans, counters and events into JSONL trace directories, off
unless enabled, and the serving engine's request/latency accounting.
"""
from .core import (OBS_SCHEMA, Observer, counter, disable, enable, enabled, event,
                   get_observer, is_enabled, read_events, read_manifest, span)
from .metrics import ServeMetrics, StreamingHistogram

__all__ = [
    "OBS_SCHEMA", "Observer",
    "enable", "disable", "enabled", "is_enabled", "get_observer",
    "span", "counter", "event", "read_events", "read_manifest",
    "ServeMetrics", "StreamingHistogram",
]
