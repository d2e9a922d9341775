"""Observability of the port (copy of ``repro.obs``): timelines, energy
attribution, sweep telemetry and serve metrics behind one zero-overhead
core.  Observational only: nothing here alters a
:class:`~repro_torch.core.report.CostReport` or enters an explore cache
key.

CLI: ``python -m repro_torch.obs {timeline,energy,report,check}``.
"""
from .core import (OBS_SCHEMA, Heartbeat, Observer, counter, disable,
                   enable, enabled, event, get_observer, heartbeat,
                   is_enabled, read_events, read_manifest, span)
from .energy import (component_group, component_rows, energy_table,
                     write_energy_csv, write_energy_json)
from .metrics import ServeMetrics, StreamingHistogram
from .timeline import check_chrome_trace, chrome_trace, write_chrome_trace

__all__ = [
    "OBS_SCHEMA", "Observer", "Heartbeat",
    "enable", "disable", "enabled", "is_enabled", "get_observer",
    "span", "counter", "event", "heartbeat",
    "read_events", "read_manifest",
    "chrome_trace", "write_chrome_trace", "check_chrome_trace",
    "component_group", "component_rows", "energy_table",
    "write_energy_csv", "write_energy_json",
    "ServeMetrics", "StreamingHistogram",
]
