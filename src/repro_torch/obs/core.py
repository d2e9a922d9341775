"""Observability core of the port: spans, counters, events, heartbeats →
process-safe JSONL sinks.

Copy of ``repro.obs.core``: the port never imports the JAX package.

``repro_torch.obs`` records what sweeps, schedules and serving runs did,
and never changes what they compute.  Its contracts are the reference's:

* **Zero overhead when disabled.**  Every recording entry point
  (:func:`span`, :func:`counter`, :func:`event`, :func:`heartbeat`)
  collapses to a module-global ``None`` check and returns a shared
  no-op object.
* **Observational only.**  Nothing here enters an
  :class:`~repro_torch.explore.job.ExploreJob` cache key or alters a
  :class:`~repro_torch.core.report.CostReport`; no output of the serving
  engine or the model depends on it.
* **Monotonic-clock event time.**  Event timestamps come from
  ``time.monotonic()`` (CLOCK_MONOTONIC — comparable across the
  processes of one host, which is exactly the merge domain of a run's
  trace directory).  The one wall-clock read is the run manifest's
  ``started_unix`` stamp — telemetry metadata, never a result.

Enabling
--------
* ``REPRO_OBS=1`` in the environment — a default trace directory is
  created under ``obs_runs/``;
* ``REPRO_OBS_DIR=<dir>`` — record into ``<dir>`` (this is also how
  worker processes join the parent's run: :func:`enable` exports the
  variable, and a worker's first recording call attaches to the same
  directory);
* programmatically via :func:`enable` / :func:`disable` (tests use the
  :func:`enabled` context manager);
* ``--obs`` on the CLIs (``python -m repro_torch.explore --obs``).

Trace directory layout
----------------------
``manifest.json``      run metadata (id, argv, schema, start time)
``events-<pid>.jsonl`` one file per writing process: spans/counters/events
``runs.jsonl``         one record per :meth:`SweepRunner.run` call
``energy_components.csv``  per-component energy rows (``repro_torch.obs.energy``)
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, IO, Iterator, List, Optional, Union

__all__ = [
    "OBS_SCHEMA", "Observer", "enable", "disable", "enabled", "is_enabled",
    "get_observer", "span", "counter", "event", "heartbeat", "Heartbeat",
    "read_events", "read_manifest",
]

# Bump when the JSONL event shape changes incompatibly; readers
# (``python -m repro_torch.obs report`` and external tooling) key on it via
# the manifest.
OBS_SCHEMA = 1

_ENV_FLAG = "REPRO_OBS"
_ENV_DIR = "REPRO_OBS_DIR"


class Observer:
    """One run's recording sink: a trace directory of JSONL files.

    Process-safe by construction: every process writes its *own*
    ``events-<pid>.jsonl`` (append mode, line-buffered), so concurrent
    writers never interleave within a line.  A forked worker inherits
    the parent's ``Observer``; the pid check in :meth:`_file` reopens a
    fresh per-pid sink on first write after the fork.
    """

    def __init__(self, trace_dir: Union[str, Path], run_id: str, *,
                 echo: bool = False):
        self.dir = Path(trace_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.run_id = run_id
        self.echo = echo
        self._pid: Optional[int] = None
        self._fh: Optional[IO[str]] = None
        self._aux: Dict[str, IO[str]] = {}

    # -- sinks ---------------------------------------------------------------
    def _file(self) -> IO[str]:
        pid = os.getpid()
        if self._fh is None or pid != self._pid:
            self._pid = pid
            self._aux = {}                     # post-fork: never share handles
            self._fh = open(self.dir / f"events-{pid}.jsonl", "a",
                            buffering=1)
        return self._fh

    def emit(self, rec: Dict) -> None:
        rec.setdefault("t", time.monotonic())
        rec["pid"] = os.getpid()
        self._file().write(json.dumps(rec, separators=(",", ":")) + "\n")
        if self.echo and rec.get("type") == "event":
            attrs = rec.get("attrs") or {}
            flat = " ".join(f"{k}={v}" for k, v in attrs.items())
            print(f"[obs] {rec.get('name')} {flat}", file=sys.stderr)

    def append_jsonl(self, name: str, rec: Dict) -> None:
        """Append one record to an auxiliary JSONL artifact (e.g. the
        ``runs.jsonl`` sweep-run manifest)."""
        pid = os.getpid()
        if pid != self._pid:
            self._file()                       # resets _aux on pid change
        fh = self._aux.get(name)
        if fh is None:
            fh = self._aux[name] = open(self.dir / name, "a", buffering=1)
        fh.write(json.dumps(rec, separators=(",", ":")) + "\n")

    def artifact_path(self, name: str) -> Path:
        """Path for a named artifact inside the trace directory."""
        return self.dir / name

    def close(self) -> None:
        for fh in (self._fh, *self._aux.values()):
            if fh is not None:
                try:
                    fh.close()
                except OSError:
                    pass
        self._fh, self._aux = None, {}

    # -- manifest ------------------------------------------------------------
    def write_manifest(self, extra: Optional[Dict] = None) -> None:
        path = self.dir / "manifest.json"
        if path.exists():                      # one manifest per run dir
            return
        manifest = {
            "run_id": self.run_id,
            "obs_schema": OBS_SCHEMA,
            # telemetry metadata, not a result
            "started_unix": time.time(),
            "argv": list(sys.argv),
            "python": sys.version.split()[0],
            "pid": os.getpid(),
        }
        if extra:
            manifest.update(extra)
        path.write_text(json.dumps(manifest, indent=2) + "\n")


# -- module state -------------------------------------------------------------

_OBSERVER: Optional[Observer] = None
_ENV_CHECKED = False
_OWNS_ENV = False


def get_observer() -> Optional[Observer]:
    """The active observer, or None.  First call per process consults
    ``REPRO_OBS``/``REPRO_OBS_DIR`` so workers auto-attach to the
    parent's run; after that the disabled fast path is one global read."""
    global _ENV_CHECKED
    if _OBSERVER is not None:
        return _OBSERVER
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        env_dir = os.environ.get(_ENV_DIR)
        if env_dir:
            return enable(env_dir, _export_env=False)
        if os.environ.get(_ENV_FLAG) == "1":
            return enable(_export_env=False)
    return None


def is_enabled() -> bool:
    return get_observer() is not None


def _default_run_id() -> str:
    # the id names a directory; it never enters a result
    return f"run-{int(time.time())}-{os.getpid()}"


def enable(trace_dir: Optional[Union[str, Path]] = None, *,
           run_id: Optional[str] = None, echo: bool = False,
           manifest: Optional[Dict] = None,
           _export_env: bool = True) -> Observer:
    """Turn recording on for this process (and, via ``REPRO_OBS_DIR``,
    for every worker process it spawns or forks).

    ``trace_dir`` defaults to ``obs_runs/<run-id>``.  Idempotent-ish:
    enabling while enabled replaces the observer (the previous one is
    closed)."""
    global _OBSERVER, _ENV_CHECKED, _OWNS_ENV
    if _OBSERVER is not None:
        _OBSERVER.close()
    rid = run_id or _default_run_id()
    if trace_dir is None:
        trace_dir = Path("obs_runs") / rid
    obs = Observer(trace_dir, rid, echo=echo)
    obs.write_manifest(manifest)
    _OBSERVER = obs
    _ENV_CHECKED = True
    if _export_env:
        os.environ[_ENV_DIR] = str(obs.dir)
        _OWNS_ENV = True
    return obs


def disable() -> None:
    """Turn recording off and drop the env hand-off (if we set it)."""
    global _OBSERVER, _ENV_CHECKED, _OWNS_ENV
    if _OBSERVER is not None:
        _OBSERVER.close()
    _OBSERVER = None
    _ENV_CHECKED = True                        # do not re-enable from env
    if _OWNS_ENV:
        os.environ.pop(_ENV_DIR, None)
        _OWNS_ENV = False


class enabled:
    """Context manager: record into ``trace_dir`` for the block."""

    def __init__(self, trace_dir: Union[str, Path], **kw):
        self._dir, self._kw = trace_dir, kw

    def __enter__(self) -> Observer:
        return enable(self._dir, **self._kw)

    def __exit__(self, *exc) -> None:
        disable()


# -- recording entry points ---------------------------------------------------

class _NullSpan:
    """Shared no-op span/heartbeat: the whole disabled-mode surface."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def set(self, **attrs) -> None:
        pass

    def tick(self, done: int, **attrs) -> None:
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_obs", "_name", "_attrs", "_t0")

    def __init__(self, obs: Observer, name: str, attrs: Dict):
        self._obs, self._name, self._attrs = obs, name, attrs
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.monotonic()
        return self

    def set(self, **attrs) -> None:
        self._attrs.update(attrs)

    def __exit__(self, exc_type, *exc) -> None:
        t1 = time.monotonic()
        rec = {"type": "span", "name": self._name, "t": self._t0,
               "dur_s": t1 - self._t0, "attrs": self._attrs}
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        self._obs.emit(rec)


def span(name: str, **attrs):
    """Time a block: ``with obs.span("explore.evaluate", arch=...)``.
    No-op (shared null object) when disabled."""
    obs = get_observer()
    if obs is None:
        return _NULL
    return _Span(obs, name, attrs)


def counter(name: str, value: Union[int, float] = 1, **attrs) -> None:
    """Record a named numeric sample (monotonic totals or gauges)."""
    obs = get_observer()
    if obs is None:
        return
    rec: Dict = {"type": "counter", "name": name, "value": value}
    if attrs:
        rec["attrs"] = attrs
    obs.emit(rec)


def event(name: str, **attrs) -> None:
    """Record a point-in-time event with attributes."""
    obs = get_observer()
    if obs is None:
        return
    obs.emit({"type": "event", "name": name, "attrs": attrs})


class Heartbeat:
    """Rate-limited progress events for long loops.

    ``tick(done)`` emits at most one ``<name>.heartbeat`` event per
    ``min_interval_s`` (plus always the final tick where
    ``done == total``), carrying points/s, ETA, and any caller attrs.
    """

    __slots__ = ("_obs", "_name", "_total", "_min_interval", "_t0", "_last")

    def __init__(self, obs: Observer, name: str, total: int,
                 min_interval_s: float = 0.25):
        self._obs, self._name, self._total = obs, name, total
        self._min_interval = min_interval_s
        self._t0 = time.monotonic()
        self._last = 0.0                       # force an early first beat

    def tick(self, done: int, **attrs) -> None:
        now = time.monotonic()
        if done < self._total and now - self._last < self._min_interval:
            return
        self._last = now
        elapsed = max(now - self._t0, 1e-9)
        rate = done / elapsed
        eta = (self._total - done) / rate if rate > 0 else float("inf")
        payload = {"done": done, "total": self._total,
                   "elapsed_s": round(elapsed, 4),
                   "points_per_s": round(rate, 2),
                   "eta_s": round(eta, 3) if eta != float("inf") else None}
        payload.update(attrs)
        self._obs.emit({"type": "event", "name": f"{self._name}.heartbeat",
                        "attrs": payload})


def heartbeat(name: str, total: int, **kw):
    """A :class:`Heartbeat` when enabled, the shared no-op otherwise."""
    obs = get_observer()
    if obs is None:
        return _NULL
    return Heartbeat(obs, name, total, **kw)


# -- reading ------------------------------------------------------------------

def read_events(trace_dir: Union[str, Path],
                name: Optional[str] = None) -> List[Dict]:
    """Merge every process's events, ordered by monotonic timestamp
    (CLOCK_MONOTONIC is host-wide, so cross-process order is real).
    ``name`` filters to one event/span/counter name."""
    out: List[Dict] = []
    for path in sorted(Path(trace_dir).glob("events-*.jsonl")):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue                   # torn tail line: skip
                if name is None or rec.get("name") == name:
                    out.append(rec)
    out.sort(key=lambda r: (r.get("t", 0.0), r.get("pid", 0)))
    return out


def read_manifest(trace_dir: Union[str, Path]) -> Optional[Dict]:
    path = Path(trace_dir) / "manifest.json"
    if not path.exists():
        return None
    return json.loads(path.read_text())


def iter_runs(trace_dir: Union[str, Path]) -> Iterator[Dict]:
    """Records from the ``runs.jsonl`` sweep-run manifest, in order."""
    path = Path(trace_dir) / "runs.jsonl"
    if not path.exists():
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue
