"""Observability core of the port: spans, counters, events, heartbeats →
process-safe JSONL sinks.

Begun as a copy of ``repro.obs.core`` (the port never imports the JAX
package); the port adds the in-memory observer, span ids and parents,
the clock anchor and the execution plane's span hooks, all below.

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

In memory
---------
``enable(in_memory=True)`` keeps every record in ``Observer.records``
and JSON-encodes nothing while recording; the records are written to
``events-<pid>.jsonl`` only at :meth:`Observer.close` (so at
:func:`disable`), and only when the observer has a directory.  This is
the mode for a hot path (the serving engine records some hundred spans a
decode step); the line-per-record file mode stays the default.

Spans and clocks
----------------
Each span record carries an integer ``id`` and the ``parent`` id of the
innermost span open in the process when it began (a per-process stack;
``None`` at the top).  Records that belong to one request carry its
``rid`` in ``attrs``.  :attr:`Observer.anchor` is a
(``time.monotonic()``, ``time.perf_counter()``) pair read together when
the observer is made, and :meth:`Observer.perf_counter_of` moves a
record's ``t`` onto the ``perf_counter`` clock with it.  The execution
plane registers two hooks through :func:`set_span_hooks` when it is
imported (this module imports no torch): one that suppresses spans (under
a trace capture), and one that opens a profiler range of the span's name
beside it while a torch profiler records, so that the profiler stamps the
span on its own clock next to the device work launched inside it.

Trace directory layout
----------------------
``manifest.json``      run metadata (id, argv, schema, start time)
``events-<pid>.jsonl`` one file per writing process: spans/counters/events
``runs.jsonl``         one record per :meth:`SweepRunner.run` call
``energy_components.csv``  per-component energy rows (``repro_torch.obs.energy``)
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, IO, Iterator, List, Optional, Tuple, Union

__all__ = [
    "OBS_SCHEMA", "Observer", "enable", "disable", "enabled", "is_enabled",
    "get_observer", "span", "counter", "event", "heartbeat", "Heartbeat",
    "read_events", "read_manifest", "set_span_hooks",
]

# Bump when the JSONL event shape changes incompatibly; readers
# (``python -m repro_torch.obs report`` and external tooling) key on it via
# the manifest.
OBS_SCHEMA = 1

_ENV_FLAG = "REPRO_OBS"
_ENV_DIR = "REPRO_OBS_DIR"


class Observer:
    """One run's recording sink: a trace directory of JSONL files, or,
    with ``in_memory``, a list of records written there at :meth:`close`.

    Process-safe by construction: every process writes its *own*
    ``events-<pid>.jsonl`` (append mode, line-buffered), so concurrent
    writers never interleave within a line.  A forked worker inherits
    the parent's ``Observer``; the pid check in :meth:`_file` reopens a
    fresh per-pid sink on first write after the fork.  ``trace_dir`` may
    be None only in memory, and then nothing is ever written.
    """

    def __init__(self, trace_dir: Optional[Union[str, Path]], run_id: str, *,
                 echo: bool = False, in_memory: bool = False):
        if trace_dir is None and not in_memory:
            raise ValueError("an observer that writes as it records needs a directory")
        self.dir = None if trace_dir is None else Path(trace_dir)
        if self.dir is not None:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.run_id = run_id
        self.echo = echo
        self.in_memory = in_memory
        self.records: List[Dict] = []
        self._written = 0
        self.anchor: Tuple[float, float] = (time.monotonic(), time.perf_counter())
        self._pid: Optional[int] = None
        self._fh: Optional[IO[str]] = None
        self._aux: Dict[str, IO[str]] = {}

    def perf_counter_of(self, t: float) -> float:
        """A record's ``t`` (``time.monotonic()``) on the
        ``time.perf_counter()`` clock, through :attr:`anchor`."""
        return t - self.anchor[0] + self.anchor[1]

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
        if self.in_memory:
            self.records.append(rec)
        else:
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

    def _flush(self) -> None:
        """Write the records kept in memory since the last flush, each
        line as the file mode writes it."""
        if self.dir is None or self._written == len(self.records):
            return
        pid = os.getpid()
        with open(self.dir / f"events-{pid}.jsonl", "a") as fh:
            for rec in self.records[self._written:]:
                fh.write(json.dumps({**rec, "pid": pid}, separators=(",", ":")) + "\n")
        self._written = len(self.records)

    def close(self) -> None:
        self._flush()
        for fh in (self._fh, *self._aux.values()):
            if fh is not None:
                try:
                    fh.close()
                except OSError:
                    pass
        self._fh, self._aux = None, {}

    # -- manifest ------------------------------------------------------------
    def write_manifest(self, extra: Optional[Dict] = None) -> None:
        if self.dir is None:
            return
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
            "anchor": {"monotonic": self.anchor[0], "perf_counter": self.anchor[1]},
        }
        if extra:
            manifest.update(extra)
        path.write_text(json.dumps(manifest, indent=2) + "\n")


# -- module state -------------------------------------------------------------

_OBSERVER: Optional[Observer] = None
_ENV_CHECKED = False
_OWNS_ENV = False
# ids of the spans open in this process, innermost last, and the next id
_OPEN: List[int] = []
_IDS = itertools.count(1)
# the execution plane's hooks (set_span_hooks)
_SUPPRESSED: Optional[Callable[[], bool]] = None
_MIRROR: Optional[Callable[[str], Any]] = None


def set_span_hooks(*, suppressed: Optional[Callable[[], bool]] = None,
                   mirror: Optional[Callable[[str], Any]] = None) -> None:
    """Hooks of the execution plane, which this module cannot import:
    while ``suppressed()`` is true a span records nothing; ``mirror(name)``
    gives a context manager to hold open for the span's length (a
    profiler range while a profiler records), or None.  Both are asked
    only while an observer is enabled."""
    global _SUPPRESSED, _MIRROR
    _SUPPRESSED, _MIRROR = suppressed, mirror


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
           manifest: Optional[Dict] = None, in_memory: bool = False,
           _export_env: bool = True) -> Observer:
    """Turn recording on for this process (and, via ``REPRO_OBS_DIR``,
    for every worker process it spawns or forks).

    ``trace_dir`` defaults to ``obs_runs/<run-id>``; with ``in_memory``
    the records stay in ``Observer.records`` until the observer closes,
    and without a ``trace_dir`` they are never written (nor is anything
    exported to workers).  Idempotent-ish: enabling while enabled
    replaces the observer (the previous one is closed)."""
    global _OBSERVER, _ENV_CHECKED, _OWNS_ENV
    if _OBSERVER is not None:
        _OBSERVER.close()
    rid = run_id or _default_run_id()
    if trace_dir is None and not in_memory:
        trace_dir = Path("obs_runs") / rid
    obs = Observer(trace_dir, rid, echo=echo, in_memory=in_memory)
    obs.write_manifest(manifest)
    _OBSERVER = obs
    _ENV_CHECKED = True
    if _export_env and obs.dir is not None:
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
    __slots__ = ("_obs", "_name", "_attrs", "_t0", "_range", "id", "parent")

    def __init__(self, obs: Observer, name: str, attrs: Dict, rng: Any = None):
        self._obs, self._name, self._attrs, self._range = obs, name, attrs, rng
        self._t0 = 0.0
        self.id: Optional[int] = None
        self.parent: Optional[int] = None

    def __enter__(self) -> "_Span":
        self.id = next(_IDS)
        self.parent = _OPEN[-1] if _OPEN else None
        _OPEN.append(self.id)
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.monotonic()
        return self

    def set(self, **attrs) -> None:
        self._attrs.update(attrs)

    def __exit__(self, exc_type, *exc) -> None:
        t1 = time.monotonic()
        if self._range is not None:
            self._range.__exit__(exc_type, *exc)
        _OPEN.pop()
        rec = {"type": "span", "name": self._name, "t": self._t0,
               "dur_s": t1 - self._t0, "id": self.id, "parent": self.parent,
               "attrs": self._attrs}
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        self._obs.emit(rec)


def span(name: str, **attrs):
    """Time a block: ``with obs.span("explore.evaluate", arch=...)``.
    No-op (shared null object) when disabled, and while the execution
    plane's hook suppresses spans."""
    obs = get_observer()
    if obs is None:
        return _NULL
    if _SUPPRESSED is not None and _SUPPRESSED():
        return _NULL
    return _Span(obs, name, attrs, None if _MIRROR is None else _MIRROR(name))


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
