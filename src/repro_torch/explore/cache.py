"""Crash-safe, content-addressed result storage for exploration jobs.

Copy of ``repro.explore.cache``: the port never imports the JAX package.

Three layers share one key space (:attr:`ExploreJob.key`):

* :class:`ResultCache` — the in-memory front every runner hits first,
  optionally backed by a
* :class:`ResultStore` — the durable tier: an SQLite database in WAL
  mode (concurrent writers across processes and hosts, torn writes
  impossible by construction) or, when ``sqlite3`` is unavailable, a
  directory of atomically-renamed JSON files.  Entries are JSON-encoded
  :class:`~repro_torch.core.report.CostReport` payloads, schema-versioned via
  ``STORE_SCHEMA``; a corrupt or truncated entry is treated as a miss,
  deleted, and counted — it can never poison later runs.
* :class:`KeyJournal` — an append-only completed-keys log a sweep run
  directory keeps next to its store.  After a SIGKILL the journal says
  exactly which points finished, so ``python -m repro_torch.explore --resume
  <run-dir>`` re-evaluates only the missing ones (a torn final line is
  dropped by the hex-key validation).

Fault injection (:mod:`repro_torch.explore.faults`) hooks the store's write
path — ``corrupt`` faults garble the payload *before* it lands on disk,
which is how the chaos tests prove the read path's corruption
tolerance.  The hook is a no-op ``None`` check when no plan is active.
"""
from __future__ import annotations

import dataclasses
import json
import os
import string
import tempfile
import warnings
from pathlib import Path
from typing import Dict, IO, Iterable, Optional, Sequence, Set, Union

from ..core.report import CostReport
from . import faults

__all__ = ["ResultCache", "ResultStore", "CacheStats", "KeyJournal",
           "StoreCheck", "StoreError", "STORE_SCHEMA"]

# Bump when the durable tier's layout changes incompatibly (table shape,
# payload encoding).  Distinct from job.CACHE_SCHEMA, which salts the
# *keys*: a CACHE_SCHEMA bump silently retires old entries, while a
# STORE_SCHEMA mismatch is a hard error — never guess at someone
# else's bytes.
STORE_SCHEMA = 1

_HEXDIGITS = set(string.hexdigits)


class StoreError(RuntimeError):
    """The durable tier is unusable (schema mismatch, unreadable db)."""


@dataclasses.dataclass
class CacheStats:
    """Hit/miss accounting, split by tier."""

    memory_hits: int = 0
    disk_hits: int = 0
    misses: int = 0
    corrupt_entries: int = 0     # torn/garbled entries dropped on read

    @property
    def hits(self) -> int:
        return self.memory_hits + self.disk_hits

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    def as_dict(self) -> Dict[str, int]:
        return {"memory_hits": self.memory_hits, "disk_hits": self.disk_hits,
                "misses": self.misses, "hits": self.hits,
                "lookups": self.lookups,
                "corrupt_entries": self.corrupt_entries}


@dataclasses.dataclass
class StoreCheck:
    """Result of :meth:`ResultStore.self_check`."""

    backend: str
    entries: int                 # entries present before the check
    readable: int                # entries that decoded to a CostReport
    corrupt: int                 # entries dropped as undecodable

    @property
    def ok(self) -> bool:
        return self.corrupt == 0


def _encode(report: CostReport) -> bytes:
    return json.dumps(report.to_dict(), separators=(",", ":")).encode()


def _decode(payload: bytes) -> CostReport:
    rep = CostReport.from_dict(json.loads(payload.decode()))
    if not isinstance(rep, CostReport):
        raise ValueError("payload is not a CostReport")
    return rep


class ResultStore:
    """Durable ``job.key -> CostReport`` storage.

    ``path`` may be a directory (the store lives at
    ``<path>/results.sqlite``) or an explicit ``*.sqlite`` file.
    ``backend`` forces ``"sqlite"`` or ``"json"``; the default picks
    sqlite when the module is importable and falls back to the
    atomic-rename JSON directory otherwise.

    Crash-safety: sqlite runs in WAL mode (readers never block writers,
    a killed writer's transaction simply never commits); the JSON
    backend stages each entry in a temp file and ``os.replace``\\ s it
    into place.  Either way a reader sees a complete old entry, a
    complete new entry, or nothing — and anything undecodable is
    deleted, counted in :attr:`corrupt_entries`, and reported as a miss.
    """

    def __init__(self, path: Union[str, Path], *,
                 backend: Optional[str] = None):
        path = Path(path)
        if backend is None:
            backend = "sqlite" if _sqlite3() is not None else "json"
        if backend not in ("sqlite", "json"):
            raise ValueError(f"unknown store backend {backend!r}")
        if backend == "sqlite" and _sqlite3() is None:
            raise StoreError("backend='sqlite' requested but the sqlite3 "
                             "module is unavailable")
        self.backend = backend
        self.corrupt_entries = 0
        if backend == "sqlite":
            if path.suffix == ".sqlite":
                self.dir, self.db_path = path.parent, path
            else:
                self.dir, self.db_path = path, path / "results.sqlite"
            self.dir.mkdir(parents=True, exist_ok=True)
            self._pid: Optional[int] = None
            self._con = None
            self._connect()                    # validate schema eagerly
        else:
            self.dir = path
            self.dir.mkdir(parents=True, exist_ok=True)
            self._check_json_meta()

    # -- sqlite backend ------------------------------------------------------
    def _connect(self):
        """Per-process connection (forked workers never share one)."""
        pid = os.getpid()
        if self._con is not None and pid == self._pid:
            return self._con
        sqlite3 = _sqlite3()
        con = sqlite3.connect(self.db_path, timeout=30.0)
        con.execute("PRAGMA journal_mode=WAL")
        con.execute("PRAGMA synchronous=NORMAL")
        con.execute("PRAGMA busy_timeout=30000")
        with con:
            con.execute("CREATE TABLE IF NOT EXISTS meta "
                        "(k TEXT PRIMARY KEY, v TEXT NOT NULL)")
            con.execute("CREATE TABLE IF NOT EXISTS results "
                        "(key TEXT PRIMARY KEY, payload BLOB NOT NULL)")
            con.execute("INSERT OR IGNORE INTO meta VALUES "
                        "('store_schema', ?)", (str(STORE_SCHEMA),))
        row = con.execute("SELECT v FROM meta WHERE k='store_schema'"
                          ).fetchone()
        if row is None or int(row[0]) != STORE_SCHEMA:
            found = "none" if row is None else row[0]
            con.close()
            raise StoreError(
                f"result store {self.db_path} has store_schema {found}, "
                f"this build expects {STORE_SCHEMA} — migrate or delete it")
        self._con, self._pid = con, pid
        return con

    # -- json backend --------------------------------------------------------
    def _check_json_meta(self) -> None:
        meta = self.dir / "store_meta.json"
        if meta.exists():
            try:
                recorded = json.loads(meta.read_text()).get("store_schema")
            except (OSError, json.JSONDecodeError):
                recorded = None
            if recorded != STORE_SCHEMA:
                raise StoreError(
                    f"result store {self.dir} has store_schema "
                    f"{recorded!r}, this build expects {STORE_SCHEMA} — "
                    f"migrate or delete it")
        else:
            self._atomic_write(meta, json.dumps(
                {"store_schema": STORE_SCHEMA}).encode())

    def _entry_path(self, key: str) -> Path:
        return self.dir / f"{key}.json"

    def _atomic_write(self, path: Path, payload: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- shared surface ------------------------------------------------------
    def get(self, key: str) -> Optional[CostReport]:
        payload: Optional[bytes] = None
        if self.backend == "sqlite":
            try:
                row = self._connect().execute(
                    "SELECT payload FROM results WHERE key=?",
                    (key,)).fetchone()
            except _sqlite3().Error as e:       # pragma: no cover - env
                warnings.warn(f"result store read failed ({e})",
                              RuntimeWarning, stacklevel=2)
                return None
            payload = bytes(row[0]) if row is not None else None
        else:
            p = self._entry_path(key)
            if p.exists():
                try:
                    payload = p.read_bytes()
                except OSError:
                    payload = None
        if payload is None:
            return None
        try:
            return _decode(payload)
        except Exception:
            # torn / bit-rotted entry: drop it so it cannot poison every
            # later run of the same sweep, count it, report a miss
            self.corrupt_entries += 1
            self.delete(key)
            return None

    def put(self, key: str, report: CostReport) -> None:
        payload = faults.corrupt_payload(key, _encode(report))
        if self.backend == "sqlite":
            try:
                con = self._connect()
                with con:
                    con.execute("INSERT OR REPLACE INTO results VALUES "
                                "(?, ?)", (key, payload))
            except _sqlite3().Error as e:       # pragma: no cover - env
                warnings.warn(f"result store write failed ({e})",
                              RuntimeWarning, stacklevel=2)
        else:
            try:
                self._atomic_write(self._entry_path(key), payload)
            except OSError as e:
                warnings.warn(f"result store write failed ({e})",
                              RuntimeWarning, stacklevel=2)

    def put_many(self, items: Dict[str, CostReport]) -> None:
        """Land many results at once.

        The sqlite backend commits ONE transaction (one fsync) for the
        whole batch instead of one per entry — the difference between
        the store being a rounding error and being the bottleneck of a
        batched sweep.  The JSON backend stays a per-entry atomic
        rename (there is no multi-file atomic rename).  Each payload
        still passes through the fault-injection corruption hook
        individually, so chaos plans see the same per-key surface as
        :meth:`put`.
        """
        if not items:
            return
        encoded = [(k, faults.corrupt_payload(k, _encode(r)))
                   for k, r in items.items()]
        if self.backend == "sqlite":
            try:
                con = self._connect()
                with con:
                    con.executemany(
                        "INSERT OR REPLACE INTO results VALUES (?, ?)",
                        encoded)
            except _sqlite3().Error as e:       # pragma: no cover - env
                warnings.warn(f"result store write failed ({e})",
                              RuntimeWarning, stacklevel=2)
        else:
            for key, payload in encoded:
                try:
                    self._atomic_write(self._entry_path(key), payload)
                except OSError as e:
                    warnings.warn(f"result store write failed ({e})",
                                  RuntimeWarning, stacklevel=2)

    def get_many(self, keys: Sequence[str]) -> Dict[str, CostReport]:
        """Fetch many keys in chunked ``SELECT ... IN`` queries (sqlite)
        or per-file reads (JSON).  Missing keys are simply absent from
        the result; corrupt entries are dropped/counted exactly like
        :meth:`get`."""
        out: Dict[str, CostReport] = {}
        if not keys:
            return out
        payloads: Dict[str, bytes] = {}
        if self.backend == "sqlite":
            try:
                con = self._connect()
                ks = list(keys)
                for i in range(0, len(ks), 500):
                    chunk = ks[i:i + 500]
                    marks = ",".join("?" * len(chunk))
                    rows = con.execute(
                        f"SELECT key, payload FROM results "
                        f"WHERE key IN ({marks})", chunk)
                    for k, p in rows:
                        payloads[k] = bytes(p)
            except _sqlite3().Error as e:       # pragma: no cover - env
                warnings.warn(f"result store read failed ({e})",
                              RuntimeWarning, stacklevel=2)
                return out
        else:
            for key in keys:
                p = self._entry_path(key)
                if p.exists():
                    try:
                        payloads[key] = p.read_bytes()
                    except OSError:
                        pass
        for key, payload in payloads.items():
            try:
                out[key] = _decode(payload)
            except Exception:
                self.corrupt_entries += 1
                self.delete(key)
        return out

    def delete(self, key: str) -> None:
        if self.backend == "sqlite":
            try:
                con = self._connect()
                with con:
                    con.execute("DELETE FROM results WHERE key=?", (key,))
            except _sqlite3().Error:            # pragma: no cover - env
                pass
        else:
            try:
                self._entry_path(key).unlink()
            except OSError:
                pass

    def keys(self) -> Set[str]:
        if self.backend == "sqlite":
            rows = self._connect().execute("SELECT key FROM results")
            return {r[0] for r in rows}
        return {p.stem for p in sorted(self.dir.glob("*.json"))
                if p.name != "store_meta.json"}

    def __contains__(self, key: str) -> bool:
        return key in self.keys()

    def __len__(self) -> int:
        if self.backend == "sqlite":
            row = self._connect().execute(
                "SELECT COUNT(*) FROM results").fetchone()
            return int(row[0])
        return len(self.keys())

    def self_check(self) -> StoreCheck:
        """Decode every entry; drop (and count) the undecodable ones."""
        all_keys = sorted(self.keys())
        before = self.corrupt_entries
        readable = sum(1 for k in all_keys if self.get(k) is not None)
        return StoreCheck(backend=self.backend, entries=len(all_keys),
                          readable=readable,
                          corrupt=self.corrupt_entries - before)

    def close(self) -> None:
        if self.backend == "sqlite" and self._con is not None:
            try:
                self._con.close()
            except Exception:
                pass
            self._con = None


def _sqlite3():
    try:
        import sqlite3
    except ImportError:          # pragma: no cover - stdlib nearly always has it
        return None
    return sqlite3


class KeyJournal:
    """Append-only completed-keys log: one 64-hex job key per line.

    Appends are line-buffered single writes, so a SIGKILL leaves at most
    one torn *final* line — and :meth:`keys` drops anything that is not
    a full hex key.  The journal is the resume contract: a key present
    here was evaluated AND durably stored before the line was written.
    """

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh: Optional[IO[str]] = None
        self._pid: Optional[int] = None

    def record(self, key: str) -> None:
        pid = os.getpid()
        if self._fh is None or pid != self._pid:
            self._fh = open(self.path, "a", buffering=1)
            self._pid = pid
        self._fh.write(key + "\n")

    def record_many(self, keys: Iterable[str]) -> None:
        """Record many completed keys in ONE write syscall — a SIGKILL
        mid-write still tears at most the final line, and every key in
        the batch was durably stored before this is called (the runner
        commits store-then-journal, batched or not)."""
        keys = list(keys)
        if not keys:
            return
        pid = os.getpid()
        if self._fh is None or pid != self._pid:
            self._fh = open(self.path, "a", buffering=1)
            self._pid = pid
        self._fh.write("".join(k + "\n" for k in keys))

    def keys(self) -> Set[str]:
        if not self.path.exists():
            return set()
        out: Set[str] = set()
        with open(self.path) as f:
            for line in f:
                key = line.strip()
                if len(key) == 64 and set(key) <= _HEXDIGITS:
                    out.add(key)
        return out

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


class ResultCache:
    """Memoises ``job.key -> CostReport``: an in-memory dict fronting an
    optional durable :class:`ResultStore`.

    ``path`` builds a store at that location (the pre-PR-9 pickle
    directory is gone — old ``*.pkl`` entries are simply never read);
    pass ``store`` to share one durable tier across caches.  Corrupt
    durable entries surface as misses and are counted in
    ``stats.corrupt_entries``.
    """

    def __init__(self, path: Optional[Union[str, Path]] = None, *,
                 store: Optional[ResultStore] = None):
        self._mem: Dict[str, CostReport] = {}
        self.stats = CacheStats()
        if store is not None:
            self.store: Optional[ResultStore] = store
        elif path is not None:
            self.store = ResultStore(path)
        else:
            self.store = None

    def __len__(self) -> int:
        return len(self._mem)

    def get(self, key: str) -> Optional[CostReport]:
        rep = self._mem.get(key)
        if rep is not None:
            self.stats.memory_hits += 1
            return rep
        if self.store is not None:
            before = self.store.corrupt_entries
            rep = self.store.get(key)
            self.stats.corrupt_entries += self.store.corrupt_entries - before
            if rep is not None:
                self._mem[key] = rep
                self.stats.disk_hits += 1
                return rep
        self.stats.misses += 1
        return None

    def get_many(self, keys: Sequence[str]) -> Dict[str, CostReport]:
        """Batched :meth:`get` with identical stats accounting: memory
        hits first, one chunked store query for the rest, misses counted
        for keys found nowhere."""
        out: Dict[str, CostReport] = {}
        missing: list = []
        for key in keys:
            rep = self._mem.get(key)
            if rep is not None:
                self.stats.memory_hits += 1
                out[key] = rep
            else:
                missing.append(key)
        if missing and self.store is not None:
            before = self.store.corrupt_entries
            found = self.store.get_many(missing)
            self.stats.corrupt_entries += self.store.corrupt_entries - before
            for key, rep in found.items():
                self._mem[key] = rep
                self.stats.disk_hits += 1
                out[key] = rep
            self.stats.misses += len(missing) - len(found)
        else:
            self.stats.misses += len(missing)
        return out

    def put(self, key: str, report: CostReport) -> None:
        self._mem[key] = report
        if self.store is not None:
            self.store.put(key, report)

    def put_many(self, items: Dict[str, CostReport]) -> None:
        """Batched :meth:`put`: one store transaction for the batch."""
        self._mem.update(items)
        if self.store is not None:
            self.store.put_many(items)

    def close(self) -> None:
        if self.store is not None:
            self.store.close()
