"""Deterministic fault injection for the explore plane.

Copy of ``repro.explore.faults``: the port never imports the JAX package.

Chaos testing only earns trust when the chaos is *reproducible*: a
:class:`FaultPlan` decides — as a pure function of ``(seed, kind,
job key)`` — whether a given evaluation crashes its worker, hangs,
raises a transient exception, or has its store entry corrupted on
write.  The same plan against the same sweep injects the same faults
in any process, on any host, in any dispatch order, which is what lets
``tests/test_torch_explore_faults.py`` assert that every *surviving* report of a
faulted sweep is bit-identical to the fault-free run.

Fault kinds
-----------
``crash``    the worker process dies mid-evaluation (``os._exit``) —
             the runner sees ``BrokenProcessPool`` and must self-heal.
``hang``     the evaluation sleeps ``hang_s`` seconds — only a per-job
             timeout recovers the worker.
``exc``      a transient :class:`FaultError` is raised — bounded retry
             absorbs it.
``corrupt``  the result's on-disk payload is garbled before the write —
             the store must treat it as a miss on read-back.

Spec grammar (``REPRO_FAULTS`` environment variable)
----------------------------------------------------
Comma-separated ``name=value`` pairs::

    REPRO_FAULTS="seed=7,crash=0.1,exc=0.2,times=1"
    REPRO_FAULTS="seed=1,hang=1.0,hang_s=30,match=ab12,times=inf"

* ``seed``   integer salt for the selection digest (default 0);
* ``crash`` / ``hang`` / ``exc`` / ``corrupt``   injection rates in
  [0, 1] — the fraction of job keys the fault selects (default 0);
* ``times``  how many *attempts* of a selected job the fault fires on
  (default 1, so one retry recovers; ``inf`` makes a permanent poison
  job for quarantine tests);
* ``hang_s`` sleep length for ``hang`` faults (default 3600);
* ``match``  hex prefix — only job keys starting with it are eligible
  (default "" = all keys); lets a test target one specific job.

Activation mirrors :mod:`repro_torch.obs`: :func:`install` sets a process
global and exports ``REPRO_FAULTS`` so pool workers (fork or spawn)
inherit the plan; :func:`active_plan` consults the environment once per
process and is a single global read afterwards, so the disabled-mode
cost of the :func:`maybe_fail` hook in the evaluation hot path is a
``None`` check.

Everything here is deterministic by construction: the selection digest
is ``blake2b`` (never the salted builtin ``hash``), and no wall clock or
entropy source is read.

The one contract this module must never break: fault knobs are
*runner-level* state.  They may not become :class:`ExploreJob` fields
or ``simulate()`` parameters — a fault plan changes how a sweep
executes, never what a job computes, so cache keys must not vary with
it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import time
from typing import Dict, Optional, Union

__all__ = [
    "FAULT_KINDS", "FaultError", "FaultPlan", "parse_fault_spec",
    "install", "uninstall", "active_plan", "mark_worker", "in_worker",
    "maybe_fail", "corrupt_payload", "CRASH_EXIT_CODE",
]

FAULT_KINDS = ("crash", "hang", "exc", "corrupt")

# exit code of a fault-injected worker crash — distinguishable from a
# real interpreter death in test logs
CRASH_EXIT_CODE = 113

_ENV_VAR = "REPRO_FAULTS"


class FaultError(RuntimeError):
    """The injected transient exception (``exc`` faults raise this)."""


def _unit(seed: int, kind: str, key: str) -> float:
    """Uniform-ish value in [0, 1) derived from content, never entropy."""
    digest = hashlib.blake2b(f"{seed}:{kind}:{key}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, content-addressed fault schedule (see module docstring)."""

    seed: int = 0
    crash: float = 0.0
    hang: float = 0.0
    exc: float = 0.0
    corrupt: float = 0.0
    times: float = 1.0          # attempts a selected fault fires on (inf ok)
    hang_s: float = 3600.0
    match: str = ""             # key prefix filter ("" = every key)

    def __post_init__(self):
        for kind in FAULT_KINDS:
            rate = getattr(self, kind)
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"fault rate {kind}={rate} not in [0, 1]")
        if self.times < 0:
            raise ValueError(f"times={self.times} must be >= 0")

    def rate(self, kind: str) -> float:
        if kind not in FAULT_KINDS:
            raise KeyError(f"unknown fault kind {kind!r}")
        return getattr(self, kind)

    def selected(self, kind: str, key: str) -> bool:
        """Does this plan target ``key`` with ``kind`` at all?  Pure
        function of (seed, kind, key) — stable across processes."""
        rate = self.rate(kind)
        if rate <= 0.0 or not key.startswith(self.match):
            return False
        return _unit(self.seed, kind, key) < rate

    def should(self, kind: str, key: str, attempt: int = 0) -> bool:
        """Fire ``kind`` on this attempt?  Selected faults fire on the
        first ``times`` attempts, so bounded retry recovers transient
        faults while ``times=inf`` models a permanent poison job."""
        return attempt < self.times and self.selected(kind, key)

    def spec(self) -> str:
        """Serialise back to the ``REPRO_FAULTS`` grammar."""
        parts = [f"seed={self.seed}"]
        for kind in FAULT_KINDS:
            rate = getattr(self, kind)
            if rate > 0:
                parts.append(f"{kind}={rate!r}")
        if self.times != 1.0:
            times = "inf" if math.isinf(self.times) else repr(self.times)
            parts.append(f"times={times}")
        if self.hang_s != 3600.0:
            parts.append(f"hang_s={self.hang_s!r}")
        if self.match:
            parts.append(f"match={self.match}")
        return ",".join(parts)


def parse_fault_spec(text: str) -> FaultPlan:
    """Parse the ``REPRO_FAULTS`` grammar into a :class:`FaultPlan`."""
    fields: Dict[str, Union[int, float, str]] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, value = part.partition("=")
        name = name.strip()
        value = value.strip()
        if not sep or not name or not value:
            raise ValueError(f"fault spec entry {part!r} is not name=value")
        if name == "seed":
            fields["seed"] = int(value)
        elif name == "match":
            fields["match"] = value
        elif name in (*FAULT_KINDS, "times", "hang_s"):
            fields[name] = float(value)      # float('inf') parses for times
        else:
            raise ValueError(
                f"unknown fault spec field {name!r} "
                f"(known: seed, {', '.join(FAULT_KINDS)}, times, hang_s, "
                f"match)")
    return FaultPlan(**fields)   # type: ignore[arg-type]


# -- process state ------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None
_ENV_CHECKED = False
_OWNS_ENV = False
_IN_WORKER = False


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, or None.  First call per process consults
    ``REPRO_FAULTS`` so pool workers inherit the parent's plan; after
    that the disabled fast path is one global read."""
    global _ENV_CHECKED, _PLAN
    if _PLAN is not None:
        return _PLAN
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        spec = os.environ.get(_ENV_VAR)
        if spec:
            _PLAN = parse_fault_spec(spec)
    return _PLAN


def install(plan: Union[FaultPlan, str], *, export_env: bool = True
            ) -> FaultPlan:
    """Activate ``plan`` for this process (and, via ``REPRO_FAULTS``,
    for every worker process it spawns or forks)."""
    global _PLAN, _ENV_CHECKED, _OWNS_ENV
    if isinstance(plan, str):
        plan = parse_fault_spec(plan)
    _PLAN = plan
    _ENV_CHECKED = True
    if export_env:
        os.environ[_ENV_VAR] = plan.spec()
        _OWNS_ENV = True
    return plan


def uninstall() -> None:
    """Deactivate fault injection (and drop the env hand-off we set)."""
    global _PLAN, _ENV_CHECKED, _OWNS_ENV
    _PLAN = None
    _ENV_CHECKED = True                       # do not re-install from env
    if _OWNS_ENV:
        os.environ.pop(_ENV_VAR, None)
        _OWNS_ENV = False


def mark_worker() -> None:
    """Called from the pool initializer: this process may be killed by
    ``crash`` faults (the parent never is — see :func:`maybe_fail`)."""
    global _IN_WORKER
    _IN_WORKER = True


def in_worker() -> bool:
    return _IN_WORKER


# -- injection points ---------------------------------------------------------

def maybe_fail(key: str, attempt: int = 0) -> None:
    """Evaluation-time injection point (called by ``evaluate_job``).

    Fires in selection order hang → crash → exc so a key selected by
    several kinds behaves predictably.  ``crash`` only hard-kills pool
    workers (:func:`mark_worker`); in the parent process — sequential
    sweeps, unit tests — it degrades to a :class:`FaultError` so the
    test process survives while the retry path is still exercised.
    """
    plan = active_plan()
    if plan is None:
        return
    if plan.should("hang", key, attempt):
        time.sleep(plan.hang_s)
    if plan.should("crash", key, attempt):
        if _IN_WORKER:
            os._exit(CRASH_EXIT_CODE)
        raise FaultError(f"injected crash (in-process) for {key[:16]}")
    if plan.should("exc", key, attempt):
        raise FaultError(f"injected transient exception for {key[:16]} "
                         f"(attempt {attempt})")


def corrupt_payload(key: str, payload: bytes, attempt: int = 0) -> bytes:
    """Store-write injection point: garble ``payload`` when a ``corrupt``
    fault targets ``key`` — simulates a torn/bit-rotted entry the store
    must survive on read-back."""
    plan = active_plan()
    if plan is None or not plan.should("corrupt", key, attempt):
        return payload
    # truncate and prepend junk: invalid as JSON, wrong length, and
    # deterministic (no entropy) so reruns corrupt identically
    return b"\x00CORRUPT\x00" + payload[: max(1, len(payload) // 3)]
