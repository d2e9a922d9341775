"""Job runner: dedup → cache lookup → (parallel) evaluate → ordered rows.

Copy of ``repro.explore.runner``: the port never imports the JAX package.

The runner is where the sweep engine earns its keep:

* **Dedup** — jobs are content-addressed, so a grid whose points share a
  dense baseline (or repeat a configuration) evaluates each distinct job
  exactly once per process pool, however many rows request it.
* **Memoisation** — a :class:`~repro_torch.explore.cache.ResultCache` serves
  repeats across sweeps (in memory) and across runs (on disk).
* **Fan-out** — remaining jobs are dispatched one future each to a
  ``concurrent.futures.ProcessPoolExecutor``.  Results are keyed, not
  positional, so completion order never affects output order: callers
  always get reports in the order they submitted jobs.
* **Fault tolerance** — each dispatch carries an optional per-job
  timeout; failures are retried with exponential backoff up to
  ``max_retries``; a dead worker (``BrokenProcessPool``) triggers pool
  respawn and re-dispatch of the in-flight jobs; a job that keeps
  failing is quarantined as a structured :class:`JobFailure` instead of
  sinking the sweep.  ``failure_mode="strict"`` (default) raises
  :class:`SweepFailure` *after* the sweep completes — every surviving
  result is already cached/journaled — while ``"degrade"`` returns
  ``None`` in the failed rows' slots.

Determinism note: the cost model synthesises sparsity masks from
content-stable seeds (see ``repro_torch.core.mapping._block_keep_grid``), so a
job evaluates to bit-identical results in any process — parallel runs
match sequential runs row for row, and a sweep that loses workers
mid-flight still produces surviving rows bit-identical to a fault-free
run (asserted under injected faults in
``tests/test_torch_explore_faults.py``).

Crash identification: when a worker dies, *every* in-flight future
raises ``BrokenProcessPool`` — the executor cannot say which job killed
it.  The runner therefore marks all in-flight jobs as suspects and
re-dispatches them **solo** (one at a time on a fresh pool): an
innocent job clears itself on success, while the culprit crashes alone
and is charged another attempt until quarantined.  This bounds the
blast radius of a poison job to ``workers`` extra solo evaluations per
crash instead of cascading misattributed retries.

Below the job-level result cache sits the tile-grid memo
(:class:`repro_torch.core.mapping.TileGridCache`): a process-wide cache of
reshape+compress+tile results that distinct jobs share whenever they
tile the same layer shapes.  It is per-process state — the sequential
path warms the parent's, and each ProcessPool worker warms its own copy
once (the runner's ``tile_cache_capacity`` is pushed into workers via
the pool initializer).
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future, ProcessPoolExecutor, wait
from concurrent.futures.process import BrokenProcessPool
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

from ..core import mapping as _mapping
from ..core.costmodel import simulate
from ..core.report import CostReport
from .. import obs
from . import faults
from .batch import (evaluate_batch, group_jobs, plan_batches,
                    warm_job_keys)
from .cache import KeyJournal, ResultCache
from .job import ExploreJob

__all__ = ["evaluate_job", "SweepRunner", "RunStats", "JobFailure",
           "SweepFailure"]


def evaluate_job(job: ExploreJob, attempt: int = 0) -> CostReport:
    """Evaluate one job.  Module-level so worker processes can import it.

    ``attempt`` is the retry ordinal the runner is on for this job; the
    simulation ignores it (results are attempt-invariant) — it only
    feeds the fault-injection hook, whose plan decides per ``(kind, key,
    attempt)`` whether to fire, so bounded retry deterministically
    recovers transient faults.

    The obs span is observational-only (a no-op object when recording is
    off) and runs in *this* process — pool workers auto-attach to the
    parent's trace directory via ``REPRO_OBS_DIR`` and write their own
    ``events-<pid>.jsonl``, so per-job spans line up with the parent's
    run span on one monotonic clock."""
    with obs.span("explore.evaluate_job", key=job.key[:16],
                  workload=job.workload.name, kind=job.kind):
        faults.maybe_fail(job.key, attempt)
        return simulate(
            job.arch, job.workload, job.mapping,
            input_sparsity=(dict(job.input_sparsity)
                            if job.input_sparsity else None),
            masks=dict(job.masks) if job.masks else None,
            profile=job.profile,
            schedule=job.schedule,
        )


def _init_worker(tile_cache_capacity: Optional[int],
                 environ: Dict[str, str]) -> None:
    """ProcessPool initializer: take the parent's environment as it was
    when the pool was made (so ``REPRO_FAULTS`` and ``REPRO_OBS_DIR``
    reach the worker as they reach a forked one); size the worker's
    process-wide tile-grid cache before any job lands, so every worker
    warms it exactly once; and mark the process as a pool worker so
    injected ``crash`` faults may hard-kill it (the parent process never
    is)."""
    os.environ.clear()
    os.environ.update(environ)
    faults.mark_worker()
    if tile_cache_capacity is not None:
        _mapping.set_default_tile_cache(
            _mapping.TileGridCache(tile_cache_capacity))


@dataclasses.dataclass(frozen=True)
class JobFailure:
    """A job quarantined after exhausting its retry budget."""

    key: str                     # ExploreJob.key of the poison job
    reason: str                  # "crash" | "timeout" | "exception"
    attempts: int                # dispatches consumed (1 + retries)
    error: str                   # repr of the last error seen

    def as_dict(self) -> Dict[str, Union[str, int]]:
        return dataclasses.asdict(self)


class SweepFailure(RuntimeError):
    """Raised at the *end* of a strict-mode run that quarantined jobs.

    Every surviving result was evaluated, cached, and journaled before
    this raises — ``results`` holds them aligned with the input job
    order (``None`` in failed slots), and a run directory can be
    resumed to retry just the failures.
    """

    def __init__(self, failures: List[JobFailure],
                 results: List[Optional[CostReport]]):
        self.failures = failures
        self.results = results
        sample = ", ".join(f"{f.key[:12]}({f.reason})" for f in failures[:3])
        more = "" if len(failures) <= 3 else f", +{len(failures) - 3} more"
        super().__init__(
            f"{len(failures)} job(s) failed after retries: {sample}{more} "
            f"— surviving results are cached; re-run or --resume to retry")


@dataclasses.dataclass
class RunStats:
    """Accounting for one :meth:`SweepRunner.run` call."""

    requested: int = 0          # jobs asked for (rows)
    unique: int = 0             # distinct cache keys among them
    memory_hits: int = 0
    disk_hits: int = 0
    evaluated: int = 0          # jobs successfully evaluated this run
    workers: int = 1
    wall_s: float = 0.0
    # tile-grid memo traffic during evaluation (sequential path only —
    # parallel evaluations hit the caches inside worker processes)
    tile_grid_hits: int = 0
    tile_grid_misses: int = 0
    # fault accounting
    failed: int = 0             # jobs quarantined after retry budget
    retried: int = 0            # extra dispatches caused by faults
    timed_out: int = 0          # dispatches cut off by the job timeout
    corrupt_entries: int = 0    # store entries dropped as undecodable
    # batched-evaluation accounting (repro_torch.explore.batch)
    batched_points: int = 0     # points evaluated via the batched path
    batches: int = 0            # batch dispatches that landed results

    @property
    def cache_hits(self) -> int:
        """Evaluations avoided: tiered-cache hits + intra-batch dedup."""
        return self.requested - self.evaluated - self.failed

    def as_dict(self) -> Dict[str, Union[int, float]]:
        d = dataclasses.asdict(self)
        d["cache_hits"] = self.cache_hits
        return d

    def stats_text(self) -> str:
        """One-line human summary (the CLI's ``engine:`` line)."""
        text = (f"{self.requested} jobs, {self.unique} unique, "
                f"{self.cache_hits} cache hits "
                f"({self.memory_hits} memory, {self.disk_hits} disk), "
                f"{self.evaluated} evaluated on {self.workers} worker(s) "
                f"in {self.wall_s:.2f}s")
        if self.failed or self.retried or self.timed_out \
                or self.corrupt_entries:
            text += (f" | faults: {self.failed} failed, "
                     f"{self.retried} retried, {self.timed_out} timed out, "
                     f"{self.corrupt_entries} corrupt entries dropped")
        if self.batches:
            text += (f" | batched: {self.batched_points} points in "
                     f"{self.batches} batches")
        return text

    def merge(self, other: "RunStats") -> "RunStats":
        return RunStats(
            requested=self.requested + other.requested,
            unique=self.unique + other.unique,
            memory_hits=self.memory_hits + other.memory_hits,
            disk_hits=self.disk_hits + other.disk_hits,
            evaluated=self.evaluated + other.evaluated,
            workers=max(self.workers, other.workers),
            wall_s=self.wall_s + other.wall_s,
            tile_grid_hits=self.tile_grid_hits + other.tile_grid_hits,
            tile_grid_misses=self.tile_grid_misses + other.tile_grid_misses,
            failed=self.failed + other.failed,
            retried=self.retried + other.retried,
            timed_out=self.timed_out + other.timed_out,
            corrupt_entries=self.corrupt_entries + other.corrupt_entries,
            batched_points=self.batched_points + other.batched_points,
            batches=self.batches + other.batches,
        )


def _resolve_workers(workers: Optional[int]) -> int:
    if workers is None:
        return max(1, (os.cpu_count() or 1))
    return max(1, workers) if workers else 1


class SweepRunner:
    """Evaluates batches of :class:`ExploreJob` with memoisation.

    ``workers``: process count for fan-out.  ``None`` → one per CPU;
    ``0``/``1`` → sequential in-process (useful for debugging and for
    row-equivalence tests).
    ``cache``: a shared :class:`ResultCache`; default is a fresh
    in-memory cache scoped to this runner.
    ``tile_cache_capacity``: entry budget for the per-process tile-grid
    memo (:mod:`repro_torch.core.mapping`); applied to this process and pushed
    into every worker via the pool initializer.  ``None`` keeps whatever
    capacity each process already has.

    Fault-tolerance knobs (runner-level by contract — never job fields):

    ``timeout_s``: per-job wall-clock budget.  A dispatch that exceeds
    it has its worker killed and is charged a retry; other in-flight
    jobs are re-dispatched uncharged.  ``None`` (default) disables the
    timeout; the sequential path cannot enforce one.
    ``max_retries``: extra dispatches a failing job gets before being
    quarantined as a :class:`JobFailure` (default 2).
    ``backoff_s``: base of the exponential re-dispatch backoff
    ``backoff_s * 2**(attempt-1)``, capped at 32× (default 0.05).
    ``failure_mode``: ``"strict"`` raises :class:`SweepFailure` after
    the sweep finishes (surviving results cached); ``"degrade"``
    returns ``None`` in failed slots.
    ``journal``: optional :class:`~repro_torch.explore.cache.KeyJournal`;
    every key is recorded immediately after its result lands in the
    cache, which is what makes ``--resume`` exact after a SIGKILL.
    ``batch_size``: enable batched evaluation (:mod:`repro_torch.explore.batch`):
    pending jobs are grouped on their variant-free base key and
    dispatched ``batch_size`` points at a time through
    :func:`~repro_torch.explore.batch.evaluate_batch` — bit-identical results
    under the same cache keys, with the costing pass, tile-grid
    precompute, and store transaction amortised per batch.  ``None``
    (default) keeps the per-point path; ``0`` picks an automatic size.
    A batch that fails for any reason (fault, crash, timeout) falls
    back wholesale to the per-point machinery *uncharged*, so retry
    budgets and crash conviction keep their per-job semantics.  Like
    the fault knobs, ``batch_size`` is runner-level execution state by
    contract — never a job field.
    """

    def __init__(self, *, workers: Optional[int] = None,
                 cache: Optional[ResultCache] = None,
                 tile_cache_capacity: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 max_retries: int = 2,
                 backoff_s: float = 0.05,
                 failure_mode: str = "strict",
                 journal: Optional[KeyJournal] = None,
                 batch_size: Optional[int] = None):
        if failure_mode not in ("strict", "degrade"):
            raise ValueError(f"failure_mode {failure_mode!r} is not "
                             f"'strict' or 'degrade'")
        self.workers = _resolve_workers(workers)
        self.cache = cache if cache is not None else ResultCache()
        self.tile_cache_capacity = tile_cache_capacity
        self.timeout_s = timeout_s
        self.max_retries = max(0, int(max_retries))
        self.backoff_s = max(0.0, backoff_s)
        self.failure_mode = failure_mode
        self.journal = journal
        if batch_size is not None and batch_size < 0:
            raise ValueError(f"batch_size must be >= 0, got {batch_size}")
        self.batch_size = batch_size
        if tile_cache_capacity is not None:
            # resize in place — replacing the process-wide cache would
            # throw away warm entries and break stats deltas other code
            # holds against the current object; workers (fresh processes
            # with nothing warm) get a new right-sized cache instead.
            _mapping.default_tile_cache().resize(tile_cache_capacity)
        self.stats = RunStats()          # cumulative across run() calls
        self._pool: Optional[ProcessPoolExecutor] = None
        self._seen_keys: set = set()     # distinct keys across the lifetime

    def _get_pool(self) -> ProcessPoolExecutor:
        # Workers fork from a fork server, never from this process, which
        # holds torch and may hold a CUDA context and its threads.  The
        # server imports this module once; every pool after it (a respawn
        # after a crash or a timeout too) forks from it in milliseconds.
        # The pool is amortised across every run() call of the runner's
        # lifetime, and its workers are up before the first dispatch, so a
        # worker's start never counts against a job's timeout.
        if self._pool is None:
            ctx = multiprocessing.get_context("forkserver")
            ctx.set_forkserver_preload([__name__])
            pool = ProcessPoolExecutor(
                max_workers=self.workers, mp_context=ctx,
                initializer=_init_worker,
                initargs=(self.tile_cache_capacity, dict(os.environ)))
            for fut in [pool.submit(os.getpid) for _ in range(self.workers)]:
                fut.result()
            self._pool = pool
        return self._pool

    def _kill_pool(self) -> None:
        """Tear the pool down *now* — used after a worker death or a
        hung job.  ``ProcessPoolExecutor`` has no per-task cancel, so
        recovering a hung worker means killing the processes (guarded
        use of the private ``_processes`` map; shutdown alone would
        block on the hung task forever)."""
        pool, self._pool = self._pool, None
        if pool is None:
            return
        procs = getattr(pool, "_processes", None) or {}
        for proc in list(procs.values()):
            try:
                proc.kill()
            except Exception:
                pass
        pool.shutdown(wait=False, cancel_futures=True)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __enter__(self) -> "SweepRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- evaluation ----------------------------------------------------------

    def _backoff(self, attempt: int) -> None:
        if attempt > 0 and self.backoff_s > 0:
            time.sleep(min(self.backoff_s * 2 ** min(attempt - 1, 5), 5.0))

    def _commit(self, job: ExploreJob, rep: CostReport,
                results: Dict[str, CostReport]) -> None:
        """Durably land one result: cache (memory + store) first, then
        the completed-keys journal — the journal line is the promise
        that the store already holds the result, so a SIGKILL between
        the two only costs a re-evaluation, never a phantom key."""
        results[job.key] = rep
        self.cache.put(job.key, rep)
        if self.journal is not None:
            self.journal.record(job.key)

    def _commit_many(self, reports: Dict[str, CostReport],
                     results: Dict[str, CostReport]) -> None:
        """Batched :meth:`_commit`: one store transaction, then one
        journal write — same store-then-journal durability order."""
        results.update(reports)
        self.cache.put_many(reports)
        if self.journal is not None:
            self.journal.record_many(reports)

    def _auto_batch_size(self, n_pending: int) -> int:
        """Pick a dispatch batch size: large enough to amortise the
        costing pass and store transaction, small enough to keep every
        worker busy and heartbeats flowing."""
        if self.workers <= 1:
            return 256
        return max(16, min(512, -(-n_pending // (self.workers * 4))))

    def _run_batched(self, pending: Sequence[ExploreJob],
                     results: Dict[str, CostReport], stats: RunStats,
                     hb) -> List[ExploreJob]:
        """Dispatch variant-grouped batches; returns the jobs that must
        fall back to the per-point path (their batch failed — fault,
        crash, or timeout — each job uncharged so per-job retry budgets
        and crash conviction semantics are preserved)."""
        size = self.batch_size or self._auto_batch_size(len(pending))
        batches: Deque[List[List[ExploreJob]]] = deque(
            plan_batches(group_jobs(pending), size))
        fallback: List[ExploreJob] = []
        done = 0

        def batch_jobs(batch: List[List[ExploreJob]]) -> List[ExploreJob]:
            return [job for grp in batch for job in grp]

        def land(batch: List[List[ExploreJob]],
                 reports: Dict[str, CostReport]) -> None:
            nonlocal done
            self._commit_many(reports, results)
            stats.batches += 1
            stats.batched_points += len(reports)
            done += len(reports)
            hb.tick(done, workers=self.workers, batch=len(reports),
                    batches=stats.batches)

        if self.workers <= 1 or len(batches) == 1:
            for batch in batches:
                try:
                    land(batch, evaluate_batch(batch))
                except Exception:   # noqa: BLE001 - fall back per-point
                    fallback.extend(batch_jobs(batch))
            return fallback

        inflight: Dict[Future, Tuple[List[List[ExploreJob]], float]] = {}
        poll = None if self.timeout_s is None \
            else max(0.02, min(0.25, self.timeout_s / 4))
        while batches or inflight:
            while batches and len(inflight) < self.workers:
                batch = batches.popleft()
                try:
                    fut = self._get_pool().submit(evaluate_batch, batch)
                except BrokenProcessPool:
                    self._kill_pool()
                    batches.appendleft(batch)
                    break
                inflight[fut] = (batch, time.monotonic())
            if not inflight:
                continue
            done_set, _ = wait(set(inflight), timeout=poll,
                               return_when=FIRST_COMPLETED)
            broken = False
            for fut in done_set:
                batch, _t = inflight.pop(fut)
                try:
                    land(batch, fut.result())
                except BrokenProcessPool:
                    broken = True
                    fallback.extend(batch_jobs(batch))
                except Exception:   # noqa: BLE001 - fall back per-point
                    fallback.extend(batch_jobs(batch))
            if broken:
                # the pool died with every other in-flight batch; their
                # jobs fall back too rather than waiting on doomed futures
                for batch, _t in inflight.values():
                    fallback.extend(batch_jobs(batch))
                inflight.clear()
                self._kill_pool()
                continue
            if self.timeout_s is not None and inflight:
                now = time.monotonic()
                # a batch gets one per-point budget per member job; a
                # genuinely hung job still trips it, just later — the
                # per-point fallback then enforces the exact per-job cut
                expired = [(f, b) for f, (b, t) in inflight.items()
                           if now - t > self.timeout_s
                           * max(1, len(batch_jobs(b)))]
                if expired:
                    for fut, batch in expired:
                        inflight.pop(fut, None)
                        fallback.extend(batch_jobs(batch))
                    survivors = [b for b, _t in inflight.values()]
                    inflight.clear()
                    self._kill_pool()
                    batches.extendleft(reversed(survivors))
        return fallback

    def _run_sequential(self, pending: Sequence[ExploreJob],
                        results: Dict[str, CostReport], stats: RunStats,
                        failures: List[JobFailure], hb) -> None:
        done = 0
        for job in pending:
            attempt = 0
            while True:
                self._backoff(attempt)
                try:
                    rep = evaluate_job(job, attempt)
                except Exception as e:      # noqa: BLE001 - retry boundary
                    attempt += 1
                    if attempt > self.max_retries:
                        stats.failed += 1
                        failures.append(JobFailure(
                            key=job.key, reason="exception",
                            attempts=attempt, error=repr(e)))
                        obs.event("explore.job.failed", key=job.key[:16],
                                  reason="exception", attempts=attempt)
                        break
                    stats.retried += 1
                    obs.event("explore.job.retry", key=job.key[:16],
                              reason="exception", attempt=attempt)
                    continue
                self._commit(job, rep, results)
                done += 1
                hb.tick(done, workers=1)
                break

    def _run_parallel(self, pending: Sequence[ExploreJob],
                      results: Dict[str, CostReport], stats: RunStats,
                      failures: List[JobFailure], hb) -> None:
        queue: Deque[ExploreJob] = deque(pending)
        # suspects of a pool break, re-dispatched one at a time (see
        # the module docstring's crash-identification note)
        solo: Deque[ExploreJob] = deque()
        attempts: Dict[str, int] = {job.key: 0 for job in pending}
        inflight: Dict[Future, Tuple[ExploreJob, float]] = {}
        done = 0

        def retry_or_fail(job: ExploreJob, reason: str, error: str,
                          to_solo: bool) -> None:
            attempts[job.key] += 1
            if attempts[job.key] > self.max_retries:
                stats.failed += 1
                failures.append(JobFailure(
                    key=job.key, reason=reason,
                    attempts=attempts[job.key], error=error))
                obs.event("explore.job.failed", key=job.key[:16],
                          reason=reason, attempts=attempts[job.key])
                return
            stats.retried += 1
            obs.event("explore.job.retry", key=job.key[:16], reason=reason,
                      attempt=attempts[job.key])
            (solo if to_solo else queue).append(job)

        def dispatch(job: ExploreJob) -> bool:
            self._backoff(attempts[job.key])
            try:
                fut = self._get_pool().submit(
                    evaluate_job, job, attempts[job.key])
            except BrokenProcessPool:
                # broke between heals: requeue uncharged, heal lazily
                self._kill_pool()
                queue.appendleft(job)
                return False
            inflight[fut] = (job, time.monotonic())
            return True

        poll = None if self.timeout_s is None \
            else max(0.02, min(0.25, self.timeout_s / 4))
        while queue or solo or inflight:
            if solo:
                # drain suspects strictly one at a time on an otherwise
                # idle pool, so a crash unambiguously convicts its job
                if not inflight:
                    dispatch(solo.popleft())
            else:
                while queue and len(inflight) < self.workers:
                    if not dispatch(queue.popleft()):
                        break
            if not inflight:
                continue

            done_set, _ = wait(set(inflight), timeout=poll,
                               return_when=FIRST_COMPLETED)
            broken = False
            victims: List[ExploreJob] = []
            for fut in done_set:
                job, _t = inflight.pop(fut)
                try:
                    rep = fut.result()
                except BrokenProcessPool as e:
                    broken = True
                    victims.append(job)
                    error = repr(e)
                except Exception as e:   # noqa: BLE001 - retry boundary
                    retry_or_fail(job, "exception", repr(e), to_solo=False)
                else:
                    self._commit(job, rep, results)
                    done += 1
                    hb.tick(done, workers=self.workers)

            if broken:
                # every other in-flight future is doomed with the pool;
                # fold them into the suspect set rather than waiting for
                # each to raise
                victims.extend(job for job, _t in inflight.values())
                inflight.clear()
                self._kill_pool()
                for job in victims:
                    retry_or_fail(job, "crash", error, to_solo=True)
                continue

            if self.timeout_s is not None and inflight:
                now = time.monotonic()
                expired = [job for job, t in inflight.values()
                           if now - t > self.timeout_s]
                if expired:
                    expired_keys = {job.key for job in expired}
                    innocents = [job for job, _t in inflight.values()
                                 if job.key not in expired_keys]
                    inflight.clear()
                    self._kill_pool()   # no per-task cancel: kill + respawn
                    for job in expired:
                        stats.timed_out += 1
                        retry_or_fail(
                            job, "timeout",
                            f"no result within {self.timeout_s}s",
                            to_solo=True)
                    # innocents lose their partial work but not a retry
                    for job in innocents:
                        queue.appendleft(job)

    def run(self, jobs: Sequence[ExploreJob]
            ) -> List[Optional[CostReport]]:
        """Evaluate ``jobs``; returns reports aligned with input order.

        Strict mode raises :class:`SweepFailure` if any job exhausted
        its retries — after finishing and caching everything else.
        Degrade mode returns ``None`` in failed slots instead."""
        t0 = time.perf_counter()
        stats = RunStats(requested=len(jobs), workers=self.workers)

        # dedup while preserving first-seen order; under batching, key
        # in one shared-subform pass (byte-identical keys, but shared
        # field objects — the workload above all — encode once)
        if self.batch_size is not None:
            warm_job_keys(jobs)
        unique: Dict[str, ExploreJob] = {}
        for job in jobs:
            unique.setdefault(job.key, job)
        stats.unique = len(unique)

        cs = self.cache.stats
        mem0, disk0, cor0 = cs.memory_hits, cs.disk_hits, cs.corrupt_entries
        results: Dict[str, CostReport] = self.cache.get_many(list(unique))
        pending: List[ExploreJob] = [job for key, job in unique.items()
                                     if key not in results]
        stats.memory_hits = cs.memory_hits - mem0
        stats.disk_hits = cs.disk_hits - disk0

        failures: List[JobFailure] = []
        tg = _mapping.default_tile_cache()
        tg_h0, tg_m0 = tg.hits, tg.misses
        n_pending = len(pending)
        if pending:
            # telemetry (no-ops when recording is off): rate-limited
            # heartbeats with points/s + ETA as evaluations complete
            hb = obs.heartbeat("explore.run", total=n_pending)
            if self.batch_size is not None and len(pending) > 1:
                pending = self._run_batched(pending, results, stats, hb)
            if pending:
                if self.workers > 1 and len(pending) > 1:
                    self._run_parallel(pending, results, stats, failures,
                                       hb)
                else:
                    self._run_sequential(pending, results, stats,
                                         failures, hb)
        stats.evaluated = n_pending - len(failures)
        stats.corrupt_entries = cs.corrupt_entries - cor0
        stats.tile_grid_hits = tg.hits - tg_h0
        stats.tile_grid_misses = tg.misses - tg_m0

        stats.wall_s = time.perf_counter() - t0
        self._seen_keys.update(unique)
        self.stats = self.stats.merge(stats)
        # cumulative 'unique' means distinct keys over the runner's
        # lifetime, not the sum of per-batch uniques
        self.stats.unique = len(self._seen_keys)
        self.last_stats = stats
        observer = obs.get_observer()
        if observer is not None:
            # one record per run() call in the run manifest, plus an
            # aggregate event so `repro_torch.obs report` needs no special case
            record = stats.as_dict()
            if failures:
                record["failures"] = [f.as_dict() for f in failures]
            observer.append_jsonl("runs.jsonl", record)
            obs.event("explore.run.done", **stats.as_dict())
        ordered = [results.get(job.key) for job in jobs]
        if failures and self.failure_mode == "strict":
            raise SweepFailure(failures, ordered)
        return ordered
