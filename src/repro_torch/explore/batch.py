"""Batched grid-point evaluation: share one costing pass per group.

Copy of ``repro.explore.batch``: the port never imports the JAX package.

Grid points frequently differ only in *variant* knobs — the calibration
``profile`` and the ``schedule`` policy — while the expensive inputs
(arch, workload with sparsity bound, mapping, masks, input-sparsity map)
are content-identical.  :func:`group_jobs` buckets jobs on a **base
key** — the job's canonical form with the variant fields nulled out —
and :func:`evaluate_batch` evaluates each bucket through
:func:`repro_torch.core.costmodel.simulate_variants`: one per-op costing pass
(tiling, band packing, access ledgers) serves every variant, and the
tile grids of ALL groups in a batch precompute together in stacked
``np.add.reduceat`` passes (:func:`repro_torch.core.mapping.precompute_tile_grids`).

Contract (the reference's, held by ``tests/test_torch_explore.py``): results are **bit-
identical** to per-point :func:`~repro_torch.explore.runner.evaluate_job`, and
cache keys are untouched — a batched evaluation of a point lands under
exactly the key a per-point evaluation would, so batched and per-point
runs share one store.  Batching is therefore an execution knob and must
never become an :class:`~repro_torch.explore.job.ExploreJob` field.

Fault injection fires *before* any evaluation, once per job: a fault
anywhere in a batch fails the whole dispatch, and the runner falls back
to the per-point retry machinery where the existing crash-conviction
semantics identify the culprit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.costmodel import simulate_variants
from ..core.mapping import TileGridCache, precompute_tile_grids
from ..core.report import CostReport
from .. import obs
from . import faults
from .job import CACHE_SCHEMA, ExploreJob, canonical

__all__ = ["job_keys", "warm_job_keys", "group_jobs", "evaluate_batch",
           "plan_batches"]

# the job fields a group may vary in: simulate_variants re-aggregates one
# costing pass under every (profile, schedule) combination bit-identically
VARIANT_FIELDS = ("profile", "schedule")

# ExploreJob's field order inside content_key's payload: canonical()
# sorts dataclass fields by name, so replicate that here once
_JOB_FIELDS = tuple(sorted(f.name for f in dataclasses.fields(ExploreJob)))


def _field_texts(job: ExploreJob, memo: Dict[int, str]) -> Dict[str, str]:
    """JSON text of each field's canonical form, shared via ``memo``.

    Canonical forms are pure lists/str/int/bool/None (``canonical``
    rewrites dicts and dataclasses into sorted lists), so the JSON
    encoding of a field is position-independent text that concatenates
    into exactly what ``json.dumps(separators=(",", ":"))`` would emit
    for the whole payload — byte-identical keys, but the expensive
    fields (the workload above all) encode once per *object* instead of
    once per job.  ``memo`` keys by ``id``; it is call-local and the
    caller's job list keeps every field object alive, so ids are stable
    for the memo's lifetime.
    """
    texts: Dict[str, str] = {}
    for name in _JOB_FIELDS:
        v = getattr(job, name)
        if v is None:
            texts[name] = "null"
            continue
        # scalars memoise by (type, value) — 1 == True == 1.0 but their
        # canonical texts differ; objects by identity, stable for the
        # call-local memo's lifetime
        mk = (("v", v.__class__, v)
              if isinstance(v, (bool, int, float, str)) else id(v))
        t = memo.get(mk)
        if t is None:
            t = json.dumps(canonical(v), separators=(",", ":"),
                           sort_keys=True)
            memo[mk] = t
        texts[name] = t
    return texts


def _keys_from_texts(texts: Dict[str, str]) -> Tuple[str, str]:
    body = ",".join(f'["{n}",{texts[n]}]' for n in _JOB_FIELDS)
    full = f'["v",{CACHE_SCHEMA},["ExploreJob",[{body}]]]'
    base_body = ",".join(
        f'["{n}",{"null" if n in VARIANT_FIELDS else texts[n]}]'
        for n in _JOB_FIELDS)
    base = f'["b",{CACHE_SCHEMA},["ExploreJob",[{base_body}]]]'
    return (hashlib.sha256(full.encode()).hexdigest(),
            hashlib.sha256(base.encode()).hexdigest())


def _ensure_keys(job: ExploreJob, memo: Dict[int, str]) -> Tuple[str, str]:
    """Memoise ``(full_key, base_key)`` onto ``job``; compute at most
    once per job across every explore-plane keying pass."""
    full = job.__dict__.get("_key")
    base = job.__dict__.get("_base_key")
    if full is None or base is None:
        full, base = _keys_from_texts(_field_texts(job, memo))
        object.__setattr__(job, "_key", full)
        object.__setattr__(job, "_base_key", base)
    return full, base


def job_keys(job: ExploreJob) -> Tuple[str, str]:
    """``(full_key, base_key)`` from one canonical traversal.

    ``full_key`` equals :attr:`ExploreJob.key` exactly (as
    ``content_key`` gives it) and is memoised
    onto the job so later ``.key`` reads are free.  ``base_key``
    digests the same form with the :data:`VARIANT_FIELDS` nulled, under
    a distinct ``"b"`` domain tag so a base key can never collide with
    a result-store key; it is memoised as ``_base_key`` so grouping
    passes that follow a :func:`warm_job_keys` pass are free.
    """
    return _ensure_keys(job, {})


def warm_job_keys(jobs: Sequence[ExploreJob]) -> None:
    """Memoise ``.key`` (and the base key) onto every job in one
    shared-subform pass.

    Grid points overwhelmingly share their heavy field objects (one
    workload serves every schedule/profile variant; one arch and
    mapping serve the whole sweep), so encoding each *object* once cuts
    keying from the dominant cost of a large sweep to near-noise.  Keys
    are byte-identical to per-job ``content_key`` — this is purely a
    sharing optimisation.
    """
    memo: Dict[int, str] = {}
    for job in jobs:
        _ensure_keys(job, memo)


def group_jobs(jobs: Sequence[ExploreJob]) -> List[List[ExploreJob]]:
    """Bucket jobs by base key, preserving first-seen order.

    Equal base keys ⟹ content-identical non-variant fields, so the
    first member's arch/workload/mapping/masks objects stand in for the
    whole group (content-identical inputs evaluate bit-identically —
    the determinism contract the explore plane is built on).
    """
    groups: "OrderedDict[str, List[ExploreJob]]" = OrderedDict()
    memo: Dict[int, str] = {}
    for job in jobs:
        _full, base = _ensure_keys(job, memo)
        groups.setdefault(base, []).append(job)
    return list(groups.values())


def plan_batches(groups: Sequence[List[ExploreJob]],
                 batch_size: int) -> List[List[List[ExploreJob]]]:
    """Chunk groups into dispatch batches of ≤ ``batch_size`` points.

    Groups are never split (a split group would pay the costing pass
    twice); a single group larger than ``batch_size`` ships whole.
    """
    batches: List[List[List[ExploreJob]]] = []
    cur: List[List[ExploreJob]] = []
    n = 0
    for grp in groups:
        if cur and n + len(grp) > batch_size:
            batches.append(cur)
            cur, n = [], 0
        cur.append(grp)
        n += len(grp)
    if cur:
        batches.append(cur)
    return batches


def evaluate_batch(groups: List[List[ExploreJob]], attempt: int = 0,
                   tile_cache: Optional[TileGridCache] = None,
                   ) -> Dict[str, CostReport]:
    """Evaluate a batch of variant groups; returns ``{job.key: report}``.

    Module-level so ProcessPool workers can import it.  ``attempt`` is
    the runner's retry ordinal, forwarded to the fault-injection hook
    for every member job up front — results are attempt-invariant.
    """
    n_jobs = sum(len(g) for g in groups)
    with obs.span("explore.evaluate_batch", groups=len(groups),
                  jobs=n_jobs):
        for grp in groups:
            for job in grp:
                faults.maybe_fail(job.key, attempt)

        # stacked tile-grid precompute across every group in the batch:
        # one reduceat pass per (tile_k, tile_n, kt) shape, one cache
        # entry per distinct grid — cold grids across the batch cost a
        # few numpy calls instead of one pass per point
        requests = []
        for grp in groups:
            job = grp[0]
            masks = dict(job.masks) if job.masks else {}
            scoped = {o.name for o in
                      job.workload.mvm_ops(job.arch.eval_scope)}
            for op in job.workload.nodes.values():
                if (op.is_mvm or op.kind == "dwconv") \
                        and op.name in scoped:
                    requests.append((op, job.arch, job.mapping.reshape,
                                     masks.get(op.name)))
        precompute_tile_grids(requests, cache=tile_cache)

        out: Dict[str, CostReport] = {}
        for grp in groups:
            job = grp[0]
            reports = simulate_variants(
                job.arch, job.workload, job.mapping,
                input_sparsity=(dict(job.input_sparsity)
                                if job.input_sparsity else None),
                masks=dict(job.masks) if job.masks else None,
                tile_cache=tile_cache,
                variants=[(j.profile, j.schedule) for j in grp])
            for j, rep in zip(grp, reports):
                out[j.key] = rep
        return out
