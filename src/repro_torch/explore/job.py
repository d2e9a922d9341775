"""Exploration jobs: hashable, content-addressed simulation requests.

Copy of ``repro.explore.job``: the port never imports the JAX package.  Dataclasses are keyed by class
name, not module, so a job of the port keys exactly as the same job of
the reference (``tests/test_torch_explore.py``).

A sweep is a list of :class:`ExploreJob` — pure-data descriptions of one
simulator evaluation (a sparse :func:`~repro_torch.core.costmodel.simulate` or
a dense baseline).  Jobs carry fully-materialised inputs (arch, workload
with sparsity already bound, mapping), so they pickle cleanly across
process boundaries and two jobs with identical content produce identical
cache keys no matter which process, run, or host built them.

The key is a digest over a *canonical form* of the job: dataclasses are
flattened to ``(class-name, sorted fields)``, dicts are sorted, numpy
arrays are serialised with their dtype and shape.  ``CACHE_SCHEMA`` salts
the digest so stale on-disk results are invalidated whenever the cost
model changes shape.

Execution-policy knobs stay out of jobs by contract: retry budgets,
timeouts, backoff, fault-injection plans (:mod:`repro_torch.explore.faults`)
change how a sweep *executes*, never what a job *computes*, so they are
runner-level state and must not become job fields or ``simulate()``
parameters — cache keys may not vary with them.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from ..calibrate.profile import CalibrationProfile
from ..core.hardware import CIMArch
from ..core.mapping import MappingSpec
from ..core.schedule import SchedulePolicy
from ..core.workload import Workload

__all__ = ["ExploreJob", "canonical", "content_key", "CACHE_SCHEMA"]

# Bump when the cost model or job serialisation changes incompatibly:
# on-disk caches keyed under an older schema are simply never hit again.
# The reference's value: the two packages' keys must stay equal.
# 2: jobs grew a calibration-profile field (repro.calibrate).
# 3: synthesised keep-grid seeds became shape-addressed (shared across
#    same-shape ops), changing simulated results for FullBlock patterns.
# 4: jobs grew a schedule-policy field (repro.core.schedule); reports
#    carry ScheduleResult/per-op placement fields and the index-capacity
#    check dropped its spurious 64x slack.
# 5: workloads carry source_digest (repro.trace): traced DAGs are keyed
#    by the jaxpr content digest of the program they were lowered from,
#    and lm_workload grew the attention context matmul (attn_ctx).
CACHE_SCHEMA = 5


@functools.lru_cache(maxsize=None)
def _sorted_field_names(cls) -> Tuple[str, ...]:
    """Field names of a dataclass type, sorted once per class.

    Field names are unique, so sorting names alone reproduces the
    original ``sorted((name, value), ...)`` pair order exactly without
    re-canonicalising values for every comparison."""
    return tuple(sorted(f.name for f in dataclasses.fields(cls)))


# Canonical forms of *hashable* immutable values (frozen dataclasses:
# specs, mapping/reshape descriptions, hardware units) recur across every
# job of a sweep — memoise them.  Keyed by (type, value) so equal values
# of different classes never collide; bounded FIFO so mask-sized oddities
# can't grow without bound.  Forms are plain JSON-able structures built
# once, so sharing them across jobs cannot change any key.
_CANON_MEMO: "OrderedDict[tuple, object]" = OrderedDict()
_CANON_MEMO_CAPACITY = 4096


def canonical(obj) -> object:
    """Reduce ``obj`` to a JSON-serialisable canonical form.

    Deterministic across processes and runs (no ``id``/``hash`` leakage):
    dataclasses become ``[class-name, [(field, value), ...]]`` with fields
    sorted by name, dicts are sorted by stringified key, and numpy arrays
    carry dtype + shape + values.
    """
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        # repr round-trips exactly and avoids JSON float surprises
        return ["f", repr(obj)]
    if isinstance(obj, CalibrationProfile):
        # key by the profile's own content address (physical parameters
        # only): two fits that agree on peaks/efficiencies are the same
        # profile for every consumer, however their provenance/residual
        # metadata differs — they must hit the same cache entries.
        return ["CalibrationProfile", obj.content_hash()]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        memo_key = None
        # never hash an ExploreJob here: its __hash__ routes through
        # content_key → canonical and would recurse
        if not isinstance(obj, ExploreJob):
            try:
                memo_key = (type(obj), obj)
                hit = _CANON_MEMO.get(memo_key)
                if hit is not None:
                    return hit
            except TypeError:                   # unhashable (mutable) field
                memo_key = None
        form = [type(obj).__name__,
                [(name, canonical(getattr(obj, name)))
                 for name in _sorted_field_names(type(obj))]]
        if memo_key is not None:
            _CANON_MEMO[memo_key] = form
            while len(_CANON_MEMO) > _CANON_MEMO_CAPACITY:
                _CANON_MEMO.popitem(last=False)
        return form
    if isinstance(obj, np.ndarray):
        # digest raw bytes: mask-sized arrays would be prohibitively slow
        # to serialise element-wise, and keying only needs content equality
        arr = np.ascontiguousarray(obj)
        return ["ndarray", str(arr.dtype), list(arr.shape),
                hashlib.sha256(arr.tobytes()).hexdigest()]
    if isinstance(obj, np.generic):
        return canonical(obj.item())
    if isinstance(obj, (list, tuple)):
        return [canonical(v) for v in obj]
    if isinstance(obj, dict):
        return ["dict", sorted((str(k), canonical(v)) for k, v in obj.items())]
    if isinstance(obj, Workload):
        return ["Workload", obj.name, obj.source_digest,
                [(name, canonical(node)) for name, node in obj.nodes.items()]]
    raise TypeError(f"cannot canonicalise {type(obj).__name__!r} for job keying")


def content_key(obj) -> str:
    """Stable hex digest of ``obj``'s canonical form."""
    payload = json.dumps(["v", CACHE_SCHEMA, canonical(obj)],
                         separators=(",", ":"), sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()


@dataclasses.dataclass(frozen=True, eq=False)
class ExploreJob:
    """One simulator evaluation, as pure data.

    ``kind`` selects the evaluation: ``"simulate"`` runs the sparse cost
    model as configured; ``"dense"`` disables the sparsity-support
    hardware and expects ``workload`` to already be the stripped dense
    twin (see :func:`dense_job`), so that every grid point sharing a
    baseline maps onto the *same* cache key.

    ``input_sparsity`` is stored as a sorted tuple of pairs (hashable);
    ``masks`` maps op name → FullBlock keep-grid from the pruning
    workflow and participates in the key via array content.
    ``profile`` is an optional measured calibration profile
    (:mod:`repro_torch.calibrate`); it scales the simulator's latency terms,
    so it is part of the job's content — analytic and calibrated
    evaluations of the same design never share a cache entry.
    ``schedule`` is the multi-macro scheduling policy
    (:class:`repro_torch.core.schedule.SchedulePolicy`); it reshapes the
    report's timing (and, for resident, the amortised weight traffic),
    so it joins the canonical key.  The convenience constructors
    normalise the explicit default ``SchedulePolicy()`` to ``None`` so
    monolithic×1 jobs share one cache entry however they were spelled.
    """

    kind: str                                   # 'simulate' | 'dense'
    arch: CIMArch
    workload: Workload
    mapping: MappingSpec
    input_sparsity: Optional[Tuple[Tuple[str, float], ...]] = None
    masks: Optional[Tuple[Tuple[str, np.ndarray], ...]] = None
    profile: Optional[CalibrationProfile] = None
    schedule: Optional[SchedulePolicy] = None

    def __post_init__(self):
        if self.kind not in ("simulate", "dense"):
            raise ValueError(f"unknown job kind {self.kind!r}")

    @property
    def key(self) -> str:
        """Content-addressed cache key (memoised per instance)."""
        k = self.__dict__.get("_key")
        if k is None:
            k = content_key(self)
            object.__setattr__(self, "_key", k)
        return k

    def __hash__(self) -> int:
        return hash(self.key)

    def __eq__(self, other) -> bool:
        return isinstance(other, ExploreJob) and self.key == other.key

    # -- convenience constructors -------------------------------------------
    @staticmethod
    def _norm_schedule(schedule: Optional[SchedulePolicy]
                       ) -> Optional[SchedulePolicy]:
        return None if schedule == SchedulePolicy() else schedule

    @staticmethod
    def simulate(arch: CIMArch, workload: Workload, mapping: MappingSpec, *,
                 input_sparsity: Optional[Dict[str, float]] = None,
                 masks: Optional[Dict[str, np.ndarray]] = None,
                 profile: Optional[CalibrationProfile] = None,
                 schedule: Optional[SchedulePolicy] = None) -> "ExploreJob":
        return ExploreJob(
            kind="simulate", arch=arch, workload=workload, mapping=mapping,
            input_sparsity=(tuple(sorted(input_sparsity.items()))
                            if input_sparsity else None),
            masks=tuple(sorted(masks.items())) if masks else None,
            profile=profile,
            schedule=ExploreJob._norm_schedule(schedule),
        )

    @staticmethod
    def dense(arch: CIMArch, workload: Workload, mapping: MappingSpec,
              profile: Optional[CalibrationProfile] = None,
              schedule: Optional[SchedulePolicy] = None) -> "ExploreJob":
        """Dense-baseline job: sparsity stripped, support hardware off.

        Stripping happens *here* (via :func:`~repro_torch.core.costmodel.dense_twin`,
        the same helper ``dense_baseline`` uses) so that e.g. every ratio
        of a pattern sweep keys its baseline identically and pays for it
        once.
        """
        from ..core.costmodel import dense_twin

        dense_arch, dense_wl = dense_twin(arch, workload)
        return ExploreJob(kind="dense", arch=dense_arch, workload=dense_wl,
                          mapping=mapping, profile=profile,
                          schedule=ExploreJob._norm_schedule(schedule))
