"""CIMinus design-space exploration engine (paper §VII use-cases).

Copy of ``repro.explore``: the port never imports the JAX package.  The plane is host-side numpy, as
the cost model it drives; the card reaches it through the calibration
profiles that price calibrated sweeps (``--profile``).

A job-based sweep runner over the cost model in :mod:`repro_torch.core`:

* :mod:`repro_torch.explore.job`    — hashable, content-addressed ``ExploreJob``
* :mod:`repro_torch.explore.cache`  — memory + on-disk result memoisation
* :mod:`repro_torch.explore.runner` — dedup / cache / process fan-out with
  deterministic row ordering
* :mod:`repro_torch.explore.batch`  — batched evaluation: variant groups share
  one costing pass, bit-identical to per-point results
* :mod:`repro_torch.explore.search` — guided search policies (exhaustive /
  successive halving / evolutionary) over lazily-indexed point spaces
* :mod:`repro_torch.explore.sweeps` — the paper's §VII-B/§VII-C grids as jobs,
  plus streaming evaluation for million-point runs
* :mod:`repro_torch.explore.pareto` — Pareto frontiers and top-k tables,
  one-shot and incremental

CLI: ``python -m repro_torch.explore <sweep> [options]`` runs a named sweep
and emits CSV/JSON (see ``--help``).

The legacy ``repro_torch.core.explorer`` sweeps remain as thin compatibility
wrappers over this engine.
"""
from . import faults
from .batch import evaluate_batch, group_jobs, job_keys, plan_batches
from .cache import (STORE_SCHEMA, CacheStats, KeyJournal, ResultCache,
                    ResultStore, StoreError)
from .faults import FaultError, FaultPlan, parse_fault_spec
from .job import CACHE_SCHEMA, ExploreJob, canonical, content_key
from .pareto import (DEFAULT_OBJECTIVES, ParetoFront, StreamingTopK,
                     pareto_front, top_k)
from .runner import (JobFailure, RunStats, SweepFailure, SweepRunner,
                     evaluate_job)
from .search import (SEARCH_KINDS, PointSpace, SearchPolicy, SearchResult,
                     estimate_job, estimate_jobs, run_search)
from .sweeps import (GridPoint, StreamResult, SweepResult, mapping_sweep,
                     org_sweep, run_grid, schedule_sweep, sparsity_sweep,
                     stream_grid)

__all__ = [
    "CACHE_SCHEMA", "ExploreJob", "canonical", "content_key",
    "CacheStats", "ResultCache", "ResultStore", "KeyJournal",
    "StoreError", "STORE_SCHEMA",
    "RunStats", "SweepRunner", "evaluate_job",
    "JobFailure", "SweepFailure",
    "faults", "FaultPlan", "FaultError", "parse_fault_spec",
    "job_keys", "group_jobs", "plan_batches", "evaluate_batch",
    "SEARCH_KINDS", "SearchPolicy", "SearchResult", "PointSpace",
    "estimate_job", "estimate_jobs", "run_search",
    "GridPoint", "SweepResult", "StreamResult", "run_grid", "stream_grid",
    "sparsity_sweep", "mapping_sweep", "org_sweep", "schedule_sweep",
    "DEFAULT_OBJECTIVES", "pareto_front", "top_k",
    "ParetoFront", "StreamingTopK",
]
