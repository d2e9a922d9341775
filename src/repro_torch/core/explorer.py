"""Design-space exploration sweeps (paper §VII use-cases).

Copy of ``repro.core.explorer``: the port never imports the JAX package.

Compatibility layer: the sweep logic lives in :mod:`repro_torch.explore`, a
job-based engine with content-addressed result caching and process
fan-out.  These wrappers keep the original signatures and row schema;
they run the engine sequentially (``workers=1``) so callers that never
opted into parallelism see identical behaviour, while still getting
baseline deduplication for free.

Pass ``workers``/``runner`` to fan a sweep out or to share a result
cache across sweeps — or use :mod:`repro_torch.explore` directly for Pareto
frontiers, top-k tables, and CSV/JSON export.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .flexblock import FlexBlockSpec
from .hardware import CIMArch
from .mapping import MappingSpec
from .workload import Workload

__all__ = ["sweep_sparsity", "sweep_mappings", "sweep_orgs"]


def sweep_sparsity(
    arch: CIMArch,
    workload_fn: Callable[[], Workload],
    patterns: Dict[str, FlexBlockSpec],
    *,
    ratios: Sequence[float] = (0.5, 0.6, 0.7, 0.8, 0.9),
    mapping: Optional[MappingSpec] = None,
    pattern_factory: Optional[Callable[[float], Dict[str, FlexBlockSpec]]] = None,
    input_sparsity: Optional[Dict[str, float]] = None,
    schedule=None,
    workers: Optional[int] = 1,
    runner=None,
) -> List[Dict]:
    """§VII-B: sparsity pattern × ratio grid on one architecture."""
    from ..explore import sparsity_sweep

    return sparsity_sweep(
        arch, workload_fn, patterns, ratios=ratios, mapping=mapping,
        pattern_factory=pattern_factory, input_sparsity=input_sparsity,
        schedule=schedule, workers=workers, runner=runner,
    ).rows


def sweep_mappings(
    arch_fn: Callable[[Tuple[int, int]], CIMArch],
    workload_fn: Callable[[], Workload],
    spec: FlexBlockSpec,
    *,
    orgs: Sequence[Tuple[int, int]] = ((8, 2), (4, 4), (2, 8)),
    strategies: Sequence[str] = ("spatial", "duplicate"),
    rearrange: Sequence[Optional[str]] = (None,),
    schedule=None,
    workers: Optional[int] = 1,
    runner=None,
) -> List[Dict]:
    """§VII-C: mapping strategy × macro organisation (× rearrangement)."""
    from ..explore import mapping_sweep

    return mapping_sweep(
        arch_fn, workload_fn, spec, orgs=orgs, strategies=strategies,
        rearrange=rearrange, schedule=schedule, workers=workers,
        runner=runner,
    ).rows


def sweep_orgs(
    arch_fn: Callable[[Tuple[int, int]], CIMArch],
    workload_fn: Callable[[], Workload],
    spec: FlexBlockSpec,
    orgs: Sequence[Tuple[int, int]],
    strategy: str = "spatial",
    **kw,
) -> List[Dict]:
    return sweep_mappings(arch_fn, workload_fn, spec, orgs=orgs,
                          strategies=(strategy,), **kw)
