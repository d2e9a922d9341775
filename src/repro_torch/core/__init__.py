"""CIMinus core of the port: copies of the reference's modeling plane.

The FlexBlock specs, hardware description, workload DAG, mapping,
scheduling, cost model and the exploration sweeps' wrappers
(:mod:`.explorer`, over :mod:`repro_torch.explore`) are host-side numpy
analytics, copied from ``repro.core`` so the port imports nothing of the
JAX package; the names below are the reference's.  Pruning (:mod:`.pruning`)
and input-sparsity profiling (:mod:`.input_sparsity`) hold the port's
tensor ops, which import torch and the kernels when they are called, so
the package imports without torch.
"""
from .flexblock import (FlexBlockSpec, FullBlock, IntraBlock, TABLE_II_PATTERNS,
                        channel_wise, column_block, column_wise, dense_spec,
                        hybrid, row_block, row_wise)
from .hardware import CIMArch, ComputeUnit, MacroSpec, MemoryUnit
from .mapping import (MappingSpec, ReshapeSpec, default_mapping,
                      duplicate_mapping, reshape_and_compress, spatial_mapping)
from .costmodel import (compare, dense_baseline, dense_twin, simulate,
                        simulate_reference)
from .report import CostReport, OpCost
from .schedule import (POLICIES, OpExec, SchedulePolicy, ScheduledOp,
                       ScheduleResult, build_schedule, critical_path)
from .workload import (MODEL_BUILDERS, OpNode, Workload, lm_workload,
                       mobilenet_v2, resnet18, resnet50, vgg16)
from .presets import mars_arch, sdp_arch, usecase_arch, PRESET_ARCHS
from .explorer import sweep_mappings, sweep_orgs, sweep_sparsity

# Mask generation (§IV-D) and input-sparsity profiling (§IV-B) run on
# tensors on their own device; torch loads when they are first called.
from .pruning import (block_losses, flexblock_mask, fullblock_mask,
                      intrablock_mask, prune_matrix)
from .input_sparsity import (analytic_skip_ratio, profile_activations,
                             quantize_int8, skippable_bit_ratio)

__all__ = [
    # flexblock
    "FlexBlockSpec", "FullBlock", "IntraBlock", "TABLE_II_PATTERNS",
    "channel_wise", "column_block", "column_wise", "dense_spec", "hybrid",
    "row_block", "row_wise",
    # hardware
    "CIMArch", "ComputeUnit", "MacroSpec", "MemoryUnit",
    "mars_arch", "sdp_arch", "usecase_arch", "PRESET_ARCHS",
    # mapping
    "MappingSpec", "ReshapeSpec", "default_mapping", "duplicate_mapping",
    "reshape_and_compress", "spatial_mapping",
    # cost model
    "compare", "dense_baseline", "dense_twin", "simulate",
    "simulate_reference", "CostReport", "OpCost",
    # scheduling
    "POLICIES", "OpExec", "SchedulePolicy", "ScheduledOp", "ScheduleResult",
    "build_schedule", "critical_path",
    # pruning
    "block_losses", "flexblock_mask", "fullblock_mask", "intrablock_mask",
    "prune_matrix",
    # workload
    "MODEL_BUILDERS", "OpNode", "Workload", "lm_workload", "mobilenet_v2",
    "resnet18", "resnet50", "vgg16",
    # input sparsity
    "analytic_skip_ratio", "profile_activations", "quantize_int8",
    "skippable_bit_ratio",
    # explorer
    "sweep_mappings", "sweep_orgs", "sweep_sparsity",
]
