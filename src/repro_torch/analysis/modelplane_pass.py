"""Model-plane validation: semantic checks over live ``Workload`` /
``OpNode`` / ``MappingSpec`` / ``CIMArch`` instances (copy of
``validate`` and its helpers in ``repro/analysis/modelplane_pass.py``;
the registered repo self-check pass over the sources is not part of the
serving path and is not copied).

:func:`validate` is the library API; :func:`repro_torch.analysis.preflight`
wraps it for ``ServeEngine``'s construction-time pre-flight.

Codes
-----
* ``CIM301`` (error) — dangling DAG edge (input names no op).
* ``CIM302`` (error) — dict-key / node-name mismatch (splice hazard).
* ``CIM303`` (error) — dependency cycle.
* ``CIM304`` (warning) — isolated op, disconnected from the DAG.
* ``CIM305`` (error) — zero/negative dims (K/N/V on MVM-shaped ops,
  negative ``elements``/``weight_count`` anywhere).
* ``CIM306`` (error) — sparsity spec incompatible with the op's matrix
  (block exceeds the K×N view, pattern cannot bind).
* ``CIM307`` — index-capacity feasibility (Eq. 8): per-op index
  footprint above ``index_capacity_bits`` is an error; declared weight
  sparsity on an arch without support is a warning.
* ``CIM308`` — macro-org feasibility: non-positive org axes (error);
  weight-side staging buffer smaller than one macro fill (warning).
* ``CIM309`` (error) — arch contract violations (missing required
  units, sparsity support without an index memory), surfaced from
  ``CIMArch.validate()`` as diagnostics.
* ``CIM310`` (error) — mapping contract violations (unknown strategy /
  flatten order / rearrange mode, ``slice`` without a positive
  ``slice_size``, bad org-axis assignment).
"""
from __future__ import annotations

from typing import List, Optional

from ..core.workload import MVM_KINDS
from .diagnostics import Diagnostic, Severity

__all__ = ["validate"]

_ISSUE_CODES = {
    "dangling-edge": ("CIM301", Severity.ERROR),
    "name-mismatch": ("CIM302", Severity.ERROR),
    "cycle": ("CIM303", Severity.ERROR),
    "isolated": ("CIM304", Severity.WARNING),
}

_PASS_NAME = "model-plane"


def _diag(code: str, severity: str, message: str, obj: str,
          hint: Optional[str] = None) -> Diagnostic:
    return Diagnostic(code=code, severity=severity, message=message,
                      pass_name=_PASS_NAME, obj=obj, hint=hint)


def _mvm_shaped(op) -> bool:
    return op.kind in MVM_KINDS or op.kind == "dwconv"


def _validate_structure(workload, prefix: str) -> List[Diagnostic]:
    out = []
    for issue in workload.validate():
        code, sev = _ISSUE_CODES[issue.kind]
        out.append(_diag(code, sev, issue.message,
                         obj=f"{prefix}.{issue.path}"))
    return out


def _validate_ops(workload, arch, prefix: str) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    index_cap = arch.index_capacity_bits() if arch is not None else 0
    for key, op in workload.nodes.items():
        obj = f"{prefix}.nodes[{key!r}]"
        # CIM305 — dims
        if _mvm_shaped(op):
            for dim in ("K", "N", "V"):
                v = getattr(op, dim)
                if v <= 0:
                    out.append(_diag(
                        "CIM305", Severity.ERROR,
                        f"{op.kind} op {key!r} has {dim}={v} "
                        f"(must be positive)", obj=f"{obj}.{dim}"))
        elif op.elements < 0:
            out.append(_diag(
                "CIM305", Severity.ERROR,
                f"{op.kind} op {key!r} has negative elements "
                f"({op.elements})", obj=f"{obj}.elements"))
        if op.weight_count is not None and op.weight_count < 0:
            out.append(_diag(
                "CIM305", Severity.ERROR,
                f"op {key!r} has negative weight_count "
                f"({op.weight_count})", obj=f"{obj}.weight_count"))

        spec = op.sparsity
        if spec is None or not _mvm_shaped(op) or op.K <= 0 or op.N <= 0:
            continue
        shape = (op.K, op.N)
        # CIM306 — spec must bind to the op's matrix view
        try:
            spec.bind(shape)
            spec.validate_for(shape)
        except (ValueError, ZeroDivisionError) as e:
            out.append(_diag(
                "CIM306", Severity.ERROR,
                f"sparsity spec incompatible with {key!r} "
                f"({op.K}x{op.N}): {e}", obj=f"{obj}.sparsity",
                hint="bind block sizes to the op shape (e.g. "
                     "channel_wise with the op's own c_in) or drop the "
                     "spec for this op"))
            continue
        # CIM307 — index-capacity feasibility (Eq. 8)
        if not spec.is_dense and arch is not None:
            if not arch.weight_sparsity_support:
                out.append(_diag(
                    "CIM307", Severity.WARNING,
                    f"op {key!r} declares weight sparsity but arch "
                    f"{arch.name!r} has no weight-sparsity support "
                    f"(weights will be stored dense)",
                    obj=f"{obj}.sparsity"))
            elif index_cap > 0:
                bits = spec.index_storage_bits(shape)
                if bits > index_cap:
                    out.append(_diag(
                        "CIM307", Severity.ERROR,
                        f"op {key!r} needs {bits} index bits but "
                        f"{arch.name!r} index_mem holds {index_cap}",
                        obj=f"{obj}.sparsity",
                        hint="coarsen the block pattern (fewer, larger "
                             "blocks) or grow index_mem"))
    return out


def _validate_arch(arch, prefix: str) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    try:
        arch.validate()
    except ValueError as e:
        out.append(_diag("CIM309", Severity.ERROR, str(e),
                         obj=f"{prefix}",
                         hint="see CIMArch.validate for the required "
                              "compute/memory unit set"))
    if arch.org[0] <= 0 or arch.org[1] <= 0:
        out.append(_diag(
            "CIM308", Severity.ERROR,
            f"arch {arch.name!r} has non-positive macro org {arch.org}",
            obj=f"{prefix}.org"))
    weight_bufs = [m for m in arch.memory_units.values()
                   if m.name.startswith("weight")]
    if weight_bufs:
        cap_bits = max(m.capacity_bytes for m in weight_bufs) * 8
        need = arch.macro.weight_capacity_bits
        if cap_bits < need:
            out.append(_diag(
                "CIM308", Severity.WARNING,
                f"arch {arch.name!r} weight buffer ({cap_bits} bits) "
                f"cannot stage one macro fill ({need} bits) — loads "
                f"will stall mid-wave", obj=f"{prefix}.memory_units"))
    return out


def _validate_mapping(mapping, prefix: str) -> List[Diagnostic]:
    out: List[Diagnostic] = []

    def bad(msg: str, path: str, hint: Optional[str] = None) -> None:
        out.append(_diag("CIM310", Severity.ERROR, msg,
                         obj=f"{prefix}.{path}", hint=hint))

    if mapping.strategy not in ("spatial", "duplicate"):
        bad(f"unknown mapping strategy {mapping.strategy!r}", "strategy",
            "valid strategies: 'spatial', 'duplicate'")
    if {mapping.k_axis, mapping.n_axis} != {0, 1}:
        bad(f"k_axis/n_axis must cover org axes 0 and 1, got "
            f"({mapping.k_axis}, {mapping.n_axis})", "k_axis")
    r = mapping.reshape
    if r.flatten_order not in ("channel_major", "kernel_major"):
        bad(f"unknown flatten_order {r.flatten_order!r}",
            "reshape.flatten_order")
    if r.compress_orient not in ("auto", "row", "col"):
        bad(f"unknown compress_orient {r.compress_orient!r}",
            "reshape.compress_orient")
    if r.rearrange not in (None, "pad", "slice"):
        bad(f"unknown rearrange mode {r.rearrange!r}", "reshape.rearrange")
    if r.rearrange == "slice" and r.slice_size <= 0:
        bad(f"rearrange='slice' needs a positive slice_size "
            f"(got {r.slice_size})", "reshape.slice_size")
    if r.tile is not None and (r.tile[0] <= 0 or r.tile[1] <= 0):
        bad(f"non-positive reshape tile {r.tile}", "reshape.tile")
    return out


def validate(workload, arch=None, mapping=None, *,
             prefix: str = "workload") -> List[Diagnostic]:
    """Semantic pre-flight over live model-plane objects.

    Returns all diagnostics (CIM301–CIM310); callers decide strictness —
    :func:`repro_torch.analysis.preflight` wraps the common raise/warn
    policy.  Cost is O(ops).
    """
    diags = _validate_structure(workload, prefix)
    diags += _validate_ops(workload, arch, prefix)
    if arch is not None:
        diags += _validate_arch(arch, prefix="arch")
    if mapping is not None:
        diags += _validate_mapping(mapping, prefix="mapping")
    return diags
