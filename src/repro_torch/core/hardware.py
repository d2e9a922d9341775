"""Hardware description interface (paper §IV-C, Fig. 5(b)).

Copy of ``repro.core.hardware``: the port never imports the JAX package.

A CIM architecture is a collection of *compute units* and *memory units*
organised around multi-macro CIM arrays.  Users provide per-access /
per-cycle energies (from synthesis flows or tools like PCACTI); CIMinus
infers unit counts from the array size, unit size, and the organisation
parameter, and tracks access counts during simulation.

Units modelled (digital SRAM-CIM paradigm):

* ``cim_array``     — the bit-serial MAC array (per sub-array per cycle)
* ``adder_tree``    — column-wise partial-sum reduction across sub-arrays
* ``shift_add``     — bit-significance accumulation per output column
* ``accumulator``   — cross-tile partial-sum accumulation
* ``pre_proc``      — bit-serial conversion of inputs (+ zero-bit detect)
* ``post_proc``     — activation / pooling / residual etc.
* ``mux_index``     — IntraBlock input-select multiplexers (§IV-C ③)
* ``sparse_accum``  — misaligned partial-sum accumulation for FullBlock

Memory units: weight/input/output global buffers (optionally ping-pong),
per-macro local buffers, and index memories for sparsity support.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

__all__ = [
    "ComputeUnit",
    "MemoryUnit",
    "MacroSpec",
    "CIMArch",
]


@dataclasses.dataclass(frozen=True)
class ComputeUnit:
    """A compute unit type with per-access dynamic energy.

    ``energy_pj``: dynamic energy per access (pJ).
    ``static_pw_mw``: static power (mW) — charged for the whole runtime.
    ``width``: elements processed per access.
    ``location``: 'macro' (instanced per macro) or 'system'.
    """

    name: str
    energy_pj: float
    static_pw_mw: float = 0.0
    width: int = 1
    location: str = "macro"


@dataclasses.dataclass(frozen=True)
class MemoryUnit:
    """A memory unit with per-access read/write energies.

    ``width_bits``: access width (bits per read/write).
    ``capacity_bytes``: storage capacity; simulation checks footprints.
    ``ping_pong``: double-buffered — loads overlap compute (§IV-C ②).
    """

    name: str
    capacity_bytes: int
    width_bits: int
    read_pj: float
    write_pj: float
    static_pw_mw: float = 0.0
    ping_pong: bool = False
    location: str = "system"


@dataclasses.dataclass(frozen=True)
class MacroSpec:
    """Geometry of one CIM macro.

    ``rows × cols`` weight elements, tiled into ``sub_rows × sub_cols``
    sub-arrays.  Digital CIM: all rows activate simultaneously.

    ``load_rows_per_cycle``: SRAM write parallelism when loading weights.
    ``mac_cycles_per_bit``: array cycles per input bit position (1 for
    fully-pipelined bit-serial digital CIM).
    """

    rows: int
    cols: int
    sub_rows: int
    sub_cols: int
    weight_bits: int = 8
    input_bits: int = 8
    load_rows_per_cycle: int = 1
    mac_cycles_per_bit: int = 1
    # row-serial digital CIM (SDP-style row-granular macros with a shared
    # per-column MAC): compute time scales with RESIDENT weight rows, so
    # row pruning shortens execution even when the whole workload fits in
    # one wave.  Fully row-parallel macros (False) activate all rows at
    # once and only save whole waves.
    row_serial: bool = False

    def __post_init__(self):
        if self.rows % self.sub_rows or self.cols % self.sub_cols:
            raise ValueError(
                f"macro {self.rows}x{self.cols} not divisible into "
                f"sub-arrays {self.sub_rows}x{self.sub_cols}"
            )

    @property
    def n_subarrays(self) -> int:
        return (self.rows // self.sub_rows) * (self.cols // self.sub_cols)

    @property
    def weight_capacity_bits(self) -> int:
        return self.rows * self.cols * self.weight_bits


@dataclasses.dataclass(frozen=True)
class CIMArch:
    """A complete multi-macro CIM architecture description."""

    name: str
    macro: MacroSpec
    org: Tuple[int, int]                      # macro organisation (rows, cols)
    compute_units: Dict[str, ComputeUnit]
    memory_units: Dict[str, MemoryUnit]
    clock_ghz: float = 1.0
    weight_sparsity_support: bool = True
    input_sparsity_support: bool = False
    eval_scope: str = "all"                   # 'all' | 'conv_only' (Table I)

    # -- derived -----------------------------------------------------------
    @property
    def n_macros(self) -> int:
        return self.org[0] * self.org[1]

    @property
    def total_rows(self) -> int:
        return self.macro.rows * self.n_macros

    @property
    def cycle_ns(self) -> float:
        return 1.0 / self.clock_ghz

    def unit(self, name: str) -> ComputeUnit:
        return self.compute_units[name]

    def mem(self, name: str) -> MemoryUnit:
        return self.memory_units[name]

    def has_unit(self, name: str) -> bool:
        return name in self.compute_units

    def has_mem(self, name: str) -> bool:
        return name in self.memory_units

    def validate(self) -> None:
        required = ["cim_array", "shift_add", "adder_tree", "accumulator",
                    "pre_proc", "post_proc"]
        for r in required:
            if r not in self.compute_units:
                raise ValueError(f"architecture {self.name} missing unit {r!r}")
        if not any(m.name.startswith(("weight", "global", "input"))
                   for m in self.memory_units.values()):
            raise ValueError(f"architecture {self.name} has no input-side buffer")
        if self.weight_sparsity_support and not self.has_mem("index_mem"):
            raise ValueError(
                f"{self.name}: weight sparsity support requires an index_mem"
            )

    def replace(self, **kw) -> "CIMArch":
        return dataclasses.replace(self, **kw)

    def with_org(self, org: Tuple[int, int]) -> "CIMArch":
        return dataclasses.replace(self, org=org)

    # convenience: index memory sizing check for a workload (Eq. 8 totals)
    def index_capacity_bits(self) -> int:
        if not self.has_mem("index_mem"):
            return 0
        return self.mem("index_mem").capacity_bytes * 8

    def static_power_mw(self) -> float:
        """Aggregate static power across all instanced units (mW)."""
        p = 0.0
        for cu in self.compute_units.values():
            inst = self.n_macros if cu.location == "macro" else 1
            p += cu.static_pw_mw * inst
        for mu in self.memory_units.values():
            inst = self.n_macros if mu.location == "macro" else 1
            p += mu.static_pw_mw * inst
        return p
