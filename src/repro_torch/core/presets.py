"""Preset energy parameters and validation-target architectures.

Copy of ``repro.core.presets``: the port never imports the JAX package.

The paper obtains unit energies from ASIC synthesis (Design Compiler +
PTPX) and PCACTI; those flows are unavailable offline, so this module
ships a preset table consistent with the 28 nm digital-CIM literature the
paper builds on (the CIM array power model follows [24] Yan et al.,
ISSCC'22; buffer energies are PCACTI-class SRAM numbers).  Exactly like
the paper's own preset path ("CIMinus also provides a preset of energy
parameters ... for preliminary software-level explorations"), every value
is overridable by the user.

Energy unit: pJ per access.  Static power: mW.  Clock: 1 GHz.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .hardware import CIMArch, ComputeUnit, MacroSpec, MemoryUnit

__all__ = [
    "default_compute_units",
    "default_memory_units",
    "mars_arch",
    "sdp_arch",
    "usecase_arch",
    "PRESET_ARCHS",
]


# ---------------------------------------------------------------------------
# Per-access energies (pJ), 28nm-class digital CIM.
# cim_array: one bit-serial MAC cycle of one sub-array (all rows active).
# Scaled with sub-array size by the builders below.
# ---------------------------------------------------------------------------
_SRAM_RD_PJ_PER_BIT = 0.012     # PCACTI-class 28nm SRAM read, per bit
_SRAM_WR_PJ_PER_BIT = 0.014
_MAC_PJ_PER_CELL_BIT = 0.0023   # digital CIM MAC cell toggle energy [24]
_ADDER_PJ_PER_BIT = 0.003
_MUX_PJ = 0.0018                # per 8-bit input select
_PRE_PJ_PER_ELEM = 0.020        # bit-serial conversion, per 8b element
_POST_PJ_PER_ELEM = 0.032       # act/pool/residual per element


def default_compute_units(macro: MacroSpec) -> Dict[str, ComputeUnit]:
    sub_cells = macro.sub_rows * macro.sub_cols
    cols = macro.cols
    return {
        "cim_array": ComputeUnit(
            "cim_array",
            energy_pj=_MAC_PJ_PER_CELL_BIT * sub_cells,
            # static leakage scales with CELL count (4.4 nW/cell at 28nm
            # digital CIM), not sub-array count — row-granular macros
            # (SDP's 1×64) would otherwise be charged 64× too much
            static_pw_mw=4.4e-6 * macro.rows * macro.cols,
            width=sub_cells,
            location="macro",
        ),
        "adder_tree": ComputeUnit(
            "adder_tree",
            energy_pj=_ADDER_PJ_PER_BIT * 16 * (macro.rows // macro.sub_rows),
            static_pw_mw=0.006,
            width=cols,
            location="macro",
        ),
        "shift_add": ComputeUnit(
            "shift_add",
            energy_pj=_ADDER_PJ_PER_BIT * 24,
            static_pw_mw=0.004,
            width=cols,
            location="macro",
        ),
        "accumulator": ComputeUnit(
            "accumulator",
            energy_pj=_ADDER_PJ_PER_BIT * 32,
            static_pw_mw=0.003,
            width=cols,
            location="macro",
        ),
        "pre_proc": ComputeUnit(
            "pre_proc", energy_pj=_PRE_PJ_PER_ELEM, static_pw_mw=0.010,
            width=1, location="system",
        ),
        "post_proc": ComputeUnit(
            # 64-lane SIMD post-processing datapath; energy is per element.
            "post_proc", energy_pj=_POST_PJ_PER_ELEM, static_pw_mw=0.015,
            width=64, location="system",
        ),
        # sparsity-support units (§IV-C ③)
        "mux_index": ComputeUnit(
            "mux_index", energy_pj=_MUX_PJ, static_pw_mw=0.002,
            width=1, location="macro",
        ),
        "sparse_accum": ComputeUnit(
            "sparse_accum", energy_pj=_ADDER_PJ_PER_BIT * 32,
            static_pw_mw=0.002, width=1, location="macro",
        ),
        "zero_detect": ComputeUnit(
            "zero_detect", energy_pj=0.0009, static_pw_mw=0.001,
            width=1, location="system",
        ),
    }


def default_memory_units(
    *,
    weight_kb: int = 128,
    input_kb: Optional[int] = None,
    output_kb: Optional[int] = None,
    unified: bool = False,
    ping_pong: bool = False,
    index_kb: int = 16,
    local_kb: int = 4,
    width_bits: int = 256,
) -> Dict[str, MemoryUnit]:
    def sram(name, kb, pp=False, loc="system"):
        cap = kb * 1024
        return MemoryUnit(
            name,
            capacity_bytes=cap,
            width_bits=width_bits,
            read_pj=_SRAM_RD_PJ_PER_BIT * width_bits * (1.0 + 0.08 * (kb / 64)),
            write_pj=_SRAM_WR_PJ_PER_BIT * width_bits * (1.0 + 0.08 * (kb / 64)),
            static_pw_mw=0.020 * kb / 16,
            ping_pong=pp,
            location=loc,
        )

    mems: Dict[str, MemoryUnit] = {}
    if unified:
        mems["global_buf"] = sram("global_buf", weight_kb, pp=ping_pong)
    else:
        mems["weight_buf"] = sram("weight_buf", weight_kb, pp=ping_pong)
        mems["input_buf"] = sram("input_buf", input_kb or weight_kb)
        mems["output_buf"] = sram("output_buf", output_kb or weight_kb // 2)
    mems["local_buf"] = sram("local_buf", local_kb, loc="macro")
    mems["index_mem"] = sram("index_mem", index_kb)
    return mems


# ---------------------------------------------------------------------------
# Validation targets (paper Table I)
# ---------------------------------------------------------------------------

def mars_arch() -> CIMArch:
    """MARS [19]: 1024×64 macro, 64×64 sub-arrays, 8 macros (2×4),
    128 KB ping-pong global buffer, FullBlock(1,16) sparsity, Conv layers
    only."""
    macro = MacroSpec(rows=1024, cols=64, sub_rows=64, sub_cols=64,
                      weight_bits=8, input_bits=8, load_rows_per_cycle=4)
    arch = CIMArch(
        name="mars",
        macro=macro,
        org=(2, 4),
        compute_units=default_compute_units(macro),
        memory_units=default_memory_units(
            weight_kb=128, unified=True, ping_pong=True, index_kb=8),
        clock_ghz=0.2,
        weight_sparsity_support=True,
        input_sparsity_support=False,
        eval_scope="conv_only",
    )
    arch.validate()
    return arch


def sdp_arch() -> CIMArch:
    """SDP [20]: 32×64 macro, 1×64 sub-arrays (row-granular digital CIM),
    512 macros (16×32), 256 KB input + 128 KB output buffers,
    IntraBlock(2,1)+FullBlock(2,8) sparsity, entire NN."""
    macro = MacroSpec(rows=32, cols=64, sub_rows=1, sub_cols=64,
                      weight_bits=8, input_bits=8, load_rows_per_cycle=2,
                      row_serial=True)
    arch = CIMArch(
        name="sdp",
        macro=macro,
        org=(16, 32),
        compute_units=default_compute_units(macro),
        memory_units=default_memory_units(
            weight_kb=128, input_kb=256, output_kb=128,
            unified=False, ping_pong=True, index_kb=32),
        clock_ghz=0.5,
        weight_sparsity_support=True,
        input_sparsity_support=True,
        eval_scope="all",
    )
    arch.validate()
    return arch


def usecase_arch(n_macros: int = 4, org: Optional[Tuple[int, int]] = None,
                 *, input_sparsity: bool = False) -> CIMArch:
    """§VII-A exploration architecture: 8-bit, 1024×32 macro with 32×32
    sub-arrays, weight-stationary; 4 macros (sparsity study) or 16 macros
    (mapping study) with configurable organisation."""
    if org is None:
        org = {4: (2, 2), 16: (4, 4)}.get(n_macros, (1, n_macros))
    if org[0] * org[1] != n_macros:
        raise ValueError(f"org {org} != n_macros {n_macros}")
    macro = MacroSpec(rows=1024, cols=32, sub_rows=32, sub_cols=32,
                      weight_bits=8, input_bits=8, load_rows_per_cycle=4)
    arch = CIMArch(
        name=f"usecase-{n_macros}m",
        macro=macro,
        org=org,
        compute_units=default_compute_units(macro),
        memory_units=default_memory_units(
            weight_kb=256, input_kb=128, output_kb=64,
            unified=False, ping_pong=True, index_kb=32),
        clock_ghz=0.5,
        weight_sparsity_support=True,
        input_sparsity_support=input_sparsity,
        eval_scope="all",
    )
    arch.validate()
    return arch


PRESET_ARCHS = {
    "mars": mars_arch,
    "sdp": sdp_arch,
    "usecase4": lambda: usecase_arch(4),
    "usecase16": lambda: usecase_arch(16),
}
