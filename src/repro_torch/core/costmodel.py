"""CIMinus cost model (paper §V).

Copy of ``repro.core.costmodel``: the port never imports the JAX package.

Latency: pipelined load / compute / write-back schedule per Eq. 3 —
``L_total = L1_load + Σ P_i(L_i^load, L_{i-1}^comp, L_{i-1}^wb) + L_n^comp
+ L_n^wb`` where ``P_i`` resolves to the pipeline bottleneck stage given
buffer double-buffering capabilities.

Energy: Eq. 4–7 — Σ per-access·access-count over compute units, read /
write energies over memory units, plus static power × total latency
(mW × ns ≡ pJ).

Sparsity-support overhead (§V-B): index-memory traffic and capacity
(Eq. 8), IntraBlock input-select multiplexers, misaligned partial-sum
accumulators, and pre-processing zero-bit detection for input sparsity.

The simulation tiles each MVM op via
:func:`repro.core.mapping.reshape_and_compress`, schedules tiles over the
macro organisation per the mapping strategy, and accumulates unit access
counts exactly (cycle-accurate at tile granularity, the level the paper
validates at).  How the *ops* share the organisation in time is the
scheduling layer's job (:mod:`repro.core.schedule`): :func:`simulate`
costs every op, builds scheduler-facing execution profiles, resolves the
:class:`~repro.core.schedule.SchedulePolicy` into a
:class:`~repro.core.schedule.ScheduleResult` (per-op start/end cycles,
critical path, macro shares), and reports the schedule's total.  The
default ``"monolithic"`` policy reproduces the historical op-serial walk
bit-for-bit (:func:`simulate_reference` retains that walk as the test
ground truth).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..calibrate.profile import CalibrationProfile
from . import mapping as _mapping
from .flexblock import FlexBlockSpec
from .hardware import CIMArch
from .mapping import (MappingSpec, TileGridCache, _band_stats_loop,
                      reshape_and_compress)
from .report import CostReport, OpCost
from .schedule import OpExec, SchedulePolicy, build_schedule
from . import workload as _workload
from .workload import OpNode, Workload

__all__ = ["simulate", "simulate_variants", "simulate_reference",
           "dense_baseline", "dense_twin", "compare", "op_class"]


def op_class(op: OpNode) -> str:
    """Map a workload op to a calibration op class.

    These are the classes the harvest plane measures
    (:func:`repro.calibrate.microbench_kernels`): attention-shaped MVMs
    (the ``attn_*`` *score/context* matmuls, ``kind="matmul"`` in
    :func:`~repro.core.workload.lm_workload` → the flash-attention
    kernel), every other MVM — including the ``attn_{q,k,v,o}``
    projections, which are plain ``fc`` GEMMs executed by the matmul
    kernels — and everything else on the post-processing unit.

    Traced workloads (:mod:`repro.trace`) emit activation×activation
    matmuls under generated names, so weight-free matmuls classify as
    attention regardless of naming — in the hand DAGs the only
    weight-free matmuls are the ``attn_*`` score/context GEMMs, so this
    is a pure generalisation.
    """
    if op.is_mvm or op.kind == "dwconv":
        if op.kind == "matmul" and (op.weights == 0
                                    or op.name.startswith("attn")):
            return "attention"
        return "matmul"
    return "post_proc"


@dataclasses.dataclass
class _Step:
    """One pipeline step: a tile-group loaded, computed, written back."""

    load: float
    comp: float
    wb: float


def _pipeline(steps: List[_Step], overlap: bool) -> float:
    """Eq. 3.  With double buffering (ping-pong weight buffer), step i's
    load overlaps step i-1's compute+write-back:
    ``P_i = max(L_i^load, L_{i-1}^comp + L_{i-1}^wb)``.  Without, stages
    serialise: ``P_i = L_i^load + L_{i-1}^comp + L_{i-1}^wb``."""
    if not steps:
        return 0.0
    if not overlap:
        return float(sum(s.load + s.comp + s.wb for s in steps))
    lat = steps[0].load
    for i in range(1, len(steps)):
        lat += max(steps[i].load, steps[i - 1].comp + steps[i - 1].wb)
    lat += steps[-1].comp + steps[-1].wb
    return float(lat)


_ACC, _READ, _WRITE = 0, 1, 2


class _OpLedger:
    """Per-op access-event buffer (same recording interface as
    :class:`_Accounting`).

    Per-op costing appends events here and :meth:`_Accounting.commit`
    absorbs them in one pass, so the shared ledger dicts see O(1) traffic
    per op instead of one guarded dict lookup per recording call.  Events
    apply in recorded order — float accumulation order (and therefore the
    energy breakdown) is bit-identical to calling the accounting methods
    directly.

    ``pinned`` marks traffic that a resident schedule pays once across
    repeated invocations (weight fill/loads, stored-once index
    metadata).  The flag rides on the event itself — keying on buffer
    *names* would misclassify activation traffic on unified-buffer
    arches, where weights and activations share one ``global_buf``.
    """

    __slots__ = ("events",)

    def __init__(self):
        self.events: List[tuple] = []

    def acc(self, unit: str, n: float) -> None:
        self.events.append((_ACC, unit, n, False))

    def read(self, mem: str, bits: float, *, pinned: bool = False) -> None:
        self.events.append((_READ, mem, bits, pinned))

    def write(self, mem: str, bits: float, *, pinned: bool = False) -> None:
        self.events.append((_WRITE, mem, bits, pinned))


class _Accounting:
    """Access-count ledger across all units."""

    def __init__(self, arch: CIMArch):
        self.arch = arch
        self.compute_acc: Dict[str, float] = {k: 0.0 for k in arch.compute_units}
        self.mem_rd: Dict[str, float] = {k: 0.0 for k in arch.memory_units}
        self.mem_wr: Dict[str, float] = {k: 0.0 for k in arch.memory_units}

    def acc(self, unit: str, n: float) -> None:
        if unit in self.compute_acc and n > 0:
            self.compute_acc[unit] += n

    def read(self, mem: str, bits: float) -> None:
        if mem in self.mem_rd and bits > 0:
            self.mem_rd[mem] += bits / self.arch.mem(mem).width_bits

    def write(self, mem: str, bits: float) -> None:
        if mem in self.mem_wr and bits > 0:
            self.mem_wr[mem] += bits / self.arch.mem(mem).width_bits

    def commit(self, ledger: _OpLedger, *, scale: float = 1.0,
               honor_pins: bool = False) -> None:
        """Absorb one op's buffered events in a single pass.

        ``scale`` multiplies every event — the schedule's invocation
        count (repeated DAG executions repeat every access).  With
        ``honor_pins`` (set for ops a resident schedule keeps loaded),
        events the ledger recorded as ``pinned`` commit once regardless:
        weight fill/loads and stored-once index metadata amortise across
        invocations while activation traffic keeps scaling.
        ``scale == 1.0`` leaves every value bit-for-bit untouched.
        """
        comp, rd, wr = self.compute_acc, self.mem_rd, self.mem_wr
        mems = self.arch.memory_units
        for kind, unit, val, pinned in ledger.events:
            if val <= 0:
                continue
            s = 1.0 if (pinned and honor_pins) else scale
            v = val if s == 1.0 else val * s
            if kind == _ACC:
                if unit in comp:
                    comp[unit] += v
            elif kind == _READ:
                if unit in rd:
                    rd[unit] += v / mems[unit].width_bits
            else:
                if unit in wr:
                    wr[unit] += v / mems[unit].width_bits

    def energy_breakdown(self, latency_cycles: float) -> Dict[str, float]:
        """Eq. 4–7, in pJ."""
        arch = self.arch
        out: Dict[str, float] = {}
        for name, cu in arch.compute_units.items():
            out[name] = cu.energy_pj * self.compute_acc[name]
        for name, mu in arch.memory_units.items():
            out[name] = (mu.read_pj * self.mem_rd[name]
                         + mu.write_pj * self.mem_wr[name])
        # Eq. 7: static energy = P_stat × L_total.  mW × ns = pJ.
        t_ns = latency_cycles * arch.cycle_ns
        out["static"] = arch.static_power_mw() * t_ns
        return out


def _input_buffer(arch: CIMArch) -> str:
    for cand in ("input_buf", "global_buf", "weight_buf"):
        if arch.has_mem(cand):
            return cand
    return next(iter(arch.memory_units))


def _weight_buffer(arch: CIMArch) -> str:
    for cand in ("weight_buf", "global_buf"):
        if arch.has_mem(cand):
            return cand
    return next(iter(arch.memory_units))


def _output_buffer(arch: CIMArch) -> str:
    for cand in ("output_buf", "global_buf", "input_buf"):
        if arch.has_mem(cand):
            return cand
    return next(iter(arch.memory_units))


def _macro_demand(bands: int, waves: int, n_macros: int,
                  bands_per_macro: int) -> int:
    """Macros an op's resident bands (incl. duplication replicas) occupy.

    Multi-wave ops cycle the whole organisation; single-wave ops occupy
    exactly the macros their bands pack into — the subset the
    partitioned scheduler may hand them without changing their cost.
    """
    if waves > 1:
        return n_macros
    return min(n_macros, max(1, math.ceil(bands / bands_per_macro)))


def _mvm_op_cost(
    op: OpNode,
    arch: CIMArch,
    mapping: MappingSpec,
    acct: _OpLedger,
    *,
    input_skip_ratio: float = 0.0,
    block_keep: Optional[np.ndarray] = None,
    tile_cache: Optional[TileGridCache] = None,
) -> OpCost:
    """Cost one MVM op with a *band-packing* schedule.

    Digital CIM accumulates partial sums per sub-array, so the placement
    granularity is a **band** of ``sub_rows`` array rows.  Each N-tile
    (``macro.cols`` output columns) with compressed row extent ``k_eff``
    demands ``ceil(k_eff / sub_rows)`` bands; bands from different tiles
    pack into the same macro (the adder tree + extra accumulators route
    their partial sums separately — §V-B's misaligned-aggregation
    support).  This is where CIM sparsity speedup actually comes from:

    * fewer bands ⇒ fewer waves when weights exceed array capacity;
    * leftover bands ⇒ weight-duplication headroom, splitting the input
      vectors across replicas (§VII-C weight duplication);
    * input sparsity ⇒ shorter effective bit-serial length.
    """
    macro = arch.macro
    grid = reshape_and_compress(op, arch, mapping.reshape,
                                block_keep=block_keep, cache=tile_cache)
    n_macros = arch.n_macros
    org_r, org_c = arch.org
    bands_per_macro = macro.rows // macro.sub_rows

    # ---- effective bit-serial length (input sparsity, §IV-C ③) ------------
    V = max(op.V, 1)
    eff_bits = float(macro.input_bits)
    if arch.input_sparsity_support and input_skip_ratio > 0.0:
        eff_bits = macro.input_bits * (1.0 - input_skip_ratio)
        # OR-tree zero detection scans every input element once per bit
        acct.acc("zero_detect", float(V) * grid.K)
    comp_cycles_per_vec = max(1.0, eff_bits * macro.mac_cycles_per_bit)

    # ---- band demand ---------------------------------------------------------
    # Per N-tile (width = macro.cols), the compressed row profile of its
    # columns sets its band demand; ragged profiles are charged at the
    # tile's max column (fragmentation — unless rearrangement equalised).
    tile_n = grid.tile_n
    nt = max(1, math.ceil(grid.n_eff / tile_n))
    k_cols = grid.k_eff if len(grid.k_eff) else np.array([grid.K])
    if _mapping._REFERENCE:
        bands_sum, n_band_tiles, row_demand, ragged = _band_stats_loop(
            grid.k_eff, grid.K, tile_n, macro.sub_rows)
    else:
        bands_sum, n_band_tiles, row_demand, ragged = grid.band_stats(
            macro.sub_rows)
    B = max(1, bands_sum)                     # total band demand
    # row_demand = Σ over N-tiles of the tile's mean real rows per column:
    # a tile's columns share its band rows, so the per-column mean is that
    # tile's real array-row footprint and the sum is the op's total real
    # row demand — the numerator of row-granular utilisation below.

    # ---- schedule -------------------------------------------------------------
    # spatial:   all macros hold distinct bands; no duplication.
    # duplicate: one org row's worth of macros holds the weights; the
    #            org[0] rows replicate them and split V.  Leftover bands
    #            within a wave add intra-wave duplication headroom.
    if mapping.strategy == "spatial":
        slots = n_macros * bands_per_macro
        waves = math.ceil(B / slots)
        dup = 1
    else:
        row_slots = org_c * bands_per_macro
        waves = math.ceil(B / row_slots)
        dup = org_r
        if waves == 1:
            dup = min(V, org_r * max(1, row_slots // B))
    v_eff = math.ceil(V / dup)

    # ---- per-wave latency (Eq. 3 inner pipeline) --------------------------------
    bands_this_wave = min(B, bands_per_macro)  # per macro, upper bound
    load_cycles = math.ceil(bands_this_wave * macro.sub_rows
                            / macro.load_rows_per_cycle)
    serial_rows = 1.0
    if macro.row_serial:
        # row-serial macros: each resident band is processed in sequence
        # by the shared per-column MAC → compute scales with resident
        # band count (this is where SDP's row-pruning speedup comes from).
        # IntraBlock column compression keeps the row count low but each
        # compressed row streams its ``intra_fanin`` broadcast candidates
        # bit-serially — the mux picks per-cell — so intra compression
        # saves ENERGY (fewer array rows) but not broadcast TIME.
        holders = n_macros if mapping.strategy == "spatial" else org_c
        serial_rows = float(min(bands_per_macro,
                                max(1, math.ceil(B / (waves * holders)))))
        serial_rows *= grid.intra_fanin
    comp_cycles = v_eff * comp_cycles_per_vec * serial_rows
    # partial sums accumulate on-chip (adder tree / accumulators); the
    # output buffer receives post-processed activation-quantized values
    out_bits_per_vec = tile_n * macro.input_bits
    wb_bus = arch.mem(_output_buffer(arch)).width_bits
    wb_cycles = math.ceil(v_eff * out_bits_per_vec / wb_bus)
    overlap = arch.mem(_weight_buffer(arch)).ping_pong
    steps = [_Step(load_cycles, comp_cycles, wb_cycles) for _ in range(waves)]
    lat = _pipeline(steps, overlap)

    # ---- compute-unit access counting --------------------------------------------
    # cim_array fires per (band × vector × bit); all V vectors pass through
    # some replica, so totals are duplication-invariant (dup trades time
    # for parallel energy) — but fragmentation (ceil to bands) costs real
    # energy, matching Fig. 9's alignment findings.
    subs_per_band = macro.cols // macro.sub_cols
    band_vec_cycles = float(B) * subs_per_band * V * comp_cycles_per_vec
    acct.acc("cim_array", band_vec_cycles)
    acct.acc("adder_tree", float(B) * V * comp_cycles_per_vec)
    acct.acc("shift_add", float(n_band_tiles or 1) * V)
    # cross-wave / cross-macro partial-sum accumulation
    k_span = max(1, math.ceil((int(k_cols.max()) if len(k_cols) else grid.K)
                              / macro.rows))
    if k_span > 1 or waves > 1:
        acct.acc("accumulator", float(max(k_span - 1, waves - 1)) * V
                 * max(grid.n_eff, 1) / max(nt, 1))

    # pre-processing: each input element bit-serial converted once per wave
    acct.acc("pre_proc", float(V) * grid.K)

    # ---- memory traffic -------------------------------------------------------------
    ibuf, wbuf, obuf = _input_buffer(arch), _weight_buffer(arch), _output_buffer(arch)
    w_bits = float(np.sum(grid.k_eff)) * macro.weight_bits
    # weight traffic is pinned: a resident schedule pays it once however
    # many invocations run (the activation traffic below always recurs)
    acct.write(wbuf, w_bits, pinned=True)         # filled once (off-chip DMA)
    acct.read(wbuf, w_bits * dup, pinned=True)    # array loads, × replicas
    # inputs: FullBlock row compression cuts traffic; IntraBlock does not
    # (each compressed row receives its intra_fanin broadcast candidates).
    mean_k = float(np.mean(k_cols)) if len(k_cols) else float(grid.K)
    in_bits = float(V) * mean_k * grid.intra_fanin * macro.input_bits
    acct.read(ibuf, in_bits)
    o_bits = float(V) * max(grid.n_eff, 1) * float(macro.input_bits)
    acct.write(obuf, o_bits)
    if k_span > 1:  # partial-sum spill/refill across K spans (32b wide)
        spill = float(V) * max(grid.n_eff, 1) * 32.0 * (k_span - 1)
        acct.read(obuf, spill)
        acct.write(obuf, spill)

    # ---- sparsity support (§V-B) ------------------------------------------------------
    spec: FlexBlockSpec = op.sparsity.bind((op.K, op.N))
    idx_bits = 0
    if not spec.is_dense and arch.weight_sparsity_support:
        idx_bits = spec.index_storage_bits((op.K, op.N))          # Eq. 8
        acct.write("index_mem", float(idx_bits), pinned=True)     # stored once
        acct.read("index_mem", float(idx_bits))                   # streamed once/op
        if grid.intra_fanin > 1 and len(k_cols):
            # mux select: every compressed row picks 1-of-fanin per vector
            acct.acc("mux_index", mean_k * V)
        if grid.misaligned or ragged:
            acct.acc("sparse_accum", float(V) * max(grid.n_eff, 1))

    # utilisation: real weight rows (× replicas) over provisioned capacity
    provisioned = waves * (n_macros * bands_per_macro) * macro.sub_rows
    util = min(1.0, row_demand * dup / max(provisioned, 1))
    # scheduling metadata: the op's resident band footprint (replicas
    # included) and the macros those bands actually occupy — the demand
    # the partitioned scheduler packs disjoint subsets from (an op never
    # benefited from macros its bands don't touch, so granting exactly
    # this share leaves latency and access counts untouched).
    bands_resident = B * dup
    m_need = _macro_demand(bands_resident, waves, n_macros, bands_per_macro)
    return OpCost(name=op.name, kind=op.kind, latency_cycles=lat,
                  macs=op.macs, tiles=n_band_tiles or 1, waves=waves,
                  utilization=util, index_bits=idx_bits,
                  occupancy=grid.mean_occupancy,
                  bands=bands_resident, load_cycles=float(load_cycles),
                  macros=m_need, macro_share=m_need / n_macros)


def _other_op_cost(op: OpNode, arch: CIMArch, acct: _OpLedger) -> OpCost:
    """Non-MVM ops (pool / act / add / norm / embed / …) run on post_proc.

    Buffer traffic is priced at the macro's activation width
    (``macro.input_bits``) — post-processing consumes/produces the same
    quantised activations the arrays chew, so 4-bit / 16-bit arch sweeps
    see consistently scaled post-proc traffic.

    Kinds outside :data:`repro.core.workload.OTHER_KINDS` (traced graphs
    surface fused elementwise primitives the hand DAGs never emit) warn
    once and are priced exactly like plain elementwise work — an
    explicit, visible fallback rather than a crash or silent zero.
    """
    _workload.warn_unknown_kind(op.kind)
    post = arch.unit("post_proc")
    act_bits = float(arch.macro.input_bits)
    n = max(op.elements, 1)
    cycles = math.ceil(n / max(post.width, 1))
    acct.acc("post_proc", float(n))
    acct.read(_input_buffer(arch), float(n) * act_bits)
    acct.write(_output_buffer(arch), float(n) * act_bits)
    if op.kind == "embed":
        acct.read(_weight_buffer(arch), float(n) * act_bits)
    return OpCost(name=op.name, kind=op.kind, latency_cycles=float(cycles),
                  macs=0, tiles=0, waves=0, utilization=0.0, index_bits=0,
                  occupancy=0.0)


def _cost_ops(
    arch: CIMArch,
    workload: Workload,
    mapping: MappingSpec,
    *,
    input_sparsity: Optional[Dict[str, float]],
    masks: Optional[Dict[str, np.ndarray]],
    profile: Optional[CalibrationProfile],
    tile_cache: Optional[TileGridCache],
) -> List[Tuple[OpNode, Optional[OpCost], _OpLedger]]:
    """Per-op costing pass, shared by :func:`simulate` and
    :func:`simulate_reference` so the scheduling layer can be proved
    behavior-preserving against the retained op-serial aggregation.

    Returns ``(op, OpCost | None, ledger)`` triples in DAG insertion
    order; ``None`` marks ops outside the arch's ``eval_scope`` (Table
    I's conv-only setups), which carry zero cost and only convey
    dependencies.
    """
    scoped = {o.name for o in workload.mvm_ops(arch.eval_scope)}
    out: List[Tuple[OpNode, Optional[OpCost], _OpLedger]] = []
    for op in workload.nodes.values():
        led = _OpLedger()
        if (op.is_mvm or op.kind == "dwconv") and op.name in scoped:
            oc = _mvm_op_cost(op, arch, mapping, led,
                              input_skip_ratio=(input_sparsity or {}).get(op.name, 0.0),
                              block_keep=(masks or {}).get(op.name),
                              tile_cache=tile_cache)
        elif arch.eval_scope == "conv_only":
            # Table I: MARS evaluates conv layers only — everything else
            # is outside the measured scope entirely.
            oc = None
        else:
            oc = _other_op_cost(op, arch, led)
        if oc is not None and profile is not None:
            eff = profile.efficiency_for(op_class(op))
            if eff != 1.0:
                oc.latency_cycles /= eff
                oc.load_cycles /= eff
        out.append((op, oc, led))
    return out


def _op_execs(arch: CIMArch,
              costed: List[Tuple[OpNode, Optional[OpCost], _OpLedger]],
              ) -> Dict[str, OpExec]:
    """Scheduler-facing execution profiles for every DAG node."""
    execs: Dict[str, OpExec] = {}
    for op, oc, _ in costed:
        if oc is None:
            execs[op.name] = OpExec(name=op.name, duration=0.0)
        elif oc.tiles > 0:                   # MVM on the CIM organisation
            # single-wave pipelines are load+comp+wb, so hoisting the
            # load (resident steady state) subtracts it exactly
            steady = (oc.latency_cycles - oc.load_cycles
                      if oc.waves <= 1 else oc.latency_cycles)
            execs[op.name] = OpExec(
                name=op.name, duration=oc.latency_cycles, steady=steady,
                load_cycles=oc.load_cycles, macros=oc.macros,
                bands=oc.bands, waves=oc.waves)
        else:                                # post-processing unit
            execs[op.name] = OpExec(name=op.name,
                                    duration=oc.latency_cycles,
                                    steady=oc.latency_cycles,
                                    uses_post=True)
    return execs


def _finish_report(
    arch: CIMArch,
    workload: Workload,
    mapping: MappingSpec,
    policy: SchedulePolicy,
    costed: List[Tuple[OpNode, Optional[OpCost], _OpLedger]],
) -> CostReport:
    """Schedule + aggregate one costed op list into a :class:`CostReport`.

    This is :func:`simulate`'s tail, factored out so
    :func:`simulate_variants` can re-aggregate ONE ``_cost_ops`` pass
    under several ``(profile, schedule)`` variants.  Every float
    operation happens in the same order as the historical inline code,
    so the extraction is bit-identical by construction.  Mutates the
    ``OpCost`` objects in ``costed`` (start/end cycles) — variant
    callers must pass per-variant copies.
    """
    bands_per_macro = arch.macro.rows // arch.macro.sub_rows
    sched = build_schedule(workload, policy, _op_execs(arch, costed),
                           n_macros=arch.n_macros,
                           band_slots=arch.n_macros * bands_per_macro)

    # mirror placements onto the per-op costs (steady-state invocation;
    # the resident preload sits before cycle 0 of this timeline)
    placed = {s.name: s for s in sched.ops}
    op_costs: List[OpCost] = []
    for op, oc, _ in costed:
        if oc is None:
            continue
        s = placed[op.name]
        oc.start_cycle, oc.end_cycle = s.start, s.end
        op_costs.append(oc)

    # commit access ledgers in DAG order, scaled by the invocation count;
    # a resident schedule honors the ledger's pinned events (MVM weight
    # fill/loads, stored-once index metadata) so only the first
    # invocation pays them — activation traffic recurs either way
    acct = _Accounting(arch)
    n_inv = float(policy.invocations)
    for op, oc, led in costed:
        acct.commit(led, scale=n_inv,
                    honor_pins=sched.resident and oc is not None
                    and oc.tiles > 0)

    total_cycles = sched.total_cycles
    energy = acct.energy_breakdown(total_cycles)
    mvm_costs = [c for c in op_costs if c.tiles > 0]
    util = (sum(c.utilization * c.macs for c in mvm_costs)
            / max(sum(c.macs for c in mvm_costs), 1)) if mvm_costs else 0.0
    idx_bits = sum(c.index_bits for c in op_costs)
    cap = arch.index_capacity_bits()
    return CostReport(
        arch=arch.name,
        workload=workload.name,
        mapping=mapping.strategy,
        latency_cycles=total_cycles,
        latency_ms=total_cycles * arch.cycle_ns * 1e-6,
        energy_pj=energy,
        total_energy_uj=sum(energy.values()) * 1e-6,
        utilization=util,
        op_costs=op_costs,
        index_storage_bits=idx_bits,
        # index_capacity_bits() already returns bits — the historical
        # `cap * 64` slack silently passed workloads 64x over capacity
        index_capacity_ok=(cap == 0 or idx_bits <= cap),
        schedule=sched,
    )


def simulate(
    arch: CIMArch,
    workload: Workload,
    mapping: MappingSpec,
    *,
    input_sparsity: Optional[Dict[str, float]] = None,
    masks: Optional[Dict[str, np.ndarray]] = None,
    profile: Optional[CalibrationProfile] = None,
    tile_cache: Optional[TileGridCache] = None,
    schedule: Optional[SchedulePolicy] = None,
) -> CostReport:
    """Run the CIMinus cost simulation.

    ``input_sparsity`` maps op name → skippable-bit ratio (from
    :mod:`repro.core.input_sparsity` profiling).
    ``masks`` maps op name → FullBlock block keep-grid from the pruning
    workflow; otherwise seeded random grids with exact Φ are synthesised
    (the paper's auto-generated mask path).
    ``profile`` is an optional measured :class:`CalibrationProfile`
    (see :mod:`repro.calibrate`): each op's latency is divided by the
    profile's efficiency factor for its :func:`op_class` — a class
    achieving half the fitted roofline takes twice the analytic latency
    — and the static-energy term follows the stretched schedule.
    Dynamic energy is access-count-based and therefore unchanged.
    ``profile=None`` (and any profile with all-1.0 efficiencies, like
    the bundled default) reproduces the analytic model bit-for-bit.
    ``tile_cache`` overrides the process-wide
    :class:`~repro.core.mapping.TileGridCache` the tiling hot path
    memoises into (``None`` = share the module default, which is what
    sweep workers rely on to warm once per process).
    ``schedule`` selects the multi-macro scheduling policy
    (:mod:`repro.core.schedule`): ``None`` (= the default
    ``SchedulePolicy()``) is the historical op-serial walk on the whole
    organisation, bit-for-bit; ``"partitioned"`` overlaps independent
    DAG branches on disjoint macro subsets; ``"resident"`` pins weights
    across ``invocations`` repeated executions.  The resolved
    :class:`~repro.core.schedule.ScheduleResult` is attached to the
    report and mirrored into each op's ``start_cycle`` / ``end_cycle``.
    """
    arch.validate()
    policy = schedule if schedule is not None else SchedulePolicy()
    costed = _cost_ops(arch, workload, mapping,
                       input_sparsity=input_sparsity, masks=masks,
                       profile=profile, tile_cache=tile_cache)
    return _finish_report(arch, workload, mapping, policy, costed)


def _apply_profile(
    costed: List[Tuple[OpNode, Optional[OpCost], _OpLedger]],
    profile: Optional[CalibrationProfile],
) -> List[Tuple[OpNode, Optional[OpCost], _OpLedger]]:
    """Copy a profile-less ``_cost_ops`` result and apply ``profile``.

    A profile only ever divides each op's ``latency_cycles`` /
    ``load_cycles`` at the very end of :func:`_cost_ops`, so dividing
    the same floats here produces bit-identical values.  OpCosts are
    shallow-copied even for ``profile=None`` because
    :func:`_finish_report` mutates their start/end cycles per variant;
    ledgers are immutable under aggregation and shared.
    """
    out: List[Tuple[OpNode, Optional[OpCost], _OpLedger]] = []
    for op, oc, led in costed:
        if oc is not None:
            oc = copy.copy(oc)
            if profile is not None:
                eff = profile.efficiency_for(op_class(op))
                if eff != 1.0:
                    oc.latency_cycles /= eff
                    oc.load_cycles /= eff
        out.append((op, oc, led))
    return out


def simulate_variants(
    arch: CIMArch,
    workload: Workload,
    mapping: MappingSpec,
    *,
    input_sparsity: Optional[Dict[str, float]] = None,
    masks: Optional[Dict[str, np.ndarray]] = None,
    tile_cache: Optional[TileGridCache] = None,
    variants: List[Tuple[Optional[CalibrationProfile],
                         Optional[SchedulePolicy]]],
) -> List[CostReport]:
    """Evaluate one grid point under several ``(profile, schedule)``
    variants, paying the per-op costing pass (tiling, band packing,
    access ledgers — the dominant cost) exactly once.

    Returns one :class:`CostReport` per variant, in order, each
    bit-identical to ``simulate(..., profile=p, schedule=s)`` — the
    batched-evaluation contract the explore plane's differential tests
    pin down.  Profiles are applied as a post-pass (see
    :func:`_apply_profile`) because :func:`_cost_ops` itself only
    touches profile efficiencies after all costing is done.
    """
    arch.validate()
    costed = _cost_ops(arch, workload, mapping,
                       input_sparsity=input_sparsity, masks=masks,
                       profile=None, tile_cache=tile_cache)
    reports: List[CostReport] = []
    for prof, sched_pol in variants:
        policy = sched_pol if sched_pol is not None else SchedulePolicy()
        reports.append(_finish_report(arch, workload, mapping, policy,
                                      _apply_profile(costed, prof)))
    return reports


def simulate_reference(
    arch: CIMArch,
    workload: Workload,
    mapping: MappingSpec,
    *,
    input_sparsity: Optional[Dict[str, float]] = None,
    masks: Optional[Dict[str, np.ndarray]] = None,
    profile: Optional[CalibrationProfile] = None,
    tile_cache: Optional[TileGridCache] = None,
) -> CostReport:
    """The pre-scheduler op-serial simulator, retained as ground truth.

    Per-op costing is shared with :func:`simulate`; the *aggregation*
    replays the historical loop verbatim — every op on the whole
    organisation, serialised in DAG insertion order, total latency the
    plain left-to-right sum, ledgers committed per op, no schedule
    built.  ``tests/test_schedule.py`` asserts the ``"monolithic"``
    policy reproduces this bit-for-bit across patterns × strategies ×
    workloads (the ``mapping.reference_loops`` discipline).  Test-only —
    production callers use :func:`simulate`.
    """
    arch.validate()
    acct = _Accounting(arch)
    op_costs: List[OpCost] = []
    cum = 0.0
    for op, oc, led in _cost_ops(arch, workload, mapping,
                                 input_sparsity=input_sparsity, masks=masks,
                                 profile=profile, tile_cache=tile_cache):
        if oc is None:
            continue
        acct.commit(led)
        oc.start_cycle = cum
        cum = cum + oc.latency_cycles
        oc.end_cycle = cum
        op_costs.append(oc)

    # Ops are data-dependent along the DAG, so they serialise at op
    # granularity; intra-op load/compute/wb overlap is already inside the
    # per-op Eq. 3 pipeline.
    total_cycles = float(sum(c.latency_cycles for c in op_costs))

    energy = acct.energy_breakdown(total_cycles)
    mvm_costs = [c for c in op_costs if c.tiles > 0]
    util = (sum(c.utilization * c.macs for c in mvm_costs)
            / max(sum(c.macs for c in mvm_costs), 1)) if mvm_costs else 0.0
    idx_bits = sum(c.index_bits for c in op_costs)
    cap = arch.index_capacity_bits()
    return CostReport(
        arch=arch.name,
        workload=workload.name,
        mapping=mapping.strategy,
        latency_cycles=total_cycles,
        latency_ms=total_cycles * arch.cycle_ns * 1e-6,
        energy_pj=energy,
        total_energy_uj=sum(energy.values()) * 1e-6,
        utilization=util,
        op_costs=op_costs,
        index_storage_bits=idx_bits,
        index_capacity_ok=(cap == 0 or idx_bits <= cap),
        schedule=None,
    )


def dense_twin(arch: CIMArch, workload: Workload) -> tuple:
    """The dense counterpart of a (arch, workload) pair: sparsity
    stripped from every op, sparsity-support hardware disabled.

    Shared by :func:`dense_baseline` and the exploration engine's
    baseline jobs (``repro.explore.job.ExploreJob.dense``) so the two
    can never diverge."""
    dense_wl = Workload(workload.name + "-dense")
    for n in workload.nodes.values():
        dn = copy.copy(n)
        dn.sparsity = FlexBlockSpec()
        dense_wl.nodes[dn.name] = dn
    dense_arch = arch.replace(weight_sparsity_support=False,
                              input_sparsity_support=False)
    return dense_arch, dense_wl


def dense_baseline(arch: CIMArch, workload: Workload,
                   mapping: MappingSpec,
                   profile: Optional[CalibrationProfile] = None,
                   schedule: Optional[SchedulePolicy] = None) -> CostReport:
    """The paper's dense baseline: same architecture configuration, no
    sparsity-support hardware engaged, dense weights.  ``schedule``
    follows the sparse evaluation's policy so comparisons stay
    like-for-like."""
    dense_arch, dense_wl = dense_twin(arch, workload)
    return simulate(dense_arch, dense_wl, mapping, profile=profile,
                    schedule=schedule)


def compare(sparse: CostReport, dense: CostReport) -> Dict[str, float]:
    """Speedup & energy saving vs. the dense baseline (paper Fig. 6/8)."""
    return {
        "speedup": dense.latency_cycles / max(sparse.latency_cycles, 1e-9),
        "energy_saving": sum(dense.energy_pj.values())
        / max(sum(sparse.energy_pj.values()), 1e-9),
        "utilization": sparse.utilization,
    }
