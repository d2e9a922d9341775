"""Lower a :class:`~repro.trace.ir.TraceGraph` into a ``Workload`` DAG.

Copy of ``repro.trace.lower``: the port never imports the JAX package.

Pure Python — no jax.  The lowering rules (see ``docs/tracing.md``):

* ``dot_general`` / ``conv_general_dilated`` become MVM :class:`OpNode`\\ s.
  For a dot, K is the product of the contracting dims; the operand backed
  by a model parameter supplies the weight matrix (N = its free dims,
  weight_count = the parameter's stored size), the other side supplies the
  vector count (V = batch dims × its free dims).  Activation×activation
  dots become ``kind="matmul"`` with ``weight_count=0`` (score/context
  attention GEMMs) — K·N·V is invariant to which side is called N.
* ``scan`` bodies are lowered once and folded: every node emitted inside
  a body of length L has V (or ``elements``) scaled by L, and weights
  sized at the per-iteration slice — exactly the per-layer-block
  convention of :func:`repro.core.workload.lm_workload`.
* ``gather`` from a parameter is classified by its slice rank: one
  offset dim → an ``embed`` node (table lookup); two or more → weight
  selection (MoE expert dispatch), which stays a weight view priced at
  the *source* parameter's full size, matching the hand DAGs' replicated
  expert storage.
* Shape-only ops (reshape/transpose/broadcast/slice/convert/…) are
  transparent.  Equations whose inputs are all literals or parameters
  are constant-folded away (masks from ``iota``, ``1 + norm_scale``, …).
* Everything else becomes a :meth:`Workload.simple` node whose
  ``elements`` is the output element count; runs of simple nodes with a
  single simple consumer are merged, summing element counts, so the
  elementwise volume is preserved while the DAG stays compact.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from ..core.workload import OpNode, Workload
from .ir import TraceEqn, TraceGraph

__all__ = ["lower_graph", "LowerError"]


class LowerError(ValueError):
    """A graph that cannot be lowered into a Workload."""


# Primitives that only reshape/relabel data: the lowered value keeps its
# producer and (for parameters) its weight identity.
TRANSPARENT_PRIMS = frozenset({
    "reshape", "transpose", "broadcast_in_dim", "squeeze", "expand_dims",
    "convert_element_type", "bitcast_convert_type", "slice", "dynamic_slice",
    "rev", "copy", "stop_gradient", "real", "imag", "device_put",
    "sharding_constraint", "reduce_precision", "split", "concatenate",
    "pad", "tie_in", "opt_barrier", "squeeze_dims",
})

# Structured primitives whose params carry a nested TraceGraph.
_BODY_PRIMS = frozenset({
    "scan", "pjit", "closed_call", "core_call", "xla_call", "remat",
    "remat2", "checkpoint", "custom_jvp_call", "custom_vjp_call",
    "custom_jvp_call_jaxpr", "custom_vjp_call_jaxpr", "while", "cond",
})

# Non-MVM kind per elementwise/reduction primitive; anything unlisted
# falls back to the primitive name itself, which the cost model prices
# as elementwise after a one-time warning (see costmodel._other_op_cost).
ELEMENTWISE_KINDS = {
    "add": "add", "sub": "add", "add_any": "add",
    "mul": "act", "div": "act", "max": "act", "min": "act", "rem": "act",
    "pow": "act", "integer_pow": "act", "exp": "act", "log": "act",
    "log1p": "act", "expm1": "act", "tanh": "act", "logistic": "act",
    "erf": "act", "erfc": "act", "erf_inv": "act", "rsqrt": "act",
    "sqrt": "act", "cbrt": "act", "neg": "act", "sign": "act",
    "abs": "act", "floor": "act", "ceil": "act", "round": "act",
    "clamp": "act", "select_n": "act", "is_finite": "act",
    "sin": "act", "cos": "act", "square": "act", "nextafter": "act",
    "and": "act", "or": "act", "xor": "act", "not": "act",
    "shift_left": "act", "shift_right_logical": "act",
    "shift_right_arithmetic": "act",
    "eq": "act", "ne": "act", "lt": "act", "le": "act", "gt": "act",
    "ge": "act",
    "reduce_sum": "reduce", "reduce_max": "reduce", "reduce_min": "reduce",
    "reduce_prod": "reduce", "reduce_and": "reduce", "reduce_or": "reduce",
    "argmax": "reduce", "argmin": "reduce", "reduce": "reduce",
    "cumsum": "reduce", "cumprod": "reduce", "cummax": "reduce",
    "cummin": "reduce", "cumlogsumexp": "reduce",
    "reduce_window_max": "pool", "reduce_window_min": "pool",
    "reduce_window_sum": "pool", "reduce_window": "pool",
    "select_and_scatter_add": "pool",
    "sort": "sort", "top_k": "sort", "approx_top_k": "sort",
    "iota": "act", "rng_uniform": "act", "rng_bit_generator": "act",
    "random_bits": "act", "random_seed": "act", "random_wrap": "act",
    "random_fold_in": "act",
    "gather": "gather", "scatter": "scatter", "scatter_add": "scatter",
    "scatter_mul": "scatter", "scatter_max": "scatter",
    "scatter_min": "scatter", "dynamic_update_slice": "scatter",
}


@dataclasses.dataclass
class _Val:
    """Lowering-time value info for one SSA variable.

    ``producer`` is the DAG node that computed it (None: graph input or
    constant).  ``weight`` is ``(param_path, stored_size)`` when the
    value is a view of a model parameter.  ``const`` marks values with
    no activation dependence at all (literals and pure functions of
    them) — equations over consts/weights alone emit no compute node.
    """

    producer: Optional[str] = None
    weight: Optional[Tuple[str, int]] = None
    const: bool = False


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


_NAME_RE = re.compile(r"[^A-Za-z0-9_]+")


class _Lowerer:
    def __init__(self, workload: Workload):
        self.w = workload
        self._counts: Dict[str, int] = {}

    # -- node naming ---------------------------------------------------------
    def _name(self, kind: str, param: Optional[str] = None) -> str:
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        base = f"{kind}{i}"
        if param:
            base += "_" + _NAME_RE.sub("_", param).strip("_")[:48]
        while base in self.w.nodes:                # defensive: keep unique
            base += "_"
        return base

    # -- graph walk ----------------------------------------------------------
    def lower(self, graph: TraceGraph, env: Dict[str, _Val],
              mult: int) -> Dict[str, _Val]:
        """Lower ``graph`` with inputs bound via ``env`` (var id → _Val);
        returns the env extended with every var the graph defines."""
        for c in graph.consts:
            env.setdefault(c, _Val(const=True))
        for eqn in graph.eqns:
            self._eqn(graph, eqn, env, mult)
        return env

    def _vals(self, eqn: TraceEqn, env: Dict[str, _Val]) -> List[_Val]:
        out = []
        for v in eqn.invars:
            if v not in env:
                raise LowerError(f"{eqn.prim}: undefined input {v!r}")
            out.append(env[v])
        return out

    @staticmethod
    def _inputs_of(vals: List[_Val]) -> Tuple[str, ...]:
        seen, order = set(), []
        for v in vals:
            if v.producer and v.producer not in seen:
                seen.add(v.producer)
                order.append(v.producer)
        return tuple(order)

    def _eqn(self, graph: TraceGraph, eqn: TraceEqn,
             env: Dict[str, _Val], mult: int) -> None:
        vals = self._vals(eqn, env)

        if eqn.prim in _BODY_PRIMS:
            self._body_eqn(eqn, vals, env, mult)
            return

        # constant folding: no activation flows in → no compute node.
        # A parameter-only expression stays a weight view (offline weight
        # preprocessing, e.g. ``1 + rms_scale``).
        if all(v.const or v.weight for v in vals):
            wsrc = next((v.weight for v in vals if v.weight), None)
            out = _Val(const=wsrc is None, weight=wsrc)
            for o in eqn.outvars:
                env[o] = out
            return

        if eqn.prim in TRANSPARENT_PRIMS:
            # single-producer pass-through; multi-input shape ops
            # (concatenate) keep every producer via a zero-cost merge
            producers = self._inputs_of(vals)
            if len(producers) > 1:
                node = self.w.simple(self._name("act"), "act", 0,
                                     inputs=producers)
                out = _Val(producer=node.name)
            else:
                src = next((v for v in vals if not v.const), vals[0])
                out = _Val(producer=src.producer, weight=src.weight)
            for o in eqn.outvars:
                env[o] = out
            return

        if eqn.prim == "dot_general":
            self._dot(graph, eqn, vals, env, mult)
            return
        if eqn.prim == "conv_general_dilated":
            self._conv(graph, eqn, vals, env, mult)
            return
        if eqn.prim == "gather":
            operand = vals[0]
            if operand.weight is not None:
                self._weight_gather(graph, eqn, vals, env, mult)
                return
            # activation gather falls through to the elementwise default

        self._elementwise(graph, eqn, vals, env, mult)

    # -- MVM lowering --------------------------------------------------------
    def _dot(self, graph, eqn, vals, env, mult) -> None:
        lhs, rhs = vals[0], vals[1]
        ls = graph.vars[eqn.invars[0]].shape
        rs = graph.vars[eqn.invars[1]].shape
        (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
        lc, rc, lb, rb = (tuple(int(i) for i in t) for t in (lc, rc, lb, rb))
        K = _prod(ls[i] for i in lc)
        batch = _prod(ls[i] for i in lb)
        l_free = _prod(d for i, d in enumerate(ls) if i not in lc + lb)
        r_free = _prod(d for i, d in enumerate(rs) if i not in rc + rb)

        if rhs.weight is not None and lhs.weight is None:
            wname, wcount = rhs.weight
            node = OpNode(name=self._name("fc", wname), kind="fc",
                          inputs=self._inputs_of(vals), K=K, N=r_free,
                          V=batch * l_free * mult, c_in=K,
                          weight_count=wcount)
        elif lhs.weight is not None and rhs.weight is None:
            wname, wcount = lhs.weight
            node = OpNode(name=self._name("fc", wname), kind="fc",
                          inputs=self._inputs_of(vals), K=K, N=l_free,
                          V=batch * r_free * mult, c_in=K,
                          weight_count=wcount)
        else:
            # activation×activation (attention scores / context) — or the
            # degenerate weight×weight case, priced the same way
            node = OpNode(name=self._name("matmul"), kind="matmul",
                          inputs=self._inputs_of(vals), K=K, N=r_free,
                          V=batch * l_free * mult, c_in=K,
                          weight_count=0, prunable=False)
        self.w.add(node)
        for o in eqn.outvars:
            env[o] = _Val(producer=node.name)

    def _conv(self, graph, eqn, vals, env, mult) -> None:
        rhs = vals[1]
        kshape = graph.vars[eqn.invars[1]].shape
        oshape = graph.vars[eqn.outvars[0]].shape
        dn = eqn.params["dimension_numbers"]
        if isinstance(dn, dict):           # captured ConvDimensionNumbers
            dn = (dn["lhs_spec"], dn["rhs_spec"], dn["out_spec"])
        lhs_spec, rhs_spec, out_spec = (tuple(int(i) for i in s) for s in dn)
        groups = int(eqn.params.get("feature_group_count", 1))
        cout = kshape[rhs_spec[0]]
        cin_per_group = kshape[rhs_spec[1]]
        kspatial = tuple(kshape[i] for i in rhs_spec[2:])
        v = (oshape[out_spec[0]] * _prod(oshape[i] for i in out_spec[2:])
             * mult)
        kernel = (kspatial + (1, 1))[:2]
        wname, wcount = rhs.weight if rhs.weight else (None, _prod(kshape))
        depthwise = groups > 1 and cin_per_group == 1
        node = OpNode(
            name=self._name("dwconv" if depthwise else "conv", wname),
            kind="dwconv" if depthwise else "conv",
            inputs=self._inputs_of(vals),
            K=cin_per_group * _prod(kspatial), N=cout, V=v,
            c_in=cin_per_group * groups, kernel=kernel,
            weight_count=wcount, prunable=not depthwise and rhs.weight is not None)
        self.w.add(node)
        for o in eqn.outvars:
            env[o] = _Val(producer=node.name)

    def _weight_gather(self, graph, eqn, vals, env, mult) -> None:
        """Gather whose operand is a parameter view.

        Slice rank (``offset_dims``) decides the semantics: rank-1
        slices are an embedding lookup (a real table read, priced as an
        ``embed`` node); matrix-valued slices are weight *selection*
        (MoE expert dispatch) — the result stays a weight view carrying
        the full source parameter size, and the selection itself costs
        nothing (the hand DAGs likewise ignore routing data movement).
        """
        operand = vals[0]
        wname, wcount = operand.weight
        dn = eqn.params.get("dimension_numbers", {})
        offset = dn.get("offset_dims", ()) if isinstance(dn, dict) else ()
        out_size = _prod(graph.vars[eqn.outvars[0]].shape)
        if len(offset) >= 2:
            # keep the index chain as provenance so the selecting op
            # (router/top-k) stays an edge into the consuming MVM
            producers = self._inputs_of(vals)
            if len(producers) > 1:
                merge = self.w.simple(self._name("act"), "act", 0,
                                      inputs=producers)
                producers = (merge.name,)
            out = _Val(producer=producers[0] if producers else None,
                       weight=(wname, wcount))
            for o in eqn.outvars:
                env[o] = out
            return
        node = self.w.add(OpNode(
            name=self._name("embed", wname), kind="embed",
            inputs=self._inputs_of(vals), elements=out_size * mult,
            weight_count=wcount))
        for o in eqn.outvars:
            env[o] = _Val(producer=node.name)

    # -- everything else -----------------------------------------------------
    def _elementwise(self, graph, eqn, vals, env, mult) -> None:
        kind = ELEMENTWISE_KINDS.get(eqn.prim, eqn.prim)
        out_size = max((_prod(graph.vars[o].shape) for o in eqn.outvars
                        if o in graph.vars), default=0)
        node = self.w.simple(self._name(kind), kind, out_size * mult,
                             inputs=self._inputs_of(vals))
        for o in eqn.outvars:
            env[o] = _Val(producer=node.name)

    # -- structured bodies ---------------------------------------------------
    def _body_eqn(self, eqn, vals, env, mult) -> None:
        body = eqn.body
        if body is None:
            raise LowerError(f"{eqn.prim}: missing body graph")
        if eqn.prim == "scan":
            length = int(eqn.params.get("length", 1))
            nc = int(eqn.params.get("num_consts", 0))
            ncar = int(eqn.params.get("num_carry", 0))
            sub = {}
            for i, inner in enumerate(body.invars):
                outer = vals[i]
                if i >= nc + ncar and outer.weight is not None:
                    # stacked parameter: the body sees one layer's slice
                    outer = _Val(producer=outer.producer,
                                 weight=(outer.weight[0],
                                         body.vars[inner].size))
                sub[inner] = outer
            out_env = self.lower(body, sub, mult * length)
            outs = [out_env[o] for o in body.outvars]
            for o, v in zip(eqn.outvars, outs):
                env[o] = v
            return
        if eqn.prim == "while":
            # lowered once: trip count is data-dependent; documented as a
            # single-iteration floor in docs/tracing.md
            inner_vals = vals[-len(body.invars):] if body.invars else []
            sub = dict(zip(body.invars, inner_vals))
            out_env = self.lower(body, sub, mult)
            outs = [out_env[o] for o in body.outvars]
            for o, v in zip(eqn.outvars, outs[-len(eqn.outvars):]):
                env[o] = v
            return
        # pjit / custom_* / remat / cond(best branch): 1:1 arg mapping,
        # trailing-aligned when the eqn carries extra leading operands
        # (cond's predicate, custom_vjp's fn refs)
        n = len(body.invars)
        inner_vals = vals[-n:] if n else []
        sub = dict(zip(body.invars, inner_vals))
        out_env = self.lower(body, sub, mult)
        outs = [out_env[o] for o in body.outvars]
        for o, v in zip(eqn.outvars, outs):
            env[o] = v


# ---------------------------------------------------------------------------
# Elementwise folding.
# ---------------------------------------------------------------------------

def _fold_simple_chains(w: Workload) -> Workload:
    """Merge each non-MVM node with a single non-MVM consumer into that
    consumer (summing ``elements``), repeatedly — MVM nodes and ``embed``
    nodes (which carry weights) are fold barriers.  DAG edges through
    merged nodes are preserved, so ``topo_order``/``levels`` and the
    schedulers see the same dependence structure at a fraction of the
    node count."""

    def foldable(n: OpNode) -> bool:
        return (not n.is_mvm and n.kind != "dwconv" and n.kind != "embed"
                and not n.weight_count)

    changed = True
    while changed:
        changed = False
        succ = w.successors()
        for name in list(w.nodes):
            node = w.nodes.get(name)
            if node is None or not foldable(node):
                continue
            consumers = succ.get(name, [])
            if len(consumers) != 1:
                continue
            c = w.nodes[consumers[0]]
            if not foldable(c):
                continue
            # splice: c absorbs node's volume and upstream edges
            c.elements += node.elements
            new_inputs = []
            for i in c.inputs:
                srcs = node.inputs if i == name else (i,)
                for s in srcs:
                    if s not in new_inputs:
                        new_inputs.append(s)
            c.inputs = tuple(new_inputs)
            if node.elements > 0 and c.elements - node.elements < node.elements \
                    and c.kind != node.kind and node.kind != "act":
                c.kind = node.kind       # dominant-volume kind wins
            del w.nodes[name]
            changed = True
            break
    # rebuild in topological insertion order so Workload.add invariants
    # (no forward references) hold for downstream consumers
    order = w.topo_order()
    w.nodes = {n: w.nodes[n] for n in order}
    return w


def lower_graph(graph: TraceGraph, *, name: Optional[str] = None,
                fold: bool = True) -> Workload:
    """Lower a captured :class:`TraceGraph` into a :class:`Workload`.

    The result carries ``source_digest`` (the graph's content digest) so
    explore-cache keys distinguish traced DAGs by program content.
    """
    wname = name or graph.meta.get("workload_name") or f"traced-{graph.name}"
    w = Workload(str(wname))
    lo = _Lowerer(w)
    env: Dict[str, _Val] = {}
    for v in graph.invars:
        if v in graph.weights:
            env[v] = _Val(weight=(graph.weights[v],
                                  graph.vars[v].size))
        else:
            env[v] = _Val()
    lo.lower(graph, env, 1)
    if fold:
        _fold_simple_chains(w)
    w.source_digest = graph.digest()
    # warn-only pre-flight: a lowering bug that produces a structurally
    # broken DAG should surface here, not deep inside a sweep (CLIs —
    # repro.trace, repro.explore — re-check strictly and reject)
    from ..analysis import preflight
    preflight(w, strict=False, where="trace.lower")
    return w
