"""Capture a PyTorch program into the trace IR (:class:`~.ir.TraceGraph`):
the port's counterpart of ``repro.trace.capture``, which traces with
``jax.make_jaxpr``.

The program runs once on ``meta`` tensors, which hold shapes and dtypes and
no data, so a capture touches no device and computes nothing, as
``make_jaxpr`` runs on ``ShapeDtypeStruct``\\ s.  A ``TorchDispatchMode`` (the
mechanism :mod:`repro_torch.launch.counting` counts with) sees every ATen op
and records it as one or more equations named by the jaxpr primitive that
:mod:`.lower` consumes, so the lowering, the differential and the CLI apply
as they are:

* ``mm`` / ``bmm`` / ``addmm`` → ``dot_general``, its operands taken from
  before the views that fold them into 2- or 3-D form, so that its
  ``dimension_numbers`` are jax's einsum's (the same K, N and V, and a
  selected expert weight keeps the edge from its index); ``convolution`` →
  ``conv_general_dilated`` with its specs and ``feature_group_count``;
* ``embedding`` / ``index`` / ``index_select`` → ``gather`` with
  ``offset_dims`` (one offset dim from a parameter is an ``embed`` node,
  two or more a weight selection); ``topk`` → ``top_k``;
* views, expands, permutes, slices, ``cat``, pads, copies and casts → the
  transparent primitives (``reshape``, ``transpose``, ...);
* elementwise ops and reductions → their ``ELEMENTWISE_KINDS`` names; ops
  that jax spells as several primitives are written as jax writes them
  (``silu`` as ``logistic``·x, ``gelu``, ``_softmax``, ``logaddexp``,
  ``mean`` as ``reduce_sum`` and ``div``, ``reciprocal`` as
  ``integer_pow(-1)``);
* an op with no mapping is recorded under its own ATen name, so that the
  cost model warns once and prices it as elementwise work (never dropped).

Ops with no tensor input (``arange``, ``full``, ``zeros``, ``*_like``) and
tensors the program did not get as arguments are constants, as literals
and ``iota`` are in a jaxpr: equations over constants and parameters alone
fold away in the lowering.  An in-place op records a new variable for the
tensor it writes.

:func:`scan` is ``jax.lax.scan``'s counterpart: a plain loop eagerly; under
a capture its body is recorded once, on one layer's slices of the stacked
``(L, ...)`` leaves, as a ``scan`` equation with ``length``,
``num_consts`` and ``num_carry``, so a stacked parameter is priced at one
layer's size, the convention of ``lm_workload``.  The model's layer loop
(``models.transformer._scan``) reaches the same recording through
:func:`repro_torch.kernels.hook.capturing`.

The port's CUDA kernels report to the capture through
:mod:`repro_torch.kernels.hook`: flash attention is recorded as the math it
computes, the two activation×activation ``dot_general``\\ s and the masked
softmax over the real lengths (a tail pad of q/k/v ahead of the causal call
is looked through: no real query sees a padded key); every other kernel
raises :class:`CaptureError`, which names its op (the reference has no
compressed model to trace).

Front doors, as the reference's: :func:`capture`, :func:`trace_model`
(``source="reference"``, the shape-faithful programs of :mod:`.reference`;
``source="model"``, the port's own ``forward`` / ``prefill`` /
``decode_step`` on ``meta`` params, dense), :func:`traced_workload` and
:func:`traced_cnn`.
"""
from __future__ import annotations

import contextlib
import functools
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterator, List, Optional, Tuple

from ..core.workload import Workload
from .ir import TraceEqn, TraceGraph, TraceVar
from .lower import TRANSPARENT_PRIMS, lower_graph

if TYPE_CHECKING:
    import torch

__all__ = ["capture", "scan", "trace_model", "traced_workload", "traced_cnn", "TRACE_STEPS",
           "CaptureError"]

TRACE_STEPS = ("forward", "prefill", "decode")
# the device a capture runs on (a name, so that importing this module
# loads no torch: the package is the port's torch-free host plane)
META = "meta"


class CaptureError(RuntimeError):
    """A program the capture cannot record."""


# ---------------------------------------------------------------------------
# Trees: dicts (keys sorted, as jax flattens them), lists and tuples
# ---------------------------------------------------------------------------

def _flatten(tree) -> Tuple[List[Tuple[Tuple[str, ...], Any]], Callable[[Dict], Any]]:
    """(leaves, rebuild): the leaves of ``tree`` with their key paths, in
    jax's order, and a function that rebuilds the tree from a mapping of
    path → new leaf (a path it lacks keeps its old leaf).  None is no leaf."""
    leaves: List[Tuple[Tuple[str, ...], Any]] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        elif t is not None:
            leaves.append((path, t))

    walk(tree, ())

    def rebuild(new: Dict[Tuple[str, ...], Any]):
        def build(t, path):
            if isinstance(t, dict):
                return {k: build(v, path + (str(k),)) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(build(v, path + (str(i),)) for i, v in enumerate(t))
            return new.get(path, t)
        return build(tree, ())

    return leaves, rebuild


def _tensors(tree) -> List[torch.Tensor]:
    import torch

    return [t for _, t in _flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _dtype(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _scalar_dtype(v) -> str:
    return "bool" if isinstance(v, bool) else "int32" if isinstance(v, int) else "float32"


def _meta_like(t: torch.Tensor, shape=None) -> torch.Tensor:
    import torch

    return torch.empty(tuple(t.shape) if shape is None else tuple(shape), dtype=t.dtype,
                       device=META)


# ---------------------------------------------------------------------------
# The graph being recorded
# ---------------------------------------------------------------------------

class _Graph:
    """One graph being recorded: the top level or a scan body.  Tensors are
    keyed by ``id``; the recorder keeps every tensor it sees alive, so no id
    is reused while it records."""

    def __init__(self, name: str, parent: Optional["_Graph"] = None):
        self.name, self.parent = name, parent
        self.ids: Dict[int, str] = {}
        self.vars: Dict[str, TraceVar] = {}
        self.eqns: List[TraceEqn] = []
        self.invars: List[str] = []
        self.consts: List[str] = []
        self.closure: List[Tuple[str, str]] = []     # (outer var, inner var)
        self.made: Dict[str, TraceEqn] = {}          # var -> the equation that made it
        self.views: Dict[str, Tuple[str, str, Any]] = {}   # var -> (its source, how, perm)
        self._nv = self._nc = 0

    def fresh(self, shape, dtype) -> str:
        name = f"v{self._nv}"
        self._nv += 1
        self.vars[name] = TraceVar(tuple(int(d) for d in shape), _dtype(dtype))
        return name

    def const(self, shape, dtype) -> str:
        name = f"c{self._nc}"
        self._nc += 1
        self.vars[name] = TraceVar(tuple(int(d) for d in shape), _dtype(dtype))
        self.consts.append(name)
        return name

    def knows(self, t: torch.Tensor) -> bool:
        g = self
        while g is not None:
            if id(t) in g.ids:
                return True
            g = g.parent
        return False

    def emit(self, prim: str, invars: List[str], outvars: List[str],
             params: Optional[dict] = None, body: Optional[TraceGraph] = None) -> TraceEqn:
        eqn = TraceEqn(prim=prim, invars=list(invars), outvars=list(outvars),
                       params=dict(params or {}), body=body)
        self.eqns.append(eqn)
        for o in outvars:
            self.made[o] = eqn
        return eqn

    def finish(self, outvars: List[str]) -> TraceGraph:
        """The graph, without the shape-only equations nothing reads (the
        views a dot looked through), and the variables they alone used."""
        used, eqns = set(outvars), []
        for e in reversed(self.eqns):
            if e.prim in TRANSPARENT_PRIMS and not used.intersection(e.outvars):
                continue
            eqns.append(e)
            used.update(e.invars)
        eqns.reverse()
        seen = set(self.invars) | set(outvars)
        for e in eqns:
            seen.update(e.invars, e.outvars)
        return TraceGraph(name=self.name, invars=list(self.invars), outvars=list(outvars),
                          vars={k: v for k, v in self.vars.items() if k in seen}, eqns=eqns,
                          consts=[c for c in self.consts if c in seen])


# ---------------------------------------------------------------------------
# ATen op → jaxpr primitive
# ---------------------------------------------------------------------------

# no data flows from their tensor arguments (shapes and dtypes only)
_FACTORIES = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "zeros",
    "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full", "full_like", "new_full",
    "arange", "scalar_tensor", "rand", "rand_like", "randn", "randn_like", "randint",
    "randint_like", "eye", "linspace", "tril_indices", "triu_indices",
})

# one ATen op, one primitive, its tensors (and, for value ops, its Python
# numbers as constants) in order
_PRIMS = {
    # shape-only: transparent in the lowering
    "view": "reshape", "_unsafe_view": "reshape", "expand": "broadcast_in_dim",
    "repeat": "broadcast_in_dim", "permute": "transpose", "transpose": "transpose",
    "t": "transpose", "unsqueeze": "expand_dims", "squeeze": "squeeze", "slice": "slice",
    "select": "slice", "split": "split", "split_with_sizes": "split", "unbind": "split",
    "alias": "copy", "clone": "copy", "copy": "copy", "detach": "stop_gradient",
    "cat": "concatenate", "stack": "concatenate", "constant_pad_nd": "pad", "flip": "rev",
    # elementwise
    "add": "add", "sub": "sub", "mul": "mul", "div": "div", "neg": "neg", "exp": "exp",
    "log": "log", "log1p": "log1p", "tanh": "tanh", "sigmoid": "logistic", "sqrt": "sqrt",
    "rsqrt": "rsqrt", "abs": "abs", "erf": "erf", "sin": "sin", "cos": "cos",
    "maximum": "max", "minimum": "min", "clamp_min": "max", "clamp_max": "min", "relu": "max",
    "clamp": "clamp", "eq": "eq", "ne": "ne", "lt": "lt", "le": "le", "gt": "gt", "ge": "ge",
    "logical_and": "and", "logical_or": "or", "logical_not": "not", "bitwise_and": "and",
    "bitwise_or": "or", "bitwise_not": "not", "isinf": "is_finite", "isnan": "is_finite",
    "masked_fill": "select_n", "tril": "select_n", "triu": "select_n",
    # reductions, sorts
    "sum": "reduce_sum", "amax": "reduce_max", "amin": "reduce_min", "argmax": "argmax",
    "any": "reduce_or", "all": "reduce_and", "cumsum": "cumsum", "topk": "top_k",
    "sort": "sort",
    # gathers, scatters
    "gather": "gather", "index_copy": "scatter", "index_put": "scatter", "scatter": "scatter",
    "scatter_add": "scatter_add", "index_add": "scatter_add",
    "max_pool2d_with_indices": "reduce_window_max",
}


# primitives whose Python-number arguments are values (constants), not dims
_VALUE_PRIMS = frozenset({"add", "sub", "mul", "div", "max", "min", "clamp", "eq", "ne",
                          "lt", "le", "gt", "ge", "and", "or", "select_n"})


def _norm_dims(dims, rank: int) -> List[int]:
    if dims is None:
        return list(range(rank))
    if isinstance(dims, int):
        dims = [dims]
    dims = [int(d) % max(rank, 1) for d in dims]
    return sorted(dims) if dims else list(range(rank))


def _arg(args, kwargs, i: int, name: str, default=None):
    if len(args) > i:
        return args[i]
    return kwargs.get(name, default)


class _Recording:
    """The state and recording of one :func:`capture` block (see the
    module docstring); :func:`_recorder` mixes in the dispatch mode."""

    captures = True

    def __init__(self, name: str):
        super().__init__()
        self.graph = _Graph(name)
        self._paused = 0
        self._keep: List[Any] = []

    # -- variables -----------------------------------------------------------

    def bind(self, t: torch.Tensor, var: str, g: Optional[_Graph] = None) -> str:
        (g or self.graph).ids[id(t)] = var
        self._keep.append(t)
        return var

    def new(self, t: torch.Tensor, g: Optional[_Graph] = None) -> str:
        g = g or self.graph
        return self.bind(t, g.fresh(t.shape, t.dtype), g)

    def use(self, t: torch.Tensor, g: Optional[_Graph] = None) -> str:
        """``t``'s variable in ``g``: its own, a new input of the scan body
        for a tensor of an enclosing graph, else a constant."""
        g = g or self.graph
        var = g.ids.get(id(t))
        if var is not None:
            return var
        if g.parent is not None and g.parent.knows(t):
            outer = self.use(t, g.parent)
            var = self.bind(t, g.fresh(t.shape, t.dtype), g)
            g.closure.append((outer, var))
            return var
        return self.bind(t, g.const(t.shape, t.dtype), g)

    def operand(self, v, g: Optional[_Graph] = None) -> Optional[str]:
        """A tensor's variable, a Python number's constant, else None."""
        import torch

        g = g or self.graph
        if isinstance(v, torch.Tensor):
            return self.use(v, g)
        if isinstance(v, (bool, int, float)):
            return g.const((), _scalar_dtype(v))
        return None

    # -- dispatch ------------------------------------------------------------

    def _record(self, func, args, kwargs, out) -> None:
        import torch

        g = self.graph
        outs = _tensors(out)
        if not outs:
            return
        name = func.overloadpacket.__name__
        base = name[:-1] if name.endswith("_") else name
        ins = _tensors((args, kwargs))
        if base in _FACTORIES or not ins:
            for t in outs:
                self.bind(t, g.const(t.shape, t.dtype), g)
            return
        rule = _RULES.get(base)
        if rule is not None:
            rule(self, g, func, args, kwargs, outs)
            return
        prim = _PRIMS.get(base)
        flat = _flat_args(args)
        if prim not in _VALUE_PRIMS:
            flat = [a for a in flat if isinstance(a, torch.Tensor)]
        invars = [v for v in (self.operand(a, g) for a in flat) if v is not None]
        params = _params(prim, base, func, args, kwargs, outs)
        if prim is None:
            prim = name
            params = {"aten": str(func)}
        outvars = [self.new(t, g) for t in outs]
        g.emit(prim, invars, outvars, params)
        how = _VIEWS.get(base)
        if how is not None and len(outs) == 1 and isinstance(args[0], torch.Tensor):
            perm = None
            if how == "perm":
                perm = _permutation(base, args, args[0].dim())
            g.views[outvars[0]] = (self.use(args[0], g), how, perm)

    # -- expansions: one op as several primitives ----------------------------

    def chain(self, g: _Graph, steps, out: torch.Tensor) -> None:
        """Emit ``steps`` [(prim, invars, shape or None, params)], each
        step's output a new variable (``shape`` None: ``out``'s shape), the
        last one bound to ``out``; an invar ``"@k"`` is step k's output."""
        made: List[str] = []
        for i, (prim, invars, shape, params) in enumerate(steps):
            ins = [made[int(v[1:])] if isinstance(v, str) and v.startswith("@") else v
                   for v in invars]
            if i == len(steps) - 1:
                o = self.new(out, g)
            else:
                o = g.fresh(out.shape if shape is None else shape, out.dtype)
            g.emit(prim, ins, [o], params)
            made.append(o)

    # -- the kernels' hook ---------------------------------------------------

    @contextlib.contextmanager
    def _kernel(self, name: str, flops: int, nbytes: int, *, op: Optional[str] = None,
                operands=None) -> Iterator[Callable]:
        if op != "flash_attention":
            raise CaptureError(
                f"{op or name}: the {name} kernel has no traced form (a capture records "
                "dense programs; the reference traces no compressed model)")
        self._paused += 1
        try:
            yield lambda out: self._attention(out, *operands)
        finally:
            self._paused -= 1

    def _unpadded(self, t: torch.Tensor) -> str:
        """``t``'s variable, or the one before a tail pad of its sequence
        dim (dim 1) where a ``pad`` equation made it."""
        g = self.graph
        var = self.use(t, g)
        eqn = g.made.get(var)
        if eqn is not None and eqn.prim == "pad":
            cfg = eqn.params.get("padding_config", [])
            if all(lo == 0 and (hi == 0 or d == 1) for d, (lo, hi, _) in enumerate(cfg)):
                return eqn.invars[0]
        return var

    def _attention(self, out: torch.Tensor, args, kwargs) -> torch.Tensor:
        """Flash attention's math over the real lengths: scores q·kᵀ, the
        scale, the causal/window mask, softmax, P·v (GQA: each kv head
        against its G query heads)."""
        import torch

        g = self.graph
        q, k, v = args[:3]
        causal = kwargs.get("causal", True)
        window = kwargs.get("window")
        qv, kv, vv = (self._unpadded(t) for t in (q, k, v))
        B, S, Hq, hd = g.vars[qv].shape
        T, Hkv = g.vars[kv].shape[1], g.vars[kv].shape[2]
        G = Hq // Hkv
        f32 = torch.float32
        qg = g.fresh((B, S, Hkv, G, hd), q.dtype)
        g.emit("reshape", [qv], [qg], {"new_sizes": [B, S, Hkv, G, hd]})
        full, red = (B, Hkv, S, G, T), (B, Hkv, S, G)
        s = g.fresh(full, f32)
        g.emit("dot_general", [qg, kv], [s], {"dimension_numbers": [[[4], [3]], [[0, 2], [0, 2]]]})
        cur = g.fresh(full, f32)
        g.emit("mul", [s, g.const((), "float32")], [cur])
        if causal or window is not None:
            masked = g.fresh(full, f32)
            g.emit("add", [cur, g.const((S, T), "float32")], [masked])
            cur = masked
        m = g.fresh(red, f32)
        g.emit("reduce_max", [cur], [m], {"axes": [4]})
        d = g.fresh(full, f32)
        g.emit("sub", [cur, m], [d])
        e = g.fresh(full, f32)
        g.emit("exp", [d], [e])
        z = g.fresh(red, f32)
        g.emit("reduce_sum", [e], [z], {"axes": [4]})
        p = g.fresh(full, f32)
        g.emit("div", [e, z], [p])
        o = g.fresh((B, Hkv, S, G, hd), f32)
        g.emit("dot_general", [p, vv], [o], {"dimension_numbers": [[[4], [1]], [[0, 1], [0, 2]]]})
        ot = g.fresh((B, S, Hkv, G, hd), f32)
        g.emit("transpose", [o], [ot], {"permutation": [0, 2, 1, 3, 4]})
        if tuple(out.shape) == (B, S, Hq, hd):
            g.emit("reshape", [ot], [self.new(out, g)], {"new_sizes": [B, S, Hq, hd]})
            return out
        o4 = g.fresh((B, S, Hq, hd), out.dtype)
        g.emit("reshape", [ot], [o4], {"new_sizes": [B, S, Hq, hd]})
        g.emit("pad", [o4], [self.new(out, g)],
               {"padding_config": [[0, int(a) - int(b), 0]
                                   for a, b in zip(out.shape, (B, S, Hq, hd))]})
        return out

    # -- scan ----------------------------------------------------------------

    def scan(self, body: Callable, init, xs, length: Optional[int] = None):
        """Record ``body`` once as a ``scan`` equation (module docstring).
        Every leaf of ``xs`` is a tensor stacked on ``length`` layers: a
        compressed weight has no traced form."""
        import torch

        outer = self.graph
        xleaves, xrebuild = _flatten(xs)
        cleaves, crebuild = _flatten(init)
        for p, t in xleaves:
            if not isinstance(t, torch.Tensor):
                raise CaptureError(f"scan: xs leaf {'/'.join(p)} is a {type(t).__name__}, "
                                   "not a tensor (a compressed weight has no traced form)")
        if length is None:
            if not xleaves:
                raise CaptureError("scan: no length and no stacked tensor in xs")
            length = int(xleaves[0][1].shape[0])
        for p, t in xleaves:
            if t.dim() == 0 or t.shape[0] != length:
                raise CaptureError(f"scan: xs leaf {'/'.join(p)} {tuple(t.shape)} is not "
                                   f"stacked on {length} layers")
        for p, t in cleaves:
            if not isinstance(t, torch.Tensor):
                raise CaptureError(f"scan: carry leaf {'/'.join(p)} is not a tensor")
        inner = _Graph(f"scan:{outer.name}", parent=outer)
        self._paused += 1
        try:
            carry_in = {p: _meta_like(t) for p, t in cleaves}
            x_in = {p: _meta_like(t, t.shape[1:]) for p, t in xleaves}
        finally:
            self._paused -= 1
        carry_vars = [self.new(carry_in[p], inner) for p, _ in cleaves]
        x_vars = [self.new(x_in[p], inner) for p, _ in xleaves]
        self.graph = inner
        try:
            new_carry, y = body(crebuild(carry_in), xrebuild(x_in))
            out_c, out_y = _flatten(new_carry)[0], _flatten(y)[0]
            if [p for p, _ in out_c] != [p for p, _ in cleaves]:
                raise CaptureError("scan: the body's carry differs from the initial carry")
            for p, t in out_c + out_y:
                if not isinstance(t, torch.Tensor):
                    raise CaptureError(f"scan: body output {'/'.join(p)} is not a tensor")
            outvars = [self.use(t, inner) for _, t in out_c + out_y]
        finally:
            self.graph = outer
        inner.invars = [v for _, v in inner.closure] + carry_vars + x_vars
        invars = ([o for o, _ in inner.closure] + [self.use(t, outer) for _, t in cleaves]
                  + [self.use(t, outer) for _, t in xleaves])
        self._paused += 1
        try:
            c_new = {p: _meta_like(t) for p, t in out_c}
            y_new = {p: _meta_like(t, (length,) + tuple(t.shape)) for p, t in out_y}
        finally:
            self._paused -= 1
        outs = [self.new(c_new[p], outer) for p, _ in out_c] + \
               [self.new(y_new[p], outer) for p, _ in out_y]
        outer.emit("scan", invars, outs,
                   {"length": length, "num_consts": len(inner.closure),
                    "num_carry": len(cleaves), "reverse": False, "unroll": 1},
                   body=inner.finish(outvars))
        ys = None if y is None else _flatten(y)[1](y_new)
        return _flatten(new_carry)[1](c_new), ys


@functools.lru_cache(maxsize=None)
def _recorder():
    """The ``TorchDispatchMode`` class of a capture, built on the first
    capture so that importing this module loads no torch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Recorder(_Recording, TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not self._paused:
                self._record(func, args, kwargs, out)
            return out

    return _Recorder


def _flat_args(args) -> List[Any]:
    """Positional arguments with list arguments (``cat``'s, ``index``'s)
    spread out, in order."""
    import torch

    out: List[Any] = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
        else:
            out.append(a)
    return out


def _params(prim: Optional[str], base: str, func, args, kwargs, outs) -> dict:
    """The jaxpr params of a one-primitive op that the IR keeps."""
    import torch

    x = args[0] if args and isinstance(args[0], torch.Tensor) else None
    if prim == "reshape":
        return {"new_sizes": list(outs[0].shape)}
    if prim == "broadcast_in_dim":
        return {"shape": list(outs[0].shape)}
    if prim == "transpose" and base == "permute":
        return {"permutation": [int(d) % x.dim() for d in args[1]]}
    if prim == "concatenate":
        return {"dimension": int(_arg(args, kwargs, 1, "dim", 0))}
    if prim == "pad" and x is not None:
        pad = list(args[1])
        cfg = [[0, 0, 0] for _ in range(x.dim())]
        for i in range(0, len(pad), 2):
            cfg[x.dim() - 1 - i // 2] = [int(pad[i]), int(pad[i + 1]), 0]
        return {"padding_config": cfg}
    if prim in ("reduce_sum", "reduce_max", "reduce_min", "reduce_or", "reduce_and",
                "argmax") and x is not None:
        return {"axes": _norm_dims(_arg(args, kwargs, 1, "dim"), x.dim())}
    if prim == "cumsum" and x is not None:
        return {"axis": int(_arg(args, kwargs, 1, "dim")) % x.dim()}
    if prim == "top_k":
        return {"k": int(_arg(args, kwargs, 1, "k"))}
    if prim == "reduce_window_max":
        k = list(args[1])
        s = list(_arg(args, kwargs, 2, "stride", k) or k)
        return {"window_dimensions": [1, 1] + k, "window_strides": [1, 1] + s}
    return {}


# ---------------------------------------------------------------------------
# Rules for ops that need more than the one-primitive default
# ---------------------------------------------------------------------------

# rearrangements a dot looks through (:func:`_dot`): row-major reshapes,
# permutations, expands and copies or casts, each of one tensor
_VIEWS = {"view": "reshape", "_unsafe_view": "reshape", "unsqueeze": "reshape",
          "squeeze": "reshape", "permute": "perm", "transpose": "perm", "t": "perm",
          "expand": "expand", "clone": "id", "alias": "id", "detach": "id", "_to_copy": "id"}


def _permutation(base: str, args, rank: int) -> List[int]:
    if base == "permute":
        return [int(d) % rank for d in args[1]]
    perm = list(range(rank))
    if rank >= 2:
        a, b = (int(args[1]) % rank, int(args[2]) % rank) if base == "transpose" else (0, 1)
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def _step_back(groups: List[List[int]], how: str, perm, src_shape, shape) -> Optional[List[List[int]]]:
    """``groups`` (each operand dim as the dims of a view it comprises, in
    row-major order) as dims of the view's source, or None where a group
    would cover part of a source dim or a broadcast."""
    if how == "id":
        return groups
    if how == "perm":
        return [[perm[d] for d in grp] for grp in groups]
    if how == "expand":
        lead = len(shape) - len(src_shape)
        out = []
        for grp in groups:
            new = []
            for d in grp:
                if d < lead or src_shape[d - lead] != shape[d]:
                    if shape[d] != 1:
                        return None                      # a broadcast dim
                    continue
                if shape[d] != 1:
                    new.append(d - lead)
            out.append(new)
        return out
    # a row-major reshape: match the non-1 dims of both shapes in groups of
    # equal product
    src = [i for i, n in enumerate(src_shape) if n != 1]
    dst = [i for i, n in enumerate(shape) if n != 1]
    blocks, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        a, b = [src[i]], [dst[j]]
        pa, pb = src_shape[src[i]], shape[dst[j]]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                a.append(src[i]); pa *= src_shape[src[i]]; i += 1      # noqa: E702
            else:
                b.append(dst[j]); pb *= shape[dst[j]]; j += 1           # noqa: E702
        blocks.append((a, b))
    block = {d: (a, b) for a, b in blocks for d in b}
    out = []
    for grp in groups:
        grp = [d for d in grp if shape[d] != 1]
        new, i = [], 0
        while i < len(grp):
            a, b = block[grp[i]]
            if grp[i:i + len(b)] != b:
                return None                      # part of a source dim
            new.extend(a)
            i += len(b)
        out.append(new)
    return out


def _sources(g: _Graph, var: str, rank: int) -> List[Tuple[str, List[List[int]]]]:
    """The states of a walk back from ``var`` through the views that made
    it: (variable, each of ``var``'s dims as that variable's dims)."""
    states = [(var, [[d] for d in range(rank)])]
    while var in g.views:
        src, how, perm = g.views[var]
        groups = _step_back(states[-1][1], how, perm, g.vars[src].shape, g.vars[var].shape)
        if groups is None:
            break
        var = src
        states.append((var, groups))
    return states


def _dot(rec, g, a, b, roles, out, extra=None) -> None:
    """``dot_general`` of ``a`` and ``b`` → ``out`` (then ``add`` of
    ``extra``, a bias).  ``roles``: each operand's dims as "b" (batch), "k"
    (contracted) or "f" (free), as ``mm``/``bmm`` lay them out.  Each
    operand is taken from before the views that fold its dims into that 2-
    or 3-D form (the deepest pair whose batch and contracted dims match in
    size, dim by dim), so the equation carries jax's einsum dims: a view of
    a selected expert weight loses no edge from its index in the lowering."""
    (av, ar), (bv, br) = (rec.use(a, g), roles[0]), (rec.use(b, g), roles[1])
    best = None
    for lv, lg in reversed(_sources(g, av, a.dim())):
        for rv, rg in reversed(_sources(g, bv, b.dim())):
            dims = {}
            for side, v, groups, role in (("l", lv, lg, ar), ("r", rv, rg, br)):
                for kind in "bk":
                    dims[side + kind] = [d for grp, r in zip(groups, role) if r == kind
                                         for d in grp]
            size = lambda v, ds: [g.vars[v].shape[d] for d in ds]        # noqa: E731
            if (size(lv, dims["lk"]) == size(rv, dims["rk"])
                    and size(lv, dims["lb"]) == size(rv, dims["rb"])):
                best = (lv, rv, dims)
                break
        if best is not None:
            break
    lv, rv, dims = best
    dn = [[dims["lk"], dims["rk"]], [dims["lb"], dims["rb"]]]
    free = lambda v, ds: [n for d, n in enumerate(g.vars[v].shape) if d not in ds]   # noqa: E731
    shape = ([g.vars[lv].shape[d] for d in dims["lb"]] + free(lv, dims["lk"] + dims["lb"])
             + free(rv, dims["rk"] + dims["rb"]))
    final = rec.new(out, g) if extra is None else g.fresh(out.shape, out.dtype)
    if (lv, rv) == (av, bv):
        g.emit("dot_general", [lv, rv], [final], {"dimension_numbers": dn})
    else:
        tmp = g.fresh(shape, out.dtype)
        g.emit("dot_general", [lv, rv], [tmp], {"dimension_numbers": dn})
        g.emit("reshape", [tmp], [final], {"new_sizes": list(out.shape)})
    if extra is not None:
        g.emit("add", [final, rec.use(extra, g)], [rec.new(out, g)])


_MM, _BMM = ("fk", "kf"), ("bfk", "bkf")
# op: (its lhs and rhs argument positions, their roles, its bias's position)
_DOTS = {"mm": (0, 1, _MM, None), "bmm": (0, 1, _BMM, None), "addmm": (1, 2, _MM, 0)}


def _rule_dot(rec, g, func, args, kwargs, outs):
    a, b, roles, bias = _DOTS[func.overloadpacket.__name__]
    _dot(rec, g, args[a], args[b], roles, outs[0],
         extra=None if bias is None else args[bias])


def _rule_convolution(rec, g, func, args, kwargs, outs):
    x, w, bias, stride, padding, dilation, transposed, _, groups = args[:9]
    if transposed:
        g.emit(func.overloadpacket.__name__, [rec.use(x, g), rec.use(w, g)],
               [rec.new(outs[0], g)], {"aten": str(func)})
        return
    spec = list(range(x.dim()))
    params = {"dimension_numbers": {"lhs_spec": spec, "rhs_spec": spec, "out_spec": spec},
              "feature_group_count": int(groups), "batch_group_count": 1,
              "window_strides": [int(s) for s in stride],
              "padding": [[int(p), int(p)] for p in padding],
              "lhs_dilation": [1] * (x.dim() - 2), "rhs_dilation": [int(d) for d in dilation]}
    if bias is None:
        g.emit("conv_general_dilated", [rec.use(x, g), rec.use(w, g)], [rec.new(outs[0], g)],
               params)
        return
    tmp = g.fresh(outs[0].shape, outs[0].dtype)
    g.emit("conv_general_dilated", [rec.use(x, g), rec.use(w, g)], [tmp], params)
    g.emit("add", [tmp, rec.use(bias, g)], [rec.new(outs[0], g)])


def _gather(rec, g, operand, indices, offset_dims, outs) -> None:
    shape = list(operand.shape)
    params = {"dimension_numbers": {"offset_dims": list(offset_dims), "collapsed_slice_dims": [0],
                                    "start_index_map": [0], "operand_batching_dims": [],
                                    "start_indices_batching_dims": []},
              "slice_sizes": [1] + shape[1:]}
    g.emit("gather", [rec.use(operand, g)] + [rec.use(i, g) for i in indices],
           [rec.new(t, g) for t in outs], params)


def _rule_embedding(rec, g, func, args, kwargs, outs):
    weight, idx = args[0], args[1]
    _gather(rec, g, weight, [idx], list(range(idx.dim(), idx.dim() + weight.dim() - 1)), outs)


def _rule_index(rec, g, func, args, kwargs, outs):
    """Advanced indexing ``x[idx]``: the dims of the result that are not
    the indices' are the offset dims."""
    x, indices = args[0], list(args[1])
    picked = [i for i, t in enumerate(indices) if t is not None]
    tensors = [t for t in indices if t is not None]
    rest = x.dim() - len(picked)
    bdim = outs[0].dim() - rest
    if picked == list(range(picked[0], picked[0] + len(picked))):
        p = picked[0]
        offset = list(range(p)) + list(range(p + bdim, p + bdim + rest - p))
    else:                                    # torch puts the broadcast dims first
        offset = list(range(bdim, bdim + rest))
    _gather(rec, g, x, tensors, offset, outs)


def _rule_index_select(rec, g, func, args, kwargs, outs):
    x, dim, idx = args[0], int(args[1]) % args[0].dim(), args[2]
    _gather(rec, g, x, [idx], [d for d in range(x.dim()) if d != dim], outs)


def _rule_where(rec, g, func, args, kwargs, outs):
    cond, a, b = args[:3]
    g.emit("select_n", [rec.operand(v, g) for v in (cond, b, a)], [rec.new(outs[0], g)])


def _rule_masked_fill(rec, g, func, args, kwargs, outs):
    x, mask, value = args[:3]
    g.emit("select_n", [rec.operand(v, g) for v in (mask, x, value)], [rec.new(outs[0], g)])


def _rule_to_copy(rec, g, func, args, kwargs, outs):
    x = args[0]
    prim = "copy" if outs[0].dtype == x.dtype else "convert_element_type"
    params = {} if prim == "copy" else {"new_dtype": _dtype(outs[0].dtype)}
    g.emit(prim, [rec.use(x, g)], [rec.new(outs[0], g)], params)


def _rule_copy_(rec, g, func, args, kwargs, outs):
    """``dst.copy_(src)``: dst's new value is src's."""
    dst, src = args[0], args[1]
    prim = "copy" if dst.dtype == src.dtype else "convert_element_type"
    g.emit(prim, [rec.use(src, g)], [rec.new(outs[0], g)])


def _rule_reciprocal(rec, g, func, args, kwargs, outs):
    g.emit("integer_pow", [rec.use(args[0], g)], [rec.new(outs[0], g)], {"y": -1})


def _rule_pow(rec, g, func, args, kwargs, outs):
    import torch

    base, exp = args[0], args[1]
    if (isinstance(base, torch.Tensor) and isinstance(exp, (int, float))
            and not isinstance(exp, bool) and float(exp).is_integer()):
        g.emit("integer_pow", [rec.use(base, g)], [rec.new(outs[0], g)], {"y": int(exp)})
        return
    g.emit("pow", [rec.operand(base, g), rec.operand(exp, g)], [rec.new(outs[0], g)])


def _reduced(x, dims, keepdim):
    """A reduction's axes and output shape (kept dims kept)."""
    axes = _norm_dims(dims, x.dim())
    shape = [1 if i in axes else s for i, s in enumerate(x.shape)] if keepdim else \
        [s for i, s in enumerate(x.shape) if i not in axes]
    return axes, shape


def _rule_mean(rec, g, func, args, kwargs, outs):
    x = args[0]
    axes, shape = _reduced(x, _arg(args, kwargs, 1, "dim"), _arg(args, kwargs, 2, "keepdim", False))
    rec.chain(g, [("reduce_sum", [rec.use(x, g)], shape, {"axes": axes}),
                  ("div", ["@0", g.const((), "float32")], None, {})], outs[0])


def _rule_silu(rec, g, func, args, kwargs, outs):
    x = rec.use(args[0], g)
    rec.chain(g, [("logistic", [x], None, {}), ("mul", [x, "@0"], None, {})], outs[0])


def _rule_gelu(rec, g, func, args, kwargs, outs):
    """jax.nn.gelu's primitives (tanh approximation: its default)."""
    x = rec.use(args[0], g)
    c = lambda: g.const((), "float32")       # noqa: E731
    if kwargs.get("approximate", "none") == "tanh":
        steps = [("integer_pow", [x], None, {"y": 3}), ("mul", [c(), "@0"], None, {}),
                 ("add", [x, "@1"], None, {}), ("mul", [c(), "@2"], None, {}),
                 ("tanh", ["@3"], None, {}), ("add", [c(), "@4"], None, {}),
                 ("mul", [c(), "@5"], None, {}), ("mul", [x, "@6"], None, {})]
    else:
        steps = [("div", [x, c()], None, {}), ("erf", ["@0"], None, {}),
                 ("add", ["@1", c()], None, {}), ("mul", [x, "@2"], None, {}),
                 ("div", ["@3", c()], None, {})]
    rec.chain(g, steps, outs[0])


def _rule_softmax(rec, g, func, args, kwargs, outs):
    """jax.nn.softmax's primitives: reduce_max, max with -inf,
    stop_gradient, sub, exp, reduce_sum, div."""
    x, dim = args[0], int(args[1]) % args[0].dim()
    xv = rec.use(x, g)
    red = [s for i, s in enumerate(x.shape) if i != dim]
    rec.chain(g, [("reduce_max", [xv], red, {"axes": [dim]}),
                  ("max", [g.const((), "float32"), "@0"], red, {}),
                  ("stop_gradient", ["@1"], red, {}), ("sub", [xv, "@2"], None, {}),
                  ("exp", ["@3"], None, {}), ("reduce_sum", ["@4"], red, {"axes": [dim]}),
                  ("div", ["@4", "@5"], None, {})], outs[0])


def _rule_logaddexp(rec, g, func, args, kwargs, outs):
    """jnp.logaddexp: max(a, b) + log1p(exp(-|a - b|))."""
    a, b = rec.operand(args[0], g), rec.operand(args[1], g)
    rec.chain(g, [("max", [a, b], None, {}), ("sub", [a, b], None, {}),
                  ("abs", ["@1"], None, {}), ("neg", ["@2"], None, {}), ("exp", ["@3"], None, {}),
                  ("log1p", ["@4"], None, {}), ("add", ["@0", "@5"], None, {})], outs[0])


_RULES = {
    "mm": _rule_dot, "bmm": _rule_dot, "addmm": _rule_dot, "convolution": _rule_convolution,
    "embedding": _rule_embedding, "index": _rule_index, "index_select": _rule_index_select,
    "where": _rule_where, "masked_fill": _rule_masked_fill, "_to_copy": _rule_to_copy,
    "copy": _rule_copy_, "reciprocal": _rule_reciprocal, "pow": _rule_pow, "mean": _rule_mean,
    "silu": _rule_silu, "gelu": _rule_gelu, "_softmax": _rule_softmax,
    "logaddexp": _rule_logaddexp,
}


# ---------------------------------------------------------------------------
# Front doors
# ---------------------------------------------------------------------------

def scan(body: Callable, init, xs, length: Optional[int] = None):
    """``jax.lax.scan``: ``carry, y = body(carry, x_l)`` over the leading
    axis of every tensor leaf of ``xs``; returns (carry, the ``y``\\ s stacked
    leaf by leaf, or None).  Eagerly a plain loop; under a capture the body
    is recorded once (module docstring)."""
    import torch

    from ..kernels import hook

    rec = hook.capturing()
    if rec is not None:
        return rec.scan(body, init, xs, length)
    leaves, rebuild = _flatten(xs)
    n = length if length is not None else int(leaves[0][1].shape[0])
    carry, ys = init, []
    for i in range(n):
        carry, y = body(carry, rebuild({p: t[i] for p, t in leaves}))
        ys.append(y)
    if ys[0] is None:
        return carry, None
    per = [dict(_flatten(y)[0]) for y in ys]
    return carry, _flatten(ys[0])[1]({p: torch.stack([d[p] for d in per]) for p in per[0]})


def capture(fn: Callable, *example_args, param_argnums: Tuple[int, ...] = (0,),
            name: str = "traced", meta: Optional[dict] = None) -> TraceGraph:
    """Run ``fn`` once on ``meta`` copies of ``example_args`` and record it
    as a :class:`TraceGraph`.

    ``example_args`` are (trees of) tensors; only their shapes and dtypes
    are read.  Tensor leaves of the arguments at ``param_argnums`` are
    model parameters, named by their key path (``layers/wq``), which the
    lowerer turns into weight attribution on the MVM nodes.  Leaves that
    are not tensors are passed through as they are.
    """
    import torch

    from ..kernels import hook

    rec = _recorder()(name)
    args, weights = [], {}
    for ai, arg in enumerate(example_args):
        leaves, rebuild = _flatten(arg)
        new = {}
        for path, t in leaves:
            if not isinstance(t, torch.Tensor):
                continue
            m = t if t.is_meta else _meta_like(t)
            var = rec.new(m)
            rec.graph.invars.append(var)
            if ai in param_argnums:
                weights[var] = "/".join(path) or f"arg{ai}"
            new[path] = m
        args.append(rebuild(new))
    hook._STACK.append(rec)
    try:
        with torch.no_grad(), rec:
            out = fn(*args)
    finally:
        hook._STACK.pop()
    graph = rec.graph.finish([rec.use(t) for t in _tensors(out)])
    graph.weights = weights
    graph.meta = dict(meta or {})
    return graph


def _model_program(cfg, step: str, seq_len: int, batch: int):
    """(fn, params, args) for the port's own model on ``meta`` tensors:
    dense bf16 params of ``init_params``'s tree, int32 tokens, and the
    stub inputs an encoder-decoder (``enc_embed``) or a prefix-LM
    (``prefix_embed``) needs."""
    import torch

    from ..models import transformer

    params = transformer.param_struct(cfg)
    extra = {}
    if cfg.enc_dec:
        extra["enc_embed"] = torch.empty((batch, cfg.enc_seq, cfg.d_model),
                                         dtype=torch.bfloat16, device=META)
    if cfg.prefix_len:
        extra["prefix_embed"] = torch.empty((batch, cfg.prefix_len, cfg.d_model),
                                            dtype=torch.bfloat16, device=META)
    toks = torch.empty((batch, seq_len), dtype=torch.int32, device=META)
    if step == "forward":
        return (lambda p, t, e: transformer.forward(p, t, cfg, **e)), params, (toks, extra)
    if step == "prefill":
        return (lambda p, t, e: transformer.prefill(p, t, cfg, **e)), params, (toks, extra)
    if step == "decode":
        cache = transformer.init_cache(cfg, batch, seq_len, device=META)
        tok1 = torch.empty((batch, 1), dtype=torch.int32, device=META)
        return ((lambda p, t, c: transformer.decode_step(p, t, cfg, c)), params, (tok1, cache))
    raise ValueError(f"unknown step {step!r}; choose from {TRACE_STEPS}")


def trace_model(cfg, *, step: str = "forward", seq_len: int = 128, batch: int = 1,
                source: str = "reference") -> TraceGraph:
    """Trace one step of an LM config into a TraceGraph.

    ``source="model"`` traces the port's ``forward`` / ``prefill`` /
    ``decode_step``; where layers differ (gemma2's alternating windows,
    hymba's), the recorded layer body is layer 0's."""
    if step not in TRACE_STEPS:
        raise ValueError(f"unknown step {step!r}; choose from {TRACE_STEPS}")
    if source == "reference":
        from .reference import reference_program
        fn, params, args = reference_program(cfg, step=step, seq_len=seq_len, batch=batch)
    elif source == "model":
        fn, params, args = _model_program(cfg, step, seq_len, batch)
    else:
        raise ValueError(f"unknown source {source!r} (choose 'reference' or 'model')")
    return capture(fn, params, *args, name=f"{cfg.name}:{step}",
                   meta={"config": cfg.name, "step": step, "seq_len": seq_len,
                         "batch": batch, "source": source,
                         "workload_name": f"traced-{cfg.name}-{step}"})


def traced_workload(cfg, *, step: str = "forward", seq_len: int = 128, batch: int = 1,
                    source: str = "reference") -> Workload:
    """Config (or config name) → lowered :class:`Workload`: the traced
    sibling of :func:`repro_torch.core.workload.lm_workload`."""
    if isinstance(cfg, str):
        from ..configs import get_config
        cfg = get_config(cfg)
    return lower_graph(trace_model(cfg, step=step, seq_len=seq_len, batch=batch,
                                   source=source))


def cnn_graph(model: str = "resnet18", img: int = 32, num_classes: int = 100) -> TraceGraph:
    """The captured graph of a CNN reference program (vgg16 / resnet18 /
    resnet50)."""
    from .reference import cnn_program
    fn, params, args = cnn_program(model, img=img, num_classes=num_classes)
    return capture(fn, params, *args, name=f"{model}-{img}",
                   meta={"model": model, "img": img, "num_classes": num_classes,
                         "workload_name": f"traced-{model}-{img}"})


def traced_cnn(model: str = "resnet18", img: int = 32, num_classes: int = 100) -> Workload:
    """Traced sibling of the CNN builders (vgg16 / resnet18 / resnet50)."""
    return lower_graph(cnn_graph(model, img, num_classes))
