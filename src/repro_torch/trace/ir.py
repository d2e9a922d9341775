"""Jax-free trace IR: a serialisable mirror of a jaxpr.

Copy of ``repro.trace.ir``: the port never imports the JAX package.

In the reference, ``repro.trace.capture`` turns a jaxpr into a
:class:`TraceGraph`; in the port, :mod:`.capture` turns a PyTorch program
run on ``meta`` tensors into one.  :mod:`.lower` turns a graph into a
:class:`~repro_torch.core.workload.Workload`.  A graph has the same
canonical JSON, and so the same digest, in both packages.

A graph records only what lowering needs: per-variable shapes/dtypes,
the equation list (primitive name + JSON-safe params), which top-level
inputs are model parameters (``weights``: var id → parameter path), and
nested bodies for structured primitives (``scan`` / ``pjit`` / custom
derivative calls).  Values, RNG keys and donation/sharding metadata are
deliberately dropped — two traces of the same program at the same shapes
produce byte-identical graphs, which is what makes :meth:`TraceGraph.digest`
a usable content key for the explore cache.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Tuple

__all__ = ["TraceVar", "TraceEqn", "TraceGraph"]


@dataclasses.dataclass
class TraceVar:
    """Shape/dtype of one SSA variable."""

    shape: Tuple[int, ...]
    dtype: str

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n


@dataclasses.dataclass
class TraceEqn:
    """One primitive application.

    ``body`` holds the lowered sub-graph for structured primitives
    (``scan``'s per-iteration jaxpr, ``pjit``'s call jaxpr, …); the
    trip count and const/carry splits stay in ``params`` under the
    primitive's own key names (``length`` / ``num_consts`` / …).
    """

    prim: str
    invars: List[str]
    outvars: List[str]
    params: Dict[str, object] = dataclasses.field(default_factory=dict)
    body: Optional["TraceGraph"] = None


@dataclasses.dataclass
class TraceGraph:
    """A jaxpr-shaped dataflow graph (possibly nested under a TraceEqn)."""

    name: str
    invars: List[str]
    outvars: List[str]
    vars: Dict[str, TraceVar]
    eqns: List[TraceEqn]
    consts: List[str] = dataclasses.field(default_factory=list)
    weights: Dict[str, str] = dataclasses.field(default_factory=dict)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    # -- (de)serialisation ---------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "invars": list(self.invars),
            "outvars": list(self.outvars),
            "vars": {k: {"shape": list(v.shape), "dtype": v.dtype}
                     for k, v in self.vars.items()},
            "consts": list(self.consts),
            "weights": dict(self.weights),
            "meta": dict(self.meta),
            "eqns": [self._eqn_dict(e) for e in self.eqns],
        }

    @staticmethod
    def _eqn_dict(e: TraceEqn) -> dict:
        d = {"prim": e.prim, "invars": list(e.invars),
             "outvars": list(e.outvars), "params": e.params}
        if e.body is not None:
            d["body"] = e.body.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TraceGraph":
        return cls(
            name=d["name"],
            invars=list(d["invars"]),
            outvars=list(d["outvars"]),
            vars={k: TraceVar(tuple(int(x) for x in v["shape"]), v["dtype"])
                  for k, v in d["vars"].items()},
            consts=list(d.get("consts", ())),
            weights=dict(d.get("weights", {})),
            meta=dict(d.get("meta", {})),
            eqns=[TraceEqn(prim=e["prim"], invars=list(e["invars"]),
                           outvars=list(e["outvars"]),
                           params=dict(e.get("params", {})),
                           body=(cls.from_dict(e["body"])
                                 if e.get("body") else None))
                  for e in d["eqns"]],
        )

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path) -> "TraceGraph":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- content addressing --------------------------------------------------
    def digest(self) -> str:
        """Stable hex digest of the graph's canonical JSON form.

        Keys traced workloads in the explore cache: same program, same
        shapes → same digest, across processes and jax versions that
        trace to the same primitives.
        """
        payload = json.dumps(self.to_dict(), sort_keys=True,
                             separators=(",", ":"))
        return hashlib.sha256(payload.encode()).hexdigest()

    # -- introspection -------------------------------------------------------
    def n_eqns(self, recursive: bool = True) -> int:
        n = len(self.eqns)
        if recursive:
            for e in self.eqns:
                if e.body is not None:
                    n += e.body.n_eqns(True)
        return n

    def __repr__(self):
        return (f"TraceGraph({self.name!r}, eqns={self.n_eqns()}, "
                f"inputs={len(self.invars)}, weights={len(self.weights)})")
