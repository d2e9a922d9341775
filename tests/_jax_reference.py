"""Load the JAX package as the reference of the PyTorch port's tests.

On jax releases outside the range ``repro/runtime/compat.py`` accepts,
that module raises at import, and with it every module of the JAX
execution plane.  :func:`load` imports the reference modules with a
stand-in ``repro.runtime.compat`` (the native mesh-context branch:
``jax.set_mesh``, ``jax.sharding.get_abstract_mesh``,
``jax.shard_map(check_vma=)``) and then removes from ``sys.modules``
every ``repro`` entry it added, and from the packages that were already
there every submodule attribute it set.  The returned module objects keep
working; the JAX package's own tests, run later in the same process,
import exactly what they would have imported without this loader.
"""
from __future__ import annotations

import importlib
import sys
import types

import jax
import jax.numpy  # noqa: F401
import jax.experimental.pallas  # noqa: F401  (third-party imports happen before the snapshot)
import jax.sharding  # noqa: F401

MODULES = {
    "ops": "repro.kernels.ops",
    "kref": "repro.kernels.ref",
    "flexblock": "repro.core.flexblock",
    "pruning": "repro.core.pruning",
    "configs": "repro.configs",
    "layers": "repro.models.layers",
    "transformer": "repro.models.transformer",
    "apply": "repro.sparsity.apply",
    "engine": "repro.serve.engine",
}


def _is_repro(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


def _compat_standin() -> types.ModuleType:
    m = types.ModuleType("repro.runtime.compat")
    m.JAX_VERSION = tuple(int("".join(c for c in p if c.isdigit()) or 0)
                          for p in jax.__version__.split(".")[:3])
    m.HAS_NATIVE_MESH_CONTEXT = True
    m.get_abstract_mesh = jax.sharding.get_abstract_mesh
    m.set_mesh = jax.set_mesh

    def shard_map(f, *, mesh, in_specs, out_specs, check_vma: bool = False):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                             check_vma=check_vma)

    m.shard_map = shard_map
    return m


def load() -> types.SimpleNamespace:
    """The reference modules of :data:`MODULES`, as a namespace."""
    before = dict(sys.modules)
    attrs = {n: dict(vars(m)) for n, m in before.items() if _is_repro(n) and m is not None}
    try:
        try:
            importlib.import_module("repro.runtime.compat")
        except ImportError:
            sys.modules["repro.runtime.compat"] = _compat_standin()
        mods = {k: importlib.import_module(v) for k, v in MODULES.items()}
    finally:
        for name in [n for n in sys.modules if _is_repro(n) and n not in before]:
            del sys.modules[name]
        for name, old in attrs.items():
            mod = before[name]
            for k in [k for k in vars(mod) if k not in old]:
                delattr(mod, k)
            for k, v in old.items():
                if vars(mod).get(k) is not v:
                    setattr(mod, k, v)
    return types.SimpleNamespace(**mods)
