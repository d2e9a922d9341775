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

A reference function that imports at call time (``moe_block`` imports
``..distributed.sharding`` when it runs) would re-import through
``sys.modules`` and meet the real ``compat``.  Run such calls inside
``with R.active(): ...``: the block puts back into ``sys.modules`` the
very module objects :func:`load` imported (``repro.distributed.sharding``
and the stand-in among them), re-imports nothing, and on leaving restores
``sys.modules`` and package attributes as it found them.
"""
from __future__ import annotations

import contextlib
import importlib
import os
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
    "input_sparsity": "repro.core.input_sparsity",
    "harvest": "repro.calibrate.harvest",
    "fit": "repro.calibrate.fit",
    "costmodel": "repro.core.costmodel",
    "workload": "repro.core.workload",
    "mapping": "repro.core.mapping",
    "presets": "repro.core.presets",
    "hardware": "repro.core.hardware",
    "profile": "repro.calibrate.profile",
    "core": "repro.core",
    "optimizer": "repro.train.optimizer",
    "step": "repro.train.step",
    "checkpoint": "repro.train.checkpoint",
    "trainer": "repro.train.trainer",
    "compress": "repro.distributed.compress",
    "pipeline": "repro.data.pipeline",
    "dryrun": "repro.launch.dryrun",
    "roofline": "repro.launch.roofline",
    "hlo_histogram": "repro.launch.hlo_histogram",
}

# imported at call time: by layers.moe_block, and by serve.engine.ServeEngine
# when it is built
LAZY = ("repro.distributed.sharding", "repro.analysis")


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


def _snapshot():
    """The ``repro`` entries of ``sys.modules`` and the attributes of each."""
    before = dict(sys.modules)
    attrs = {n: dict(vars(m)) for n, m in before.items() if _is_repro(n) and m is not None}
    return before, attrs


def _restore(before, attrs) -> None:
    """Undo every change to ``repro`` entries and their attributes since
    :func:`_snapshot` gave ``before`` and ``attrs``."""
    for name in [n for n in sys.modules if _is_repro(n)]:
        if name not in before:
            del sys.modules[name]
        elif sys.modules[name] is not before[name]:
            sys.modules[name] = before[name]
    for name in [n for n in before if _is_repro(n) and n not in sys.modules]:
        sys.modules[name] = before[name]
    for name, old in attrs.items():
        mod = before[name]
        for k in [k for k in vars(mod) if k not in old]:
            delattr(mod, k)
        for k, v in old.items():
            if vars(mod).get(k) is not v:
                setattr(mod, k, v)


def load() -> types.SimpleNamespace:
    """The reference modules of :data:`MODULES`, as a namespace, with
    ``active()``: a context manager for reference calls that import lazily."""
    before, attrs = _snapshot()
    # repro.launch.dryrun and hlo_histogram set XLA_FLAGS (512 / 256 host
    # devices) when imported: start JAX's backend first, so that the flag
    # reaches no backend, and put the variable back as it was after
    jax.devices()
    xla_flags = os.environ.get("XLA_FLAGS")
    try:
        try:
            importlib.import_module("repro.runtime.compat")
        except ImportError:
            sys.modules["repro.runtime.compat"] = _compat_standin()
        mods = {k: importlib.import_module(v) for k, v in MODULES.items()}
        for name in LAZY:
            importlib.import_module(name)
        loaded = {n: m for n, m in sys.modules.items() if _is_repro(n)}
    finally:
        _restore(before, attrs)
        if xla_flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = xla_flags

    @contextlib.contextmanager
    def active():
        outer = _snapshot()
        sys.modules.update(loaded)
        try:
            yield
        finally:
            _restore(*outer)

    return types.SimpleNamespace(**mods, active=active)
