"""The reference's ``lower_cell`` on a (2, 2) mesh of 4 virtual CPU devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_mesh_reference.py CASES.json OUT.json

CASES.json is a list of ``{"name", "cfg", "cell", "options"}``: an
``ArchConfig`` and a ``ShapeCell`` as dicts, and the sharding options the
reference's dry-run sets (``fsdp``, ``zero1``, ``attn_kv_fallback``).  For
each case the reference's own ``repro.launch.dryrun.lower_cell`` lowers
the cell on a ("data", "model") = (2, 2) mesh with every layer and kv
chunk unrolled (so that XLA's cost analysis counts each one) and no
remat, and compiles it; OUT.json gets, per case, the per-device
``memory_analysis()`` sizes, ``cost_analysis()`` flops, the elements of
the compiled module's converts, the flops of its dots (2 x the result's
elements x the contracted extent, each ``dot`` of the text), and
``collective_bytes`` of its text.  The JAX package is loaded through tests/_jax_reference.py.  Its
own interpreter: jax fixes the device count when it starts.
"""
from __future__ import annotations

import json
import re
import sys

import numpy as np

import jax

import _jax_reference

_HLO_CONVERT = re.compile(r"^\s*(?:ROOT )?%[\w.\-]+ = \w+\[([\d,]*)\]\S* convert\(", re.M)


_HLO_SHAPE = re.compile(r"%([\w.\-]+) = \(?\w+\[([\d,]*)\]")
_HLO_DOT = re.compile(r"= \w+\[([\d,]*)\]\S* dot\(%([\w.\-]+), %[\w.\-]+\).*?"
                      r"lhs_contracting_dims=\{([\d,]*)\}")


def _dims(text: str):
    return [int(d) for d in text.split(",") if d]


def _converts(hlo_text: str) -> int:
    return sum(int(np.prod(_dims(m.group(1)))) for m in _HLO_CONVERT.finditer(hlo_text))


def _dot_flops(hlo_text: str) -> int:
    """2 x result elements x contracted extent, summed over the dots."""
    shapes = {m.group(1): _dims(m.group(2)) for m in _HLO_SHAPE.finditer(hlo_text)}
    total = 0
    for m in _HLO_DOT.finditer(hlo_text):
        lhs = shapes[m.group(2)]
        k = int(np.prod([lhs[d] for d in _dims(m.group(3))]))
        total += 2 * int(np.prod(_dims(m.group(1)))) * k
    return total


def main() -> int:
    R = _jax_reference.load()
    assert jax.device_count() == 4, jax.devices()
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    with open(sys.argv[1]) as f:
        cases = json.load(f)
    for case in cases:
        cfg = R.configs.base.ArchConfig(**case["cfg"])
        cell = R.configs.base.ShapeCell(**case["cell"])
        with R.active():
            shd = sys.modules["repro.distributed.sharding"]
            prev = shd.get_options()
            shd.set_options(**case["options"])
            try:
                with R.transformer.scan_unroll(cfg.n_layers), R.layers.chunk_unroll(8):
                    compiled = R.dryrun.lower_cell(cfg, cell, mesh, multi_pod=False,
                                                   remat=False).compile()
            finally:
                shd._OPTS = prev
        mem = compiled.memory_analysis()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        text = compiled.as_text()
        out[case["name"]] = {
            "argument_bytes": int(mem.argument_size_in_bytes),
            "output_bytes": int(mem.output_size_in_bytes),
            "temp_bytes": int(mem.temp_size_in_bytes),
            "flops": float(cost["flops"]),
            "converts": _converts(text),
            "dot_flops": _dot_flops(text),
            "bytes_accessed": float(cost["bytes accessed"]),
            "collective_bytes": R.dryrun.collective_bytes(text),
        }
    with open(sys.argv[2], "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
