"""The reference's expert-parallel MoE block on 4 virtual CPU devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_ep_reference.py OUT.npz

Runs ``repro.models.layers.moe_block`` (which takes ``_moe_block_ep``) on
a (data 2, model 2) mesh for the cases of tests/_dist_cases.py at a
dropping capacity, loading the JAX package through
tests/_jax_reference.py, and writes the outputs to OUT.npz.  Its own
interpreter: jax fixes the device count when it starts.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

import jax
import jax.numpy as jnp

import _dist_cases as cases
import _jax_reference


def main() -> int:
    R = _jax_reference.load()
    assert jax.device_count() == cases.WORLD, jax.devices()
    cfg = cases.moe_cfg(capacity_factor=1.0)
    jcfg = R.configs.ArchConfig(**dataclasses.asdict(cfg))
    inp = cases.moe_inputs(cfg)
    p = {k: jnp.asarray(inp[k]) for k in ("w_router", "w_up", "w_gate", "w_down")}
    mesh = jax.make_mesh(cases.MESH, cases.AXES)
    with R.active():
        with jax.set_mesh(mesh):
            y = jax.jit(lambda x, p: R.layers.moe_block(x, p, jcfg))(jnp.asarray(inp["x"]), p)
    np.savez(sys.argv[1], moe_drops=np.asarray(y))
    return 0


if __name__ == "__main__":
    sys.exit(main())
