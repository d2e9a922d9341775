"""Hand-written Hopper kernels of the port: one per ported Pallas kernel,
and decode attention over the cache, which ports none (the JAX package
computes it in jnp).

Each kernel ships:

* ``csrc/<name>.cu`` — the CUDA C++ source for ``sm_90a`` (plain C
  interface, built by :mod:`._build` on first use);
* ``<name>.py``      — the wrapper: checks, allocation, launch, count;
* ``ref.py``         — its plain PyTorch version (CPU path + yardstick);
* ``ops.py``         — the ``impl`` dispatch and the layout builders.

Callers use :mod:`.ops`.
"""
