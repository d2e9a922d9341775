"""Serve metrics (copy of the reference's jax-free accumulators)."""
