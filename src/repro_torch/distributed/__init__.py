"""Distributed-training numerics of the port (gradient compression)."""
