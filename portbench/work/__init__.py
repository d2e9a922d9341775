"""Logical work of one call of each kernel, one file per kernel name."""
