"""Slot-pool serving engine of the port."""
