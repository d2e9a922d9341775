"""Calibration samples of the port (copy of ``repro.calibrate.harvest``'s
sample format, plus kernel microbenchmarks on the card)."""
