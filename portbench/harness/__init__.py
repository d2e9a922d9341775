"""The benchmark harness of the port: the one traffic generator, the
closed loop, the seeded weights, the tracer and the correctness check.
It runs the program under test, ``repro_torch``, and reads only what the
program hands back (outputs, and from the wrapped calls, spans, shapes
and the device trace)."""
