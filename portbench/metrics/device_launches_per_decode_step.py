"""device_launches_per_decode_step: device kernels in the profiler's
trace launched inside ``decode_step`` calls, over the number of those
calls in the traced window."""


def read(run):
    t = run.trace or {}
    if not t.get("decode_steps") or not t.get("busy_s"):
        return None
    return t["decode_kernels"] / t["decode_steps"]
