"""device_idle_share: the share of the traced window in which no kernel,
copy or memset ran on the card (torch.profiler, CUPTI), in %."""


def read(run):
    t = run.trace or {}
    if not t.get("window_s") or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
