"""prefill_ms_per_ktok: wall time of the ``_prefill_slot`` spans of the
window's steps (each ends in its first token's read, a synchronise), per
1000 prompt tokens."""


def read(run):
    spans = [p for s in run.steps() for p in s["prefills"]]
    tokens = sum(S for _, _, S in spans)
    if not tokens:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in spans) / (tokens / 1e3)
