"""decode_step_ms: the mean over the window's steps of each ``step()``
span less the prefill spans inside it: ``decode_step`` with the engine's
bookkeeping and its read of the next tokens."""


def read(run):
    parts = [(s["t1"] - s["t0"]) - sum(t1 - t0 for t0, t1, _ in s["prefills"])
             for s in run.steps() if s["decodes"]]
    return 1e3 * sum(parts) / len(parts) if parts else None
