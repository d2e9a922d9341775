"""output_tokens_per_s: every output token handed back in the window
(first tokens included), over the window's seconds."""


def read(run):
    return len(run.window_tokens()) / (run.w1 - run.w0)
