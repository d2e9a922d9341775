"""decode_issue_share: the time from each call of ``decode_step`` to its
return (the host's issue: nothing inside it waits for the card), over the
decode part of its step, summed over the window's steps, in %."""


def read(run):
    issue = decode = 0.0
    for s in run.steps():
        if not s["decodes"]:
            continue
        issue += sum(t1 - t0 for t0, t1 in s["decodes"])
        decode += (s["t1"] - s["t0"]) - sum(t1 - t0 for t0, t1, _ in s["prefills"])
    return 100.0 * issue / decode if decode > 0 else None
