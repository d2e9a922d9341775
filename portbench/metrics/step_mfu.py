"""step_mfu: model FLOPs of the tokens served in the window over the
window's seconds and the card's bf16 peak, in %: each prefill whose first
token came in the window at its prompt length, each later token at its
position (``portbench.harness.modelflops``: live weights only, a token's
top-k experts, causal attention over the filled positions, the head)."""
from portbench.harness import modelflops


def read(run):
    if not run.peaks:
        return None
    arch, pruning = run.cfg["arch"], run.cfg["pruning"]
    flops = 0.0
    for r, i, _ in run.window_tokens():
        S = len(r.prompt)
        flops += (modelflops.prefill_flops(arch, pruning, S) if i == 0
                  else modelflops.decode_flops(arch, pruning, S + i - 1))
    return 100.0 * flops / ((run.w1 - run.w0) * run.peaks["bf16_flops_per_s"])
