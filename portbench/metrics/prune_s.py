"""prune_s: ``prune_params`` and ``compress_params`` on the dense
weights (the MoE's expert leaves through the host), host clock, ended by
a synchronise."""


def read(run):
    return run.prune_s
