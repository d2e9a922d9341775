"""setup_s: process start to the window's start (imports, kernels loaded
or built, weights made, pruned and compressed, the engine built, the
closed loop run to steady state), host clock."""


def read(run):
    return run.w0 - run.t_start
