"""Set-up: from the process's start to the first timed batch (imports, the
card's start, the weights made from the seed, the kernels loaded, and on a
checkout's first run built, every shape of the traffic warmed up)."""


def value(run):
    return run.setup_s
