"""Seconds from the process's start to the first timed step: imports, the
card, building or loading the kernels, the weights, the compared first steps
and the warm-up (host clock)."""


def read(run):
    return run.setup_s
