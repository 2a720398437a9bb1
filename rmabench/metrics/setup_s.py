"""Set-up time: process start to the first timed step or request (host
clock): imports, weights made from the seed, kernels loaded (built on a
checkout's first run), warm-up and the checked steps."""


def read(run):
    return run.setup_s
