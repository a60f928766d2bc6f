"""setup_s: process start to the first timed request (imports, CUDA
start, inputs from the seed, the warm-up request), host clock."""


def read(run):
    return run.setup_s
