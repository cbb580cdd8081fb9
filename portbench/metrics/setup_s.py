"""Seconds from the process's start to the first timed request: imports,
CUDA, the kernels' load (and build, in a fresh checkout), the input, the
set-up's encode, staging and warm-up (every cell)."""


def read(run):
    return run.setup_s
