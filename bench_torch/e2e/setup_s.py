"""Seconds from the process's start to the window: imports, the kernels'
build or load, the inputs made from the seed, the program's set-up and
the warm-up."""


def read(run):
    return run.setup_s
