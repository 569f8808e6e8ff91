"""Kernels the device ran in the traced window, the program's and torch's,
per IHT iteration of the solves started in it."""


def read(run):
    iterations = run.units()
    kernels = len(run.trace.kernels())
    return kernels / iterations if iterations and kernels else None
