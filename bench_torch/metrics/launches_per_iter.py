"""Kernels the device ran in the traced window, the program's and torch's,
per IHT iteration of the solves started in it; the reader of every
``launches_per_iter.<cell kind>``."""


def read(run):
    iterations = run.units()
    kernels = len(run.trace.kernels())
    return kernels / iterations if iterations and kernels else None
