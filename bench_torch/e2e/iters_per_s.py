"""IHT iterations of the solves completed in the window (each ends with x
on the host), over the window."""


def read(run):
    return run.rate("units")
