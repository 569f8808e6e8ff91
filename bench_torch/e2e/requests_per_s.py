"""Requests completed in the window (the result's codes and scales on the
client's host), over the window."""


def read(run):
    return run.rate("requests")
