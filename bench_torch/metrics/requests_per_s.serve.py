"""Requests completed in the traced window over the window: the served
rate, which the host's speed moves by more than any bound holds."""


def read(run):
    return run.rate("requests") or None
