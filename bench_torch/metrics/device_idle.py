"""Percent of the traced window in which no operation (kernel, copy or
set) ran on the device; the reader of every ``device_idle.<cell kind>``."""


def read(run):
    return run.idle_pct()
