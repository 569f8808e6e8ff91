"""The device memory the deployment holds while it serves: the peak that
the allocator reads over the window, in MB (10^6 bytes)."""


def read(run):
    peak = run.memory_peak_bytes
    return peak / 1e6 if peak else None
