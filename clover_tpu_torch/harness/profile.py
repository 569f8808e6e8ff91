"""Profiling (counterpart of clover_tpu/harness/profile.py): device traces
from ``torch.profiler`` (Chrome trace format, viewable in Perfetto) and a
roofline accountant that pairs measured op times with the bytes each op
must move, against the card's data-sheet memory rate.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .timing import gbs, pct_roofline


@contextlib.contextmanager
def trace(logdir: str = "build/clover_tpu_torch_trace"):
    """Profile a block, CPU activity and, where a card is present, CUDA
    activity; the Chrome trace goes into ``logdir``.  Yields the profiler
    (``key_averages()`` sums device time by kernel); a region inside it
    is a ``tracing.span``:

        with profile.trace("build/t") as prof:
            run_step()
    """
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"))


def roofline_report(entries, device="cuda") -> str:
    """entries: [(name, nbytes, seconds)] -> formatted roofline table
    against ``device``'s memory rate (a CUDA device or a card's name)."""
    lines = [f"{'op':32s} {'time(ms)':>10} {'GB/s':>9} {'%HBM roof':>10}"]
    for (name, nbytes, dt) in entries:
        lines.append(f"{name:32s} {dt * 1e3:>10.4f} {gbs(nbytes, dt):>9.1f} "
                     f"{pct_roofline(nbytes, dt, device):>9.1f}%")
    return "\n".join(lines)
