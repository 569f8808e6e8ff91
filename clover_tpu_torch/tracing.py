"""The program's spans and counters.

Spans mark where the host spends its time: ``clover.solve``,
``clover.chain`` (each chained launch) and ``clover.iteration`` (each
unchained iteration; models/solvers.py), ``clover.kernel.<name>`` around
each kernel wrapper's checks, allocations and launch (:func:`kernel`), and
``clover.server.gather`` and ``clover.server.batch`` on the MVM server's
dispatcher (serving.py).  A span is recorded only while a
``torch.profiler`` records, as an operator event on the profiler's clock,
the clock of the device activity it traces; otherwise :func:`span` returns
one shared no-op context after one test of a module flag.  A profiler
records spans on threads other than its own (the server's dispatcher) only
with ``experimental_config=torch._C._profiler._ExperimentalConfig(
profile_all_threads=True)``.

Counters are always on: process-wide integers, each written at most once
per request, batch, solve or kernel call, read with :func:`counters`:
``server.*`` (serving.py) and ``solver.chained_iterations``
(models/solvers.py).  The
kernels' launch counts stay on their wrappers (``<wrapper>.launches``,
``kernels.launch_counts()``).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.autograd import profiler as _profiler

SPAN_PREFIX = "clover."

# An operator-scope record function: its events carry no device-side copy,
# unlike record_function's user annotations.
_recorder = getattr(torch._C._profiler, "_RecordFunctionFast",
                    torch.profiler.record_function)
_OFF = contextlib.nullcontext()

_lock = threading.Lock()
_counts: dict[str, int] = {}


def span(name: str):
    """A context that records the span ``name`` while a profiler records,
    and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _recorder(name)


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """A snapshot of every counter written so far."""
    with _lock:
        return dict(_counts)


def kernel(name: str):
    """Decorate a ``*_cuda`` wrapper, the kernel ``name`` of
    ``kernels.KERNELS``: each call runs in the span
    ``clover.kernel.<name>``, and each call that returns adds one to the
    wrapper's ``launches``."""
    label = f"{SPAN_PREFIX}kernel.{name}"

    def decorate(fn):
        @functools.wraps(fn)
        def launch(*args, **kwargs):
            if _profiler._is_profiler_enabled:   # span(), inlined
                with _recorder(label):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            with _lock:
                launch.launches += 1
            return out

        launch.kernel = name
        launch.launches = 0
        return launch

    return decorate
