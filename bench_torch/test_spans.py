"""``spans.py``'s reduction of the program's spans, on synthetic traces in
the style of ``test_bench.py``'s ``test_trace_reduction``:

    python -m pytest bench_torch -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import spans, tracing  # noqa: E402

Span, Op = tracing.Span, tracing.DeviceOp


class Event:
    """The part of a kineto event that ``spans.collect`` reads."""

    def __init__(self, name, start, length, thread=1, device=False):
        self._args = name, start, length, thread, device

    def name(self):
        return self._args[0]

    def start_ns(self):
        return self._args[1]

    def duration_ns(self):
        return self._args[2]

    def start_thread_id(self):
        return self._args[3]

    def device_type(self):
        return DeviceType.CUDA if self._args[4] else DeviceType.CPU


def test_collect_keeps_host_program_spans_and_counts_device_copies():
    events = [Event("clover.solve", 50, 100, 2),
              Event("clover.kernel.mvm4", 60, 10, 2),
              Event("clover.kernel.mvm4", 60, 5, device=True),
              Event("bench.solve.iterate", 40, 200),
              Event("bench.solve.iterate", 40, 200, device=True),
              Event("cudaLaunchKernel", 61, 3)]
    got, copies = spans.collect(events)
    assert got == [Span("clover.solve", 50, 150, 2),
                   Span("clover.kernel.mvm4", 60, 70, 2)]
    assert copies == 1


def test_mean_and_self_time():
    ss = [Span("clover.solve", 0, 100, 1),
          Span("clover.iteration", 10, 90, 1),
          Span("clover.kernel.mvm4", 20, 40, 1),
          Span("clover.kernel.threshold4", 35, 50, 1),   # overlaps the last
          Span("clover.kernel.mvm4", 95, 120, 1),        # past the solve's end
          Span("clover.kernel.mvm4", 0, 100, 2),         # another thread
          Span("clover.solve", 200, 250, 1)]
    assert spans.mean_ns(ss, lambda n: n.startswith(spans.KERNEL)) == (
        20 + 15 + 25 + 100) / 4
    assert spans.mean_ns(ss, lambda n: n == "clover.none") is None
    # 100 less [20, 50) and [95, 100); 50 with no kernel in it
    assert spans.self_ns(ss, "clover.solve", spans.KERNEL) == [65, 50]


def test_a_gap_is_split_between_the_spans_open_in_it():
    ops = [Op("k", "kernel", 0, 100, 1), Op("k", "kernel", 80, 200, 2),
           Op("k", "kernel", 500, 600, 3), Op("k", "kernel", 900, 1000, 4)]
    # the gap [200, 500) starts in gather and ends in batch, on another
    # thread for part of it; [600, 900) starts outside every span
    ss = [Span("clover.server.gather", 150, 300, 5),
          Span("clover.server.batch", 250, 520, 6),
          Span("clover.server.gather", 700, 800, 5)]
    idle = spans.idle_by_program_span(ops, ss)
    assert idle == {"clover.server.gather": 50 + 100,
                    "clover.server.batch+clover.server.gather": 50,
                    "clover.server.batch": 200,
                    spans.OUTSIDE: 100 + 100}
    assert sum(idle.values()) == 300 + 300
    got = spans.readings(ss, idle, {"server.requests": 4,
                                    "server.queue_wait_ns": 2_000_000}, 1e-6)
    assert got == pytest.approx({
        "straggler_wait_ms": 125 / 1e6, "dispatch_host_ms": 270 / 1e6,
        "queue_wait_ms": 0.5, "idle_in_gather_pct": 100.0 * 200 / 1000})


def test_no_program_spans_read_nothing():
    """The parent commit's program: no span, no counter, nothing read; the
    idle time is all outside program spans."""
    ops = [Op("k", "kernel", 0, 100, 1), Op("k", "kernel", 300, 400, 2)]
    assert spans.collect([Event("bench.client.read", 0, 10)]) == ([], 0)
    idle = spans.idle_by_program_span(ops, [])
    assert idle == {spans.OUTSIDE: 200}
    assert spans.readings([], idle, {}, 1.0) == {}
    assert spans.self_ns([], "clover.solve", spans.KERNEL) == []
