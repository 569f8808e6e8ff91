"""What the traced run reads from ``torch.profiler``: the device operations,
the host-side launch behind each, and the benchmark's own spans, reduced to
plain tuples that the per-layer readers take.

A device operation is a kernel, a memory copy or a memory set.  A span is a
``record_function`` region that the benchmark opened around a call into
the program; its name starts with ``SPAN_PREFIX``.  A kernel belongs to a
span when the host call that launched it (matched by the profiler's
correlation id) started inside that span, on the same thread.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

SPAN_PREFIX = "bench."


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    kind: str          # "kernel", "memcpy" or "memset"
    start: int         # ns, the profiler's clock
    end: int
    correlation: int


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: int
    end: int
    thread: int


@dataclasses.dataclass
class Trace:
    ops: list            # DeviceOp, sorted by start
    launches: dict       # correlation id -> (host start ns, thread)
    spans: list          # Span, sorted by start

    def kernels(self) -> list:
        return [op for op in self.ops if op.kind == "kernel"]

    def busy_ns(self) -> int:
        """Length of the union of every device operation's interval."""
        return sum(b - a for a, b in _merged(self.ops))

    def span_count(self, name: str) -> int:
        return sum(s.name == name for s in self.spans)

    def kernels_in(self, name: str) -> list:
        """The kernels launched from inside a span called ``name``."""
        by_thread = collections.defaultdict(list)
        for s in self.spans:
            if s.name == name:
                by_thread[s.thread].append(s)
        starts = {t: [s.start for s in ss] for t, ss in by_thread.items()}
        found = []
        for op in self.kernels():
            launch = self.launches.get(op.correlation)
            if launch is None:
                continue
            t0, thread = launch
            ss = by_thread.get(thread)
            if not ss:
                continue
            i = bisect.bisect_right(starts[thread], t0) - 1
            if i >= 0 and ss[i].start <= t0 <= ss[i].end:
                found.append(op)
        return found

    def device_ops_by_time(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        total = collections.Counter()
        for op in self.ops:
            total[op.name] += op.end - op.start
        return [[name, ns / 1e9] for name, ns in total.most_common(top)]

    def idle_by_span(self, top: int = 10) -> list:
        """[[label, seconds]]: the device's idle gaps, summed by the spans the
        host was in when each gap began ("no span" outside them)."""
        merged = _merged(self.ops)
        gaps = [(end, nxt - end) for (_, end), (nxt, _)
                in zip(merged, merged[1:])]
        edges = sorted([(s.start, 1, s.name) for s in self.spans]
                       + [(s.end, -1, s.name) for s in self.spans])
        open_, idle, i = collections.Counter(), collections.Counter(), 0
        for at, length in gaps:
            while i < len(edges) and edges[i][0] <= at:
                open_[edges[i][2]] += edges[i][1]
                i += 1
            names = sorted(n for n, c in open_.items() if c > 0)
            idle["during " + ("+".join(names) or "no span")] += length
        return [[label, ns / 1e9] for label, ns in idle.most_common(top)]


def _merged(ops) -> list:
    """The union of the operations' intervals as sorted disjoint pairs."""
    out = []
    for op in sorted(ops, key=lambda o: o.start):
        if out and op.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], op.end)
        else:
            out.append([op.start, op.end])
    return out


def _device_kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def collect(prof) -> Trace:
    """The Trace of a finished ``torch.profiler.profile``.  Device events
    are a kernel, a copy or a set, told apart by name, and the profiler's
    device-side copies of the spans, which are left out; a launch is a host
    call into the CUDA runtime or driver (a name starting with "cu")."""
    from torch.autograd import DeviceType
    ops, launches, spans = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(SPAN_PREFIX):
                ops.append(DeviceOp(name, _device_kind(name), start, end,
                                    e.correlation_id()))
        elif name.startswith(SPAN_PREFIX):
            spans.append(Span(name, start, end, e.start_thread_id()))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = (start, e.start_thread_id())
    ops.sort(key=lambda o: o.start)
    spans.sort(key=lambda s: s.start)
    return Trace(ops, launches, spans)
