"""The program's own spans and counters over one traced window of a cell:

    python bench_torch/spans.py --workload <cell> --seed <n> --seconds <s>

The program records its spans (names starting ``clover.``,
``clover_tpu_torch/tracing.py``) on the profiler's clock while a
``torch.profiler`` records, and counts its server's requests whatever
runs.  This script sets the cell up as ``run.py`` does (``harness.setup``,
the generator's warm-up), then drives one window of ``--seconds`` under a
profiler that records every thread (the MVM server's dispatcher is one of
the program's own) and prints one JSON line: the rate in the traced window, the
cell's per-layer metrics as the benchmark reads them from this trace, the
program's counters over the window, the readings below, and the window's
idle time split by the program spans open during it.  The benchmark's own
runs do not run this; ``harness.window`` records only the thread that
starts its profiler, and reads no program span.

- ``straggler_wait_ms``, ``dispatch_host_ms``: mean length of
  ``clover.server.gather`` and ``clover.server.batch``;
- ``queue_wait_ms``: ``server.queue_wait_ns`` over ``server.requests``;
- ``idle_in_gather_pct``: percent of the window in which no device
  operation runs while a ``clover.server.gather`` span is open;
- ``launch_host_us``: mean length of the ``clover.kernel.*`` spans (a
  kernel wrapper's checks, allocations and launch);
- ``solver_self_us``: per ``clover.solve`` span, its length less the parts
  that ``clover.kernel.*`` spans on its thread cover, mean over solves.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import gc
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

PREFIX = "clover."
KERNEL = PREFIX + "kernel."
OUTSIDE = "outside program spans"


def collect(events):
    """(host-side program Spans by start, count of device-side events
    named like one) from a profiler's kineto events."""
    from torch.autograd import DeviceType
    from bench_torch.tracing import Span
    spans, copies = [], 0
    for e in events:
        name = e.name()
        if not name.startswith(PREFIX):
            continue
        if e.device_type() == DeviceType.CUDA:
            copies += 1
            continue
        start = e.start_ns()
        spans.append(Span(name, start, start + e.duration_ns(),
                          e.start_thread_id()))
    spans.sort(key=lambda s: s.start)
    return spans, copies


def mean_ns(spans, match) -> float | None:
    """Mean length of the spans whose name ``match`` accepts."""
    lengths = [s.end - s.start for s in spans if match(s.name)]
    return sum(lengths) / len(lengths) if lengths else None


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def self_ns(spans, parent: str, child_prefix: str) -> list:
    """For each span named ``parent``, its length less the union of the
    parts of spans named ``child_prefix``... on its thread that lie in
    it."""
    children = collections.defaultdict(list)
    for s in spans:                      # by start
        if s.name.startswith(child_prefix):
            children[s.thread].append(s)
    starts = {t: [c.start for c in cs] for t, cs in children.items()}
    longest = {t: max(c.end - c.start for c in cs)
               for t, cs in children.items()}
    out = []
    for p in spans:
        if p.name != parent:
            continue
        cs, at = children.get(p.thread, []), starts.get(p.thread, [])
        lo = bisect.bisect_left(at, p.start - longest.get(p.thread, 0))
        hi = bisect.bisect_left(at, p.end)
        inside = [(max(c.start, p.start), min(c.end, p.end))
                  for c in cs[lo:hi] if c.end > p.start]
        out.append(p.end - p.start - sum(b - a for a, b in _union(inside)))
    return out


def idle_by_program_span(ops, spans) -> dict:
    """{label: ns} of the gaps between the device's merged operations, each
    part of a gap labelled by the sorted ``+``-joined names of the program
    spans open then, on any thread (``OUTSIDE`` where none is)."""
    busy = _union((op.start, op.end) for op in ops)
    gaps = [(end, nxt) for (_, end), (nxt, _) in zip(busy, busy[1:])]
    edges = sorted([(s.start, 1, s.name) for s in spans]
                   + [(s.end, -1, s.name) for s in spans])
    open_, idle, i = collections.Counter(), collections.Counter(), 0

    def label():
        names = sorted(n for n, c in open_.items() if c > 0)
        return "+".join(names) or OUTSIDE

    for a, b in gaps:
        while i < len(edges) and edges[i][0] <= a:
            open_[edges[i][2]] += edges[i][1]
            i += 1
        at = a
        while i < len(edges) and edges[i][0] < b:
            idle[label()] += edges[i][0] - at
            at = edges[i][0]
            open_[edges[i][2]] += edges[i][1]
            i += 1
        idle[label()] += b - at
    return {k: v for k, v in idle.items() if v > 0}


def readings(spans, idle: dict, counts: dict, window_s: float) -> dict:
    """The readings of the module docstring; a reading with nothing to read
    is left out."""
    gather, batch = PREFIX + "server.gather", PREFIX + "server.batch"
    selves = self_ns(spans, PREFIX + "solve", KERNEL)
    requests = counts.get("server.requests", 0)
    idle_gather = sum(ns for label, ns in idle.items()
                      if gather in label.split("+"))
    ns = {
        "straggler_wait_ms": mean_ns(spans, lambda n: n == gather),
        "dispatch_host_ms": mean_ns(spans, lambda n: n == batch),
        "queue_wait_ms": (counts.get("server.queue_wait_ns", 0) / requests
                          if requests else None),
        "launch_host_us": mean_ns(spans, lambda n: n.startswith(KERNEL)),
        "solver_self_us": sum(selves) / len(selves) if selves else None,
    }
    out = {k: v / (1e6 if k.endswith("_ms") else 1e3)
           for k, v in ns.items() if v is not None}
    if idle_gather:
        out["idle_in_gather_pct"] = 100.0 * idle_gather / 1e9 / window_s
    return out


def _counters() -> dict:
    """The program's counters; none in a program without them."""
    try:
        from clover_tpu_torch import tracing
    except ImportError:
        return {}
    return tracing.counters()


def main(argv) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bench_torch import harness, tracing
    from clover_tpu_torch import kernels
    import torch
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    harness.pin_cpus()
    harness.cache_dirs()
    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    load = harness.setup(cell, args.seed, "cuda", True)
    gen = harness.generator(cell, load, args.seed)
    gen.warm()
    gc.collect()
    gc.freeze()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities,
                                experimental_config=config) as prof:
        torch.cuda.synchronize()
        counts0, launches0 = _counters(), kernels.launch_counts()
        records, _, errors, start, deadline = gen.run(args.seconds)
        torch.cuda.synchronize()
        counts1, launches1 = _counters(), kernels.launch_counts()
    window_end = time.perf_counter()
    counts = {k: v - counts0.get(k, 0) for k, v in counts1.items()}
    launches = {k: v - launches0[k] for k, v in launches1.items() if v
                - launches0[k]}
    events = prof.profiler.kineto_results.events()
    trace = tracing.collect(prof)
    spans, copies = collect(events)
    run = harness.Run(cell, args.seconds, setup_s, records, start, deadline,
                      trace, launches, torch.cuda.get_device_name(0))
    window_s = run.traced_window_s()
    idle = idle_by_program_span(trace.ops, spans)
    load.close()
    line = {
        "workload": cell.name, "seed": args.seed,
        "device": run.device_name, "power_limit": harness.power_limit(),
        "failed": len(errors), "rate": run.rate(),
        "setup_s": setup_s, "window_s": window_s,
        "profiled_s": window_end - start,
        "per_layer": {k: v["value"] for k, v in
                      harness.read_metrics(run, cell.per_layer).items()},
        "program": readings(spans, idle, counts, window_s),
        "counters": counts, "launches": launches,
        "spans": dict(collections.Counter(s.name for s in spans)),
        "device_copies_of_spans": copies,
        "idle_program": [[k, v / 1e9] for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:10]],
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
