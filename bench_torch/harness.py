"""The benchmark's shared machinery: finding a cell's files by name, the
output check, the traced run and the last line.

Every piece that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment's sizes and precisions
  (``bits``, the matrix's; ``vector_bits``, the vectors', where it
  differs; ``control``, the precisions of the check's control, where they
  are not one below each); its ``system`` key names
  ``systems/<system>.py``, the module that sets the program up and
  answers one request;
- ``traffic/<traffic>.json``: the load's parameters; its ``generator``
  key names ``generators/<generator>.py``, whose ``Generator`` warms the
  system up and drives one window, and the rest is read by that module
  and the system module;
- ``e2e/<metric>.py`` and ``metrics/<metric>.py``: one reader each,
  ``read(run) -> float | None``; a metric ``<stem>.<part>`` with no file
  of its own is read by ``e2e/<stem>.py`` or ``metrics/<stem>.py``.

A run: set-up (the program's state, the inputs from ``--seed``, the
warm-up), then the device's peak memory reset and a window of
``--seconds`` driven by the traffic's generator; then the window's peak
memory; then the program's state freed and a seeded sample of the
window's answers held against the plain reference (``reference.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


# -- finding things by name ---------------------------------------------------

def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def module_path(kind: str, name: str) -> Path:
    """``<kind>/<name>.py``; for a metric with no file of its own,
    ``<kind>/<stem>.py``, the reader of every ``<stem>.*``."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        path = BENCH / kind / f"{name.split('.')[0]}.py"
    return path


def load_module(kind: str, name: str):
    """``module_path(kind, name)`` as a module (names may hold dots)."""
    path = module_path(kind, name)
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list       # BENCHMARK.json metric entries this cell reports
    per_layer: list


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or spec()
    (entry,) = [w for w in bench["workloads"] if w["name"] == name] or [None]
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    (conf,) = [c for c in bench["configs"] if c["name"] == entry["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    return Cell(name, entry["chips"], config,
                load_json("traffic", entry["traffic"]),
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def derive(seed: int, *what) -> int:
    """A 63-bit integer drawn from ``seed`` and the labels ``what``."""
    text = "/".join(map(str, (seed, *what))).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


# -- the load -----------------------------------------------------------------

@dataclasses.dataclass
class Record:
    client: int
    start: float           # host clock, s
    end: float
    units: int             # iterations or requests the answer completed
    ok: bool


@dataclasses.dataclass
class Sample:
    index: int             # the pool entry the request carried
    answer: object         # what the client read back


# -- the check ----------------------------------------------------------------

def precisions(config: dict) -> tuple[int, int]:
    """(matrix bits, vector bits): ``vector_bits``, the precision of the
    vectors, is ``bits`` where the configuration does not state it."""
    bits = int(config["bits"])
    return bits, int(config.get("vector_bits", bits))


def control_precisions(config: dict) -> tuple[int, int]:
    """The control's (matrix bits, vector bits): the configuration's
    ``control`` where it states one, else one precision below each."""
    if "control" in config:
        return (int(config["control"]["bits"]),
                int(config["control"]["vector_bits"]))
    return tuple(b - 1 for b in precisions(config))


def gaps(load, samples: list, config: dict, answers=None) -> list:
    """For each sample, |e - e_ref| / e_ref, where e is the error of the
    answer (the program's, or ``answers`` in its place) against the exact
    result and e_ref that of the plain reference at the configuration's
    precisions."""
    want = load.reference_answers(samples, precisions(config), "reference")
    got = answers if answers is not None else [s.answer for s in samples]
    out = []
    for s, a, r in zip(samples, got, want):
        e, e_ref = load.error(a, s), load.error(r, s)
        out.append(abs(e - e_ref) / e_ref)
    return out


def control_answers(load, samples: list, config: dict) -> list:
    """The reference at the control's precisions, in the program's
    place."""
    return load.reference_answers(samples, control_precisions(config),
                                  "control")


# -- the run ------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What a reader reads."""
    cell: Cell
    seconds: float
    setup_s: float
    records: list          # Records of requests started in the window
    start: float
    deadline: float
    trace: object = None   # tracing.Trace of the traced run
    counters: dict = None  # the program's launch counts over the traced
                           # window, for program_counter readers
    device_name: str = ""
    memory_peak_bytes: int = 0   # the device's peak in the window

    def completed(self) -> list:
        """Records that completed inside the window."""
        return [r for r in self.records if r.ok and r.end <= self.deadline]

    def rate(self, what: str = "units") -> float:
        done = self.completed()
        n = sum(r.units for r in done) if what == "units" else len(done)
        return n / self.seconds

    def latencies_ms(self) -> list:
        """Every request started in the window, by the host clock."""
        return sorted((r.end - r.start) * 1e3 for r in self.records if r.ok)

    def units(self) -> int:
        """Iterations or requests of every request started in the window
        (the traced run waits for each)."""
        return sum(r.units for r in self.records if r.ok)

    def traced_window_s(self) -> float:
        """From the window's start to the last answer of the traced run."""
        return max([r.end for r in self.records],
                   default=self.deadline) - self.start

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.trace.busy_ns() / 1e9
                        / self.traced_window_s())


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q`` percentile of sorted ``values``."""
    return values[max(0, math.ceil(q / 100 * len(values)) - 1)]


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=30).stdout.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({type(e).__name__})"


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


HOST_CPUS = 4


def pin_cpus():
    """Run this process, and every thread and child it starts later, on
    the first ``HOST_CPUS`` of the cores it may use: threads that move
    between the cores of a shared host stall at random and widen the
    spread of the served cells' tails between runs."""
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cpus[:HOST_CPUS])


def cache_dirs():
    """Keep every build and kernel cache inside the checkout, at fixed
    paths."""
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def setup(cell: Cell, seed: int, device, traced: bool):
    """The cell's system module's Load, set up."""
    import torch
    system = load_module("systems", cell.config["system"])
    span = (torch.profiler.record_function if traced
            else lambda name: contextlib.nullcontext())
    return system.Load(cell.config, cell.traffic, seed, device, span)


def generator(cell: Cell, load, seed: int):
    """The traffic's generator, driving ``load``."""
    module = load_module("generators", cell.traffic["generator"])
    return module.Generator(load, cell.traffic, seed)


def window(gen, seconds: float, traced: bool, cuda: bool):
    """The measured window; with ``traced``, under the profiler, with the
    program's launch counts over it -> (records, samples, errors, start,
    deadline, Trace or None, counts or None)."""
    import torch
    if not traced:
        if cuda:
            torch.cuda.synchronize()
        return (*gen.run(seconds), None, None)
    from clover_tpu_torch import kernels
    from bench_torch import tracing
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        out = gen.run(seconds)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
    counts = {k: after[k] - before[k] for k in after}
    return (*out, tracing.collect(prof), counts)


def measure(cell: Cell, seed: int, seconds: float, traced: bool, t_start: float,
            device="cuda"):
    """Set-up, warm-up and the window -> (Run, load, samples, errors,
    the window's memory peak)."""
    import torch
    cuda = torch.device(device).type == "cuda"
    load = setup(cell, seed, device, traced)
    gen = generator(cell, load, seed)
    gen.warm()
    # what set-up made stays: later collections scan only the window's
    # objects
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.synchronize()
        # the peak of what the window holds, not of set-up's freed inputs
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    records, samples, errors, start, deadline, trace, counts = window(
        gen, seconds, traced, cuda)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = Run(cell, seconds, setup_s, records, start, deadline, trace, counts,
              memory_peak_bytes=peak)
    return run, load, samples, errors, peak


def check(cell: Cell, load, samples: list, errors: list) -> dict:
    """{name: {"value", "limit"}} of the numbers compared."""
    (name, limit), = cell.config["limits"].items()
    values = gaps(load, samples, cell.config) if samples else [math.inf]
    return {name: {"value": max(values), "limit": limit,
                   "answers": len(samples)},
            "failed_requests": {"value": len(errors), "limit": 0}}


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def read_metrics(run: Run, entries: list) -> dict:
    kind = "e2e" if entries is run.cell.end_to_end else "metrics"
    out = {}
    for m in entries:
        value = load_module(kind, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(cell: Cell, seed: int, seconds: float, traced: bool,
            t_start: float, device="cuda") -> tuple[dict, dict]:
    """One run of ``cell`` -> (the result line, the numbers compared with
    their limits and the count of answers each covers)."""
    import torch
    cuda = torch.device(device).type == "cuda"
    run, load, samples, errors, peak = measure(cell, seed, seconds, traced,
                                               t_start, device)
    run.device_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": run.device_name,
           "count": cell.chips, "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit"] = power_limit()
    if traced:
        dev["busy_s"] = run.trace.busy_ns() / 1e9
        dev["window_s"] = run.traced_window_s()
        metrics = read_metrics(run, cell.per_layer)
    else:
        metrics = read_metrics(run, cell.end_to_end)
    load.close()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    checks = check(cell, load, samples, errors)
    line = {"correct": correct(checks) and bool(run.completed()),
            "attempted": len(run.records),
            "failed": sum(not r.ok for r in run.records),
            "metrics": metrics, "device": dev}
    if traced:
        line["breakdown"] = {"device_ops": run.trace.device_ops_by_time(),
                             "idle_gaps": run.trace.idle_by_span()}
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                      for k, v in checks.items()}
    for e in errors[:5]:
        print(e, file=sys.stderr)
    return line, checks


# JAX and the JAX package the port was made from: the run measures the
# port alone.  Top-level names, compared whole (``clover_tpu_torch`` is
# the port).
NOT_LOADED = ("jax", "jaxlib", "flax", "clover_tpu")


def loaded_not_allowed() -> list:
    """The names of ``NOT_LOADED`` that this process has imported."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(NOT_LOADED))


def main(argv, t_start: float) -> int:
    args = parse(argv)
    pin_cpus()
    cache_dirs()
    cell = find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, checks = execute(cell, args.seed, args.seconds, bool(args.trace),
                           t_start)
    found = loaded_not_allowed()
    if found:
        print(f"loaded in the run's process: {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}"
              + (f" over {v['answers']} answers" if "answers" in v else ""),
              file=sys.stderr)
    print(json.dumps(line))
    return 0
