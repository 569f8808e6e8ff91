"""The self-test of the chained-iteration cell, on the CPU (the program's
plain versions):

    python -m pytest bench_torch -q

``iht4-4096x8192.chain`` runs 100-iteration solves, which the program
carries ``solvers.ITER_CHAIN`` iterations a launch through
``iteration_chain``.  ``test_bench.py`` runs its IHT cells at 3 iterations,
below one chain, and plants its iteration fault in ``solvers._iteration``,
which a chained solve never calls; here the cell keeps its mu and its 100
iterations at a size the CPU can hold, so every solve chains, and the
faults are planted in the chain.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import harness, tracing  # noqa: E402
from bench_torch.test_bench import (SPEC, _answer_altered_iht,  # noqa: E402
                                    _reference_only, run_cpu)

CELL = "iht4-4096x8192.chain"
# At 1024 x 2048 (K 512) a sound run's gap read at most 0.026 over 4 seeds
# of 4 answers and the control's (the reference at 3 bits) at least 0.093,
# so the runs here hold to the configuration's own limit; the faults read
# 0.17 and more.
SMALL = dict(m=1024, n=2048, K=512)


def small_cell() -> harness.Cell:
    cell = harness.find_cell(CELL, SPEC)
    cell.config.update(SMALL)
    cell.traffic.update(warmup=1, sample=4)
    return cell


def _chained() -> int:
    from clover_tpu_torch import tracing as program
    return program.counters().get("solver.chained_iterations", 0)


def test_cell_keeps_the_protocol():
    config = harness.find_cell(CELL, SPEC).config
    assert (config["m"], config["n"], config["K"]) == (4096, 8192, 2048)
    assert config["iterations"] == 100 and config["bits"] == 4
    from clover_tpu_torch.models.solvers import ITER_CHAIN
    assert config["iterations"] % ITER_CHAIN == 0


def test_last_line_is_correct_and_every_solve_chains():
    cell = small_cell()
    before = _chained()
    line, checks = run_cpu(cell, seconds=2.0)
    assert line["correct"] is True and line["failed"] == 0, checks
    # the warm-up's request and the window's, every iteration chained
    assert _chained() - before == (1 + line["attempted"]) * 100


def _chain_state_unchanged(monkeypatch):
    from clover_tpu_torch.kernels import iteration as fused
    monkeypatch.setattr(fused, "iteration_chain_plain",
                        lambda bits_a, bits_x, phi, phit, y, x, *a: x)


@pytest.mark.parametrize("fault", [_chain_state_unchanged,
                                   _answer_altered_iht])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line, checks = run_cpu(small_cell())
    assert line["correct"] is False, checks


def test_control_fails():
    """The reference at 3 bits, in the program's place, reads above the
    limit on every sampled answer."""
    cell = small_cell()
    module = harness.load_module("systems", cell.config["system"])
    load = module.Load.__new__(module.Load)
    load.__dict__.update(_reference_only(module, cell, seed=7))
    samples = [harness.Sample(j, None) for j in range(4)]
    control = harness.gaps(
        load, samples, cell.config,
        harness.control_answers(load, samples, cell.config))
    (limit,) = cell.config["limits"].values()
    assert min(control) > limit, control


def _run(kernels, spans, units):
    launches = {k.correlation: (k.start - 5, 1) for k in kernels}
    trace = tracing.Trace(kernels, launches, spans)
    records = [harness.Record(0, 0.0, 1.0, u, True) for u in units]
    return harness.Run(harness.find_cell(CELL, SPEC), 51.0, 1.0, records,
                       0.0, 51.0, trace)


def test_readers_by_hand():
    """Two solves of 100 iterations: 25 chain kernels of 90 us each and a
    1 us quantize inside each solve's ``bench.solve.iterate`` span, a 2 us
    restore after it."""
    kernels, spans, t = [], [], 0
    for solve in range(2):
        spans.append(tracing.Span("bench.solve.iterate", t, t + 3_000_000, 1))
        for j in range(26):
            length = 1_000 if j == 0 else 90_000
            kernels.append(tracing.DeviceOp("k", "kernel", t + 10, t + 10
                                            + length, len(kernels) + 1))
            t += 100_000
        t += 1_000_000
        kernels.append(tracing.DeviceOp("r", "kernel", t, t + 2_000,
                                        len(kernels) + 1))
        t += 10_000
    run = _run(kernels, spans, [100, 100])
    iter_us = harness.load_module("metrics", "iter_device_us.chain")
    per_iter = harness.load_module("metrics", "launches_per_iter.iterate")
    assert iter_us.read(run) == pytest.approx(2 * (1 + 25 * 90) / 200)
    assert per_iter.read(run) == pytest.approx(54 / 200)
    # a trace with nothing in it reads nothing
    empty = _run([], [], [100])
    assert iter_us.read(empty) is None and per_iter.read(empty) is None
