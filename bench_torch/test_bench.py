"""The benchmark's self-test, on the CPU (the program's plain versions):

    python -m pytest bench_torch -q

It holds ``BENCHMARK.json`` to the contract (every entry found by name,
names and units, which metric moves what), the byte counts to values
worked out by hand, the last line to its keys, and the output check to its
purpose: the control (the reference one precision below) and each fault
planted in the program come out not correct, at sizes the CPU can hold.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import harness, roofline, tracing  # noqa: E402

SPEC = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")

# Small sizes for the CPU: a tuned IHT entry and a square MVM.  A sound
# run's gap at 512 x 1024 reads up to a few percent (the full size's reads
# under 1%), so the IHT's runs here hold to a limit of 0.08; the faults
# planted below read 0.15 and more.
SMALL = {"iht": dict(m=512, n=1024, K=256, mu=0.003427354231262207,
                     iterations=3, limits={"recovery_gap": 0.08}),
         "mvm_server": dict(m=1024, n=1024)}


# -- BENCHMARK.json against the contract ---------------------------------------

def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.ROOT / p).is_dir()
    assert 1 <= len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert LINE.match(word) and not word.startswith("/")
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entry_keys_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        entries = SPEC[group]
        assert len({e["name"] for e in entries}) == len(entries)
        for e in entries:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                  "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert LINE.match(e[text]), e["name"]
    assert len(SPEC["per_layer"]) <= 128 and len(SPEC["end_to_end"]) <= 16


def test_configs_resolve():
    used = {w["config"] for w in SPEC["workloads"]}
    assert 1 <= len(SPEC["configs"]) <= 24
    files = set()
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert (harness.BENCH / "systems" / f"{data['system']}.py").is_file()
        assert len(data["limits"]) == 1


def test_workloads_resolve():
    pairs = set()
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = harness.load_json("traffic", w["traffic"])
        # the traffic's generator is a module found by its name
        assert NAME.match(traffic["generator"])
        module = harness.load_module("generators", traffic["generator"])
        assert callable(module.Generator)
        cell = harness.find_cell(w["name"], SPEC)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
    assert len(SPEC["workloads"]) <= 24
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)


def test_metrics_resolve():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        assert callable(harness.load_module("e2e", m["name"]).read)
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            # every cell that reads this metric reports what it moves
            assert harness.applies(moved, cell), (m["name"], cell)
        assert callable(harness.load_module("metrics", m["name"]).read)
        # a reader of its own, or its stem's: device_idle.* share one
        path = harness.module_path("metrics", m["name"])
        assert path.stem in (m["name"], m["name"].split(".")[0])
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for name, names in layers.items():
        assert len(names) == 1, name


# -- the byte counts ---------------------------------------------------------

def test_byte_counts_by_hand():
    # 16384 x 32768: f32 Phi 2,147,483,648; each 4-bit Phi 268,435,456 of
    # codes and 256 x 512 tiles of 4-byte scales
    mat = 268_435_456 + 256 * 512 * 4
    assert roofline.mat_bytes(16384, 32768, 4) == mat == 268_959_744
    assert roofline.solve_setup_bytes(16384, 32768, 4) == (
        2_684_354_560 + 2 * 256 * 512 * 4 + 16384 * 4 + 8192 + 256 * 4)
    assert roofline.iteration_bytes(16384, 32768, 4) == (
        2 * mat + (8192 + 1024) + 2 * (16384 + 2048)) == 537_965_568
    # 16384 x 16384: 134,217,728 bytes of codes, 256 x 256 scales
    assert roofline.mvm_batch_bytes(16384, 16384, 4, 8) == (
        134_217_728 + 262_144 + 8 * 2 * (8192 + 1024))
    assert roofline.memory_rate("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.share_pct(3.35e9, 1e-3, 3.35e12) == pytest.approx(100.0)
    assert roofline.share_pct(1.0, 0.0, 3.35e12) is None


# -- the trace reduction -------------------------------------------------------

def test_trace_reduction():
    ops = [tracing.DeviceOp("k1", "kernel", 100, 200, 1),
           tracing.DeviceOp("k2", "kernel", 150, 300, 2),
           tracing.DeviceOp("copy", "memcpy", 500, 600, 3),
           tracing.DeviceOp("k1", "kernel", 900, 1000, 4)]
    launches = {1: (10, 7), 2: (20, 7), 3: (30, 8), 4: (700, 7)}
    spans = [tracing.Span("bench.a", 5, 25, 7),
             tracing.Span("bench.b", 25, 800, 7)]
    tr = tracing.Trace(ops, launches, spans)
    assert tr.busy_ns() == 200 + 100 + 100
    assert [k.correlation for k in tr.kernels_in("bench.a")] == [1, 2]
    assert [k.correlation for k in tr.kernels_in("bench.b")] == [4]
    assert tr.span_count("bench.b") == 1
    assert tr.device_ops_by_time(1) == [["k1", 200 / 1e9]]
    idle = dict(tr.idle_by_span())
    assert idle == {"during bench.b": 500 / 1e9}


# -- runs on the CPU -------------------------------------------------------------

def small_cell(name: str, **traffic) -> harness.Cell:
    cell = harness.find_cell(name, SPEC)
    cell.config.update(SMALL[cell.config["system"]])
    cell.traffic.update({"warmup": 1, "sample": 4} | traffic)
    return cell


def run_cpu(cell, seconds: float = 1.0):
    torch.manual_seed(0)
    return harness.execute(cell, 2 ** 31 + 12345, seconds, False,
                           time.perf_counter(), "cpu")


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_last_line(name):
    line, _ = run_cpu(small_cell(name))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    cell = harness.find_cell(name, SPEC)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = line["metrics"][m["name"]]
        assert got == {"value": got["value"], "unit": m["unit"]}
        assert got["value"] > 0 and math.isfinite(got["value"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("system,name,size", [
    ("iht", "iht4-16384x32768.solve", dict(m=2048, n=4096, K=1024,
                                           mu=0.0010050263122558596,
                                           iterations=2)),
    ("mvm_server", "mvm4serve-16384.clients1", dict(m=2048, n=2048)),
])
def test_control_fails(system, name, size):
    """The reference one precision below, in the program's place, reads
    above the limit on every sampled answer."""
    cell = harness.find_cell(name, SPEC)
    cell.config.update(size)
    module = harness.load_module("systems", system)
    load = module.Load.__new__(module.Load)
    load.__dict__.update(_reference_only(module, cell, seed=7))
    samples = [harness.Sample(j, None) for j in range(4)]
    bits = cell.config["bits"]
    control = harness.gaps(load, samples, bits,
                           harness.control_answers(load, samples, bits))
    (limit,) = cell.config["limits"].values()
    assert min(control) > limit, control


def _reference_only(module, cell, seed: int) -> dict:
    """The state a Load's reference needs, without the program."""
    c, dev = cell.config, torch.device("cpu")
    state = dict(seed=seed, m=c["m"], n=c["n"], bits=c["bits"], device=dev)
    if c["system"] == "iht":
        phi = module.make_phi(c["m"], c["n"], seed, dev)
        x_star, y = module.make_problems(phi, c["K"], 4, seed)
        state.update(k=c["K"], mu=c["mu"], iterations=c["iterations"],
                     per_request=True, x_star=x_star, y=y, _ref_phi={})
    else:
        state.update(pool=4)
    return state


# -- faults planted in the program -------------------------------------------

def _state_unchanged(monkeypatch):
    from clover_tpu_torch.models import solvers
    monkeypatch.setattr(solvers, "_iteration",
                        lambda Phi, PhiT, y, x, mu, k, seed: x)


def _answer_altered_iht(monkeypatch):
    import clover_tpu_torch as tt
    restore = tt.restore_vec

    def altered(q):
        out = restore(q)
        return dataclasses.replace(out, values=out.values.flip(-1))
    monkeypatch.setattr(tt, "restore_vec", altered)


def _half_batch_left_out(monkeypatch):
    from clover_tpu_torch import serving
    mvm_batched = serving.mvm_batched

    def half(A, xs, generator=None):
        ys = mvm_batched(A, xs, generator)
        b = ys.codes.shape[0]
        keep = math.ceil(b / 2)
        rows = torch.cat([torch.arange(keep), torch.zeros(b - keep,
                                                          dtype=torch.long)])
        return dataclasses.replace(ys, codes=ys.codes[rows],
                                   scales=ys.scales[rows])
    monkeypatch.setattr(serving, "mvm_batched", half)


def _answer_altered_server(monkeypatch):
    from clover_tpu_torch import serving
    mvm_batched = serving.mvm_batched

    def altered(A, xs, generator=None):
        ys = mvm_batched(A, xs, generator)
        return dataclasses.replace(ys, codes=torch.roll(ys.codes, 32, -1))
    monkeypatch.setattr(serving, "mvm_batched", altered)


@pytest.mark.parametrize("name,fault,traffic", [
    ("iht4-16384x32768.solve", _state_unchanged, {}),
    ("iht4-16384x32768.solve", _answer_altered_iht, {}),
    ("iht4-16384x32768.iterate", _state_unchanged, {}),
    ("iht4-16384x32768.iterate", _answer_altered_iht, {}),
    ("mvm4serve-16384.clients1", _answer_altered_server, {}),
    # a batch of one request has no half to leave out: eight clients
    ("mvm4serve-16384.clients1", _half_batch_left_out, {"clients": 8,
                                                        "sample": 16}),
    ("mvm4serve-16384.clients1", _answer_altered_server, {"clients": 8,
                                                          "sample": 16}),
])
def test_fault_is_not_correct(monkeypatch, name, fault, traffic):
    fault(monkeypatch)
    line, checks = run_cpu(small_cell(name, **traffic))
    assert line["correct"] is False, checks
