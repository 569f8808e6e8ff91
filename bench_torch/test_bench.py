"""The benchmark's self-test, on the CPU (the program's plain versions):

    python -m pytest bench_torch -q

It holds ``BENCHMARK.json`` to the contract (every entry found by name,
names and units, which metric moves what), the byte counts to values
worked out by hand, the last line to its keys, and the output check to its
purpose: the control (the reference at the control's precisions) and each
fault planted in the program come out not correct, at sizes the CPU can
hold.  The existing cells' readers are held to the formulas they were
written with, on synthetic traces.
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

# Sizes for a cell whose system's default above does not fit, each with its
# reason, and the window each runs here (a window must see a solve end).
#
# iht4x8-16384x32768.iterate keeps its 100 iterations, its mu * m (0.4096),
# K = n / 4 and its 4x8 precisions.  Its control, the pure 4-bit solve,
# separates from sound runs only as the size grows: at 1152 x 2304 a sound
# run's answers read gaps up to 0.021 and the control's as little as 0.011
# (2 seeds), at 1664 x 3328 0.021 against 0.023 (3 seeds).  At 2304 x 4608
# (4 seeds of 2 answers) sound answers read at most 0.0165, the control's
# at least 0.035, and the program with y at 4 bits at least 0.034 (its runs'
# worst 0.049 and more): so CPU_LIMIT_4X8.  2304 is no multiple of 512, so
# the program takes the unchained iteration (two MVM+AXPY legs and
# threshold8), its path at 16384 x 32768.  A solve takes ~5 s here, so the
# window is 12 s.
CPU_LIMIT_4X8 = 0.03
CELLS = {"iht4x8-16384x32768.iterate": dict(
    m=2304, n=4608, K=1152, mu=0.4096 / 2304,
    limits={"recovery_gap": CPU_LIMIT_4X8})}
SECONDS = {"iht4x8-16384x32768.iterate": 12.0}


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


def test_jax_is_named_and_the_port_is_not(monkeypatch):
    import types
    assert harness.loaded_not_allowed() == []
    for name in ("jax.numpy", "clover_tpu.ops", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "clover_tpu_torch_x",
                        types.ModuleType("clover_tpu_torch_x"))
    assert harness.loaded_not_allowed() == ["clover_tpu", "flax", "jax"]


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
    # 4x8: the same Phi and PhiT; 8-bit y (16384 bytes of codes, 256
    # scales) and x read and written (32768 bytes, 512 scales, each)
    assert roofline.iteration_bytes(16384, 32768, 4, 8) == (
        2 * mat + (16384 + 1024) + 2 * (32768 + 2048)) == 538_006_528
    assert roofline.solve_setup_bytes(16384, 32768, 4, 8) == (
        2_684_354_560 + 2 * 256 * 512 * 4 + 16384 * 4 + 16384 + 256 * 4)
    for m, n in ((16384, 32768), (4096, 8192), (1000, 3000)):
        for bits in (4, 8):
            assert roofline.iteration_bytes(m, n, bits) == (
                roofline.iteration_bytes(m, n, bits, bits))
            assert roofline.solve_setup_bytes(m, n, bits) == (
                roofline.solve_setup_bytes(m, n, bits, bits))
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


# -- the readers of the cells before the 4x8 cell -------------------------------

def _synthetic_run(name: str) -> harness.Run:
    """Three solves, each a ``bench.solve.setup`` span (kernels of 500 and
    300 us), a ``bench.solve.iterate`` span (an ``mvm_kernel`` of 100 us,
    a leg of 100 us, a select of 20 us) and a restore of 5 us outside
    both; four requests, the last ending after the 51 s window."""
    ops, spans, launches, t = [], [], {}, 1_000
    for _ in range(3):
        spans.append(tracing.Span("bench.solve.setup", t, t + 2_000_000, 1))
        spans.append(tracing.Span("bench.solve.iterate", t + 2_000_000,
                                  t + 3_000_000, 1))
        for name_, at, length in (
                ("quantize_mat_kernel", 10, 500_000),
                ("transpose4_kernel", 600_000, 300_000),
                ("void clover::mvm_kernel<4, 4, 8>(clover::MvmArgs)",
                 2_000_010, 100_000),
                ("void clover::mvm_kernel<4, 4, 4>(clover::MvmArgs)",
                 2_200_000, 100_000),
                ("threshold_kernel", 2_400_000, 20_000),
                ("restore_vec_kernel", 3_100_000, 5_000)):
            c = len(ops) + 1
            ops.append(tracing.DeviceOp(name_, "kernel", t + at + 5,
                                        t + at + 5 + length, c))
            launches[c] = (t + at, 1)
        t += 4_000_000
    cell = harness.find_cell(name, SPEC)
    units = cell.config.get("iterations", 1)
    records = [harness.Record(0, a, b, units, True) for a, b in (
        (0.0, 0.002), (0.002, 0.005), (0.005, 0.0075), (0.0075, 60.0))]
    run = harness.Run(cell, 51.0, 7.5, records, 0.0, 51.0,
                      tracing.Trace(ops, launches, spans),
                      memory_peak_bytes=135_088_128)
    run.device_name = "NVIDIA H100 80GB HBM3"
    return run


# Each reader's value on ``_synthetic_run``, by the formula it had before
# configurations could state a vector precision: a window of 60 s from
# the first request to the last answer, 3 x 1.025 ms busy.
RATE = 3.35e12
IDLE = 100 * (1 - 3 * 1.025e-3 / 60.0)
BEFORE = {
    "iht4-16384x32768.solve": {
        "solve_ms_p95": (60.0 - 0.0075) * 1e3, "setup_s": 7.5,
        "device_idle.solve": IDLE,
        "setup_roofline.solve": 100 * 3 * 2_685_477_888 / RATE / 2.4e-3},
    "iht4-16384x32768.iterate": {
        "iters_per_s": 3 * 2 / 51.0, "setup_s": 7.5,
        "device_idle.iterate": IDLE,
        "iteration_roofline.iterate":
            100 * 3 * 2 * 537_965_568 / RATE / 6.6e-4,
        "launches_per_iter.iterate": 18 / (4 * 2)},
    # the served rate as a per-layer metric, and the served deployment's
    # device memory as its end-to-end metric, since no bound holds the rate
    "mvm4serve-16384.clients1": {
        "requests_per_s.serve": 3 / 51.0, "setup_s": 7.5,
        "device_memory_mb": 135.088128,
        "device_idle.serve": IDLE,
        "mvm_roofline.serve": 100 * 6 * 134_498_304 / RATE / 6e-4},
    # the chain's rate, idle share and launches under names of its own
    # since its iterations per second took a bound of their own
    "iht4-4096x8192.chain": {
        "iters_per_s.chain": 3 * 100 / 51.0, "setup_s": 7.5,
        "device_idle.chain": IDLE,
        "launches_per_iter.chain": 18 / (4 * 100),
        "iter_device_us.chain": 3 * 220 / (3 * 100)},
}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_readers_keep_their_values(name):
    """Every end-to-end and per-layer reader of the cells that came before
    the 4x8 configuration reads what its formula gave then."""
    run = _synthetic_run(name)
    cell = run.cell
    assert {m["name"] for m in cell.end_to_end + cell.per_layer} == set(
        BEFORE[name])
    for kind, entries in (("e2e", cell.end_to_end),
                          ("metrics", cell.per_layer)):
        for m in entries:
            got = harness.load_module(kind, m["name"]).read(run)
            assert got == pytest.approx(BEFORE[name][m["name"]],
                                        rel=1e-12), m["name"]


def test_4x8_roofline_counts_8_bit_vectors():
    run = _synthetic_run("iht4x8-16384x32768.iterate")
    got = harness.load_module("metrics", "iteration_roofline.iterate").read(
        run)
    assert got == pytest.approx(100 * 3 * 100 * 538_006_528 / RATE / 6.6e-4,
                                rel=1e-12)


def test_precisions():
    """Configurations that state one precision keep it for the vectors and
    a control one below both; the 4x8 configuration states its own."""
    for w in SPEC["workloads"]:
        c = harness.find_cell(w["name"], SPEC).config
        if "vector_bits" not in c:
            assert harness.precisions(c) == (c["bits"], c["bits"])
            assert harness.control_precisions(c) == (c["bits"] - 1,
                                                     c["bits"] - 1)
    c = harness.find_cell("iht4x8-16384x32768.iterate", SPEC).config
    assert harness.precisions(c) == (4, 8)
    assert harness.control_precisions(c) == (4, 4)


def test_cpu_sizes_keep_the_protocol():
    """A cell sized down for the CPU keeps its iterations, mu * m, K / n
    and precisions, and a side off the whole-iteration kernel's multiples
    of 512 where the cell's are past its 8192 (then the unchained
    iteration runs)."""
    for name in CELLS:
        full = harness.find_cell(name, SPEC).config
        small = small_cell(name).config
        assert small["iterations"] == full["iterations"]
        assert small["mu"] * small["m"] == pytest.approx(
            full["mu"] * full["m"], rel=1e-12)
        assert small["K"] / small["n"] == full["K"] / full["n"]
        assert harness.precisions(small) == harness.precisions(full)
        if full["m"] > 8192 or full["n"] > 8192:
            assert small["m"] % 512 or small["n"] % 512


# -- the reference's quantize order -------------------------------------------

@pytest.mark.parametrize("bits", [3, 4, 8])
def test_reference_codes_in_the_programs_order(bits):
    """``reference._codes`` forms ``qmax / s`` and ``s / qmax`` as IEEE
    divisions, as the program does (``ops/_core.sr_codes``,
    ``expand_vec_scales``): the restored values agree bit for bit, the
    absmax elements too, where a reciprocal times qmax floors a share of
    them one code lower."""
    from bench_torch import reference
    from clover_tpu_torch.ops import _core
    gen = torch.Generator().manual_seed(bits)
    # blocks of 64 with scales over many binades; every block's absmax
    # element at a random place
    v = torch.rand(4096, 64, generator=gen) * 2 - 1
    v *= torch.exp2(torch.randint(-20, 20, (4096, 1), generator=gen))
    flat = v.reshape(-1)
    got = reference.quant_vec(flat, bits)
    s = _core.block_scales(flat)
    qm = reference.qmax(bits)
    # the program's order (``ops/_core`` holds 4 and 8 bits; 3 as they)
    mult = _core.div(qm, s.repeat_interleave(64))
    codes = torch.floor(flat.abs() * mult).clamp_max(qm) * torch.sign(flat)
    want = codes * _core.div(s, qm).repeat_interleave(64)
    assert torch.equal(got, want)
    top = flat.abs() == s.repeat_interleave(64)
    assert torch.equal(got[top].abs(), want[top].abs())
    if bits in (4, 8):
        codes8 = _core.sr_codes(flat, s.repeat_interleave(64), bits, None)
        assert torch.equal(codes8.float(), codes)
    # the reciprocal form the reference had reads lower on some of them
    recip = torch.floor(flat.abs() * (qm / s.repeat_interleave(64)))
    assert (recip[top] < codes[top].abs()).any()


# -- runs on the CPU -------------------------------------------------------------

def small_cell(name: str, **traffic) -> harness.Cell:
    cell = harness.find_cell(name, SPEC)
    cell.config.update(CELLS.get(name) or SMALL[cell.config["system"]])
    cell.traffic.update({"warmup": 1, "sample": 4} | traffic)
    return cell


def run_cpu(cell, seconds: float = 1.0):
    torch.manual_seed(0)
    return harness.execute(cell, 2 ** 31 + 12345, seconds, False,
                           time.perf_counter(), "cpu")


DEVICE_ONLY = {"device_memory_mb"}


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_last_line(name):
    line, _ = run_cpu(small_cell(name), SECONDS.get(name, 1.0))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    cell = harness.find_cell(name, SPEC)
    # a CPU run has no device allocator to read memory from
    on_cpu = {m["name"] for m in cell.end_to_end} - DEVICE_ONLY
    assert set(line["metrics"]) == on_cpu
    for m in cell.end_to_end:
        if m["name"] in DEVICE_ONLY:
            continue
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
    ("iht", "iht4x8-16384x32768.iterate",
     CELLS["iht4x8-16384x32768.iterate"]),
])
def test_control_fails(system, name, size):
    """The reference at the control's precisions (one below the
    configuration's, or the ones it states), in the program's place,
    reads above the limit on every sampled answer."""
    cell = harness.find_cell(name, SPEC)
    cell.config.update(size)
    module = harness.load_module("systems", system)
    load = module.Load.__new__(module.Load)
    load.__dict__.update(_reference_only(module, cell, seed=7))
    samples = [harness.Sample(j, None) for j in range(4)]
    control = harness.gaps(
        load, samples, cell.config,
        harness.control_answers(load, samples, cell.config))
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


def _y_at_matrix_bits(monkeypatch):
    """The program's y quantized at the matrix's 4 bits: x starts at y's
    precision, so the solve runs the 4x4 path in place of 4x8."""
    import clover_tpu_torch as tt
    quantize_vec = tt.quantize_vec
    monkeypatch.setattr(tt, "quantize_vec",
                        lambda x, bits, generator=None:
                        quantize_vec(x, 4, generator))


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
    ("iht4x8-16384x32768.iterate", _y_at_matrix_bits, {}),
    ("iht4x8-16384x32768.iterate", _state_unchanged, {}),
    ("iht4x8-16384x32768.iterate", _answer_altered_iht, {}),
])
def test_fault_is_not_correct(monkeypatch, name, fault, traffic):
    fault(monkeypatch)
    line, checks = run_cpu(small_cell(name, **traffic),
                           SECONDS.get(name, 1.0))
    assert line["correct"] is False, checks
