"""``-p`` (clover_tpu_torch.harness.perf) on the CPU at small sizes: every
table prints clover_tpu's row names, with its byte counts computed from
clover_tpu containers of the same shapes (clover_tpu/harness/perf.py's
``_row`` arguments).

The port's names differ from the reference's in three places only: the
fp32 MVM baseline is a torch matmul, not the TPU's MXU ("mvm 32-bit
(matmul)"); the rows meant to read the L2 say "L2-warm" (the reference's
"warm" rows and the thresholds at n <= 2^20); and bench_mvm adds the probe
floor rows ("dma probe ...").  No int4 row: Hopper has no int4 MMA.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import clover_tpu as ct
from clover_tpu_torch import cli
from clover_tpu_torch.harness import perf
from torch_helpers import one_thread  # noqa: F401 (autouse)


N = 4096
M = 256


@pytest.fixture
def rows(monkeypatch):
    """(name, nbytes, has a base time, warm) of every _row call."""
    got = []
    real = perf._row

    def record(log, name, nbytes, dt, base_dt=None, device="cuda",
               warm=False):
        got.append((name, nbytes, base_dt is not None, warm))
        return real(log, name, nbytes, dt, base_dt, device, warm)
    monkeypatch.setattr(perf, "_row", record)
    monkeypatch.setattr(perf, "IHT_ITERS", 2)
    return got


def _q(bits, shape=(N,)):
    return ct.quantize(jnp.zeros(shape, jnp.float32), bits)


def _run(bench, *args, **kwargs):
    lines = []
    bench(lines.append, *args, device="cpu", **kwargs)
    return lines


def test_quantize_rows(rows):
    _run(perf.bench_quantize, [N])
    assert rows == [(f"quantize {b:2d}-bit n={N}", 4 * N + _q(b).nbytes,
                     False, False) for b in (4, 8, 16, 32)]


def test_restore_rows(rows):
    _run(perf.bench_restore, [N])
    assert rows == [(f"restore {b:2d}-bit n={N}", _q(b).nbytes + 4 * N,
                     False, False) for b in (4, 8, 16)]


def test_dot_rows(rows):
    _run(perf.bench_dot, [N])
    want = [(f"dot 32-bit n={N}", 8 * N, False, False)]
    want += [(f"dot {b:2d}-bit n={N}", 2 * _q(b).nbytes, True, False)
             for b in (4, 8, 16)]
    assert rows == want
    assert want[-1][1] == 4 * N          # the reference's 2 * q16.nbytes / p


def test_axpy_rows(rows):
    _run(perf.bench_axpy, [N])
    want = [(f"scaleAndAdd 32-bit n={N}", 12 * N, False, False)]
    want += [(f"scaleAndAdd {b:2d}-bit n={N}", 3 * _q(b).nbytes, True, False)
             for b in (4, 8, 16)]
    assert rows == want


def test_small_warm_rows(rows):
    _run(perf.bench_small_warm, [N])
    want = [(f"L2-warm dot 32-bit n={N}", 8 * N, False, True),
            (f"L2-warm axpy 32-bit n={N}", 12 * N, False, True)]
    for b in (4, 8):
        want += [(f"L2-warm dot {b:2d}-bit n={N}", 2 * _q(b).nbytes, True,
                  True),
                 (f"L2-warm axpy {b:2d}-bit n={N}", 3 * _q(b).nbytes, True,
                  True)]
    assert rows == want


def test_threshold_rows(rows):
    _run(perf.bench_threshold, [N])
    assert rows == [(f"L2-warm threshold {b:2d}-bit n={N}", 2 * _q(b).nbytes,
                     False, True) for b in (4, 8, 16, 32)]


def test_get_lines():
    lines = _run(perf.bench_get, 4096, 64)
    assert [line.split()[:2] for line in lines[1:]] == [
        ["get", f"{b:2d}-bit".strip()] for b in (4, 8, 16, 32)]
    assert all(line.endswith("ns/elem") for line in lines[1:])


def test_mvm_rows_and_probe_floor(rows):
    from clover_tpu.kernels.probes import dma_probe_call
    lines = _run(perf.bench_mvm, [M])
    qa = {b: _q(b, (M, M)) for b in (4, 8, 16)}
    want = [(f"mvm 32-bit (matmul) n={M}", 4 * M * M, False, False)]
    for ba, bxs in ((4, (4, 8)), (8, (8,)), (16, (16,))):
        if ba < 16:
            # the reference's dma_probe_call streams the codes
            streamed = dma_probe_call(qa[ba])[1]
            want += [(f"dma probe cluster {ba}-bit n={M}", streamed, False,
                      False),
                     (f"dma probe {ba}-bit n={M}", streamed, False, False),
                     (f"dma probe stream {ba}-bit n={M}", streamed, False,
                      False)]
        want += [(f"mvm {ba:2d}x{bx:2d}-bit n={M}", qa[ba].nbytes, True,
                  False) for bx in bxs]
    assert rows == want
    floors = [line for line in lines if "probe floor" in line]
    assert len(floors) == 3
    assert [f.split("% of the ")[1].split()[0] for f in floors] == \
        ["4-bit", "4-bit", "8-bit"]
    assert lines[1].startswith("launch probe")


def test_mvm_batched_lines():
    lines = _run(perf.bench_mvm_batched, [M], batches=(1, 4))
    assert [line.split()[:4] for line in lines[1:]] == [
        ["mvm_batched", mode, f"n={M}", f"B={b}"]
        for mode in ("4x4", "8x8") for b in (1, 4)]


def test_transpose_rows(rows):
    _run(perf.bench_transpose, [M])
    want = [(f"transpose 32-bit n={M}", 8 * M * M, False, False)]
    want += [(f"transpose {b:2d}-bit n={M}", 2 * _q(b, (M, M)).nbytes, True,
              False) for b in (4, 8, 16)]
    assert rows == want


def test_iht_rows(rows):
    lines = _run(perf.bench_iht, [(M, 2 * M)])
    assert rows == [(f"IHT {name:>4s}-bit {M}x{2 * M}",
                     2 * _q(mb, (M, 2 * M)).nbytes, False, False)
                    for name, mb, _ in perf.IHT_CONFIGS]
    assert sum("iters/s (host clock)" in line for line in lines) == 5


def test_iht_batched_line(rows):
    lines = _run(perf.bench_iht_batched, [(M, 2 * M)])
    assert lines[1].startswith(f"IHT_batched 4-bit {M}x{2 * M} B=8:")
    assert "x vs single @" in lines[1]


def test_rows_refuse_a_cache_rate_on_the_card(monkeypatch):
    """Above 100% of spec a row raises without printing; L2-warm rows do
    not, and neither does the CPU."""
    monkeypatch.setattr(perf, "pct_roofline", lambda n, dt, d: 180.0)
    printed = []
    with pytest.raises(RuntimeError, match="cache"):
        perf._row(printed.append, "restore  4-bit n=65536", 10, 1.0,
                  device="cuda")
    assert printed == []
    perf._row(printed.append, "L2-warm dot 32-bit n=65536", 10, 1.0,
              device="cuda", warm=True)
    perf._row(printed.append, "restore  4-bit n=65536", 10, 1.0,
              device="cpu")
    assert len(printed) == 2 and " L2 " in printed[0]


def test_slots_rotate_only_small_operands_on_the_card():
    assert perf._slots(1 << 20, "cpu") == 1
    assert perf._slots(1 << 20, "cuda") == 512
    assert perf._slots(300 << 20, "cuda") == 1
    assert perf._slots(16, "cuda") == 4096


def test_run_perf_sharded_raises(monkeypatch):
    """-p --sharded runs on the card: with no card and no --device cpu it
    raises, and falls back to nothing (its rows on a world of one are in
    tests/test_torch_parallel.py)."""
    import torch
    import torch.distributed as dist
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf.run_perf(lambda *_: None, sharded=True)


def test_cli_reaches_run_perf(monkeypatch, capsys):
    seen = {}
    real = perf.run_perf

    def small(log=print, quick=False, sharded=False, device="cuda",
              sizes=None):
        seen.update(quick=quick, sharded=sharded, device=str(device))
        return real(log, quick, sharded, device,
                    sizes={"vec": [N], "mvm": [M], "iht": [(M, 2 * M)],
                           "warm": [N], "get": (N, 64)})
    monkeypatch.setattr(perf, "run_perf", small)
    monkeypatch.setattr(perf, "IHT_ITERS", 2)
    assert cli.main(["-p", "--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert seen == {"quick": True, "sharded": False, "device": "cpu"}
    assert "clover_tpu_torch" in out.splitlines()[0]
    for name in (f"quantize  4-bit n={N}", f"dma probe 4-bit n={M}",
                 f"IHT    4-bit {M}x{2 * M}", "IHT_batched"):
        assert name in out
    assert np.isfinite(float(out.split("launch probe (one 64x128 tile)")[1]
                             .split()[0]))
