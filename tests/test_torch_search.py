"""The ``-g`` search machinery (clover_tpu_torch.harness.search) against
clover_tpu's (tests/test_harness.py), on the same NumPy problems.

Tolerances: the early-stop verdict is a pure function of the trace, so
identical traces give identical results.  A probe's trace differs between
the packages: at 32 bits by the fp32 summation orders of torch and XLA
(rtol 2.3e-5, the GD-16 gap of tests/test_torch_accuracy.py); at 4 and 8
bits by the absmax floor-boundary gap (ROADMAP queue 3, "Known gaps"), a
1-ulp difference in a band's absmax that flips a code and parts the
trajectories.  Mixed 4x8 and 8-bit qualities are held within 5% and
iteration counts within one step.  Pure 4-bit IHT parts from the first
iteration (a 6 <-> 7 code flip changes which ties the threshold keeps):
on this problem at mu = 3e-3 the qualities differ by 6.3% and the
early-stop points by 4 steps of a flat tail (measured), so its quality is
held within 10%, test_torch_accuracy.py's 4-bit IHT bound, and its stop
point is not compared.
"""

import numpy as np
import pytest
import torch

from clover_tpu.harness import search as jax_search
from clover_tpu_torch import cli
from clover_tpu_torch.harness import search
from clover_tpu_torch.harness.search import SearchProblem, _trace_verdict
from torch_helpers import one_thread  # noqa: F401 (autouse)


TRACES = [np.array([1.5, 0.8, 0.5, 0.4995, 0.49949], np.float32),
          np.array([1.0, np.nan, 0.1]),
          np.array([3.0, 2.9999, 2.99985]),
          np.array([2.0, 1.0, 0.5], np.float32),
          np.array([0.9, 0.95, 0.96, 0.5]),
          np.array([1.0, np.inf]),
          np.array([], np.float32)]


def test_trace_verdict_semantics():
    # converges: improvement dries up below 0.001 at a loss < 2
    r = _trace_verdict(TRACES[0])
    assert r.convergent and abs(r.quality - 0.4995) < 1e-6 and r.n_iter == 4
    # NaN anywhere -> divergent
    assert not _trace_verdict(TRACES[1]).convergent
    # flat but above the loss bound -> divergent
    assert not _trace_verdict(TRACES[2]).convergent
    # monotone descent to the end -> quality is the final loss
    r = _trace_verdict(TRACES[3])
    assert r.convergent and abs(r.quality - 0.5) < 1e-6


@pytest.mark.parametrize("i", range(len(TRACES)))
def test_trace_verdict_equals_the_reference(i):
    got, want = _trace_verdict(TRACES[i]), jax_search._trace_verdict(TRACES[i])
    assert (got.convergent, got.quality, got.n_iter) == \
        (want.convergent, want.quality, want.n_iter)


def _iht_problem(m=128, n=256, k=16, seed=3):
    rng = np.random.default_rng(seed)
    phi = (rng.random((m, n), dtype=np.float32) * 2 - 1)
    x = np.zeros(n, np.float32)
    x[rng.permutation(n)[:k]] = 1.0
    return phi, x, (phi.astype(np.float64) @ x).astype(np.float32)


def _gd_problem(m=96, n=64, seed=4):
    rng = np.random.default_rng(seed)
    phi = rng.random((m, n), dtype=np.float32) * 2 - 1
    phi /= np.linalg.norm(phi, axis=1, keepdims=True)
    x = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return phi, x, (phi.astype(np.float64) @ x).astype(np.float32)


def _both(problem, mat_bits, vec_bits, k, limit):
    phi, x, y = problem
    port = SearchProblem(torch.from_numpy(phi), torch.from_numpy(y),
                         torch.from_numpy(x), mat_bits, vec_bits, k=k,
                         iteration_limit=limit)
    ref = jax_search.SearchProblem(phi, y, x, mat_bits, vec_bits, k=k,
                                   iteration_limit=limit)
    return port, ref


def _close(got, want, mat_bits, vec_bits):
    assert got.convergent == want.convergent
    if not want.convergent:
        return
    if mat_bits == 32:
        assert got.quality == pytest.approx(want.quality, rel=2.3e-5)
        assert got.n_iter == want.n_iter
    elif vec_bits == 4:
        assert got.quality == pytest.approx(want.quality, rel=0.10)
    else:
        assert got.quality == pytest.approx(want.quality, rel=0.05)
        assert abs(got.n_iter - want.n_iter) <= 1


@pytest.mark.parametrize("mat_bits,vec_bits",
                         [(4, 4), (4, 8), (8, 8), (32, 32)])
def test_probe_verdicts_equal_the_reference(mat_bits, vec_bits):
    port, ref = _both(_iht_problem(), mat_bits, vec_bits, 16, 30)
    for mu in (3e-3, 0.5):
        _close(port.probe(mu), ref.probe(mu), mat_bits, vec_bits)
    assert port.probe(3e-3).convergent and not port.probe(0.5).convergent


def test_search_problem_probe_and_iterations():
    port, ref = _both(_iht_problem(), 4, 8, 16, 30)
    good = port.probe(3e-3)
    it = port.iterations_to(3e-3, quality_target=good.quality / 0.98)
    assert 0 <= it <= 30
    want = ref.iterations_to(3e-3, quality_target=good.quality / 0.98)
    assert abs(it - want) <= 1


@pytest.mark.parametrize("mat_bits,vec_bits",
                         [(4, 8), (8, 8), (16, 16), (32, 32)])
def test_search_problem_all_precisions(mat_bits, vec_bits):
    """The per-precision columns of -g need SearchProblem at every
    precision."""
    port, _ = _both(_iht_problem(), mat_bits, vec_bits, 16, 20)
    r = port.probe(3e-3)
    assert r.convergent and np.isfinite(r.quality)
    it = port.iterations_to(3e-3, quality_target=r.quality / 0.98)
    assert 0 <= it <= 20


def test_gd_find_best_n_iterations():
    port, ref = _both(_gd_problem(), 8, 8, 0, 25)
    q, mu = search.gd_best_possible_quality(port, 0.1, 0.5, 0.1)
    it, mu_b = search.gd_find_best_n_iterations(
        port, q / 0.9, lo=0.1, hi=0.5, precision=0.1)
    assert 0 <= it <= 25 and 0.1 <= mu_b <= 0.5
    q_ref, mu_ref = jax_search.gd_best_possible_quality(ref, 0.1, 0.5, 0.1)
    assert q == pytest.approx(q_ref, rel=0.05)


def test_iht_best_quality_small():
    port, _ = _both(_iht_problem(), 4, 4, 16, 30)
    q, mu, it = search.iht_best_possible_quality(
        port, lo=1e-4, hi=0.05, precision=1e-3)
    assert q < 2.0 and 1e-4 <= mu <= 0.05 and 1 <= it <= 30


def test_constants_and_ladders_equal_the_reference():
    for name in ("ITERATION_LIMIT", "IMPROVEMENT_EPS",
                 "CONVERGENCE_LOSS_BOUND", "GRID_SIZE", "SIZE_LADDER",
                 "SEARCH_SIZES", "SEARCH_SIZES_FULL", "PRECISION_COLUMNS"):
        assert getattr(search, name) == getattr(jax_search, name), name


def test_search_family_records_every_column():
    row = search.search_family("gd", 64, device="cpu", log=lambda *_: None)
    assert (row["m"], row["n"], row["K"]) == (96, 64, 0)
    assert set(row["cols"]) == {4, 8, 16, 32}
    assert all(c is None or (0 <= c[0] <= 50 and 0.1 <= c[1] <= 0.5)
               for c in row["cols"].values())
    # the same seed searches the same instance: the same row again
    again = search.search_family("gd", 64, device="cpu",
                                 log=lambda *_: None)
    assert again == row


def test_search_family_records_a_failed_column(monkeypatch):
    real = search.SearchProblem

    def failing(phi, y, x, mat_bits, vec_bits, **kw):
        if mat_bits == 16:
            raise MemoryError("no room for the fp16 pair")
        return real(phi, y, x, mat_bits, vec_bits, **kw)
    monkeypatch.setattr(search, "SearchProblem", failing)
    logs = []
    row = search.search_family("gd_mixed", 64, device="cpu", log=logs.append)
    assert row["cols"][16] is None and row["cols"][8] is not None
    assert any("16-bit SKIPPED" in line for line in logs)


def test_cli_grid_search_prints_every_kind_and_size(monkeypatch, capsys):
    """-g --gd --quick: the GD families over the first two sizes, one
    table row per precision column (search_family is tested above; a
    stand-in returns its rows here)."""
    calls = []

    def family(kind, size, seed=None, log=print, device=None):
        calls.append((kind, size, str(device)))
        return {"m": int(size * 1.5), "n": size, "K": 0,
                "quality_target": 0.5,
                "cols": {4: (3, 0.25), 8: (2, 0.2), 16: None, 32: (1, 0.2)}}
    monkeypatch.setattr(search, "search_family", family)
    monkeypatch.setattr(search, "SEARCH_SIZES_FULL", [64, 96, 128])
    assert cli.main(["-g", "--gd", "--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert calls == [(kind, size, "cpu") for kind in ("gd", "gd_mixed")
                     for size in (64, 96)]
    assert "=== gd ===" in out and "=== gd_mixed ===" in out
    assert "=== iht ===" not in out
    rows = [line.split() for line in out.splitlines()
            if line.split()[:1] in (["4"], ["8"], ["16"], ["32"])]
    assert sorted({(r[1], r[2]) for r in rows}) == [("144", "96"),
                                                    ("96", "64")]
    assert len(rows) == 2 * 2 * 4
    # a failed column prints "-" and nan, never a number
    assert all(r[4:6] == ["-", "nan"] for r in rows if r[0] == "16")
