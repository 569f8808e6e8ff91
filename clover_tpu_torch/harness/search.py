"""Hyper-parameter (mu) search, the ``-g`` grid search (counterpart of
clover_tpu/harness/search.py, same constants, ladders and verdicts).

A probe runs the solver's full fixed-length traced solve and applies the
reference's early-stopping rule to the returned loss trace on the host:
* walk ||x_i - x*|| / ||x*||; stop at the first step with 0 <= improvement
  < 0.001; NaN => divergent; convergent iff the stop-loss < 2; quality =
  the stop-loss;
* ``iht_best_possible_quality``: binary-search the largest convergent mu
  in [lo, hi], then repeat a 10-point grid refinement between the two best
  grid points until the bracket is tighter than ``precision``;
* ``gd_best_possible_quality``: a linear sweep lo -> hi by ``precision``,
  stopping at the first divergence;
* ``find_best_n_iterations``: over the same grids, the fewest iterations
  reaching a quality target.

Probes iterate deterministically by default (``generator=None``), as the
searches behind the tuned tables did.  Each family's problem is drawn on
the CPU from its seed and then moved to the device, so every device
searches the same instance.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..formats import QVec32
from ..models import problems, solvers
from ..ops.quantize import quantize_mat, quantize_vec
from ..ops.transpose import transpose

ITERATION_LIMIT = 50
IMPROVEMENT_EPS = 0.001
CONVERGENCE_LOSS_BOUND = 2.0
GRID_SIZE = 10


@dataclasses.dataclass
class ProbeResult:
    convergent: bool
    quality: float          # loss at the early-stop point (inf if divergent)
    n_iter: int             # steps taken to the early-stop point


def _trace_verdict(trace: np.ndarray) -> ProbeResult:
    """Apply the reference's early-stopping walk to a full loss trace."""
    prev = np.inf
    stop_i = len(trace) - 1
    curr = float(trace[-1]) if len(trace) else np.inf
    for i, curr_i in enumerate(np.asarray(trace, np.float64)):
        if math.isnan(curr_i) or math.isinf(curr_i):
            return ProbeResult(False, float("inf"), len(trace))
        improvement = prev - curr_i
        prev = curr_i
        if 0 <= improvement < IMPROVEMENT_EPS:
            stop_i, curr = i, float(curr_i)
            break
        stop_i, curr = i, float(curr_i)
    if math.isnan(curr) or not curr < CONVERGENCE_LOSS_BOUND:
        return ProbeResult(False, float("inf"), stop_i + 1)
    return ProbeResult(True, curr, stop_i + 1)


class SearchProblem:
    """A quantized (Phi, y, x*) instance on the device of ``phi32``."""

    def __init__(self, phi32, y32, x_star32, mat_bits: int, vec_bits: int,
                 k=None, generator=None,
                 iteration_limit: int = ITERATION_LIMIT):
        self.qphi = quantize_mat(phi32, mat_bits, generator)
        self.qphit = transpose(self.qphi)
        self.qy = quantize_vec(y32, vec_bits, generator)
        x_star32 = torch.as_tensor(x_star32, dtype=torch.float32)
        self.x_star = QVec32(
            values=F.pad(x_star32, (0, self.qphi.cols_pad - len(x_star32))),
            length=self.qphi.cols)
        self.k = k
        self.generator = generator
        self.iteration_limit = iteration_limit

    def _trace(self, mu: float, k) -> np.ndarray:
        if k:
            res = solvers.iht(self.qphi, self.qphit, self.qy,
                              self.iteration_limit, int(k), float(mu),
                              self.generator, x_star=self.x_star)
        else:
            res = solvers.gd(self.qphi, self.qphit, self.qy,
                             self.iteration_limit, float(mu), self.generator,
                             x_star=self.x_star)
        return res.trace.cpu().numpy()

    def probe(self, mu: float, k=None) -> ProbeResult:
        return _trace_verdict(self._trace(mu, self.k if k is None else k))

    def iterations_to(self, mu: float, quality_target: float) -> int:
        """The first step reaching the target, or the limit on NaN or
        failure."""
        tr = self._trace(mu, self.k)
        if np.any(np.isnan(tr)):
            return self.iteration_limit
        hits = np.nonzero(tr <= quality_target)[0]
        return int(hits[0]) if len(hits) else self.iteration_limit


def iht_best_possible_quality(problem: SearchProblem, lo: float = 1e-6,
                              hi: float = 0.5, precision: float = 1e-6,
                              log=lambda *_: None):
    """-> (best_quality, best_mu, best_n_iter)."""
    first = problem.probe(lo)
    if not first.convergent:
        raise RuntimeError(f"IHT does not converge at mu={lo}; "
                           "this should never happen")
    best_q, best_mu, best_it = first.quality, lo, first.n_iter
    lo_initial = lo

    # binary search the convergence boundary
    ub_found = False
    while lo + precision <= hi:
        mu = (lo + hi) / 2
        r = problem.probe(mu)
        log(f"mu={mu:.10f}: {'OK  ' if r.convergent else 'Fail'} | "
            f"quality {r.quality:.6f} | iters {r.n_iter}")
        if r.convergent:
            lo = mu
            ub_found = True
            if r.quality < best_q:
                best_q, best_mu, best_it = r.quality, mu, r.n_iter
        else:
            hi = mu
    if not ub_found:
        raise RuntimeError("upper bound not found")

    # 10-point grid, repeatedly refined between the two best points, with
    # the rounds capped and a stalled bracket ending the refinement
    lo = lo_initial
    rounds = 0
    while lo + precision <= hi and rounds < 24:
        rounds += 1
        prev_span = hi - lo
        step = (hi - lo) / GRID_SIZE
        quals = []
        for i in range(GRID_SIZE + 1):
            mu = lo + step * i
            r = problem.probe(mu)
            log(f"mu={mu:.10f}: {'OK  ' if r.convergent else 'Fail'} | "
                f"quality {r.quality:.6f} | iters {r.n_iter}")
            quals.append(r.quality if r.convergent else np.inf)
            if r.convergent and r.quality < best_q:
                best_q, best_mu, best_it = r.quality, mu, r.n_iter
        order = np.argsort(quals)
        i1, i2 = int(order[0]), int(order[1])
        hi = lo + step * max(i1, i2)
        lo = lo + step * min(i1, i2)
        log(f"readjustment: {lo} - {hi}")
        if hi - lo >= prev_span * 0.95:     # stalled bracket
            break
    return best_q, best_mu, best_it


def gd_best_possible_quality(problem: SearchProblem, lo: float,
                             hi: float, precision: float,
                             log=lambda *_: None):
    """Linear sweep; stop at the first divergent mu."""
    first = problem.probe(lo, k=0)
    if not first.convergent:
        raise RuntimeError(f"GD does not converge at mu={lo}")
    best_q, best_mu = first.quality, lo
    mu = lo + precision
    while mu < hi:
        r = problem.probe(mu, k=0)
        if not r.convergent:
            break
        log(f"mu={mu:.10f}: quality {r.quality:.6f}")
        if r.quality < best_q:
            best_q, best_mu = r.quality, mu
        mu += precision
    return best_q, best_mu


def find_best_n_iterations(problem: SearchProblem, quality_target: float,
                           lo: float = 1e-6, hi: float = 0.5,
                           log=lambda *_: None):
    """Fewest iterations reaching the (relaxed) quality target over the
    refined mu grid."""
    best_it, best_mu = problem.iteration_limit, lo
    lo0 = lo
    # coarse boundary by a binary search on convergence
    while lo + (hi - lo0) / 1e6 <= hi and hi - lo > 1e-6:
        mu = (lo + hi) / 2
        if problem.probe(mu).convergent:
            lo = mu
        else:
            hi = mu
    grid_hi, lo = hi, lo0
    step = (grid_hi - lo) / GRID_SIZE
    for i in range(GRID_SIZE + 1):
        mu = lo + step * i
        it = problem.iterations_to(mu, quality_target)
        log(f"mu={mu:.10f}: {it} iterations to target {quality_target:.4f}")
        if it < best_it:
            best_it, best_mu = it, mu
    return best_it, best_mu


def gd_find_best_n_iterations(problem: SearchProblem, quality_target: float,
                              lo: float = 0.1, hi: float = 0.5,
                              precision: float = 0.05,
                              log=lambda *_: None):
    """A linear mu sweep lo..hi by ``precision``; the fewest iterations
    reaching the target."""
    best_it, best_mu = problem.iteration_limit, lo
    mu = lo
    while mu <= hi + 1e-12:
        it = problem.iterations_to(mu, quality_target)
        log(f"mu={mu:.10f}: {it} iterations to target {quality_target:.4f}")
        if it < best_it:
            best_it, best_mu = it, mu
        mu += precision
    return best_it, best_mu


# The reference's size ladder: 19 entries, 256 -> 32768.  IHT: m = size,
# n = 2m, K = n/4; GD: n = size, m = 1.5n.
SIZE_LADDER = ([256, 512, 1024, 2048, 4096, 6144, 8192, 10240, 12288,
                14336, 16384, 18432, 20480, 22528, 24576, 26624, 28672,
                30720, 32768])
SEARCH_SIZES = [(256 << i, 512 << i) for i in range(5)]
# Default ladder for full regeneration runs: 12 sizes spanning the
# reference's range (the full 19 are one flag away via SIZE_LADDER).
SEARCH_SIZES_FULL = [256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096,
                     8192, 16384, 32768]

# The per-precision columns tuned per size: the 4-bit (pure or mixed)
# configuration sets the quality target; 8/16/32-bit tune iterations to it.
PRECISION_COLUMNS = [(8, 8), (16, 16), (32, 32)]


def _problem(gd: bool, m: int, n: int, k: int, seed, device):
    """(Phi, x*, y) drawn on the CPU from ``seed`` (default the problems'
    DEFAULT_SEED) and moved to ``device`` (default ``cuda``)."""
    gen = torch.Generator().manual_seed(
        problems.DEFAULT_SEED if seed is None else seed)
    made = (problems.make_gd_problem(m, n, generator=gen) if gd else
            problems.make_iht_problem(m, n, k, generator=gen))
    return tuple(t.to(device or "cuda") for t in made)


def run_search(sizes=None, mixed=False, gd=False, seed=None, log=print,
               device=None):
    """Single-family search: per size, best quality / mu / iterations for
    the pure 4-bit (or mixed 4x8) configuration.  Returns (m, n, K,
    quality, mu, iterations) rows."""
    rows = []
    for (m, n) in sizes or SEARCH_SIZES:
        k = n // 4
        if gd:
            phi, x_star, y = _problem(True, m, n, 0, seed, device)
            prob = SearchProblem(phi, y, x_star, 4, 8 if mixed else 4, k=0)
            q, mu = gd_best_possible_quality(prob, 0.05, 0.95, 0.05, log=log)
            it = prob.iterations_to(mu, q / 0.98)
        else:
            phi, x_star, y = _problem(False, m, n, k, seed, device)
            prob = SearchProblem(phi, y, x_star, 4, 8 if mixed else 4, k=k)
            q, mu, it = iht_best_possible_quality(prob, log=log)
            # relax the target by 2% before tuning iterations
            it, mu = find_best_n_iterations(prob, q / 0.98, log=log)
        rows.append((m, n, k, q, mu, it))
        log(f"size {m}x{n} K={k}: quality={q:.6f} mu={mu:.8f} iters={it}")
    return rows


def search_family(kind: str, size: int, seed=None, log=print, device=None):
    """One size of one family at full granularity: the 4-bit
    configuration (pure 4x4 or mixed 4x8) searches the best quality, the
    target is relaxed (/0.98 IHT, /0.9 GD), then EVERY precision tunes
    (iterations, mu) to that target.

    ``kind``: "iht" | "iht_mixed" | "gd" | "gd_mixed".  Returns {"m", "n",
    "K", "quality_target", "cols": {4: (iters, mu), 8: ..., 16: ...,
    32: ...}}; a column that cannot run (e.g. fp32 at sizes whose Phi +
    PhiT exceed the device's memory) is recorded as None, never silently
    dropped.
    """
    gd = kind.startswith("gd")
    mixed = kind.endswith("mixed")
    if gd:
        m, n = int(size * 1.5), size
        k = 0
    else:
        m, n = size, 2 * size
        k = n // 4
    phi, x_star, y = _problem(gd, m, n, k, seed, device)

    def build(mat_bits, vec_bits):
        return SearchProblem(phi, y, x_star, mat_bits, vec_bits, k=k)

    base = build(4, 8 if mixed else 4)
    if gd:
        q, mu0 = gd_best_possible_quality(base, 0.1, 0.5, 0.05, log=log)
        target = q / 0.9
        it0, mu0 = gd_find_best_n_iterations(base, target, log=log)
    else:
        q, mu_q, it_q = iht_best_possible_quality(base, log=log)
        target = q / 0.98
        it0, mu0 = find_best_n_iterations(base, target, log=log)
        if it_q < it0:
            it0, mu0 = it_q, mu_q
    cols = {4: (it0, mu0)}
    for mat_bits, vec_bits in PRECISION_COLUMNS:
        try:
            prob = build(mat_bits, vec_bits)
            if gd:
                it, mu = gd_find_best_n_iterations(prob, target, log=log)
            else:
                it, mu = find_best_n_iterations(prob, target, log=log)
            cols[mat_bits] = (it, mu)
        except Exception as e:                # memory etc.: record, not hide
            log(f"  column {mat_bits}-bit SKIPPED at {m}x{n}: {e}")
            cols[mat_bits] = None
        finally:
            prob = None
    return {"m": m, "n": n, "K": k, "quality_target": float(target),
            "cols": cols}


def run_search_full(sizes=None, kinds=("gd", "iht", "gd_mixed", "iht_mixed"),
                    seed=None, log=print, device=None):
    """The complete ``-g`` invocation: GD pure, IHT pure, GD mixed, IHT
    mixed, each per size with all four precision columns.  Returns {kind:
    [search_family rows]}."""
    out = {}
    for kind in kinds:
        log(f"=== {kind} ===")
        out[kind] = []
        for size in sizes or SEARCH_SIZES_FULL:
            row = search_family(kind, size, seed=seed, log=log, device=device)
            c = ", ".join(
                f"{b}-bit: " + (f"iters={v[0]} mu={v[1]:.8f}" if v else "SKIP")
                for b, v in row["cols"].items())
            log(f"{kind} {row['m']}x{row['n']} K={row['K']} "
                f"target={row['quality_target']:.6f} | {c}")
            out[kind].append(row)
    return out
