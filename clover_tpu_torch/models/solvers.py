"""Quantized GD and IHT solvers (counterpart of
clover_tpu/models/solvers.py).

The per-iteration update (IHT; GD omits the threshold):
    t2 = Q(y - Q(Phi @ x))          fused MVM+AXPY, one launch
    x  = Q(x + mu * Q(PhiT @ t2))   fused MVM+AXPY, one launch
    x  = top_k(x, K)                threshold, one launch

Small 4x4 and 4x8 problems (both padded sides multiples of 512, at most
8192: kernels/iteration.py iteration_eligible) run the two legs as one
whole-iteration launch, and untraced solves of at least ``ITER_CHAIN``
iterations run ``ITER_CHAIN`` whole iterations, thresholds included, per
launch, the rest unchained.  Every path gives the same bytes.

The solve is a Python loop that never waits for the device: ``mu`` and
``k`` reach the kernels as host numbers, the per-op SR seeds are host ints
derived by int32 arithmetic, and the threshold's cut-off stays on the
device.  The optional error trace restores x once per iteration (one
restore launch) and keeps each relative error on the device as a 0-d
tensor, so a traced solve does not wait either; x starts at y's
precision, 8-bit for the mixed 4x8 configuration.  Under a profiler the
solve is the span ``clover.solve``, each chained launch the span
``clover.chain`` and each unchained iteration the span
``clover.iteration`` (tracing.py).  A solve that chains adds the
iterations it chained to the counter ``solver.chained_iterations``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..formats import QVec32, zeros_vector
from ..kernels import iteration as fused
from ..kernels.dispatch import SEED_GOLD, SEED_OP, on_cuda, seed_from, wrap_i32
from ..ops.mvm import mvm_axpy
from ..ops.quantize import restore_vec
from ..ops.threshold import threshold
from ..tracing import add, span


class SolveResult(NamedTuple):
    x: object              # quantized solution container
    trace: torch.Tensor    # f32[iterations]: ||x - x*|| / ||x*|| per
                           # iteration (zeros when no x_star was given)


def _op_seeds(seed, n: int = 4):
    """n per-op int32 seeds from an iteration seed by constant strides."""
    if seed is None:
        return (None,) * n
    s = seed_from(seed)[0]
    return tuple(wrap_i32(s + (j + 1) * SEED_OP) for j in range(n))


# iterations per chained launch: clover_tpu's default chain length
# (CLOVER_ITER_CHAIN_LEN, clover_tpu/models/solvers.py)
ITER_CHAIN = 4


def _fused(kernel, plain, Phi, PhiT, y, x, *args, seeds):
    """x after a whole-iteration kernel (or its plain version on the
    CPU) with arguments ``args`` and the per-op seeds, None for
    deterministic."""
    words = [0 if s is None else s for s in seeds]
    noise = tuple(s is not None for s in seeds[:4])
    fn = kernel if on_cuda(Phi.codes, x.codes) else plain
    codes, scales = fn(Phi.bits, x.bits, *[(q.codes, q.scales) for q in
                                           (Phi, PhiT, y, x)],
                       *args, words, noise)
    return type(x)(codes=codes, scales=scales, length=x.length)


def _iteration(Phi, PhiT, y, x, mu, k, seed):
    k1, k2, k3, k4 = _op_seeds(seed)
    if fused.iteration_eligible(Phi, PhiT, y, x):
        x = _fused(fused.iteration_cuda, fused.iteration_plain, Phi, PhiT,
                   y, x, mu, seeds=(k1, k2, k3, k4))
    else:
        t2 = mvm_axpy(Phi, x, y, -1.0, k1, k2)      # y - Phi x
        x = mvm_axpy(PhiT, t2, x, mu, k3, k4)       # x + mu PhiT t2
    if k is not None:
        x = threshold(x, k)
    return x


def _device(q) -> torch.device:
    return (q.codes if hasattr(q, "codes") else q.values).device


def _solve(Phi, PhiT, y, x0, x_star, iterations: int, k, mu: float,
           generator) -> SolveResult:
    with span("clover.solve"):
        seed0 = seed_from(generator)[0] if generator is not None else None
        xs = x_star.values if x_star is not None else None
        xs_norm = torch.linalg.norm(xs) if xs is not None else None
        x, errs, start = x0, [], 0

        def seed_of(it):
            return (wrap_i32(seed0 + it * SEED_GOLD) if seed0 is not None
                    else None)

        if (xs is None and iterations >= ITER_CHAIN
                and fused.iteration_chain_eligible(Phi, PhiT, y, x0, k)):
            start = iterations // ITER_CHAIN * ITER_CHAIN
            for c in range(0, start, ITER_CHAIN):
                with span("clover.chain"):
                    seeds = [s for it in range(c, c + ITER_CHAIN)
                             for s in _op_seeds(seed_of(it))]
                    x = _fused(fused.iteration_chain_cuda,
                               fused.iteration_chain_plain, Phi, PhiT, y, x,
                               float(mu), k, seeds=seeds)
            add("solver.chained_iterations", start)
        for it in range(start, iterations):
            with span("clover.iteration"):
                x = _iteration(Phi, PhiT, y, x, float(mu), k, seed_of(it))
            if xs is not None:
                errs.append(torch.linalg.norm(restore_vec(x).values - xs)
                            / xs_norm)
        trace = (torch.stack(errs) if errs
                 else torch.zeros(iterations, device=_device(x0)))
        return SolveResult(x=x, trace=trace)


def iht(Phi, PhiT, y, iterations: int, k: int, mu: float,
        generator=None, x_star: QVec32 | None = None) -> SolveResult:
    """Quantized Iterative Hard Thresholding.

    ``Phi``/``PhiT`` are quantized matrices (PhiT materialized up front);
    ``y`` a quantized vector of observations; ``x_star`` (QVec32, padded
    values) enables the per-iteration relative-error trace.
    """
    return _solve(Phi, PhiT, y, _initial_x(Phi, y), x_star, iterations,
                  int(k), mu, generator)


def gd(Phi, PhiT, y, iterations: int, mu: float, generator=None,
       x_star: QVec32 | None = None) -> SolveResult:
    """Quantized gradient descent on least squares ||y - Phi x||^2."""
    return _solve(Phi, PhiT, y, _initial_x(Phi, y), x_star, iterations,
                  None, mu, generator)


def _initial_x(Phi, y):
    """x starts cleared at y's precision (the pure configs' update
    precision)."""
    return zeros_vector(y.bits, Phi.cols, device=_device(y))
