"""Batched GD / IHT: B independent problems against one resident matrix
(counterpart of clover_tpu/models/batch.py).

Per iteration, for the stacked iterate xs (leading batch dim):
    t1 = mvm_batched(Phi, xs)          one batched MVM launch
    t2 = Q(ys - t1)                    one AXPY launch over the whole batch
    t3 = mvm_batched(PhiT, t2)         one batched MVM launch
    xs = Q(xs + mu * t3)               one AXPY launch
    xs = top_k(xs, K) per problem      one threshold launch (IHT)

Each problem follows the unfused single-problem iteration, so a
deterministic batched solve equals B single solves (``models.iht``, whose
fused ``mvm_axpy`` is the unfused sequence bit for bit).  SR: the batched
MVM gives vector j the seed ``seed + j``; the AXPYs draw over the flat
batch (ops/axpy.py).  Like the single solver, the loop never waits for the
device; a trace restores the whole batch in one launch per iteration.

Supported precisions: the int modes 4x4, 4x8 and 8x8.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..formats import QVec32, stack_vectors, zeros_vector
from ..kernels.dispatch import SEED_GOLD, seed_from, wrap_i32
from ..ops.axpy import scale_and_add
from ..ops.gemm import mvm_batched
from ..ops.quantize import restore_vec
from ..ops.threshold import threshold
from .solvers import _op_seeds


class BatchSolveResult(NamedTuple):
    xs: object             # stacked quantized solutions (B leading dim)
    trace: torch.Tensor    # f32[iterations, B]: ||x_j - x*_j|| / ||x*_j||
                           # (zeros when no xs_star was given)


def _iteration_b(Phi, PhiT, ys, xs, mu, k, seed):
    k1, k2, k3, k4 = _op_seeds(seed)
    t1 = mvm_batched(Phi, xs, k1)                   # (B, m)
    t2 = scale_and_add(ys, t1, -1.0, k2)
    t3 = mvm_batched(PhiT, t2, k3)                  # (B, n)
    xs = scale_and_add(xs, t3, mu, k4)
    if k is not None:
        xs = threshold(xs, k)
    return xs


def _solve_b(Phi, PhiT, ys, xs0, xs_star, iterations: int, k, mu: float,
             generator) -> BatchSolveResult:
    seed0 = seed_from(generator)[0] if generator is not None else None
    star = xs_star.values if xs_star is not None else None
    star_norm = torch.linalg.norm(star, dim=-1) if star is not None else None
    xs, errs = xs0, []
    for it in range(iterations):
        seed = wrap_i32(seed0 + it * SEED_GOLD) if seed0 is not None else None
        xs = _iteration_b(Phi, PhiT, ys, xs, float(mu), k, seed)
        if star is not None:
            errs.append(torch.linalg.norm(restore_vec(xs).values - star,
                                          dim=-1) / star_norm)
    trace = (torch.stack(errs) if errs else
             torch.zeros(iterations, ys.codes.shape[0],
                         device=ys.codes.device))
    return BatchSolveResult(xs=xs, trace=trace)


def _initial_xs(Phi, ys):
    """Zeros at ys' precision, one row per problem."""
    x0 = zeros_vector(ys.bits, Phi.cols, device=ys.codes.device)
    return stack_vectors([x0] * ys.codes.shape[0])


def iht_batched(Phi, PhiT, ys, iterations: int, k: int, mu: float,
                generator=None, xs_star: QVec32 | None = None
                ) -> BatchSolveResult:
    """Quantized IHT over a stacked batch of observation vectors ``ys``
    (``formats.stack_vectors``); every problem shares Phi, PhiT, mu and
    K.  ``xs_star`` (stacked QVec32, optional) enables the per-problem
    error trace."""
    return _solve_b(Phi, PhiT, ys, _initial_xs(Phi, ys), xs_star,
                    iterations, int(k), mu, generator)


def gd_batched(Phi, PhiT, ys, iterations: int, mu: float, generator=None,
               xs_star: QVec32 | None = None) -> BatchSolveResult:
    """Quantized gradient descent over a stacked batch of observations."""
    return _solve_b(Phi, PhiT, ys, _initial_xs(Phi, ys), xs_star,
                    iterations, None, mu, generator)
