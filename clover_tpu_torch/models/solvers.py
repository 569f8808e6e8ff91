"""Quantized GD and IHT solvers (counterpart of
clover_tpu/models/solvers.py).

The per-iteration update (IHT; GD omits the threshold):
    t2 = Q(y - Q(Phi @ x))          fused MVM+AXPY, one launch
    x  = Q(x + mu * Q(PhiT @ t2))   fused MVM+AXPY, one launch
    x  = top_k(x, K)                threshold, one launch

The solve is a Python loop that never waits for the device: ``mu`` and
``k`` reach the kernels as host numbers, the per-op SR seeds are host ints
derived by int32 arithmetic, and the threshold's cut-off stays on the
device.  The optional error trace restores x once per iteration (one
restore launch) and keeps each relative error on the device as a 0-d
tensor, so a traced solve does not wait either; x starts at y's
precision, 8-bit for the mixed 4x8 configuration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..formats import QVec32, zeros_vector
from ..kernels.dispatch import SEED_GOLD, SEED_OP, seed_from, wrap_i32
from ..ops.mvm import mvm_axpy
from ..ops.quantize import restore_vec
from ..ops.threshold import threshold


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


def _iteration(Phi, PhiT, y, x, mu, k, seed):
    k1, k2, k3, k4 = _op_seeds(seed)
    t2 = mvm_axpy(Phi, x, y, -1.0, k1, k2)          # y - Phi x
    x = mvm_axpy(PhiT, t2, x, mu, k3, k4)           # x + mu PhiT t2
    if k is not None:
        x = threshold(x, k)
    return x


def _device(q) -> torch.device:
    return (q.codes if hasattr(q, "codes") else q.values).device


def _solve(Phi, PhiT, y, x0, x_star, iterations: int, k, mu: float,
           generator) -> SolveResult:
    seed0 = seed_from(generator)[0] if generator is not None else None
    xs = x_star.values if x_star is not None else None
    xs_norm = torch.linalg.norm(xs) if xs is not None else None
    x, errs = x0, []
    for it in range(iterations):
        seed = wrap_i32(seed0 + it * SEED_GOLD) if seed0 is not None else None
        x = _iteration(Phi, PhiT, y, x, float(mu), k, seed)
        if xs is not None:
            errs.append(torch.linalg.norm(restore_vec(x).values - xs) / xs_norm)
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
