"""The reference accuracy protocols (counterpart of
clover_tpu/models/accuracy.py).

IHT: m=512, n=1024, K=64, 200 epochs, per-precision tuned mu; the metric is
||x - x*|| / ||x*|| per epoch, for the five precision configurations:
mixed 4x8, 4, 8, 16 and 32.  GD: m=384, n=256, 500 iterations,
mu=0.4000000358.

Each run quantizes Phi and y (SR draws from ``generator`` when one is
given) and solves traced, on ``device`` (default ``cuda``).  At 512x1024
the 4 and 4x8 configurations take the whole-iteration kernel.
"""

from __future__ import annotations

import torch

from ..formats import QVec32, pad_vector
from ..ops.quantize import quantize_mat, quantize_vec
from ..ops.transpose import transpose
from .problems import (
    DEFAULT_SEED, make_gd_problem, make_gd_problem_reference,
    make_iht_problem, make_iht_problem_reference,
)
from .solvers import gd, iht

# Tuned step sizes of the reference protocol (clover_tpu's ACCURACY_MU).
ACCURACY_MU = {
    "4x8": 0.0051299855,
    4: 0.0042842566,
    8: 0.0042007011,
    16: 0.0048838919,
    32: 0.0048838919,
}

GD_MU = 0.4000000358


def _bits(config) -> tuple[int, int]:
    """(matrix bits, vector bits) of a configuration."""
    return (4, 8) if config == "4x8" else (config, config)


def _solve(solver, config, phi, x_star, y, generator, *args):
    mat_bits, vec_bits = _bits(config)
    qphi = quantize_mat(phi, mat_bits, generator)
    qphit = transpose(qphi)
    qy = quantize_vec(y, vec_bits, generator)
    xs = QVec32(values=pad_vector(x_star), length=x_star.shape[0])
    return solver(qphi, qphit, qy, *args, generator=generator,
                  x_star=xs).trace


def _seeded(seed, device) -> torch.Generator:
    """The random instance's generator on ``device`` (default ``cuda``)."""
    return torch.Generator(device=device or "cuda").manual_seed(
        DEFAULT_SEED if seed is None else seed)


def run_iht_accuracy(config, m=512, n=1024, k=64, epochs=200, mu=None,
                     seed=None, generator=None, device=None, data="auto"):
    """One precision configuration of the IHT protocol; -> the per-epoch
    relative recovery error trace, f32[epochs] on ``device``.

    ``config`` is 4, 8, 16, 32 or "4x8".  ``data``: "reference" is the
    reference's own instance (make_iht_problem_reference, to which the
    published mu values are tuned), "random" a seeded make_iht_problem;
    "auto" takes the reference instance at 512x1024 with no ``seed``.
    """
    if data == "auto":
        data = ("reference" if (m, n) == (512, 1024) and seed is None
                else "random")
    if data == "reference":
        phi, x_star, y = make_iht_problem_reference(m, n, k, device)
    else:
        phi, x_star, y = make_iht_problem(m, n, k, _seeded(seed, device))
    mu = ACCURACY_MU[config] if mu is None else mu
    return _solve(iht, config, phi, x_star, y, generator, epochs, k, mu)


def run_gd_accuracy(config, m=384, n=256, iterations=500, mu=GD_MU,
                    seed=None, generator=None, device=None, data="auto"):
    """One precision configuration of the GD protocol, as
    :func:`run_iht_accuracy` ("auto": the reference instance at 384x256
    with no ``seed``)."""
    if data == "auto":
        data = ("reference" if (m, n) == (384, 256) and seed is None
                else "random")
    if data == "reference":
        phi, x_star, y = make_gd_problem_reference(m, n, device)
    else:
        phi, x_star, y = make_gd_problem(m, n, _seeded(seed, device))
    return _solve(gd, config, phi, x_star, y, generator, iterations, mu)
