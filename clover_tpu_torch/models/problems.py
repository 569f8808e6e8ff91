"""Problem generators for the solvers (counterpart of
clover_tpu/models/problems.py).

- IHT: Phi ~ U(-1, 1), x* a random K-sparse 0/1 vector, y = Phi x*.
- GD:  Phi ~ U(-1, 1) with L2-normalized rows, x* in {-1, +1}^n,
  y = Phi x*.

The random generators make their data where the generator lives, so a
CUDA generator builds a full-size problem on the card without a host round
trip; with neither a generator nor a device they build on ``cuda``.  The
reference instances -- the exact (Phi, x*, y) the reference's ``clover -a``
solves -- are drawn in NumPy from the reference's generator (rng.py), bit
for bit clover_tpu's, and moved to the asked device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..rng import avx_part2_lanes, avx_quirk_stream

DEFAULT_SEED = 445560390295639063 % (2 ** 32)

# The reference's fixed data-generation keys.
REF_KEY1 = 445560390295639063
REF_KEY2 = 2935984234003016713


def _generator(generator: torch.Generator | None, device) -> torch.Generator:
    """``generator``, or one on ``device`` (default ``cuda``) seeded with
    ``DEFAULT_SEED``."""
    if generator is None:
        return torch.Generator(device=device or "cuda").manual_seed(
            DEFAULT_SEED)
    if device is not None and torch.device(device).type != generator.device.type:
        raise ValueError(f"device {device} differs from the generator's "
                         f"{generator.device}")
    return generator


def make_iht_problem(m: int, n: int, k: int,
                     generator: torch.Generator | None = None, device=None):
    """-> (Phi f32[m, n], x_star f32[n], y f32[m]) on the generator's
    device, or on ``device`` (default ``cuda``) from a generator seeded
    with ``DEFAULT_SEED``."""
    generator = _generator(generator, device)
    device = generator.device
    phi = torch.rand(m, n, generator=generator, device=device) * 2 - 1
    x = torch.zeros(n, device=device)
    x[torch.randperm(n, generator=generator, device=device)[:k]] = 1.0
    return phi, x, phi @ x


def make_gd_problem(m: int, n: int, generator: torch.Generator | None = None,
                    device=None):
    """-> (Phi row-normalized f32[m, n], x_star in {-1, 1}^n, y f32[m]),
    placed as :func:`make_iht_problem`'s."""
    generator = _generator(generator, device)
    device = generator.device
    phi = torch.rand(m, n, generator=generator, device=device) * 2 - 1
    phi = phi / torch.linalg.norm(phi, dim=1, keepdim=True)
    u = torch.rand(n, generator=generator, device=device)
    x = torch.where(u < 0.5, -1.0, 1.0)
    return phi, x, phi @ x


def _avx_floats(i32: np.ndarray, min_v: float, max_v: float) -> np.ndarray:
    """The reference's setRandomFloats recipe: abs_epi32 (wrapping
    INT32_MIN), cvtepi32_ps, then one f32 FMA with scale (max-min)/2^31
    and addend min."""
    ir = np.abs(i32, dtype=np.int32)
    frandom = ir.astype(np.float32)
    scale = np.float32(np.float32(max_v - min_v) / np.float32(2147483648.0))
    # FMA: exact f64 product + addend, one rounding to f32
    return (frandom.astype(np.float64) * np.float64(scale)
            + np.float64(np.float32(min_v))).astype(np.float32)


def _avx_unit(i32: np.ndarray) -> np.ndarray:
    """The reference's create_array_of_random_values recipe: mask bit 31,
    cvtepi32_ps, f32-multiply by 2^-31 -> U[0, 1)."""
    m = (i32.view(np.uint32) & np.uint32(0x7FFFFFFF)).view(np.int32)
    return np.float32(m.astype(np.float32)) * np.float32(1.0 / 2147483648.0)


def _reference_phi(m: int, n: int):
    state = avx_part2_lanes(REF_KEY1, REF_KEY2)
    draws, state = avx_quirk_stream(state, (m * n + 7) // 8)
    phi = _avx_floats(draws.reshape(-1)[:m * n].view(np.int32),
                      -1.0, 1.0).reshape(m, n)
    return phi, state


def _on(device, arrays):
    """Copies of cached NumPy arrays as tensors on ``device`` (default
    ``cuda``)."""
    return tuple(torch.tensor(a, device=device or "cuda") for a in arrays)


def make_iht_problem_reference(m: int = 512, n: int = 1024, k: int = 64,
                               device=None):
    """The reference's IHT accuracy instance, bit for bit clover_tpu's
    ``make_iht_problem_reference``: Phi from the AVX quirk stream, x* by
    the reference's round-to-nearest swap shuffle, y = Phi x* accumulated
    in f64 and rounded once.  The published accuracy mu values are tuned
    to this Phi.  -> (Phi, x_star, y) f32 tensors on ``device`` (default
    ``cuda``)."""
    return _on(device, _iht_reference(m, n, k))


@functools.cache
def _iht_reference(m: int, n: int, k: int):
    phi, state = _reference_phi(m, n)
    draws, state = avx_quirk_stream(state, (n + 7) // 8)
    rf = _avx_unit(draws.reshape(-1)[:n].view(np.int32))
    x = np.zeros(n, np.float32)
    x[:k] = 1.0
    for i in range(n - 1):   # the reference's swap shuffle
        j = int(np.float32(np.round(np.float32(i) * rf[i])))
        x[i], x[j] = x[j], x[i]
    y = (phi.astype(np.float64) @ x.astype(np.float64)).astype(np.float32)
    return phi, x, y


def make_gd_problem_reference(m: int = 384, n: int = 256, device=None):
    """The reference's GD accuracy instance, bit for bit clover_tpu's
    ``make_gd_problem_reference``: rows scaled by (float)(1/norm) from a
    sequential f64 sum of squares, x* = sign of a second draw, y from a
    sequential f64 accumulation rounded once.  -> (Phi, x_star, y) f32
    tensors on ``device`` (default ``cuda``)."""
    return _on(device, _gd_reference(m, n))


@functools.cache
def _gd_reference(m: int, n: int):
    phi, state = _reference_phi(m, n)
    p64 = phi.astype(np.float64)
    # sequential f64 sums (np.cumsum), not np.sum's pairwise order
    nrm = np.sqrt(np.cumsum(p64 * p64, axis=1)[:, -1])
    scale = (1.0 / nrm).astype(np.float32)
    phi = phi * scale[:, None]
    draws, state = avx_quirk_stream(state, (n + 7) // 8)
    xr = _avx_floats(draws.reshape(-1)[:n].view(np.int32), -1.0, 1.0)
    x = np.where(xr < 0, np.float32(-1.0), np.float32(1.0))
    p64 = phi.astype(np.float64)
    y = np.cumsum(p64 * x.astype(np.float64), axis=1)[:, -1].astype(
        np.float32)
    return phi, x, y
