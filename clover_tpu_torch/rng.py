"""The NumPy half of clover_tpu/rng.py: the reference's XORShift128+ lane
seeding and its AVX generator's quirk stream, which the reference problem
instances are drawn from (models/problems.py), and the plain xorshift
stream the random-data generators read (ops/access.py).

A copy, not an import: clover_tpu/rng.py imports jax.  ``_np_next``,
``_np_jump``, ``init_lanes``, ``np_stream``, ``avx_part2_lanes`` and
``avx_quirk_stream``
are clover_tpu's functions unchanged, so both packages draw the same
instances bit for bit (tests/test_torch_accuracy.py).
"""

from __future__ import annotations

import numpy as np

_JUMP = (0x8A5CD789635D2DFF, 0x121FD2155C472F96)
U64 = np.uint64


def _np_next(s0: np.ndarray, s1: np.ndarray):
    """One xorshift128+ step on uint64 lane arrays; returns (s0', s1', out).

    The reference's scalar ``xorshift128plus_onkeys`` convention: x = old
    s0 is the shifted word, c = old s1 becomes the new s0; out = s1' + c.
    """
    x = s0.copy()
    c = s1.copy()
    x ^= x << U64(23)
    new_s1 = x ^ c ^ (x >> U64(18)) ^ (c >> U64(5))
    return c.copy(), new_s1, new_s1 + c


def _np_jump(s0, s1):
    """Advance 2^64 steps."""
    j0 = np.zeros_like(s0)
    j1 = np.zeros_like(s1)
    a, b = s0.copy(), s1.copy()
    for word in _JUMP:
        for bit in range(64):
            if word & (1 << bit):
                j0 ^= a
                j1 ^= b
            x = a.copy()
            x ^= x << U64(23)
            nb = x ^ b ^ (x >> U64(18)) ^ (b >> U64(5))
            a, b = b.copy(), nb
    return j0, j1


def init_lanes(key1: int, key2: int, lanes: int = 8):
    """Reference lane seeding: lane 0 = (key1, key2), lane i+1 =
    jump(lane i)."""
    s0 = np.zeros(lanes, U64)
    s1 = np.zeros(lanes, U64)
    s0[0] = U64(key1 & 0xFFFFFFFFFFFFFFFF)
    s1[0] = U64(key2 & 0xFFFFFFFFFFFFFFFF)
    for i in range(1, lanes):
        a, b = _np_jump(s0[i - 1:i], s1[i - 1:i])
        s0[i], s1[i] = a[0], b[0]
    return s0, s1


def np_stream(key1: int, key2: int, n_draws: int, lanes: int = 8):
    """n_draws xorshift outputs per lane -> uint64[(n_draws, lanes)]."""
    s0, s1 = init_lanes(key1, key2, lanes)
    out = np.zeros((n_draws, lanes), U64)
    for i in range(n_draws):
        s0, s1, out[i] = _np_next(s0, s1)
    return out


def avx_part2_lanes(key1: int, key2: int, lanes: int = 4) -> np.ndarray:
    """The per-lane 64-bit states the reference's AVX generator evolves:
    its step reads only the S1 (part2) lanes of the seeding."""
    _, s1 = init_lanes(key1, key2, lanes)
    return s1.copy()


def avx_quirk_stream(state: np.ndarray, n_draws: int):
    """n_draws steps of the reference's AVX generator, which assigns
    ``part1 = part2`` and so evolves one 64-bit state per lane:

        t = u ^ (u << 23);  u' = t ^ u ^ (t >> 18) ^ (u >> 5);  out = u' + u

    Returns (uint32[n_draws, 2*lanes] in AVX register memory order --
    [lo32(w0), hi32(w0), lo32(w1), ...] -- and the final lane state).
    """
    u = state.copy()
    lanes = u.shape[0]
    out = np.zeros((n_draws, 2 * lanes), np.uint32)
    for i in range(n_draws):
        t = u ^ (u << U64(23))
        un = t ^ u ^ (t >> U64(18)) ^ (u >> U64(5))
        o = un + u
        u = un
        out[i, 0::2] = (o & U64(0xFFFFFFFF)).astype(np.uint32)
        out[i, 1::2] = (o >> U64(32)).astype(np.uint32)
    return out, u
