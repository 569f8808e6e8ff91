"""Philox4x32-10 in torch integer ops: the stochastic-rounding noise.

The same generator is written out in CUDA in ``csrc/philox.cuh``; the two
give the same bits, so a kernel and its plain version round alike in SR
mode.  The key is ``(seed, 0)`` with ``seed`` the op's int32 seed read as
uint32; the counter is ``(index mod 2^32, index >> 32, leg, 0)`` with
``index`` the element's global index in the padded operand and ``leg``
telling apart the requantizations of one op (0: quantize / MVM output,
1: AXPY output).  Word 0 of the output becomes
``u = (r & 0xFFFFFF) * 2^-24``, the 24-bit recipe of the TPU kernels
(clover_tpu/kernels/mvm.py ``_unoise``).  Nothing depends on the launch
geometry.

uint32 values are held in int64 tensors; products are split into 16-bit
halves so that no intermediate leaves the int64 range.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57     # round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85     # key schedule (Weyl) increments
ROUNDS = 10
LEG_QUANTIZE = 0
LEG_AXPY = 1
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product ``m * b``."""
    p_lo = m * (b & 0xFFFF)                       # < 2^48
    t = m * (b >> 16) + (p_lo >> 16)              # < 2^49
    return t >> 16, ((t & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 counter words."""
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & _MASK32, (k1 + W1) & _MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform(seed: int, shape, leg: int, device=None) -> torch.Tensor:
    """f32 U[0,1) noise of ``shape``; element i (row-major) uses counter i."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    zeros = torch.zeros_like(idx)
    r0 = philox4x32(idx & _MASK32, idx >> 32, zeros + int(leg), zeros,
                    int(seed) & _MASK32, 0)[0]
    return ((r0 & 0xFFFFFF).to(torch.float32)
            * (1.0 / (1 << 24))).reshape(tuple(shape))
