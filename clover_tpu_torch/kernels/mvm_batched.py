"""Batched requantizing MVM kernel (csrc/mvm_batched.cu) and its plain
torch version.

Replaces clover_tpu/kernels/mvm_batched.py mvm_batched_pallas in the 4x4,
4x8 and 8x8 modes: 1 <= B <= ``MAX_BATCH`` stacked vectors x_j against one
matrix A.  Vector j's output is the single MVM's
(:func:`~clover_tpu_torch.kernels.mvm.mvm4_plain`,
:func:`~clover_tpu_torch.kernels.mvm.mvm8_plain`) with ``seed1 = seed + j``
(int32 wrap-around), the seed rule of clover_tpu's vmapped path
(clover_tpu/ops/gemm.py); the plain version is exactly those B calls, and
the kernel agrees with it bit for bit, deterministic and SR.  Output codes
are ``(B, m_pad * bo / 8)`` int8 and scales ``(B, m_pad / 64)`` f32.
"""

from __future__ import annotations

import torch

from ..formats import BLOCK
from . import _build
from .dispatch import wrap_i32
from .mvm import _mvm_plain

MAX_BATCH = 32


def _out_bits(bits_a: int, bits_x: int) -> int:
    return 4 if bits_a == bits_x == 4 else 8


def mvm_batched_plain(bits_a: int, bits_x: int, a_codes, a_scales, x_codes,
                      x_scales, seed: int = 0, noise: bool = False):
    """B single-vector MVMs, vector j with seed ``seed + j``; any B."""
    outs = [_mvm_plain(bits_a, bits_x, a_codes, a_scales, xc, xs, None,
                       None, 0.0, wrap_i32(seed + j), noise, 0, False)
            for j, (xc, xs) in enumerate(zip(x_codes, x_scales))]
    return (torch.stack([c for c, _ in outs]),
            torch.stack([s for _, s in outs]))


def mvm_batched_cuda(bits_a: int, bits_x: int, a_codes, a_scales, x_codes,
                     x_scales, seed: int = 0, noise: bool = False):
    """Kernel form of :func:`mvm_batched_plain`: one launch for
    1 <= B <= MAX_BATCH."""
    if (bits_a, bits_x) not in ((4, 4), (4, 8), (8, 8)):
        raise ValueError(f"batched MVM modes are 4x4, 4x8 and 8x8, got "
                         f"{bits_a}x{bits_x}")
    m_pad, wa = a_codes.shape
    n_pad = wa * 8 // bits_a
    if m_pad % 128 or n_pad % 128:
        raise ValueError(f"A codes {tuple(a_codes.shape)} not padded to 128")
    b = x_codes.shape[0]
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch {b} outside 1..{MAX_BATCH}")
    _build.check(a_codes, (m_pad, wa), torch.int8, "A codes")
    device = a_codes.device
    _build.check(a_scales, (m_pad // BLOCK, n_pad // BLOCK), torch.float32,
                 "A scales", device)
    _build.check(x_codes, (b, n_pad * bits_x // 8), torch.int8, "x codes",
                 device)
    _build.check(x_scales, (b, n_pad // BLOCK), torch.float32, "x scales",
                 device)
    bits_out = _out_bits(bits_a, bits_x)
    out = torch.empty(b, m_pad * bits_out // 8, dtype=torch.int8,
                      device=device)
    out_scales = torch.empty(b, m_pad // BLOCK, dtype=torch.float32,
                             device=device)
    P = _build.ptr
    _build.launch("clover_mvm_batched", device, P(a_codes), P(a_scales),
                  P(x_codes), P(x_scales), P(out), P(out_scales), m_pad,
                  n_pad, b, bits_a, bits_x, int(noise), seed & 0xFFFFFFFF)
    mvm_batched_cuda.launches += 1
    return out, out_scales


mvm_batched_cuda.launches = 0
