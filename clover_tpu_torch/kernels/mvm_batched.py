"""Batched requantizing MVM kernel (csrc/mvm_batched.cu) and its plain
torch version.

Replaces clover_tpu/kernels/mvm_batched.py mvm_batched_pallas in the 4x4,
4x8 and 8x8 modes: 1 <= B <= ``MAX_BATCH`` stacked vectors x_j against one
matrix A.  Vector j's output is the single MVM's
(:func:`~clover_tpu_torch.kernels.mvm.mvm4_plain`,
:func:`~clover_tpu_torch.kernels.mvm.mvm8_plain`) with ``seed1 = seed + j``
(int32 wrap-around), the seed rule of clover_tpu's vmapped path
(clover_tpu/ops/gemm.py); the plain version is exactly those B calls, and
the kernel agrees with it bit for bit, deterministic and SR: its exact
integer block dots run on the int8 tensor cores, its f32 sums in the
single kernel's order (the source note of csrc/mvm_batched.cu).  Output
codes are ``(B, m_pad * bo / 8)`` int8 and scales ``(B, m_pad / 64)``
f32.

The f32-output mode (:func:`mvm_batched_f32_cuda`, replacing
mvm_batched_pallas_f32) returns f32[B, m_pad], each row the single f32
MVM's (:func:`~clover_tpu_torch.kernels.mvm.mvm_f32_plain`), for the
sharded server; it takes sides that are multiples of 64.
"""

from __future__ import annotations

import torch

from ..formats import BLOCK
from .. import tracing
from . import _build
from .dispatch import wrap_i32
from .mvm import _mvm_plain, check_operands, mvm_f32_plain

MAX_BATCH = 32


def _out_bits(bits_a: int, bits_x: int) -> int:
    return 4 if bits_a == bits_x == 4 else 8


def _batch_of(x_codes) -> int:
    b = x_codes.shape[0]
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch {b} outside 1..{MAX_BATCH}")
    return b


def mvm_batched_plain(bits_a: int, bits_x: int, a_codes, a_scales, x_codes,
                      x_scales, seed: int = 0, noise: bool = False):
    """B single-vector MVMs, vector j with seed ``seed + j``; any B."""
    outs = [_mvm_plain(bits_a, bits_x, a_codes, a_scales, xc, xs, None,
                       None, 0.0, wrap_i32(seed + j), noise, 0, False)
            for j, (xc, xs) in enumerate(zip(x_codes, x_scales))]
    return (torch.stack([c for c, _ in outs]),
            torch.stack([s for _, s in outs]))


@tracing.kernel("mvm_batched")
def mvm_batched_cuda(bits_a: int, bits_x: int, a_codes, a_scales, x_codes,
                     x_scales, seed: int = 0, noise: bool = False):
    """Kernel form of :func:`mvm_batched_plain`: one launch for
    1 <= B <= MAX_BATCH."""
    b = _batch_of(x_codes)
    device, m_pad, n_pad = check_operands(bits_a, bits_x, a_codes, a_scales,
                                          x_codes, x_scales, batch=(b,))
    bits_out = _out_bits(bits_a, bits_x)
    out = torch.empty(b, m_pad * bits_out // 8, dtype=torch.int8,
                      device=device)
    out_scales = torch.empty(b, m_pad // BLOCK, dtype=torch.float32,
                             device=device)
    P = _build.ptr
    _build.launch("clover_mvm_batched", device, P(a_codes), P(a_scales),
                  P(x_codes), P(x_scales), P(out), P(out_scales), m_pad,
                  n_pad, b, bits_a, bits_x, int(noise), seed & 0xFFFFFFFF)
    return out, out_scales


def mvm_batched_f32_plain(bits_a: int, bits_x: int, a_codes, a_scales,
                          x_codes, x_scales) -> torch.Tensor:
    """f32[B, m_pad]: B single f32 MVMs; any B."""
    return torch.stack([mvm_f32_plain(bits_a, bits_x, a_codes, a_scales, xc,
                                      xs)
                        for xc, xs in zip(x_codes, x_scales)])


@tracing.kernel("mvm_batched_f32")
def mvm_batched_f32_cuda(bits_a: int, bits_x: int, a_codes, a_scales,
                         x_codes, x_scales) -> torch.Tensor:
    """Kernel form of :func:`mvm_batched_f32_plain`: one launch for
    1 <= B <= MAX_BATCH; sides multiples of 64."""
    b = _batch_of(x_codes)
    device, m_pad, n_pad = check_operands(bits_a, bits_x, a_codes, a_scales,
                                          x_codes, x_scales, pad=BLOCK,
                                          batch=(b,))
    out = torch.empty(b, m_pad, dtype=torch.float32, device=device)
    P = _build.ptr
    _build.launch("clover_mvm_batched_f32", device, P(a_codes), P(a_scales),
                  P(x_codes), P(x_scales), P(out), m_pad, n_pad, b, bits_a,
                  bits_x)
    return out
