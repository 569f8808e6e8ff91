"""Matrix-vector multiply with blockwise output requantization
(counterpart of clover_tpu/ops/mvm.py).

y = A @ x with exact int32 block dots, a per-tile f32 scale combine
``(sA/qA) * (sx/qx)``, and per 64-row band an absmax requant with
stochastic rounding.  4-bit x 4-bit runs the fused MVM kernel on CUDA and
its plain version on the CPU.  The other int combinations (4x8, 8x8) are
plain and CPU only until their kernels are ported; fp paths dequantize.
"""

from __future__ import annotations

import torch

from ..formats import QMat4, QMat8, QMat16, QMat32, QVec4, QVec8, QVec16, QVec32
from ..kernels.dispatch import on_cuda, seed_from
from ..kernels.mvm import blocked_products, mvm4_cuda, mvm4_plain
from .axpy import scale_and_add
from .quantize import quantize_vec, restore_mat, restore_vec

_INT_MATS, _INT_VECS = (QMat4, QMat8), (QVec4, QVec8)


def mvm_f32(A, x) -> torch.Tensor:
    """y = A @ x as a padded f32 tensor, no output requantization.

    Plain torch on any device; the independent reference for the kernel
    (its block sums use torch's order, not the kernel's)."""
    if isinstance(A, _INT_MATS) and isinstance(x, _INT_VECS):
        return blocked_products(A.codes, A.scales, x.codes, x.scales,
                                A.bits, x.bits).sum(dim=1)
    af = A.values.to(torch.float32) if isinstance(A, (QMat16, QMat32)) \
        else restore_mat(A).values
    xf = x.values.to(torch.float32) if isinstance(x, (QVec16, QVec32)) \
        else restore_vec(x).values
    return af @ xf


def _is_4x4(A, x) -> bool:
    return isinstance(A, QMat4) and isinstance(x, QVec4)


def _pending(A, x):
    return NotImplementedError(
        f"{type(A).__name__} x {type(x).__name__} MVM kernel is not ported "
        f"yet (ROADMAP.md queue 2)")


def mvm(A, x, generator=None):
    """Fused MVM: y = requantize_by_band(A @ x).

    Output precision follows the reference dispatch table:
    (4,4)->4, (8,8)->8, (4,8)->8, (16,16)->16, (*,32)->32, (32,32)->32.
    """
    if _is_4x4(A, x):
        seed, noise = seed_from(generator)
        fn = mvm4_cuda if on_cuda(A.codes, x.codes) else mvm4_plain
        codes, scales = fn(A.codes, A.scales, x.codes, x.scales,
                           seed1=seed, noise1=noise)
        return QVec4(codes=codes, scales=scales, length=A.rows)
    if isinstance(A, _INT_MATS) and isinstance(x, _INT_VECS) and on_cuda(A.codes):
        raise _pending(A, x)
    return _requant_output(mvm_f32(A, x), A.rows, _out_bits(A, x), generator)


def mvm_axpy(A, x, u, alpha, generator_mvm=None, generator_axpy=None):
    """r = scale_and_add(u, mvm(A, x), alpha), the AXPY fused behind the
    MVM's band requant in one kernel launch for 4x4 (the intermediate
    quantized MVM result is formed but never written out).  The plain
    version is the unfused sequence, bit for bit."""
    if _is_4x4(A, x) and isinstance(u, QVec4):
        s1, n1 = seed_from(generator_mvm)
        s2, n2 = seed_from(generator_axpy)
        fn = mvm4_cuda if on_cuda(A.codes, x.codes, u.codes) else mvm4_plain
        codes, scales = fn(A.codes, A.scales, x.codes, x.scales, u.codes,
                           u.scales, alpha, s1, n1, s2, n2)
        return QVec4(codes=codes, scales=scales, length=A.rows)
    return scale_and_add(u, mvm(A, x, generator_mvm), alpha, generator_axpy)


def _out_bits(A, x) -> int:
    if isinstance(x, QVec32):
        return 32
    if isinstance(A, QMat4) and isinstance(x, QVec4):
        return 4
    if isinstance(A, (QMat4, QMat8)) and isinstance(x, QVec8):
        return 8
    if isinstance(A, QMat16) and isinstance(x, QVec16):
        return 16
    if isinstance(A, QMat32):
        return 32
    raise TypeError(f"unsupported MVM combination {type(A).__name__} x "
                    f"{type(x).__name__}")


def _requant_output(y32: torch.Tensor, rows: int, out_bits: int, generator):
    if out_bits == 32:
        return QVec32(values=y32, length=rows)
    if out_bits == 16:
        return QVec16(values=y32.to(torch.float16), length=rows)
    # 64-element output blocks coincide with the 64-row bands, so vector
    # quantization IS the band requantization
    return quantize_vec(QVec32(values=y32, length=rows), out_bits, generator)
