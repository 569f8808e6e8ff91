"""Matrix-vector multiply with blockwise output requantization
(counterpart of clover_tpu/ops/mvm.py).

y = A @ x with exact int32 block dots, a per-tile f32 scale combine
``(sA/qA) * (sx/qx)``, and per 64-row band an absmax requant with
stochastic rounding.  The int combinations 4x4, 4x8 and 8x8 run the fused
MVM kernel on CUDA and its plain version on the CPU; fp paths dequantize
and stay torch (clover_tpu computes them in XLA).
"""

from __future__ import annotations

from functools import partial

import torch

from ..formats import QMat4, QMat8, QMat16, QMat32, QVec4, QVec8, QVec16, QVec32
from ..kernels.dispatch import on_cuda, seed_from
from ..kernels.mvm import (
    blocked_products, mvm4_cuda, mvm4_plain, mvm8_cuda, mvm8_plain,
    mvm_f32_cuda, mvm_f32_plain,
)
from . import _core
from .axpy import scale_and_add
from .quantize import quantize_vec, restore_mat, restore_vec

_INT_MATS, _INT_VECS = (QMat4, QMat8), (QVec4, QVec8)


def mvm_f32(A, x) -> torch.Tensor:
    """y = A @ x as a padded f32 tensor, no output requantization.

    Plain torch on any device; the independent reference for the kernel
    (its block sums use torch's order, not the kernel's).  An int matrix
    times an f32 vector goes through ``gemm_f32``, as in clover_tpu, so no
    restored copy of A is formed."""
    if isinstance(A, _INT_MATS) and isinstance(x, _INT_VECS):
        return blocked_products(A.codes, A.scales, x.codes, x.scales,
                                A.bits, x.bits).sum(dim=1)
    if isinstance(A, _INT_MATS) and isinstance(x, QVec32):
        from .gemm import gemm_f32
        return gemm_f32(A, x.values[:, None])[:, 0]
    af = A.values.to(torch.float32) if isinstance(A, (QMat16, QMat32)) \
        else restore_mat(A).values
    xf = x.values.to(torch.float32) if isinstance(x, (QVec16, QVec32)) \
        else restore_vec(x).values
    with _core.ieee_fp32():
        return af @ xf


def mvm_f32_fast(A, x) -> torch.Tensor:
    """Like :func:`mvm_f32`, through the MVM kernel's f32-output mode for
    the int combinations 4x4, 4x8 and 8x8 (its plain version on the CPU,
    summed in the kernel's order).  The sharded path (parallel/ops.mvm_psum)
    runs this per shard; any other combination is :func:`mvm_f32`."""
    if _fused(A, x) is None:
        return mvm_f32(A, x)
    fn = mvm_f32_cuda if on_cuda(A.codes, x.codes) else mvm_f32_plain
    return fn(A.bits, x.bits, A.codes, A.scales, x.codes, x.scales)


def _fused(A, x):
    """(kernel form, plain version, output type) of an int MVM, or None
    for another combination."""
    if isinstance(A, QMat4) and isinstance(x, QVec4):
        return mvm4_cuda, mvm4_plain, QVec4
    if isinstance(A, _INT_MATS) and isinstance(x, QVec8):
        return partial(mvm8_cuda, A.bits), partial(mvm8_plain, A.bits), QVec8
    return None


def mvm(A, x, generator=None):
    """Fused MVM: y = requantize_by_band(A @ x).

    Output precision follows the reference dispatch table:
    (4,4)->4, (8,8)->8, (4,8)->8, (16,16)->16, (*,32)->32, (32,32)->32.
    """
    fused = _fused(A, x)
    if fused is not None:
        cuda, plain, out = fused
        fn = cuda if on_cuda(A.codes, x.codes) else plain
        seed, noise = seed_from(generator)
        codes, scales = fn(A.codes, A.scales, x.codes, x.scales,
                           seed1=seed, noise1=noise)
        return out(codes=codes, scales=scales, length=A.rows)
    return requant_output(mvm_f32(A, x), A.rows, out_bits(A, x), generator)


def mvm_axpy(A, x, u, alpha, generator_mvm=None, generator_axpy=None):
    """r = scale_and_add(u, mvm(A, x), alpha), the AXPY fused behind the
    MVM's band requant in one kernel launch for the int combinations (the
    intermediate quantized MVM result is formed but never written out).
    The plain version is the unfused sequence, bit for bit."""
    fused = _fused(A, x)
    if fused is not None and isinstance(u, fused[2]):
        cuda, plain, out = fused
        fn = cuda if on_cuda(A.codes, x.codes, u.codes) else plain
        s1, n1 = seed_from(generator_mvm)
        s2, n2 = seed_from(generator_axpy)
        codes, scales = fn(A.codes, A.scales, x.codes, x.scales, u.codes,
                           u.scales, alpha, s1, n1, s2, n2)
        return out(codes=codes, scales=scales, length=A.rows)
    return scale_and_add(u, mvm(A, x, generator_mvm), alpha, generator_axpy)


def out_bits(A, x) -> int:
    """The output precision of the MVM ``A @ x`` (the table in
    :func:`mvm`); raises ``TypeError`` for a combination it refuses."""
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


def requant_output(y32: torch.Tensor, rows: int, out_bits: int, generator):
    """The MVM's output container of ``out_bits`` from the padded f32 sums
    ``y32``: the band requant for 4 and 8 bits."""
    if out_bits == 32:
        return QVec32(values=y32, length=rows)
    if out_bits == 16:
        return QVec16(values=y32.to(torch.float16), length=rows)
    # 64-element output blocks coincide with the 64-row bands, so vector
    # quantization IS the band requantization
    return quantize_vec(QVec32(values=y32, length=rows), out_bits, generator)
