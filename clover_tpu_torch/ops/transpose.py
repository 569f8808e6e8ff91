"""Quantized matrix transpose (counterpart of clover_tpu/ops/transpose.py).

Tile scales are per 64x64 block, so transposing the values and the scale
grid commute exactly: ``T(A)[i, j] == A[j, i]`` bit for bit.  4- and 8-bit
run the transpose kernel on CUDA and its plain version on the CPU; 16/32-bit
are a plain ``.T``.
"""

from __future__ import annotations

from ..formats import QMat4, QMat8, QMat16, QMat32
from ..kernels.dispatch import on_cuda
from ..kernels.transpose import (
    transpose4_cuda, transpose4_plain, transpose8_cuda, transpose8_plain,
)


def transpose(A):
    if isinstance(A, (QMat4, QMat8)):
        if isinstance(A, QMat4):
            fn = transpose4_cuda if on_cuda(A.codes) else transpose4_plain
        else:
            fn = transpose8_cuda if on_cuda(A.codes) else transpose8_plain
        return type(A)(codes=fn(A.codes), scales=A.scales.T.contiguous(),
                       rows=A.cols, cols=A.rows)
    if isinstance(A, QMat16):
        return QMat16(values=A.values.T.contiguous(), rows=A.cols, cols=A.rows)
    if isinstance(A, QMat32):
        return QMat32(values=A.values.T.contiguous(), rows=A.cols, cols=A.rows)
    raise TypeError(f"not a quantized matrix: {type(A).__name__}")
