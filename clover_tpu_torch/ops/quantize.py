"""Quantize / restore for all container precisions (counterpart of
clover_tpu/ops/quantize.py).

``generator`` drives stochastic rounding: None is deterministic
truncation, a ``torch.Generator`` (or an int seed) gives Philox noise.
4- and 8-bit quantize and restore, vectors and matrices, run their kernels
on CUDA tensors and the kernels' plain versions on CPU tensors.
"""

from __future__ import annotations

import torch

from ..formats import (
    QMat4, QMat8, QMat16, QMat32, QVec4, QVec8, QVec16, QVec32,
    pad_matrix, pad_vector,
)
from ..kernels.dispatch import on_cuda, seed_from
from ..kernels.quantize import (
    quantize_mat_cuda, quantize_mat_plain, quantize_vec_cuda,
    quantize_vec_plain,
)
from ..kernels.restore import (
    restore_mat_cuda, restore_mat_plain, restore_vec_cuda, restore_vec_plain,
)


def _as_padded_vec(x) -> tuple[torch.Tensor, int]:
    if isinstance(x, QVec32):
        return x.values, x.length
    x = torch.as_tensor(x, dtype=torch.float32)
    return pad_vector(x).contiguous(), x.shape[-1]


def _as_padded_mat(a) -> tuple[torch.Tensor, int, int]:
    if isinstance(a, QMat32):
        return a.values, a.rows, a.cols
    a = torch.as_tensor(a, dtype=torch.float32)
    return pad_matrix(a).contiguous(), a.shape[-2], a.shape[-1]


def quantize_vec(x, bits: int, generator=None):
    """fp32 vector (tensor, array or QVec32) -> quantized container."""
    xp, length = _as_padded_vec(x)
    if bits == 32:
        return QVec32(values=xp, length=length)
    if bits == 16:
        return QVec16(values=xp.to(torch.float16), length=length)
    seed, noise = seed_from(generator)
    fn = quantize_vec_cuda if on_cuda(xp) else quantize_vec_plain
    codes, scales = fn(xp, bits, seed, noise)
    cls = QVec4 if bits == 4 else QVec8
    return cls(codes=codes, scales=scales, length=length)


def quantize_mat(a, bits: int, generator=None):
    """fp32 matrix (tensor, array or QMat32) -> quantized container."""
    ap, rows, cols = _as_padded_mat(a)
    if bits == 32:
        return QMat32(values=ap, rows=rows, cols=cols)
    if bits == 16:
        return QMat16(values=ap.to(torch.float16), rows=rows, cols=cols)
    seed, noise = seed_from(generator)
    fn = quantize_mat_cuda if on_cuda(ap) else quantize_mat_plain
    codes, scales = fn(ap, bits, seed, noise)
    cls = QMat4 if bits == 4 else QMat8
    return cls(codes=codes, scales=scales, rows=rows, cols=cols)


def restore_vec(q) -> QVec32:
    """Quantized vector -> fp32 container; a stacked container restores in
    one flat pass over its ``B * n_pad`` elements (blocks are contiguous)."""
    if isinstance(q, QVec32):
        return q
    if isinstance(q, QVec16):
        return QVec32(values=q.values.to(torch.float32), length=q.length)
    fn = restore_vec_cuda if on_cuda(q.codes) else restore_vec_plain
    values = fn(q.codes.reshape(-1), q.scales.reshape(-1), q.bits)
    return QVec32(values=values.reshape(*q.codes.shape[:-1], -1),
                  length=q.length)


def restore_mat(q) -> QMat32:
    if isinstance(q, QMat32):
        return q
    if isinstance(q, QMat16):
        return QMat32(values=q.values.to(torch.float32), rows=q.rows,
                      cols=q.cols)
    fn = restore_mat_cuda if on_cuda(q.codes) else restore_mat_plain
    return QMat32(values=fn(q.codes, q.scales, q.bits), rows=q.rows,
                  cols=q.cols)


def quantize(x, bits: int, generator=None):
    arr = x.values if isinstance(x, (QVec32, QMat32)) else torch.as_tensor(x)
    if arr.ndim == 1:
        return quantize_vec(x, bits, generator)
    if arr.ndim == 2:
        return quantize_mat(x, bits, generator)
    raise ValueError(f"unsupported rank {arr.ndim}")


def restore(q):
    if isinstance(q, (QVec4, QVec8, QVec16, QVec32)):
        return restore_vec(q)
    return restore_mat(q)
