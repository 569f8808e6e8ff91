"""scaleAndAdd: ``r = quantize(restore(u) + a*restore(v))`` blockwise
(counterpart of clover_tpu/ops/axpy.py).

4- and 8-bit operands run the AXPY kernel on CUDA tensors and its plain
version on CPU tensors; 16/32-bit are plain torch.  Stacked containers
(leading batch dim) go through as one flat vector of ``B * n_pad``
elements: deterministic results equal the per-row ones, and the SR noise
counters run over the flat index, so each row draws its own noise (where
clover_tpu's vmap shares one draw across the batch).
"""

from __future__ import annotations

import torch

from ..formats import QVec16, QVec32
from ..kernels.axpy import axpy_cuda
from ..kernels.dispatch import on_cuda, seed_from
from ..kernels.mvm import axpy_plain
from .quantize import restore_vec


def scale_and_add(u, v, a, generator=None):
    """r = Q(restore(u) + a * restore(v)) at u's precision."""
    if type(u) is not type(v):
        raise TypeError(f"precision mismatch: {type(u).__name__} vs "
                        f"{type(v).__name__}")
    if isinstance(u, (QVec16, QVec32)):
        x = restore_vec(u).values + torch.tensor(
            a, dtype=torch.float32, device=u.values.device) * restore_vec(v).values
        if isinstance(u, QVec32):
            return QVec32(values=x, length=u.length)
        return QVec16(values=x.to(torch.float16), length=u.length)
    if u.codes.shape != v.codes.shape:
        raise ValueError(f"shape mismatch: {tuple(u.codes.shape)} vs "
                         f"{tuple(v.codes.shape)}")
    fn = axpy_cuda if on_cuda(u.codes, v.codes) else axpy_plain
    seed, noise = seed_from(generator)
    codes, scales = fn(u.codes.reshape(-1), u.scales.reshape(-1),
                       v.codes.reshape(-1), v.scales.reshape(-1), a, u.bits,
                       seed, noise)
    return type(u)(codes=codes.reshape(u.codes.shape),
                   scales=scales.reshape(u.scales.shape), length=u.length)
