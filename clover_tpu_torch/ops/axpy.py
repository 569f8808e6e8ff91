"""scaleAndAdd: ``r = quantize(restore(u) + a*restore(v))`` blockwise
(counterpart of clover_tpu/ops/axpy.py).

Plain only.  On the solver path the AXPY runs as the epilogue of the fused
MVM kernel (ops/mvm.py mvm_axpy); the standalone AXPY kernel is not ported
yet, so 4/8-bit operands on CUDA raise.
"""

from __future__ import annotations

import torch

from ..formats import QVec16, QVec32
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
    if on_cuda(u.codes, v.codes):
        raise NotImplementedError("the standalone AXPY kernel is not ported "
                                  "yet (ROADMAP.md queue 2); use mvm_axpy")
    seed, noise = seed_from(generator)
    codes, scales = axpy_plain(u.codes, u.scales, v.codes, v.scales, a,
                               u.bits, seed, noise)
    return type(u)(codes=codes, scales=scales, length=u.length)
