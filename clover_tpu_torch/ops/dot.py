"""Quantized dot products (counterpart of clover_tpu/ops/dot.py).

Per 64-element block, exact integer accumulation of the code products,
then an f32 combine with ``(su/qmax) * (sv/qmax)`` per block.  4- and
8-bit run the dot kernel on CUDA and its plain version on the CPU; 16- and
32-bit are one f32 ``torch.dot`` on either device (clover_tpu computes
them in XLA, with no Pallas kernel).
"""

from __future__ import annotations

import torch

from ..formats import QVec16, QVec32
from ..kernels.dispatch import on_cuda
from ..kernels.dot import dot_cuda, dot_plain


def dot(u, v) -> torch.Tensor:
    """Dot product of two quantized vectors of the same precision, as a
    0-dim f32 tensor on their device.  Mixed fp precisions (16/32) upcast
    to f32."""
    if isinstance(u, (QVec16, QVec32)) or isinstance(v, (QVec16, QVec32)):
        return torch.dot(u.values.to(torch.float32),
                         v.values.to(torch.float32))
    if u.bits != v.bits or u.length_pad != v.length_pad:
        raise ValueError(f"dot of {type(u).__name__}({u.length_pad}) and "
                         f"{type(v).__name__}({v.length_pad}): expected one "
                         f"precision and padded length")
    fn = dot_cuda if on_cuda(u.codes, v.codes) else dot_plain
    return fn(u.codes, u.scales, v.codes, v.scales, u.bits)
