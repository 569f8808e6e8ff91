"""Hard thresholding: keep the K largest-magnitude elements, zero the rest
(counterpart of clover_tpu/ops/threshold.py).

Selection is exact, in golden order: |value| descending, then index
ascending.  Scales are never touched.  4-bit runs the threshold kernel on
CUDA and its plain version on the CPU; one kernel serves every length.
8/16/32-bit are plain and CPU only until their kernels are ported.
"""

from __future__ import annotations

import torch

from ..formats import QVec4, QVec8, QVec16, QVec32
from ..kernels.dispatch import on_cuda
from ..kernels.threshold import golden_keep, threshold4_cuda, threshold4_plain
from .quantize import restore_vec


def threshold(x, k: int):
    """Return x with all but its K largest-magnitude elements zeroed;
    ``k >= x.length`` returns x unchanged."""
    k = int(k)
    if k >= x.length:
        return x
    if k < 0:
        raise ValueError(f"k={k} must be >= 0")
    if isinstance(x, QVec4):
        fn = threshold4_cuda if on_cuda(x.codes) else threshold4_plain
        return QVec4(codes=fn(x.codes, x.scales, k), scales=x.scales,
                     length=x.length)
    t = x.codes if isinstance(x, QVec8) else x.values
    if on_cuda(t):
        raise NotImplementedError(f"the {type(x).__name__} threshold kernel "
                                  f"is not ported yet (ROADMAP.md queue 2)")
    av = restore_vec(x).values.abs()
    valid = torch.arange(av.shape[0]) < x.length
    keep = golden_keep(av, k, valid)
    if isinstance(x, QVec8):
        return QVec8(codes=torch.where(keep, x.codes, torch.zeros_like(x.codes)),
                     scales=x.scales, length=x.length)
    cls = QVec16 if isinstance(x, QVec16) else QVec32
    return cls(values=torch.where(keep, x.values, torch.zeros_like(x.values)),
               length=x.length)
