"""Hard thresholding: keep the K largest-magnitude elements, zero the rest
(counterpart of clover_tpu/ops/threshold.py).

Selection is exact, in golden order: |value| descending, then index
ascending.  Scales are never touched.  4- and 8-bit run the threshold
kernel on CUDA and its plain version on the CPU; one kernel serves every
length, and a stacked 4/8-bit container (leading batch dim) thresholds
each row in the same launch, the counterpart of ``jax.vmap(threshold)``
in clover_tpu/models/batch.py.  16/32-bit are plain torch on either
device (clover_tpu computes them in XLA, with no Pallas kernel).
"""

from __future__ import annotations

import torch

from ..formats import QVec4, QVec8, QVec16, QVec32
from ..kernels.dispatch import on_cuda
from ..kernels.threshold import (
    golden_keep, threshold4_cuda, threshold4_plain, threshold8_cuda,
    threshold8_plain,
)


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
    if isinstance(x, QVec8):
        if on_cuda(x.codes):
            codes = threshold8_cuda(x.codes, x.scales, k)
        else:
            codes = threshold8_plain(x.codes, x.scales, k, x.length)
        return QVec8(codes=codes, scales=x.scales, length=x.length)
    v = x.values
    keep = golden_keep(v.to(torch.float32).abs(), k, x.length)
    cls = QVec16 if isinstance(x, QVec16) else QVec32
    return cls(values=torch.where(keep, v, torch.zeros_like(v)),
               length=x.length)
