"""Hard thresholding: keep the K largest-magnitude elements, zero the rest
(counterpart of clover_tpu/ops/threshold.py).

Selection is exact, in golden order: |value| descending, then index
ascending.  Scales are never touched.  4- and 8-bit run the radix-select
threshold kernel on CUDA and its plain version on the CPU; a stacked
4/8-bit container (leading batch dim) thresholds each row in the same
launch, the counterpart of ``jax.vmap(threshold)`` in
clover_tpu/models/batch.py.  A 1-D 4-bit vector with 2^19 <= n_pad < 2^24
and k <= 256 takes the hybrid instead, clover_tpu's rule
(ops/threshold.py HYBRID4_MIN_N, _HYBRID4_SEL_K): the hist4 pass, an exact
selector over the 8x-compressed multiset in torch, the mask4 pass, with no
host sync (plain versions of both passes on the CPU).  16/32-bit are plain
torch on either device (clover_tpu computes them in XLA, with no Pallas
kernel).
"""

from __future__ import annotations

import torch

from ..formats import QVec4, QVec8, QVec16, QVec32
from ..kernels.dispatch import on_cuda
from ..kernels.threshold import (
    golden_keep, hist4_cuda, hist4_plain, mask4_cuda, mask4_plain,
    threshold4_cuda, threshold4_plain, threshold8_cuda, threshold8_plain,
)
from . import _core

HYBRID4_MIN_N = 1 << 19     # padded lengths the hybrid takes: [2^19, 2^24)
HYBRID4_MAX_N = 1 << 24
HYBRID4_MAX_K = 256


def hybrid4_eligible(x, k: int) -> bool:
    """A 1-D 4-bit vector the hybrid thresholds (clover_tpu's rule)."""
    return (isinstance(x, QVec4) and x.codes.dim() == 1 and k <= HYBRID4_MAX_K
            and HYBRID4_MIN_N <= x.length_pad < HYBRID4_MAX_N)


def hybrid_select(hist: torch.Tensor, m7: torch.Tensor, k: int):
    """Exact (tau, fill, tie offsets) for the k largest of the multiset of
    candidates ``c * m7[b]`` (c = 1..7) with weights ``hist[b, c]``.

    tau is the largest value whose weight at or above it reaches k (0 when
    the whole multiset fits in k: keep every nonzero code), fill = k -
    weight(> tau), and offset[b] the ties at tau in blocks before b.  Every
    candidate of weight >= 1 above tau is among the k largest candidates,
    so one top-k over the 7 nb candidates and a running weight find tau.
    All three stay on the device: 0-dim f32, 0-dim int64, int64[nb]."""
    dev = m7.device
    w = hist[:, 1:].to(torch.int64)                            # (nb, 7)
    cand = torch.arange(1, 8, dtype=torch.float32, device=dev) * m7[:, None]
    if k == 0:
        tau = torch.full((), float("inf"), device=dev)
        fill = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        vals = torch.where(w > 0, cand, -1.0).reshape(-1)
        kk = min(k, vals.numel())
        top, at = torch.topk(vals, kk)                         # descending
        top_w = w.reshape(-1)[at]
        first = (top_w.cumsum(0) < k).sum().clamp(max=kk - 1)
        tau = torch.where(w.sum() > k, top.gather(0, first.view(1))[0], 0.0)
        fill = k - torch.where(top > tau, top_w, 0).sum()
    ties = torch.where(cand == tau, w, 0).sum(dim=1)
    return tau, fill, ties.cumsum(0) - ties


def _threshold4_hybrid(x, k: int):
    cuda = on_cuda(x.codes)
    hist4, mask4 = ((hist4_cuda, mask4_cuda) if cuda
                    else (hist4_plain, mask4_plain))
    m7 = _core.div(x.scales, 7.0)
    tau, fill, offset = hybrid_select(hist4(x.codes), m7, k)
    return QVec4(codes=mask4(x.codes, m7, tau, fill, offset),
                 scales=x.scales, length=x.length)


def threshold(x, k: int):
    """Return x with all but its K largest-magnitude elements zeroed;
    ``k >= x.length`` returns x unchanged."""
    k = int(k)
    if k >= x.length:
        return x
    if k < 0:
        raise ValueError(f"k={k} must be >= 0")
    if hybrid4_eligible(x, k):
        return _threshold4_hybrid(x, k)
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
