"""Exact threshold kernels (csrc/threshold.cu, csrc/threshold_hybrid.cu)
and their plain versions.

The radix select replaces clover_tpu/kernels/threshold.py
threshold4_pallas and threshold8_pallas.  Every form keeps the k largest
|code * (s/qmax)| of a 4-bit (packed) or 8-bit vector in golden order
(|value| descending, index ascending), zeros the other codes, and returns
the new codes; scales are the caller's, untouched.  The kernel needs no
length: padding codes are zero, so keeping or dropping a padding tie
writes the same byte.  Every form also takes a stacked batch, ``(B, w)``
codes and ``(B, nb)`` scales, and thresholds each row on its own
(clover_tpu vmaps the threshold over a batch): the kernel in one launch
of B CTAs, the plain versions row by row.

The large-n 4-bit hybrid's two passes replace hist4_pallas and
mask4_pallas, on 1-D packed codes: ``hist4`` counts |code| == c (c = 0..7)
per 64-block as int32 (nb, 8); ``mask4`` keeps an element when
v = |code| * m7[b] (m7 = s/7) is above tau, or equals it with
offset[b] + (earlier ties of block b in element order) < fill.  tau, fill
and the offsets come from ops/threshold.py hybrid_select.
"""

from __future__ import annotations

import torch

from ..formats import BLOCK, pack_nibbles, unpack_nibbles
from ..ops import _core
from .. import tracing
from . import _build


def golden_keep(values: torch.Tensor, k: int,
                length: int | None = None) -> torch.Tensor:
    """Bool mask of the first k of ``values`` (f32 >= 0) in golden order;
    entries at or past ``length`` rank after every other one."""
    n = values.shape[0]
    bits = values.view(torch.int32).to(torch.int64)
    idx = torch.arange(n, device=values.device)
    key = (bits << 32) | (n - 1 - idx)            # unique, order-preserving
    if length is not None and length < n:
        key = torch.where(idx < length, key, torch.full_like(key, -1))
    keep = torch.zeros(n, dtype=torch.bool, device=values.device)
    keep[torch.topk(key, k).indices] = True
    return keep


def _rows(plain, codes, scales, *args):
    return torch.stack([plain(c, s, *args) for c, s in zip(codes, scales)])


def threshold4_plain(codes: torch.Tensor, scales: torch.Tensor,
                     k: int) -> torch.Tensor:
    if codes.dim() == 2:
        return _rows(threshold4_plain, codes, scales, k)
    c = unpack_nibbles(codes)
    m7 = _core.div(scales, 7.0).repeat_interleave(BLOCK)
    keep = golden_keep(c.abs().to(torch.float32) * m7, k)
    return pack_nibbles(torch.where(keep, c, torch.zeros_like(c)))


def threshold8_plain(codes: torch.Tensor, scales: torch.Tensor, k: int,
                     length: int) -> torch.Tensor:
    if codes.dim() == 2:
        return _rows(threshold8_plain, codes, scales, k, length)
    av = codes.to(torch.float32).abs() * _core.expand_vec_scales(scales, 8)
    keep = golden_keep(av, k, length)
    return torch.where(keep, codes, torch.zeros_like(codes))


def _launch(codes: torch.Tensor, scales: torch.Tensor, k: int,
            bits: int) -> torch.Tensor:
    *lead, wb = codes.shape
    if len(lead) > 1 or lead == [0]:
        raise ValueError(f"codes {tuple(codes.shape)}: expected (w,) or "
                         f"(B, w) with B >= 1")
    n_pad = wb * 8 // bits
    if n_pad % 128:
        raise ValueError(f"codes {tuple(codes.shape)} not padded to 128")
    if not 0 <= k < 2 ** 31:
        raise ValueError(f"k={k} out of range")
    _build.check(codes, (*lead, wb), torch.int8, "codes")
    _build.check(scales, (*lead, n_pad // BLOCK), torch.float32, "scales",
                 codes.device)
    batch = lead[0] if lead else 1
    out = torch.empty_like(codes)
    _build.launch("clover_threshold", codes.device, _build.ptr(codes),
                  _build.ptr(scales), _build.ptr(out), n_pad, int(k), bits,
                  batch)
    return out


@tracing.kernel("threshold4")
def threshold4_cuda(codes: torch.Tensor, scales: torch.Tensor,
                    k: int) -> torch.Tensor:
    return _launch(codes, scales, k, 4)


@tracing.kernel("threshold8")
def threshold8_cuda(codes: torch.Tensor, scales: torch.Tensor,
                    k: int) -> torch.Tensor:
    return _launch(codes, scales, k, 8)


def hist4_plain(codes: torch.Tensor) -> torch.Tensor:
    mag = unpack_nibbles(codes).abs().reshape(-1, BLOCK)
    values = torch.arange(8, dtype=mag.dtype, device=mag.device)
    return (mag[:, :, None] == values).sum(dim=1, dtype=torch.int32)


def mask4_plain(codes: torch.Tensor, m7: torch.Tensor, tau: torch.Tensor,
                fill: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    c = unpack_nibbles(codes)
    v = c.abs().to(torch.float32) * m7.repeat_interleave(BLOCK)
    tie = (v == tau).reshape(-1, BLOCK).to(torch.int64)
    rank = tie.cumsum(dim=1) - tie + offset[:, None]
    keep = (v > tau) | ((tie > 0) & (rank < fill)).reshape(-1)
    return pack_nibbles(torch.where(keep, c, torch.zeros_like(c)))


def _packed4(codes: torch.Tensor) -> int:
    """Check 1-D packed 4-bit codes; -> n_pad."""
    if codes.dim() != 1:
        raise ValueError(f"codes {tuple(codes.shape)}: expected 1-D")
    n_pad = 2 * codes.shape[0]
    if n_pad % 128:
        raise ValueError(f"codes {tuple(codes.shape)} not padded to 128")
    _build.check(codes, codes.shape, torch.int8, "codes")
    return n_pad


@tracing.kernel("hist4")
def hist4_cuda(codes: torch.Tensor) -> torch.Tensor:
    n_pad = _packed4(codes)
    hist = torch.empty(n_pad // BLOCK, 8, dtype=torch.int32,
                       device=codes.device)
    _build.launch("clover_hist4", codes.device, _build.ptr(codes),
                  _build.ptr(hist), n_pad)
    return hist


@tracing.kernel("mask4")
def mask4_cuda(codes: torch.Tensor, m7: torch.Tensor, tau: torch.Tensor,
               fill: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    n_pad = _packed4(codes)
    dev, nb = codes.device, n_pad // BLOCK
    _build.check(m7, (nb,), torch.float32, "m7", dev)
    _build.check(tau, (), torch.float32, "tau", dev)
    _build.check(fill, (), torch.int64, "fill", dev)
    _build.check(offset, (nb,), torch.int64, "offset", dev)
    out = torch.empty_like(codes)
    P = _build.ptr
    _build.launch("clover_mask4", dev, P(codes), P(m7), P(tau), P(fill),
                  P(offset), P(out), n_pad)
    return out
