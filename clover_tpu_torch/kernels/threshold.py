"""Exact 4-bit threshold kernel (csrc/threshold.cu) and its plain version.

Replaces clover_tpu/kernels/threshold.py threshold4_pallas.  Both forms
keep the k largest |code * (s/7)| of a packed 4-bit vector in golden order
(|value| descending, index ascending), zero the other codes, and return the
new packed codes; scales are the caller's, untouched.
"""

from __future__ import annotations

import torch

from ..formats import BLOCK, pack_nibbles, unpack_nibbles
from ..ops import _core
from . import _build


def golden_keep(values: torch.Tensor, k: int,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """Bool mask of the first k of ``values`` (f32 >= 0) in golden order;
    entries where ``valid`` is False rank after every valid one."""
    n = values.shape[0]
    bits = values.view(torch.int32).to(torch.int64)
    idx = torch.arange(n, device=values.device)
    key = (bits << 32) | (n - 1 - idx)            # unique, order-preserving
    if valid is not None:
        key = torch.where(valid, key, torch.full_like(key, -1))
    keep = torch.zeros(n, dtype=torch.bool, device=values.device)
    keep[torch.topk(key, k).indices] = True
    return keep


def threshold4_plain(codes: torch.Tensor, scales: torch.Tensor,
                     k: int) -> torch.Tensor:
    c = unpack_nibbles(codes)
    m7 = _core.div(scales, 7.0).repeat_interleave(BLOCK)
    keep = golden_keep(c.abs().to(torch.float32) * m7, k)
    return pack_nibbles(torch.where(keep, c, torch.zeros_like(c)))


def threshold4_cuda(codes: torch.Tensor, scales: torch.Tensor,
                    k: int) -> torch.Tensor:
    (wb,) = codes.shape
    n_pad = 2 * wb
    if n_pad % 128:
        raise ValueError(f"codes {tuple(codes.shape)} not padded to 128")
    if not 0 <= k < 2 ** 31:
        raise ValueError(f"k={k} out of range")
    _build.check(codes, (wb,), torch.int8, "codes")
    _build.check(scales, (n_pad // BLOCK,), torch.float32, "scales", codes.device)
    out = torch.empty_like(codes)
    _build.launch("clover_threshold4", codes.device, _build.ptr(codes),
                  _build.ptr(scales), _build.ptr(out), n_pad, int(k))
    threshold4_cuda.launches += 1
    return out


threshold4_cuda.launches = 0
