"""4-bit transpose kernel (csrc/transpose.cu) and its plain torch version.

Replaces clover_tpu/kernels/transpose.py transpose_pallas (4-bit).  Both
forms map packed codes int8[m_pad, n_pad/2] to int8[n_pad, m_pad/2]; the
tile scales transpose outside, as ``scales.T``.
"""

from __future__ import annotations

import torch

from ..formats import pack_nibbles, unpack_nibbles
from . import _build


def transpose4_plain(codes: torch.Tensor) -> torch.Tensor:
    return pack_nibbles(unpack_nibbles(codes).T.contiguous())


def transpose4_cuda(codes: torch.Tensor) -> torch.Tensor:
    m_pad, wb = codes.shape
    n_pad = 2 * wb
    if m_pad % 128 or n_pad % 128:
        raise ValueError(f"codes {tuple(codes.shape)} not padded to 128")
    _build.check(codes, (m_pad, wb), torch.int8, "codes")
    out = torch.empty(n_pad, m_pad // 2, dtype=torch.int8, device=codes.device)
    _build.launch("clover_transpose4", codes.device, _build.ptr(codes),
                  _build.ptr(out), m_pad, n_pad)
    transpose4_cuda.launches += 1
    return out


transpose4_cuda.launches = 0
