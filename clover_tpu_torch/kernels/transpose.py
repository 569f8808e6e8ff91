"""Transpose kernels (csrc/transpose.cu) and their plain torch versions.

Replaces clover_tpu/kernels/transpose.py transpose_pallas.  4-bit: packed
codes int8[m_pad, n_pad/2] to int8[n_pad, m_pad/2], nibbles re-paired;
8-bit: int8[m_pad, n_pad] to int8[n_pad, m_pad].  The tile scales
transpose outside, as ``scales.T``.
"""

from __future__ import annotations

import torch

from ..formats import pack_nibbles, unpack_nibbles
from .. import tracing
from . import _build


def transpose4_plain(codes: torch.Tensor) -> torch.Tensor:
    return pack_nibbles(unpack_nibbles(codes).T.contiguous())


def transpose8_plain(codes: torch.Tensor) -> torch.Tensor:
    return codes.T.contiguous()


def _launch(codes: torch.Tensor, bits: int) -> torch.Tensor:
    m_pad, wb = codes.shape
    n_pad = wb * 8 // bits
    if m_pad % 128 or n_pad % 128:
        raise ValueError(f"codes {tuple(codes.shape)} not padded to 128")
    _build.check(codes, (m_pad, wb), torch.int8, "codes")
    out = torch.empty(n_pad, m_pad * bits // 8, dtype=torch.int8,
                      device=codes.device)
    _build.launch("clover_transpose", codes.device, _build.ptr(codes),
                  _build.ptr(out), m_pad, n_pad, bits)
    return out


@tracing.kernel("transpose4")
def transpose4_cuda(codes: torch.Tensor) -> torch.Tensor:
    return _launch(codes, 4)


@tracing.kernel("transpose8")
def transpose8_cuda(codes: torch.Tensor) -> torch.Tensor:
    return _launch(codes, 8)
