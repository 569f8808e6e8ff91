"""Vector and matrix restore kernels (csrc/restore.cu) and their plain
torch versions.

Replaces clover_tpu/kernels/restore.py restore_vec_pallas and
restore_mat_pallas.  Every form maps the codes and scales of a 4- or 8-bit
vector (one scale per 64-block) to f32[n_pad], or of a matrix (one scale
per 64x64 tile) to f32[m_pad, n_pad], as ``code * (s / qmax)``: the
multiplier divided first (IEEE), then one product, the op order of
clover_tpu's restore, so kernel, plain version and clover_tpu agree bit
for bit.
"""

from __future__ import annotations

import torch

from ..formats import BLOCK, unpack_nibbles
from ..ops import _core
from .. import tracing
from . import _build


def restore_vec_plain(codes: torch.Tensor, scales: torch.Tensor,
                      bits: int) -> torch.Tensor:
    c = unpack_nibbles(codes) if bits == 4 else codes
    return c.to(torch.float32) * _core.expand_vec_scales(scales, bits)


@tracing.kernel("restore_vec")
def restore_vec_cuda(codes: torch.Tensor, scales: torch.Tensor,
                     bits: int) -> torch.Tensor:
    if bits not in (4, 8):
        raise ValueError(f"restore kernel takes bits 4 or 8, got {bits}")
    (wb,) = codes.shape
    n_pad = wb * 8 // bits
    if n_pad % 128:
        raise ValueError(f"codes {tuple(codes.shape)} not padded to 128")
    _build.check(codes, (wb,), torch.int8, "codes")
    _build.check(scales, (n_pad // BLOCK,), torch.float32, "scales",
                 codes.device)
    out = torch.empty(n_pad, dtype=torch.float32, device=codes.device)
    _build.launch("clover_restore_vec", codes.device, _build.ptr(codes),
                  _build.ptr(scales), _build.ptr(out), n_pad, bits)
    return out


def restore_mat_plain(codes: torch.Tensor, scales: torch.Tensor,
                      bits: int) -> torch.Tensor:
    c = unpack_nibbles(codes) if bits == 4 else codes
    return c.to(torch.float32) * _core.expand_tile_scales(scales, bits)


@tracing.kernel("restore_mat")
def restore_mat_cuda(codes: torch.Tensor, scales: torch.Tensor,
                     bits: int) -> torch.Tensor:
    if bits not in (4, 8):
        raise ValueError(f"restore kernel takes bits 4 or 8, got {bits}")
    if codes.dim() != 2:
        raise ValueError(f"codes {tuple(codes.shape)}: expected 2-D")
    m_pad, wb = codes.shape
    n_pad = wb * 8 // bits
    if m_pad % 128 or n_pad % 128:
        raise ValueError(f"codes {tuple(codes.shape)} not padded to 128")
    _build.check(codes, (m_pad, wb), torch.int8, "codes")
    _build.check(scales, (m_pad // BLOCK, n_pad // BLOCK), torch.float32,
                 "scales", codes.device)
    out = torch.empty(m_pad, n_pad, dtype=torch.float32, device=codes.device)
    _build.launch("clover_restore_mat", codes.device, _build.ptr(codes),
                  _build.ptr(scales), _build.ptr(out), m_pad, n_pad, bits)
    return out
