"""Shared torch primitives for the quantized ops and the kernels' plain
versions (counterpart of clover_tpu/ops/_core.py).

Every quotient divides a tensor by a tensor of its own shape: torch computes
``scalar / tensor`` as ``reciprocal(tensor) * scalar`` and, on CUDA,
``tensor / scalar`` as a product with the reciprocal, and either can miss
the IEEE quotient by one ulp.  The kernels divide in IEEE, so the plain
versions must too.
"""

from __future__ import annotations

import torch

from ..formats import BLOCK

_QMAX = {4: 7.0, 8: 127.0}


def qmax(bits: int) -> float:
    return _QMAX[bits]


def div(num, den: torch.Tensor) -> torch.Tensor:
    """IEEE ``num / den`` elementwise (``num`` or ``den`` may be a float).

    A float operand is filled on the tensor's device, never copied there:
    a host-to-device copy of a scalar synchronizes the stream."""
    if not isinstance(num, torch.Tensor):
        num = torch.full_like(den, float(num))
    if not isinstance(den, torch.Tensor):
        den = torch.full_like(num, float(den))
    elif den.shape != num.shape:
        den = torch.broadcast_to(den.to(num.device, num.dtype),
                                 num.shape).contiguous()
    return torch.div(num, den)


def nonzero_scales(s: torch.Tensor) -> torch.Tensor:
    """Zero block scales -> 1.0."""
    return torch.where(s == 0, torch.ones_like(s), s).to(torch.float32)


def block_scales(x: torch.Tensor) -> torch.Tensor:
    """Per-64-block absmax of a padded 1-D f32 tensor; zero blocks -> 1.0."""
    return nonzero_scales(x.reshape(-1, BLOCK).abs().amax(dim=-1))


def tile_scales(a: torch.Tensor) -> torch.Tensor:
    """Per-64x64-tile absmax of a padded f32 matrix; zero tiles -> 1.0."""
    m, n = a.shape
    t = a.abs().reshape(m // BLOCK, BLOCK, n // BLOCK, BLOCK)
    return nonzero_scales(t.amax(dim=(1, 3)))


def sr_codes(x: torch.Tensor, scale_per_elem: torch.Tensor, bits: int,
             noise: torch.Tensor | None) -> torch.Tensor:
    """q = min(floor(|x| * (qmax/s) + u), qmax) * sign(x) as int8.

    Op order of clover_tpu/ops/_core.py: ``mult = qm / s`` first.
    ``noise`` is U[0,1) of x's shape, or None for deterministic mode.
    """
    qm = _QMAX[bits]
    mult = div(qm, scale_per_elem)
    mag = x.abs() * mult
    if noise is not None:
        mag = mag + noise
    q_abs = torch.floor(mag).clamp_max(qm).to(torch.int32)
    return torch.where(x < 0, -q_abs, q_abs).to(torch.int8)


def expand_vec_scales(scales: torch.Tensor, bits: int) -> torch.Tensor:
    """(nb,) block scales -> per-element dequant multiplier (npad,)."""
    return div(scales, _QMAX[bits]).repeat_interleave(BLOCK)


def expand_tile_scales(scales: torch.Tensor, bits: int) -> torch.Tensor:
    """(mb, nb) tile scales -> per-element dequant multiplier (m, n)."""
    s = div(scales, _QMAX[bits])
    return s.repeat_interleave(BLOCK, dim=0).repeat_interleave(BLOCK, dim=1)
