"""Quantize kernels (csrc/quantize.cu) and their plain torch versions.

Replaces clover_tpu/kernels/quantize.py quantize_vec_pallas and
quantize_mat_pallas.  Both forms take a padded f32 operand and return
``(codes, scales)``: 4-bit codes packed, 8-bit codes as int8.  SR noise
is Philox with counter (element index, leg 0), so kernel and plain version
agree bit for bit in both modes.
"""

from __future__ import annotations

import torch

from ..formats import BLOCK, pack_nibbles
from ..ops import _core
from .. import tracing
from . import _build, philox


def _check_bits(bits: int):
    if bits not in (4, 8):
        raise ValueError(f"quantize kernel takes bits 4 or 8, got {bits}")


def _noise(seed: int, noise: bool, shape, leg: int, device):
    return philox.uniform(seed, shape, leg, device) if noise else None


def quantize_vec_plain(xp: torch.Tensor, bits: int, seed: int = 0,
                       noise: bool = False, leg: int = philox.LEG_QUANTIZE):
    """Padded f32[n_pad] -> (codes, scales f32[n_pad/64])."""
    _check_bits(bits)
    scales = _core.block_scales(xp)
    codes = _core.sr_codes(xp, scales.repeat_interleave(BLOCK), bits,
                           _noise(seed, noise, xp.shape, leg, xp.device))
    return (pack_nibbles(codes) if bits == 4 else codes), scales


def quantize_mat_plain(ap: torch.Tensor, bits: int, seed: int = 0,
                       noise: bool = False):
    """Padded f32[m_pad, n_pad] -> (codes, scales f32[m_pad/64, n_pad/64])."""
    _check_bits(bits)
    scales = _core.tile_scales(ap)
    per_elem = scales.repeat_interleave(BLOCK, 0).repeat_interleave(BLOCK, 1)
    codes = _core.sr_codes(ap, per_elem, bits,
                           _noise(seed, noise, ap.shape,
                                  philox.LEG_QUANTIZE, ap.device))
    return (pack_nibbles(codes) if bits == 4 else codes), scales


@tracing.kernel("quantize_vec")
def quantize_vec_cuda(xp: torch.Tensor, bits: int, seed: int = 0,
                      noise: bool = False):
    """Kernel form of :func:`quantize_vec_plain` (leg 0)."""
    _check_bits(bits)
    (n_pad,) = xp.shape
    if n_pad % 128:
        raise ValueError(f"length {n_pad} not padded to 128")
    _build.check(xp, (n_pad,), torch.float32, "x")
    codes = torch.empty(n_pad // 2 if bits == 4 else n_pad, dtype=torch.int8,
                        device=xp.device)
    scales = torch.empty(n_pad // BLOCK, dtype=torch.float32, device=xp.device)
    _build.launch("clover_quantize_vec", xp.device, _build.ptr(xp),
                  _build.ptr(codes), _build.ptr(scales), n_pad, bits,
                  int(noise), seed & 0xFFFFFFFF)
    return codes, scales


def counter_bits(m_pad: int, n_pad: int) -> int:
    """Width of the Philox element counter csrc/quantize.cu's matrix kernel
    forms: 32 bits below 2^32 elements (counter word 1 is then 0), else
    64.  Both give the same noise where both apply."""
    return 32 if m_pad * n_pad < 1 << 32 else 64


@tracing.kernel("quantize_mat")
def quantize_mat_cuda(ap: torch.Tensor, bits: int, seed: int = 0,
                      noise: bool = False):
    """Kernel form of :func:`quantize_mat_plain`."""
    _check_bits(bits)
    m_pad, n_pad = ap.shape
    if m_pad % 128 or n_pad % 128:
        raise ValueError(f"shape {(m_pad, n_pad)} not padded to 128")
    _build.check(ap, (m_pad, n_pad), torch.float32, "a")
    codes = torch.empty(m_pad, n_pad // 2 if bits == 4 else n_pad,
                        dtype=torch.int8, device=ap.device)
    scales = torch.empty(m_pad // BLOCK, n_pad // BLOCK, dtype=torch.float32,
                         device=ap.device)
    _build.launch("clover_quantize_mat", ap.device, _build.ptr(ap),
                  _build.ptr(codes), _build.ptr(scales), m_pad, n_pad, bits,
                  int(noise), int(counter_bits(m_pad, n_pad) == 64),
                  seed & 0xFFFFFFFF)
    return codes, scales
