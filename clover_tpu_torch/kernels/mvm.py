"""Fused MVM(+AXPY) kernel (csrc/mvm.cu) and its plain torch versions.

Replaces clover_tpu/kernels/mvm.py mvm_pallas and mvm_axpy_pallas in the
4x4, 4x8 and 8x8 modes.  Every form computes, on raw tensors,

    y  = sum_b (sA/qA)(sx/qx) * dot_int(A[:, b], x[b])    exact int block dots
    q1 = band-requant(y)                                  Philox leg 0, seed1
    out = q1                                              u is None
    out = band-requant(u*(us/qO) + alpha*(q1*(s1/qO)))    Philox leg 1, seed2

and returns ``(codes, scales)`` of the output: 4-bit packed for 4x4
(:func:`mvm4_cuda`), 8-bit for 4x8 and 8x8 (:func:`mvm8_cuda`, whose first
argument is A's bits).  The plain versions sum the block products in the
kernel's order (:func:`blocked_sum`), so the two agree bit for bit; against
clover_tpu, whose f32 sum order is XLA's, they agree within one output LSB.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..formats import BLOCK, cdiv, unpack_nibbles
from ..ops import _core
from . import _build, philox
from .quantize import quantize_vec_plain


def groups(bits_a: int) -> int:
    """64-element blocks a warp of the kernel covers per 512-byte chunk of
    a row of A: 16 packed 4-bit blocks, or 8 of 8 bits."""
    return 16 if bits_a == 4 else 8


def blocked_products(a_codes, a_scales, x_codes, x_scales,
                     bits_a: int = 4, bits_x: int = 4) -> torch.Tensor:
    """(m_pad, nb) f32: ((sA/qa)*(sx/qx)) * exact int32 dot per (row, block)."""
    a = unpack_nibbles(a_codes) if bits_a == 4 else a_codes
    x = unpack_nibbles(x_codes) if bits_x == 4 else x_codes
    m = a.shape[0]
    nb = x.shape[0] // BLOCK
    dots = (a.reshape(m, nb, BLOCK).to(torch.int32)
            * x.reshape(1, nb, BLOCK).to(torch.int32)).sum(-1, dtype=torch.int32)
    comb = (_core.div(a_scales, _core.qmax(bits_a)).repeat_interleave(BLOCK, 0)
            * _core.div(x_scales, _core.qmax(bits_x))[None, :])
    return comb * dots.to(torch.float32)


def blocked_sum(t: torch.Tensor, n_groups: int = 16) -> torch.Tensor:
    """Row sums of (m, nb) in the kernel's order: group g accumulates blocks
    g, g+G, g+2G, ... from 0 (G = ``n_groups``), then the groups reduce
    (g, g^G/2), (g, g^G/4), ..., (g, g^1)."""
    m, nb = t.shape
    nch = cdiv(nb, n_groups)
    t = F.pad(t, (0, nch * n_groups - nb)).reshape(m, nch, n_groups)
    acc = torch.zeros(m, n_groups, dtype=t.dtype, device=t.device)
    for c in range(nch):
        acc = acc + t[:, c]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


def axpy_plain(u_codes, u_scales, v_codes, v_scales, alpha: float, bits: int,
               seed: int = 0, noise: bool = False):
    """r = Q(restore(u) + alpha * restore(v)) on raw tensors (Philox leg 1);
    op order of clover_tpu/ops/axpy.py."""
    def restore(codes, scales):
        c = unpack_nibbles(codes) if bits == 4 else codes
        return c.to(torch.float32) * _core.expand_vec_scales(scales, bits)
    a = torch.tensor(alpha, dtype=torch.float32, device=u_codes.device)
    xf = restore(u_codes, u_scales) + a * restore(v_codes, v_scales)
    return quantize_vec_plain(xf, bits, seed, noise, leg=philox.LEG_AXPY)


def _mvm_plain(bits_a, bits_x, a_codes, a_scales, x_codes, x_scales,
               u_codes, u_scales, alpha, seed1, noise1, seed2, noise2):
    bits_out = 4 if bits_a == bits_x == 4 else 8
    y = blocked_sum(blocked_products(a_codes, a_scales, x_codes, x_scales,
                                     bits_a, bits_x), groups(bits_a))
    codes, scales = quantize_vec_plain(y, bits_out, seed1, noise1)
    if u_codes is None:
        return codes, scales
    return axpy_plain(u_codes, u_scales, codes, scales, alpha, bits_out,
                      seed2, noise2)


def _mvm_cuda(bits_a, bits_x, a_codes, a_scales, x_codes, x_scales,
              u_codes, u_scales, alpha, seed1, noise1, seed2, noise2):
    bits_out = 4 if bits_a == bits_x == 4 else 8
    m_pad, wa = a_codes.shape
    n_pad = wa * 8 // bits_a
    if m_pad % 128 or n_pad % 128:
        raise ValueError(f"A codes {tuple(a_codes.shape)} not padded to 128")
    _build.check(a_codes, (m_pad, wa), torch.int8, "A codes")
    device = a_codes.device
    _build.check(a_scales, (m_pad // BLOCK, n_pad // BLOCK), torch.float32,
                 "A scales", device)
    _build.check(x_codes, (n_pad * bits_x // 8,), torch.int8, "x codes",
                 device)
    _build.check(x_scales, (n_pad // BLOCK,), torch.float32, "x scales", device)
    if (u_codes is None) != (u_scales is None):
        raise ValueError("u codes and scales come together")
    out_width = m_pad * bits_out // 8
    if u_codes is not None:
        _build.check(u_codes, (out_width,), torch.int8, "u codes", device)
        _build.check(u_scales, (m_pad // BLOCK,), torch.float32, "u scales",
                     device)
    out = torch.empty(out_width, dtype=torch.int8, device=device)
    out_scales = torch.empty(m_pad // BLOCK, dtype=torch.float32, device=device)
    P = _build.ptr
    _build.launch("clover_mvm", device, P(a_codes), P(a_scales), P(x_codes),
                  P(x_scales), P(u_codes), P(u_scales), float(alpha), P(out),
                  P(out_scales), m_pad, n_pad, bits_a, bits_x, int(noise1),
                  seed1 & 0xFFFFFFFF, int(noise2), seed2 & 0xFFFFFFFF)
    return out, out_scales


def mvm4_plain(a_codes, a_scales, x_codes, x_scales, u_codes=None,
               u_scales=None, alpha: float = 0.0, seed1: int = 0,
               noise1: bool = False, seed2: int = 0, noise2: bool = False):
    """4-bit A times 4-bit x, 4-bit output."""
    return _mvm_plain(4, 4, a_codes, a_scales, x_codes, x_scales, u_codes,
                      u_scales, alpha, seed1, noise1, seed2, noise2)


def mvm4_cuda(a_codes, a_scales, x_codes, x_scales, u_codes=None,
              u_scales=None, alpha: float = 0.0, seed1: int = 0,
              noise1: bool = False, seed2: int = 0, noise2: bool = False):
    """Kernel form of :func:`mvm4_plain`: one launch, epilogue on when
    ``u_codes`` is given."""
    out = _mvm_cuda(4, 4, a_codes, a_scales, x_codes, x_scales, u_codes,
                    u_scales, alpha, seed1, noise1, seed2, noise2)
    mvm4_cuda.launches += 1
    return out


def mvm8_plain(bits_a: int, a_codes, a_scales, x_codes, x_scales,
               u_codes=None, u_scales=None, alpha: float = 0.0,
               seed1: int = 0, noise1: bool = False, seed2: int = 0,
               noise2: bool = False):
    """``bits_a``-bit A (4 or 8) times 8-bit x, 8-bit output."""
    return _mvm_plain(bits_a, 8, a_codes, a_scales, x_codes, x_scales,
                      u_codes, u_scales, alpha, seed1, noise1, seed2, noise2)


def mvm8_cuda(bits_a: int, a_codes, a_scales, x_codes, x_scales,
              u_codes=None, u_scales=None, alpha: float = 0.0,
              seed1: int = 0, noise1: bool = False, seed2: int = 0,
              noise2: bool = False):
    """Kernel form of :func:`mvm8_plain`."""
    if bits_a not in (4, 8):
        raise ValueError(f"A bits must be 4 or 8, got {bits_a}")
    out = _mvm_cuda(bits_a, 8, a_codes, a_scales, x_codes, x_scales, u_codes,
                    u_scales, alpha, seed1, noise1, seed2, noise2)
    mvm8_cuda.launches += 1
    return out


mvm4_cuda.launches = 0
mvm8_cuda.launches = 0
