"""Fused 4-bit MVM(+AXPY) kernel (csrc/mvm.cu) and its plain torch version.

Replaces clover_tpu/kernels/mvm.py mvm_pallas and mvm_axpy_pallas in 4x4
mode.  Both forms compute, on raw tensors,

    y  = sum_b (sA/7)(sx/7) * dot_int(A[:, b], x[b])   exact int block dots
    q1 = band-requant(y)                               Philox leg 0, seed1
    out = q1                                           u is None
    out = band-requant(u*(us/7) + alpha*(q1*(s1/7)))   Philox leg 1, seed2

and return ``(codes, scales)`` of the 4-bit output.  The plain version sums
the block products in the kernel's order (:func:`blocked_sum`), so the two
agree bit for bit; against clover_tpu, whose f32 sum order is XLA's, they
agree within one output LSB.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..formats import BLOCK, cdiv, unpack_nibbles
from ..ops import _core
from . import _build, philox
from .quantize import quantize_vec_plain

PAIRS = 16            # 32-byte blocks a warp covers per 512-byte chunk


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


def blocked_sum(t: torch.Tensor) -> torch.Tensor:
    """Row sums of (m, nb) in the kernel's order: pair p accumulates blocks
    p, p+16, ... from 0, then pairs reduce (p, p^8), (p, p^4), (p, p^2),
    (p, p^1)."""
    m, nb = t.shape
    nch = cdiv(nb, PAIRS)
    t = F.pad(t, (0, nch * PAIRS - nb)).reshape(m, nch, PAIRS)
    acc = torch.zeros(m, PAIRS, dtype=t.dtype, device=t.device)
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


def mvm4_plain(a_codes, a_scales, x_codes, x_scales, u_codes=None,
               u_scales=None, alpha: float = 0.0, seed1: int = 0,
               noise1: bool = False, seed2: int = 0, noise2: bool = False):
    y = blocked_sum(blocked_products(a_codes, a_scales, x_codes, x_scales))
    codes, scales = quantize_vec_plain(y, 4, seed1, noise1)
    if u_codes is None:
        return codes, scales
    return axpy_plain(u_codes, u_scales, codes, scales, alpha, 4, seed2, noise2)


def mvm4_cuda(a_codes, a_scales, x_codes, x_scales, u_codes=None,
              u_scales=None, alpha: float = 0.0, seed1: int = 0,
              noise1: bool = False, seed2: int = 0, noise2: bool = False):
    """Kernel form of :func:`mvm4_plain`: one launch, epilogue on when
    ``u_codes`` is given."""
    m_pad, wb = a_codes.shape
    n_pad = 2 * wb
    if m_pad % 128 or n_pad % 128:
        raise ValueError(f"A codes {tuple(a_codes.shape)} not padded to 128")
    _build.check(a_codes, (m_pad, wb), torch.int8, "A codes")
    device = a_codes.device
    _build.check(a_scales, (m_pad // BLOCK, n_pad // BLOCK), torch.float32,
           "A scales", device)
    _build.check(x_codes, (wb,), torch.int8, "x codes", device)
    _build.check(x_scales, (n_pad // BLOCK,), torch.float32, "x scales", device)
    if (u_codes is None) != (u_scales is None):
        raise ValueError("u codes and scales come together")
    if u_codes is not None:
        _build.check(u_codes, (m_pad // 2,), torch.int8, "u codes", device)
        _build.check(u_scales, (m_pad // BLOCK,), torch.float32, "u scales",
               device)
    out = torch.empty(m_pad // 2, dtype=torch.int8, device=device)
    out_scales = torch.empty(m_pad // BLOCK, dtype=torch.float32, device=device)
    P = _build.ptr
    _build.launch("clover_mvm4", device, P(a_codes), P(a_scales), P(x_codes),
                  P(x_scales), P(u_codes), P(u_scales), float(alpha), P(out),
                  P(out_scales), m_pad, n_pad, int(noise1), seed1 & 0xFFFFFFFF,
                  int(noise2), seed2 & 0xFFFFFFFF)
    mvm4_cuda.launches += 1
    return out, out_scales


mvm4_cuda.launches = 0
