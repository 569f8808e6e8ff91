"""Dot-product kernel (csrc/dot.cu) and its plain torch version.

Replaces clover_tpu/kernels/dot.py dot_pallas.  Both forms take the codes
and block scales of two 4-bit (packed) or 8-bit vectors of one padded
length and return the f32 scalar

    sum_b ((su_b / qmax) * (sv_b / qmax)) * acc_b

with acc_b the exact integer dot of block b's codes, the term order of
clover_tpu's dot and golden.py.  The terms agree bit for bit; their f32 sum
is taken in another order by the kernel (per-CTA partials, then one fixed
pass over them) than by torch, so the two agree within the rounding of a
reordered sum, and each is deterministic.
"""

from __future__ import annotations

import torch

from ..formats import BLOCK, unpack_nibbles
from ..ops import _core
from . import _build

BLOCKS_PER_CTA = 256      # csrc/dot.cu DOT_BLOCKS_PER_CTA


def dot_terms(u_codes: torch.Tensor, u_scales: torch.Tensor,
              v_codes: torch.Tensor, v_scales: torch.Tensor,
              bits: int) -> torch.Tensor:
    """The per-block terms, f32[nb]."""
    cu = unpack_nibbles(u_codes) if bits == 4 else u_codes
    cv = unpack_nibbles(v_codes) if bits == 4 else v_codes
    acc = (cu.to(torch.int32) * cv.to(torch.int32)).reshape(-1, BLOCK).sum(
        dim=1, dtype=torch.int32)
    qm = _core.qmax(bits)
    comb = _core.div(u_scales, qm) * _core.div(v_scales, qm)
    return comb * acc.to(torch.float32)


def dot_plain(u_codes: torch.Tensor, u_scales: torch.Tensor,
              v_codes: torch.Tensor, v_scales: torch.Tensor,
              bits: int) -> torch.Tensor:
    return dot_terms(u_codes, u_scales, v_codes, v_scales, bits).sum()


def dot_cuda(u_codes: torch.Tensor, u_scales: torch.Tensor,
             v_codes: torch.Tensor, v_scales: torch.Tensor,
             bits: int) -> torch.Tensor:
    """0-dim f32 tensor on the codes' device; does not synchronize."""
    if bits not in (4, 8):
        raise ValueError(f"dot kernel takes bits 4 or 8, got {bits}")
    (wb,) = u_codes.shape
    n_pad = wb * 8 // bits
    if n_pad % 128:
        raise ValueError(f"codes {tuple(u_codes.shape)} not padded to 128")
    dev = u_codes.device
    nb = n_pad // BLOCK
    _build.check(u_codes, (wb,), torch.int8, "u codes")
    _build.check(v_codes, (wb,), torch.int8, "v codes", dev)
    _build.check(u_scales, (nb,), torch.float32, "u scales", dev)
    _build.check(v_scales, (nb,), torch.float32, "v scales", dev)
    partial = torch.empty(-(-nb // BLOCKS_PER_CTA), dtype=torch.float32,
                          device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    P = _build.ptr
    _build.launch("clover_dot", dev, P(u_codes), P(v_codes), P(u_scales),
                  P(v_scales), P(partial), P(out), n_pad, bits)
    dot_cuda.launches += 1
    return out


dot_cuda.launches = 0
