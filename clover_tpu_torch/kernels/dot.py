"""Dot-product kernel (csrc/dot.cu) and its plain torch versions.

Replaces clover_tpu/kernels/dot.py dot_pallas.  Every form takes the codes
and block scales of two 4-bit (packed) or 8-bit vectors of one padded
length and returns the f32 scalar

    sum_b ((su_b / qmax) * (sv_b / qmax)) * acc_b

with acc_b the exact integer dot of block b's codes, the term order of
clover_tpu's dot and golden.py.  :func:`dot_plain`, which the ops take for
CPU tensors, sums the terms in torch's order; :func:`dot_plain_ordered` in
the kernel's, a function of the length alone (csrc/dot.cu's order note),
so the kernel equals it bit for bit at every grid.  The two sums agree
within the rounding of a reordered sum.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..formats import BLOCK, unpack_nibbles
from ..ops import _core
from .. import tracing
from . import _build

TILE = 256                # csrc/dot.cu DOT_TILE: blocks of a tile
THREADS = 256             # csrc/dot.cu DOT_THREADS
WARPS = THREADS // 32


def steps(bits: int) -> int:
    """Warp steps of a tile (csrc/dot.cu DotGeom::STEPS): a step reads
    32 / (lanes a block) blocks in each of the WARPS warps."""
    return TILE // (WARPS * 32 // (2 if bits == 4 else 4))


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


def _halve(t: torch.Tensor) -> torch.Tensor:
    """The halving tree over the last dim: (g, g ^ w/2), ..., (g, g ^ 1)."""
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t[..., 0]


def dot_plain_ordered(u_codes: torch.Tensor, u_scales: torch.Tensor,
                      v_codes: torch.Tensor, v_scales: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """The terms of :func:`dot_terms` summed in the kernel's order, one
    elementwise f32 add at a time: per tile, each lane group's
    ``steps(bits)`` terms from +0, the groups' and then the warps' halving
    trees; the tiles' partials by THREADS threads from +0, then the same
    trees."""
    terms = dot_terms(u_codes, u_scales, v_codes, v_scales, bits)
    tiles = -(-terms.shape[0] // TILE)
    terms = F.pad(terms, (0, tiles * TILE - terms.shape[0]))
    terms = terms.view(tiles, steps(bits), WARPS, -1)
    acc = torch.zeros_like(terms[:, 0])
    for s in range(steps(bits)):
        acc = acc + terms[:, s]
    partials = _halve(_halve(acc))
    rows = -(-tiles // THREADS)
    partials = F.pad(partials, (0, rows * THREADS - tiles)).view(rows,
                                                                 THREADS)
    c = torch.zeros_like(partials[0])
    for r in range(rows):
        c = c + partials[r]
    return _halve(_halve(c.view(WARPS, 32)))


@functools.cache
def _ticket(device_index: int, stream: int) -> torch.Tensor:
    """The kernel's ticket counter on one stream: zeroed once here, reset
    by the kernel's last CTA at the end of every call."""
    return torch.zeros(1, dtype=torch.int32,
                       device=torch.device("cuda", device_index))


@tracing.kernel("dot")
def dot_cuda(u_codes: torch.Tensor, u_scales: torch.Tensor,
             v_codes: torch.Tensor, v_scales: torch.Tensor,
             bits: int, grid: int | None = None) -> torch.Tensor:
    """0-dim f32 tensor on the codes' device; one launch of ``grid`` CTAs
    (default one a tile); does not synchronize."""
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
    tiles = -(-nb // TILE)
    if grid is None:
        grid = tiles
    if grid < 1:
        raise ValueError(f"grid {grid}: the dot kernel needs a CTA")
    partial = torch.empty(tiles, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    ticket = _ticket(dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    P = _build.ptr
    _build.launch("clover_dot", dev, P(u_codes), P(v_codes), P(u_scales),
                  P(v_scales), P(partial), P(ticket), P(out), n_pad, bits,
                  grid)
    return out
