"""Standalone scaleAndAdd kernel (csrc/axpy.cu).

Replaces clover_tpu/kernels/quantize.py axpy_pallas.  Computes, on the raw
tensors of two 4- or 8-bit vectors of equal padded length,

    r = Q(u*(us/q) + alpha*(v*(vs/q)))     per 64-block, Philox leg 1

and returns ``(codes, scales)``.  Its plain version is
:func:`clover_tpu_torch.kernels.mvm.axpy_plain`, the AXPY stage of the MVM
kernel's plain version; kernel and plain version agree bit for bit, and a
``mvm`` followed by this kernel equals the fused ``mvm_axpy``.  Operands are
flat: a stacked batch is passed as its ``B * n_pad`` elements in one launch.
"""

from __future__ import annotations

import torch

from ..formats import BLOCK
from .. import tracing
from . import _build


@tracing.kernel("axpy")
def axpy_cuda(u_codes, u_scales, v_codes, v_scales, alpha: float, bits: int,
              seed: int = 0, noise: bool = False):
    """Kernel form of :func:`~clover_tpu_torch.kernels.mvm.axpy_plain`."""
    if bits not in (4, 8):
        raise ValueError(f"AXPY kernel takes bits 4 or 8, got {bits}")
    (width,) = u_codes.shape
    n = width * 8 // bits
    if n % 128:
        raise ValueError(f"codes {tuple(u_codes.shape)} not padded to 128")
    _build.check(u_codes, (width,), torch.int8, "u codes")
    device = u_codes.device
    _build.check(v_codes, (width,), torch.int8, "v codes", device)
    _build.check(u_scales, (n // BLOCK,), torch.float32, "u scales", device)
    _build.check(v_scales, (n // BLOCK,), torch.float32, "v scales", device)
    out = torch.empty_like(u_codes)
    out_scales = torch.empty_like(u_scales)
    P = _build.ptr
    _build.launch("clover_axpy", device, P(u_codes), P(u_scales), P(v_codes),
                  P(v_scales), float(alpha), P(out), P(out_scales), n, bits,
                  int(noise), seed & 0xFFFFFFFF)
    return out, out_scales
