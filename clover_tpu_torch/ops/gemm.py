"""Batched MVM and the quantized-matrix GEMM (counterpart of
clover_tpu/ops/gemm.py).

``mvm_batched``: y_j = requantize(A @ x_j) for a stacked batch of quantized
vectors.  The int modes 4x4, 4x8 and 8x8 run the batched MVM kernel on
CUDA (B = 1 the single MVM kernel; B > MAX_BATCH split into launches of at
most MAX_BATCH) and its plain version on the CPU.  Vector j always takes
the SR seed ``seed + j`` of its position in the whole batch, so a result
does not depend on how the batch was split, and equals ``mvm(A, x_j,
seed + j)`` bit for bit.

``mvm_batched_f32_fast``: the batched MVM without the requant, f32[B, m_pad],
through the kernel's f32-output mode (the sharded server's per-shard step).

``gemm_f32``: C = restore(A) @ B for an f32 B, the per-block partial
products scaled afterwards; plain torch on any device (clover_tpu computes
it in XLA, outside any Pallas kernel).
"""

from __future__ import annotations

import torch

from ..formats import (
    BLOCK, QMat4, QMat16, QMat32, stack_vectors, unpack_nibbles, vector_at,
)
from ..kernels.dispatch import on_cuda, seed_from, wrap_i32
from ..kernels.mvm import mvm_f32_cuda
from ..kernels.mvm_batched import (
    MAX_BATCH, mvm_batched_cuda, mvm_batched_f32_cuda, mvm_batched_f32_plain,
    mvm_batched_plain,
)
from . import _core
from .mvm import _fused, mvm, mvm_f32


def _batch(xs) -> int:
    return (xs.codes if hasattr(xs, "codes") else xs.values).shape[0]


def mvm_batched(A, xs, generator=None):
    """Fused MVM over a stacked batch of quantized vectors; returns a
    stacked container of the outputs."""
    b = _batch(xs)
    seed, noise = seed_from(generator)
    fused = _fused(A, xs)
    if fused is None:
        # 16/32-bit combinations: one plain MVM per vector, seed + j
        return stack_vectors([
            mvm(A, vector_at(xs, j), wrap_i32(seed + j) if noise else None)
            for j in range(b)])
    out = fused[2]
    bits = (A.bits, xs.bits)
    if not on_cuda(A.codes, xs.codes):
        codes, scales = mvm_batched_plain(*bits, A.codes, A.scales, xs.codes,
                                          xs.scales, seed, noise)
        return out(codes=codes, scales=scales, length=A.rows)
    if b == 1:
        y = mvm(A, vector_at(xs, 0), seed if noise else None)
        return out(codes=y.codes[None], scales=y.scales[None], length=A.rows)
    parts = [mvm_batched_cuda(*bits, A.codes, A.scales,
                              xs.codes[j:j + MAX_BATCH],
                              xs.scales[j:j + MAX_BATCH],
                              wrap_i32(seed + j), noise)
             for j in range(0, b, MAX_BATCH)]
    if len(parts) == 1:
        codes, scales = parts[0]
    else:
        codes = torch.cat([c for c, _ in parts])
        scales = torch.cat([s for _, s in parts])
    return out(codes=codes, scales=scales, length=A.rows)


def mvm_batched_f32(A, xs) -> torch.Tensor:
    """f32[B, m_pad] batched MVM, no output requantization."""
    return torch.stack([mvm_f32(A, vector_at(xs, j))
                        for j in range(_batch(xs))])


def mvm_batched_f32_fast(A, xs) -> torch.Tensor:
    """Like :func:`mvm_batched_f32`, through the batched MVM kernel's
    f32-output mode for the int modes (B = 1 the single kernel's, B >
    MAX_BATCH split into launches of at most MAX_BATCH; the plain version
    on the CPU) -- the per-shard step of parallel/ops.mvm_batched_psum."""
    if _fused(A, xs) is None:
        return mvm_batched_f32(A, xs)
    bits = (A.bits, xs.bits)
    if not on_cuda(A.codes, xs.codes):
        return mvm_batched_f32_plain(*bits, A.codes, A.scales, xs.codes,
                                     xs.scales)
    if _batch(xs) == 1:
        return mvm_f32_cuda(*bits, A.codes, A.scales, xs.codes[0],
                            xs.scales[0])[None]
    return torch.cat([mvm_batched_f32_cuda(*bits, A.codes, A.scales,
                                           xs.codes[j:j + MAX_BATCH],
                                           xs.scales[j:j + MAX_BATCH])
                      for j in range(0, _batch(xs), MAX_BATCH)])


def gemm_f32(A, B: torch.Tensor) -> torch.Tensor:
    """C = restore(A) @ B with B f32[n_pad, r]; f32[m_pad, r] out.

    For a 4/8-bit A, per 64-column block the codes (exact in f32) meet B's
    rows in one batched product, and the (nb, m, r) partials are then
    scaled by the tile's s/qmax and summed over blocks, clover_tpu's order;
    no restored copy of A is formed.  The products run in IEEE fp32
    (``_core.ieee_fp32``), whatever the caller's TF32 setting.
    """
    if isinstance(A, (QMat16, QMat32)):
        with _core.ieee_fp32():
            return A.values.to(torch.float32) @ B.to(torch.float32)
    m, n = A.rows_pad, A.cols_pad
    nb = n // BLOCK
    codes = unpack_nibbles(A.codes) if isinstance(A, QMat4) else A.codes
    a3 = codes.reshape(m, nb, BLOCK).transpose(0, 1).to(torch.float32)
    b3 = B.reshape(nb, BLOCK, -1).to(torch.float32)
    se = _core.div(A.scales, _core.qmax(A.bits)).repeat_interleave(
        BLOCK, 0).T                                           # (nb, m)
    with _core.ieee_fp32():
        part = torch.bmm(a3, b3)                              # (nb, m, r)
        return torch.einsum("bmr,bm->mr", part, se)
