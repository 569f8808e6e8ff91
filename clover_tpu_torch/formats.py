"""Quantized container formats, byte-compatible with ``clover_tpu.formats``.

* 4-bit codes are two's-complement values in [-7, 7], two per byte, packed
  *deinterleaved per 64-element block*: byte ``32*b + j`` holds element
  ``64*b + j`` in the low nibble, biased by +8, and element ``64*b + j + 32``
  in the high nibble, plain two's complement.  A packed byte is therefore
  ``16*hi + (lo + 8)`` as a signed int8, and a zero code packs to ``0x08``.
* One fp32 scale per 64-element block (vectors) or per 64x64 tile
  (matrices): the block absmax, with all-zero blocks normalized to 1.0.
* Vector lengths and matrix dims are padded to a multiple of 128.  Padding
  codes are zero and padding scales are 1.0; every op keeps that invariant.
* 16-bit is IEEE fp16 without scales; 32-bit is plain fp32.

Containers are frozen dataclasses of tensors.  A container lives on the
device of its tensors; ops run where their inputs are.  A *stacked* vector
container holds B vectors: its tensors carry a leading batch dim and
``length`` is each vector's (:func:`stack_vectors`, :func:`vector_at`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

BLOCK = 64            # elements per scale block / tile side
PAD = 128             # pad granularity for vector length and matrix dims
PACK = 2              # 4-bit codes per byte


def pad_to(n: int, m: int = PAD) -> int:
    """Round ``n`` up to a multiple of ``m``."""
    return int(-(-int(n) // m) * m)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Nibble packing (deinterleaved per-block layout)
# ---------------------------------------------------------------------------

def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Pack int8 codes in [-8, 7] two per byte, deinterleaved per 64-block.

    ``codes`` has shape ``(..., L)`` with ``L`` a multiple of 64; returns
    int8 of shape ``(..., L // 2)`` with byte ``32*b + j`` equal to
    ``16*codes[64*b + j + 32] + (codes[64*b + j] + 8)``.
    """
    *lead, L = codes.shape
    if L % BLOCK:
        raise ValueError(f"length {L} not a multiple of {BLOCK}")
    c = codes.to(torch.int8).reshape(*lead, L // BLOCK, BLOCK)
    lo = c[..., : BLOCK // 2]
    hi = c[..., BLOCK // 2:]
    packed = ((lo + 8) & 0x0F) | (hi << 4)
    return packed.reshape(*lead, L // 2)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`: int8 ``(..., K)`` -> ``(..., 2K)``."""
    *lead, K = packed.shape
    if packed.dtype != torch.int8 or K % (BLOCK // 2):
        raise ValueError(f"expected int8 (..., 32*j) codes, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    p = packed.reshape(*lead, K // (BLOCK // 2), BLOCK // 2)
    hi = p >> 4                       # arithmetic on int8: sign-extends
    lo = (p & 0x0F) - 8
    return torch.cat([lo, hi], dim=-1).reshape(*lead, 2 * K)


# ---------------------------------------------------------------------------
# Vectors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QVec4:
    """Block-scaled 4-bit vector."""
    codes: torch.Tensor    # int8[length_pad // 2], packed nibbles
    scales: torch.Tensor   # f32[length_pad // 64]
    length: int            # logical length

    bits = 4

    @property
    def length_pad(self) -> int:
        return self.codes.shape[-1] * PACK

    @property
    def blocks(self) -> int:
        return self.scales.shape[-1]

    @property
    def nbytes(self) -> int:
        """Bytes touched when streaming this vector (codes + scales)."""
        return self.codes.numel() + self.scales.numel() * 4


@dataclasses.dataclass(frozen=True)
class QVec8:
    """Block-scaled 8-bit vector."""
    codes: torch.Tensor    # int8[length_pad]
    scales: torch.Tensor   # f32[length_pad // 64]
    length: int

    bits = 8

    @property
    def length_pad(self) -> int:
        return self.codes.shape[-1]

    @property
    def blocks(self) -> int:
        return self.scales.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.codes.numel() + self.scales.numel() * 4


@dataclasses.dataclass(frozen=True)
class QVec16:
    """IEEE fp16 vector, no scales."""
    values: torch.Tensor   # f16[length_pad]
    length: int

    bits = 16

    @property
    def length_pad(self) -> int:
        return self.values.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.values.numel() * 2


@dataclasses.dataclass(frozen=True)
class QVec32:
    """fp32 vector."""
    values: torch.Tensor   # f32[length_pad]
    length: int

    bits = 32

    @property
    def length_pad(self) -> int:
        return self.values.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.values.numel() * 4


# ---------------------------------------------------------------------------
# Matrices
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QMat4:
    """Block-scaled 4-bit matrix, one fp32 scale per 64x64 tile.  Codes are
    row-major with each row nibble-packed per 64-column block."""
    codes: torch.Tensor    # int8[rows_pad, cols_pad // 2]
    scales: torch.Tensor   # f32[rows_pad // 64, cols_pad // 64]
    rows: int
    cols: int

    bits = 4

    @property
    def rows_pad(self) -> int:
        return self.codes.shape[-2]

    @property
    def cols_pad(self) -> int:
        return self.codes.shape[-1] * PACK

    @property
    def nbytes(self) -> int:
        return self.codes.numel() + self.scales.numel() * 4


@dataclasses.dataclass(frozen=True)
class QMat8:
    """Block-scaled 8-bit matrix."""
    codes: torch.Tensor    # int8[rows_pad, cols_pad]
    scales: torch.Tensor   # f32[rows_pad // 64, cols_pad // 64]
    rows: int
    cols: int

    bits = 8

    @property
    def rows_pad(self) -> int:
        return self.codes.shape[-2]

    @property
    def cols_pad(self) -> int:
        return self.codes.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.codes.numel() + self.scales.numel() * 4


@dataclasses.dataclass(frozen=True)
class QMat16:
    """fp16 matrix."""
    values: torch.Tensor   # f16[rows_pad, cols_pad]
    rows: int
    cols: int

    bits = 16

    @property
    def rows_pad(self) -> int:
        return self.values.shape[-2]

    @property
    def cols_pad(self) -> int:
        return self.values.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.values.numel() * 2


@dataclasses.dataclass(frozen=True)
class QMat32:
    """fp32 matrix."""
    values: torch.Tensor   # f32[rows_pad, cols_pad]
    rows: int
    cols: int

    bits = 32

    @property
    def rows_pad(self) -> int:
        return self.values.shape[-2]

    @property
    def cols_pad(self) -> int:
        return self.values.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.values.numel() * 4


VECTOR_TYPES = {4: QVec4, 8: QVec8, 16: QVec16, 32: QVec32}
MATRIX_TYPES = {4: QMat4, 8: QMat8, 16: QMat16, 32: QMat32}


def to_device(q, device):
    """Copy of container ``q`` with every tensor moved to ``device``."""
    return dataclasses.replace(q, **{
        f.name: getattr(q, f.name).to(device)
        for f in dataclasses.fields(q)
        if isinstance(getattr(q, f.name), torch.Tensor)})


def stack_vectors(vecs):
    """Stack vector containers of one type and length into one container
    whose tensors carry a leading batch dim: codes ``(B, w)``, scales
    ``(B, nb)`` (the counterpart of ``jax.tree.map(jnp.stack, ...)``)."""
    first = vecs[0]
    for v in vecs[1:]:
        if type(v) is not type(first) or v.length != first.length:
            raise TypeError(f"cannot stack {type(v).__name__}({v.length}) "
                            f"with {type(first).__name__}({first.length})")
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(v, f.name) for v in vecs])
        for f in dataclasses.fields(first)
        if isinstance(getattr(first, f.name), torch.Tensor)})


def vector_at(q, j: int):
    """Vector ``j`` of a stacked container, as views of its rows."""
    return dataclasses.replace(q, **{
        f.name: getattr(q, f.name)[j]
        for f in dataclasses.fields(q)
        if isinstance(getattr(q, f.name), torch.Tensor)})


# ---------------------------------------------------------------------------
# Construction helpers
# ---------------------------------------------------------------------------

def pad_vector(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last dim of an fp tensor to a multiple of PAD."""
    n = x.shape[-1]
    return F.pad(x, (0, pad_to(n) - n)) if pad_to(n) != n else x


def pad_matrix(a: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last two dims to multiples of PAD."""
    m, n = a.shape[-2:]
    mp, np_ = pad_to(m), pad_to(n)
    if (mp, np_) == (m, n):
        return a
    return F.pad(a, (0, np_ - n, 0, mp - m))


def zeros_vector(bits: int, length: int, device=None):
    """All-zero quantized vector with the pad invariant (scales 1.0)."""
    npad = pad_to(length)
    if bits == 4:
        # the zero CODE packs to byte 0x08 (biased low nibble)
        return QVec4(codes=torch.full((npad // 2,), 0x08, dtype=torch.int8,
                                      device=device),
                     scales=torch.ones(npad // BLOCK, device=device),
                     length=length)
    if bits == 8:
        return QVec8(codes=torch.zeros(npad, dtype=torch.int8, device=device),
                     scales=torch.ones(npad // BLOCK, device=device),
                     length=length)
    if bits == 16:
        return QVec16(values=torch.zeros(npad, dtype=torch.float16,
                                         device=device), length=length)
    if bits == 32:
        return QVec32(values=torch.zeros(npad, device=device), length=length)
    raise ValueError(f"unsupported bits={bits}")
