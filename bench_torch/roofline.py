"""The yardstick of the roofline shares: each operation's bytes, computed from
its shapes, and the card's published memory rate.

A byte count is what the operation needs, each input read once and each
output written once, whatever the kernels that implement it read again or
keep between them: a later kernel, fused or split, reads against the same
count.  Every operand here is memory-bound (integer block dots and
requantization, no tensor-core-sized arithmetic), so a share is
``bytes / rate`` over the measured device time.

Container sizes follow the quantized formats: 4-bit codes two to a byte,
one f32 scale per 64-element block of a vector or 64x64 tile of a matrix,
sides padded to multiples of 128.
"""

from __future__ import annotations

# Memory bytes/s by device name, NVIDIA data sheets (SXM parts at their full
# power limit); the first key found in the name wins.
HBM_RATE = (("H100 PCIe", 2.0e12), ("H100", 3.35e12), ("H200", 4.8e12))


def memory_rate(device_name: str) -> float | None:
    """The data sheet's memory rate for a card's name, or None."""
    return next((rate for key, rate in HBM_RATE if key in device_name), None)


def padded(n: int) -> int:
    return -(-n // 128) * 128


def vec_bytes(n: int, bits: int) -> int:
    """A quantized vector of length n: codes and per-64-block scales."""
    n = padded(n)
    return n * bits // 8 + n // 64 * 4


def mat_bytes(m: int, n: int, bits: int) -> int:
    """A quantized m x n matrix: codes and per-64x64-tile scales."""
    m, n = padded(m), padded(n)
    return m * n * bits // 8 + (m // 64) * (n // 64) * 4


def f32_mat_bytes(m: int, n: int) -> int:
    return padded(m) * padded(n) * 4


def solve_setup_bytes(m: int, n: int, bits: int,
                      vector_bits: int | None = None) -> int:
    """A solve's set-up: the f32 Phi and y read once, the quantized Phi,
    PhiT (at ``bits``) and y (at ``vector_bits``, default ``bits``)
    written once."""
    vector_bits = bits if vector_bits is None else vector_bits
    return (f32_mat_bytes(m, n) + 2 * mat_bytes(m, n, bits)
            + padded(m) * 4 + vec_bytes(m, vector_bits))


def iteration_bytes(m: int, n: int, bits: int,
                    vector_bits: int | None = None) -> int:
    """One IHT iteration: Phi and PhiT (at ``bits``) read once, y and x
    (at ``vector_bits``, default ``bits``) read, x written."""
    vector_bits = bits if vector_bits is None else vector_bits
    return (2 * mat_bytes(m, n, bits) + vec_bytes(m, vector_bits)
            + 2 * vec_bytes(n, vector_bits))


def mvm_batch_bytes(m: int, n: int, bits: int, vectors: int) -> int:
    """One batch of a served MVM: the matrix read once, each vector read and
    its result written."""
    return (mat_bytes(m, n, bits)
            + vectors * (vec_bytes(n, bits) + vec_bytes(m, bits)))


def share_pct(nbytes: float, seconds: float, rate: float | None):
    """Percent of the memory roofline, or None where nothing was timed or
    the card's rate is unknown."""
    if not rate or seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / rate / seconds
