"""Measurement probes (csrc/probes.cu) and their plain torch versions;
never on a solver's path.

Replaces clover_tpu/kernels/probes.py.  ``dma_probe`` streams a packed 4-
or 8-bit matrix through the fused MVM's own CTA layout (csrc/mvm.cu), so
its time is the same-geometry streaming floor that ``-p`` reports beside
the MVM: the MVM's rate as a share of this probe's, measured in the same
run.  ``salted_probe`` is the same stream with a small f32 salt input:
``dma_probe_stream`` runs it over a matrix stacked to at least 512 MB, so
that it streams from device memory and not from the 50 MB L2 (the part the
TPU's VMEM played for the reference), and ``launch_probe`` runs it over one
tile, which measures the fixed cost of a launch.

A departure from the reference: its TPU kernels touched one 8x128 corner
of each tile while the tile's DMA moved it whole.  On the GPU a load whose
value feeds nothing is deleted by the compiler, so these kernels sum every
byte: per 64-row band they write ``salt + float(int32 sum of the band's
code bytes)``.  That is exact in any order (the int32 sum wraps mod 2^32
alike), so kernel and plain version agree bit for bit.

``make(iters)`` keeps the reference's contract: a zero-argument callable
that runs ``iters`` launches and returns a finite float, which waits for
them.
"""

from __future__ import annotations

import torch

from . import _build
from .dispatch import on_cuda

RING_BYTES = 512 << 20        # the stacked stream's least size


def _band_sums(codes: torch.Tensor) -> torch.Tensor:
    """f32 per 64-row band: the int32 sum of its code bytes, wrapped mod
    2^32 as the kernel's int32 adds wrap."""
    s = codes.reshape(codes.shape[0] // 64, -1).sum(dim=1, dtype=torch.int64)
    s = (s + (1 << 31)) % (1 << 32) - (1 << 31)
    return s.to(torch.int32).to(torch.float32)


def dma_probe_plain(codes: torch.Tensor) -> torch.Tensor:
    return _band_sums(codes)


def salted_probe_plain(codes: torch.Tensor, salt: torch.Tensor
                       ) -> torch.Tensor:
    return salt + _band_sums(codes)


def _check(codes: torch.Tensor) -> tuple[int, int]:
    if codes.dim() != 2:
        raise ValueError(f"codes {tuple(codes.shape)}: expected 2-D")
    rows, wa = codes.shape
    if rows % 64 or wa % 16 or rows == 0:
        raise ValueError(f"codes {tuple(codes.shape)}: rows must be a "
                         f"multiple of 64 and row bytes of 16")
    _build.check(codes, (rows, wa), torch.int8, "codes")
    return rows, wa


def dma_probe_cuda(codes: torch.Tensor) -> torch.Tensor:
    """f32[rows / 64] band sums of int8 codes[rows, wa] on the card."""
    rows, wa = _check(codes)
    out = torch.empty(rows // 64, dtype=torch.float32, device=codes.device)
    _build.launch("clover_dma_probe", codes.device, _build.ptr(codes),
                  _build.ptr(out), rows, wa)
    dma_probe_cuda.launches += 1
    return out


def salted_probe_cuda(codes: torch.Tensor, salt: torch.Tensor
                      ) -> torch.Tensor:
    """salt[0] + the band sums of int8 codes[rows, wa] on the card."""
    rows, wa = _check(codes)
    _build.check(salt, (1,), torch.float32, "salt", codes.device)
    out = torch.empty(rows // 64, dtype=torch.float32, device=codes.device)
    _build.launch("clover_salted_probe", codes.device, _build.ptr(codes),
                  _build.ptr(salt), _build.ptr(out), rows, wa)
    salted_probe_cuda.launches += 1
    return out


dma_probe_cuda.launches = 0
salted_probe_cuda.launches = 0


def dma_probe(codes: torch.Tensor) -> torch.Tensor:
    """The kernel on a CUDA tensor, its plain version on a CPU one."""
    return (dma_probe_cuda if on_cuda(codes) else dma_probe_plain)(codes)


def salted_probe(codes: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    fn = salted_probe_cuda if on_cuda(codes, salt) else salted_probe_plain
    return fn(codes, salt)


def _salted_chain(codes: torch.Tensor):
    """make(iters): iters salted launches, each salted by the last one's
    first band, then a wait for the last."""
    def make(iters: int):
        def run() -> float:
            salt = torch.zeros(1, device=codes.device)
            out = salt
            for _ in range(iters):
                out = salted_probe(codes, salt)
                salt = out[:1] * 1e-30
            return float(out[0])
        return run
    return make


def stacked_codes(qA, ring_bytes: int = RING_BYTES):
    """-> (qA's codes stacked p times along the rows, p), with p =
    ceil(ring_bytes / codes bytes), at least 1."""
    p = max(1, -(-ring_bytes // qA.codes.nbytes))
    return qA.codes.repeat(p, 1), p


def dma_probe_stream(qA, ring_bytes: int = RING_BYTES):
    """-> (make, stacked bytes, p): qA's codes stacked to at least
    ring_bytes (:func:`stacked_codes`), streamed by the salted probe in
    one launch.  The time of one slab is a launch's time / p."""
    stacked, p = stacked_codes(qA, ring_bytes)
    return _salted_chain(stacked), stacked.nbytes, p


def launch_probe(device="cuda"):
    """-> make for the smallest salted launch: one CTA over one 64x128
    tile of ones."""
    return _salted_chain(torch.ones(64, 128, dtype=torch.int8,
                                    device=device))


def dma_probe_call(qA):
    """-> (make, bytes streamed per launch): ``make(iters)`` runs iters
    dma probes over qA's codes and waits for the last."""
    codes = qA.codes

    def make(iters: int):
        def run() -> float:
            out = None
            for _ in range(iters):
                out = dma_probe(codes)
            return float(out[0])
        return run
    return make, codes.nbytes
