"""The plain reference that decides ``correct``: block-scaled quantized IHT
and MVM in plain PyTorch, written from the semantics alone.

It imports nothing of the program.  Every quantized operand is held as its
restored f32 values, code * s / qmax, with s the absmax of its 64-element
block (vectors) or 64x64 tile (matrices), an all-zero block taking s = 1:

    quantize   code = sign(v) * min(floor(|v| * (qmax / s) + u), qmax)
               u ~ U[0, 1) for stochastic rounding, 0 for truncation;
               restored, code * (s / qmax); each quotient an IEEE
               division, formed before the product
    mvm        y = requant(A @ x) per 64-row band, truncating
    mvm_axpy   r = requant(u + alpha * mvm(A, x)), truncating
    threshold  keep the K largest |v|, ties to the lower index
    iht        t2 = mvm_axpy(Phi, x, y, -1); x = mvm_axpy(PhiT, t2, x, mu);
               x = threshold(x, K); x starts at 0

``bits`` sets qmax = 2^(bits-1) - 1: 7 at 4 bits, 127 at 8, 3 at 3.  In
``iht`` the matrix holds its own precision, quantized before the call,
and y, t2 and x hold ``vector_bits``.  Products run in IEEE fp32 (TF32
off).  Lengths are multiples of 64; the harness's shapes are.
"""

from __future__ import annotations

import contextlib

import torch

BLOCK = 64


def qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


@contextlib.contextmanager
def ieee_fp32():
    """fp32 matrix products in IEEE fp32 inside the block, whatever the
    caller's TF32 setting."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _div(num, den) -> torch.Tensor:
    """IEEE ``num / den`` elementwise, a float operand filled to the
    tensor's shape: torch forms ``float / tensor`` as a reciprocal times
    the float, and on CUDA ``tensor / float`` as a product with the
    reciprocal, either of which can miss the quotient by one ulp and move
    an absmax element's code down by one."""
    if not isinstance(num, torch.Tensor):
        num = torch.full_like(den, num)
    if not isinstance(den, torch.Tensor):
        den = torch.full_like(num, den)
    return torch.div(num, den)


def _codes(v: torch.Tensor, s: torch.Tensor, bits: int, generator):
    """Signed codes of ``v`` against the broadcastable scales ``s``."""
    mag = v.abs() * _div(qmax(bits), s)
    if generator is not None:
        mag += torch.rand(v.shape, generator=generator, device=v.device)
    mag = mag.floor_().clamp_max_(qmax(bits))
    return mag.mul_(torch.sign(v))


def _scales(absmax: torch.Tensor) -> torch.Tensor:
    return torch.where(absmax == 0, torch.ones_like(absmax), absmax)


def quant_vec(v: torch.Tensor, bits: int, generator=None) -> torch.Tensor:
    """Restored values of ``v`` (..., L) quantized per 64-block of its last
    dim."""
    b = v.reshape(*v.shape[:-1], -1, BLOCK)
    s = _scales(b.abs().amax(dim=-1, keepdim=True))
    return (_codes(b, s, bits, generator)
            * _div(s, qmax(bits))).reshape(v.shape)


def quant_mat(a: torch.Tensor, bits: int, generator=None) -> torch.Tensor:
    """Restored values of ``a`` (m, n) quantized per 64x64 tile."""
    m, n = a.shape
    t = a.reshape(m // BLOCK, BLOCK, n // BLOCK, BLOCK)
    s = _scales(t.abs().amax(dim=(1, 3), keepdim=True))
    return (_codes(t, s, bits, generator)
            * _div(s, qmax(bits))).reshape(m, n)


def mvm(a: torch.Tensor, x: torch.Tensor, bits: int) -> torch.Tensor:
    """requant(a @ x), truncating; ``x`` (n,) or (n, B)."""
    with ieee_fp32():
        y = a @ x
    return quant_vec(y, bits) if y.ndim == 1 else quant_vec(y.mT, bits).mT


def mvm_axpy(a, x, u, alpha: float, bits: int) -> torch.Tensor:
    return quant_vec(u + alpha * mvm(a, x, bits), bits)


def threshold(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` with all but its K largest |values| zeroed; ties keep the lower
    index (a stable sort of the magnitudes, descending)."""
    order = torch.sort(x.abs(), descending=True, stable=True).indices
    out = torch.zeros_like(x)
    out[order[:k]] = x[order[:k]]
    return out


def iht(phi_q, y_q, iterations: int, k: int, mu: float, vector_bits: int):
    """The deterministic IHT iterations on quantized operands (restored
    values), t2 and x requantized at ``vector_bits``; -> x, restored."""
    x = torch.zeros(phi_q.shape[1], device=phi_q.device)
    for _ in range(iterations):
        t2 = mvm_axpy(phi_q, x, y_q, -1.0, vector_bits)
        x = threshold(mvm_axpy(phi_q.T, t2, x, mu, vector_bits), k)
    return x


def restore4(codes: torch.Tensor, scales: torch.Tensor, length: int):
    """The values of a 4-bit vector container read back as bytes: byte
    32b + j holds element 64b + j in its low nibble, biased by 8, and
    element 64b + j + 32 in its high nibble, two's complement; one f32
    scale per 64-element block; the first ``length`` values."""
    p = codes.to(torch.int16).reshape(-1, BLOCK // 2)
    low = (p & 0x0F) - 8
    high = torch.where(p < 0, p + 256, p) >> 4
    high = torch.where(high > 7, high - 16, high)
    c = torch.cat([low, high], dim=1).to(torch.float32)
    return (c * _div(scales.reshape(-1, 1), qmax(4))).reshape(-1)[:length]


def rel_error(x: torch.Tensor, want: torch.Tensor) -> float:
    """||x - want|| / ||want|| in f64."""
    x, want = x.double(), want.double()
    return float(torch.linalg.norm(x - want) / torch.linalg.norm(want))
