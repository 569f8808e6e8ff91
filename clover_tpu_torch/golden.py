"""Golden reference implementations (the validation oracle): the port's
copy of clover_tpu/golden.py, which imports jax for one divide.

Pure NumPy, float32-faithful re-statements of the reference's ``_scalar``
kernels (reference: include/CloverVector4.h:452-603,
include/CloverMatrix4.h:311-434, include/CloverVector8.h:205-392).  These
are deliberately independent of the production torch/CUDA paths: tests
compare production output against these, mirroring the reference's
SIMD-vs-scalar validation mode (test/validate/02_vector.cpp:557-641).

Layout-independent: codes are *unpacked* int8 arrays here (one code per
element).  Tests unpack production containers before comparing.

Semantics notes (all cited to the reference):
* scale = block absmax, zero blocks -> 1.0 (CloverVector4.h:661-663; the
  scalar path leaves 0, which NaN-poisons zero blocks — we adopt the SIMD
  path's normalization everywhere).
* quantize: q = floor(|x| * (B/s) + u) * sign(x), u ~ U[0,1), B = 7 or 127
  (CloverVector4.h:499-514).  We additionally clip |q| <= B: the reference
  can overflow to -8 when |x| = s and the noise pushes the sum to 8.0
  (1-ulp fp excess in 7/s * s); with u = 0 no clipping ever triggers, so
  deterministic-mode outputs are bit-identical to the reference.
* restore: x̂ = q * (s / B) (CloverVector4.h:519-553).
* dot: per block, exact integer accumulation of code products, then one
  f32 FMA with (su/7)*(sv/7); blocks accumulated in order
  (CloverVector4.h:555-595).
* fused MVM: 64-row band of blocked dots -> band absmax -> requantize with
  stochastic rounding (CloverMatrix4.h:311-401).
* mixed MVM (4x8, 4x32, 8x32): float64 accumulation of dequantized
  products, then requantize (CloverMatrix4.h:404-434).
* threshold(K): keep the K largest |x̂|; ties broken toward the lower
  index (deterministic re-statement of the reference's heap order,
  CloverVector4.h:1929-1973); scales are NOT updated.
"""

from __future__ import annotations

import numpy as np

BLOCK = 64

f32 = np.float32


def _blocked(x: np.ndarray) -> np.ndarray:
    n = x.shape[-1]
    assert n % BLOCK == 0
    return x.reshape(*x.shape[:-1], n // BLOCK, BLOCK)


def block_scales(x: np.ndarray) -> np.ndarray:
    """Per-64-block absmax scales, zero blocks -> 1.0."""
    s = np.max(np.abs(_blocked(np.asarray(x, f32))), axis=-1)
    return np.where(s == 0, f32(1.0), s).astype(f32)


def tile_scales(a: np.ndarray) -> np.ndarray:
    """Per-64x64-tile absmax scales for a padded matrix."""
    m, n = a.shape
    t = np.abs(np.asarray(a, f32)).reshape(m // BLOCK, BLOCK, n // BLOCK, BLOCK)
    s = t.max(axis=(1, 3))
    return np.where(s == 0, f32(1.0), s).astype(f32)


def _xla_div(num, den) -> np.ndarray:
    """f32 division, IEEE (NumPy).

    clover_tpu's oracle routes the quantization multiplier and the restore
    multiplier through XLA's divide, because XLA's CPU backend with fast
    math on divides through a reciprocal that can miss IEEE by one ulp.
    Its CPU tests run with fast math off, where that divide is IEEE and
    equals this one; the port's kernels and plain versions divide in IEEE
    too.  The name is kept so the two oracles read line by line alike.
    """
    return np.divide(np.asarray(num, np.float32), np.asarray(den, np.float32),
                     dtype=np.float32)


def _sr_quantize(x: np.ndarray, scale_per_elem: np.ndarray, qmax: int,
                 noise: np.ndarray | float) -> np.ndarray:
    """floor(|x| * (qmax/s) + u) * sign(x), clipped to [-qmax, qmax]."""
    x = np.asarray(x, f32)
    mult = _xla_div(qmax, scale_per_elem).astype(f32)
    q_abs = np.floor(np.abs(x) * mult + np.asarray(noise, f32)).astype(np.int32)
    q_abs = np.minimum(q_abs, qmax)
    sign = np.where(np.signbit(x), -1, 1).astype(np.int32)
    return (q_abs * sign).astype(np.int8)


# ---------------------------------------------------------------------------
# Vector quantize / restore
# ---------------------------------------------------------------------------

def quantize_vec(x: np.ndarray, bits: int, noise=0.0):
    """-> (codes int8[n], scales f32[n//64]).  bits in {4, 8}."""
    qmax = 7 if bits == 4 else 127
    s = block_scales(x)
    per_elem = np.repeat(s, BLOCK)
    codes = _sr_quantize(x, per_elem, qmax, noise)
    return codes, s


def restore_vec(codes: np.ndarray, scales: np.ndarray, bits: int) -> np.ndarray:
    if bits == 16:
        return codes.astype(f32)
    if bits == 32:
        return codes.astype(f32)
    qmax = 7.0 if bits == 4 else 127.0
    # s/qmax divided first, through _xla_div, as in clover_tpu's oracle.
    per_elem = np.repeat(_xla_div(scales, qmax).astype(f32), BLOCK)
    return (codes.astype(f32) * per_elem).astype(f32)


def quantize_mat(a: np.ndarray, bits: int, noise=0.0):
    """-> (codes int8[m,n], scales f32[m//64, n//64])."""
    qmax = 7 if bits == 4 else 127
    s = tile_scales(a)
    per_elem = np.kron(s, np.ones((BLOCK, BLOCK), f32)).astype(f32)
    codes = _sr_quantize(a, per_elem, qmax, noise)
    return codes, s


def restore_mat(codes: np.ndarray, scales: np.ndarray, bits: int) -> np.ndarray:
    qmax = 7.0 if bits == 4 else 127.0
    per_elem = np.kron(_xla_div(scales, qmax).astype(f32),
                       np.ones((BLOCK, BLOCK), f32)).astype(f32)
    return (codes.astype(f32) * per_elem).astype(f32)


# ---------------------------------------------------------------------------
# Dot product (exact int block accumulation, ordered f32 combine)
# ---------------------------------------------------------------------------

def dot(u_codes, u_scales, v_codes, v_scales, bits: int) -> np.float32:
    qmax = f32(7.0) if bits == 4 else f32(127.0)
    ub = _blocked(u_codes.astype(np.int64))
    vb = _blocked(v_codes.astype(np.int64))
    acc = (ub * vb).sum(axis=-1)                       # exact integer
    combined = ((u_scales / qmax) * (v_scales / qmax)).astype(f32)
    result = f32(0.0)
    for b in range(acc.shape[-1]):                     # ordered f32 combine
        result = f32(result + combined[b] * f32(acc[b]))
    return result


# ---------------------------------------------------------------------------
# scaleAndAdd: r = quantize_blockwise(restore(u) + a * restore(v))
# (reference: CloverVector4.h:336-430)
# ---------------------------------------------------------------------------

def scale_and_add(u_codes, u_scales, v_codes, v_scales, a, bits: int,
                  noise=0.0):
    x = restore_vec(u_codes, u_scales, bits) + \
        f32(a) * restore_vec(v_codes, v_scales, bits)
    x = x.astype(f32)
    return quantize_vec(x, bits, noise)


# ---------------------------------------------------------------------------
# Fused MVM with output requantization (reference: CloverMatrix4.h:311-401)
# ---------------------------------------------------------------------------

def mvm_f32_exact(a_codes, a_scales, x_codes, x_scales, bits: int) -> np.ndarray:
    """The f32 band values BEFORE requantization: per-row blocked int dot
    with per-tile combined scales, blocks combined in order."""
    qmax = f32(7.0) if bits == 4 else f32(127.0)
    m, n = a_codes.shape
    nb = n // BLOCK
    a3 = a_codes.astype(np.int64).reshape(m, nb, BLOCK)
    x2 = x_codes.astype(np.int64).reshape(nb, BLOCK)
    acc = np.einsum("ibk,bk->ib", a3, x2)              # exact integer
    comb = ((np.repeat(a_scales, BLOCK, axis=0) / qmax) *
            (x_scales[None, :] / qmax)).astype(f32)    # (m, nb)
    y = np.zeros(m, f32)
    for b in range(nb):
        y = (y + comb[:, b] * acc[:, b].astype(f32)).astype(f32)
    return y


def mvm(a_codes, a_scales, x_codes, x_scales, bits: int, noise=0.0):
    """Pure same-precision fused MVM -> (codes, scales) of the output."""
    y32 = mvm_f32_exact(a_codes, a_scales, x_codes, x_scales, bits)
    return quantize_vec(y32, bits, noise)


def mvm_mixed(a_codes, a_scales, a_bits, x_restored: np.ndarray):
    """Mixed-precision MVM: f64 accumulation over dequantized products
    (reference: CloverMatrix4.h:404-434).  Returns the f32 result vector;
    caller quantizes to the output precision."""
    a = restore_mat(a_codes, a_scales, a_bits).astype(np.float64)
    return (a @ x_restored.astype(np.float64)).astype(f32)


# ---------------------------------------------------------------------------
# Hard thresholding (top-K by |value|, scales untouched)
# ---------------------------------------------------------------------------

def threshold(codes: np.ndarray, scales: np.ndarray, k: int, length: int,
              bits: int):
    """Zero all but the K largest-|value| codes among the first ``length``
    elements.  Ties break toward the lower index.  Returns new codes."""
    vals = np.abs(restore_vec(codes, scales, bits))[:length]
    # stable sort: descending |value|, ascending index on ties
    order = np.lexsort((np.arange(length), -vals))
    keep = order[:k]
    out = np.zeros_like(codes)
    out[keep] = codes[keep]
    return out


def threshold_f32(values: np.ndarray, k: int, length: int) -> np.ndarray:
    vals = np.abs(values[:length])
    order = np.lexsort((np.arange(length), -vals))
    keep = order[:k]
    out = np.zeros_like(values)
    out[keep] = values[keep]
    return out
