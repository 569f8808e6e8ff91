"""Element access for quantized containers and the random-data generators
(counterpart of clover_tpu/ops/access.py): the reference's
get/set/getBits/setBits and setRandomInteger/setRandomFloats.

Host and debug utilities: element reads return Python numbers, and
:func:`vec_set_code` returns a new container (clover_tpu's ``.at[].set``).
Bulk paths use quantize/restore.  Dequantized values divide the scale by
qmax first (IEEE), then multiply, as restore does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import BLOCK, QMat8, QMat16, QMat32, QVec4, QVec8, QVec16, QVec32
from . import _core

HALF = BLOCK // 2


def _nib_pos(i: int):
    """element index -> (byte index, is_hi) in the deinterleaved layout."""
    b, j = i // BLOCK, i % BLOCK
    return b * HALF + (j % HALF), j >= HALF


def _code(p: int, is_hi: bool) -> int:
    return (p >> 4) if is_hi else ((p & 15) - 8)


def vec_get_code(q, i: int) -> int:
    """The stored integer code of element i (the reference's getBits)."""
    if isinstance(q, QVec8):
        return int(q.codes[i])
    if not isinstance(q, QVec4):
        raise TypeError(f"expected QVec4 or QVec8, got {type(q).__name__}")
    byte, is_hi = _nib_pos(i)
    return _code(int(q.codes[byte]), is_hi)


def vec_get(q, i: int) -> float:
    """Dequantized value of element i (the reference's get)."""
    if isinstance(q, (QVec16, QVec32)):
        return float(q.values[i])
    mult = _core.div(q.scales[i // BLOCK], _core.qmax(q.bits))
    return float(vec_get_code(q, i) * mult)


def vec_set_code(q, i: int, code: int):
    """A copy of q with the stored code of element i set (setBits)."""
    codes = q.codes.clone()
    if isinstance(q, QVec8):
        codes[i] = code
        return QVec8(codes=codes, scales=q.scales, length=q.length)
    if not isinstance(q, QVec4):
        raise TypeError(f"expected QVec4 or QVec8, got {type(q).__name__}")
    byte, is_hi = _nib_pos(i)
    p = int(codes[byte])
    p = ((p & 0x0F) | ((code & 15) << 4) if is_hi
         else (p & ~0x0F) | ((code + 8) & 15))
    codes[byte] = (p + 128) % 256 - 128            # back to int8
    return QVec4(codes=codes, scales=q.scales, length=q.length)


def mat_get(q, i: int, j: int) -> float:
    if isinstance(q, (QMat16, QMat32)):
        return float(q.values[i, j])
    mult = _core.div(q.scales[i // BLOCK, j // BLOCK], _core.qmax(q.bits))
    if isinstance(q, QMat8):
        return float(int(q.codes[i, j]) * mult)
    byte, is_hi = _nib_pos(j)
    return float(_code(int(q.codes[i, byte]), is_hi) * mult)


def vec_gather(q, idx: torch.Tensor) -> torch.Tensor:
    """Dequantized values at ``idx`` (an int tensor on q's device): the bulk
    form of :func:`vec_get`, one gather."""
    if isinstance(q, (QVec16, QVec32)):
        return q.values[idx].to(torch.float32)
    mult = _core.div(q.scales[idx // BLOCK], _core.qmax(q.bits))
    if isinstance(q, QVec8):
        return q.codes[idx].to(torch.float32) * mult
    b, j = idx // BLOCK, idx % BLOCK
    byte = q.codes[b * HALF + (j % HALF)].to(torch.int32)
    code = torch.where(j >= HALF, byte >> 4, (byte & 15) - 8)
    return code.to(torch.float32) * mult


# ---------------------------------------------------------------------------
# Reproducible random data (the reference's setRandom*, from the xorshift
# stream of rng.py, so NumPy, clover_tpu and the port draw the same data)
# ---------------------------------------------------------------------------

def random_floats(key1: int, key2: int, n: int,
                  device="cuda") -> torch.Tensor:
    """f32[n] in [0, ~1) from the xorshift stream's noise recipe (8 floats
    per 64-bit draw), on ``device`` (default ``cuda``)."""
    from ..rng import np_stream
    draws = -(-n // 8)
    stream = np_stream(key1, key2, draws, lanes=1).ravel()
    out = np.zeros((draws, 8), np.float32)
    for d, w in enumerate(stream):
        halves = [np.uint32(w & 0xFFFFFFFF), np.uint32(w >> np.uint64(32))]
        vals = []
        for h in halves:
            m = np.uint32(h) & np.uint32(0x7F7F7F7F)
            for k in (0, 8, 16, 24):
                vals.append(np.float32(np.int32(np.uint32(m << np.uint32(k))
                                                & 0xFFFFFFFF)) * 2.0 ** -31)
        out[d] = vals
    return torch.tensor(out.ravel()[:n], device=device)


def random_integers(key1: int, key2: int, n: int, r: int,
                    device="cuda") -> torch.Tensor:
    """Integer values in [-r, r] (setRandomInteger semantics) as f32[n]."""
    u = random_floats(key1, key2, n, device=device)
    return torch.floor(u * (2 * r + 1)) - r
