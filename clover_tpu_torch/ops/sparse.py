"""Sparse-vector MVM (counterpart of clover_tpu/ops/sparse.py): the
reference's IHT-specific ``dense_matrix_transpose_times_sparse_vector``.
When x is K-sparse (as after IHT's hard threshold), y = Phi x is the sum of
x_j * PhiT[j, :] over the K nonzero j, rows of the materialized transpose.

``torch.topk`` picks the K entries, the K rows of AT are gathered and
dequantized (``code * (s/qmax)``, the restore's op order), and one f32
``vals @ rows`` product gives y: O(K n) bytes instead of O(m n).  The
product is a plain matmul, as clover_tpu leaves it to XLA, pinned to IEEE
fp32 (``_core.ieee_fp32``, clover_tpu's ``Precision.HIGHEST``) whatever the
caller's TF32 setting.
"""

from __future__ import annotations

import torch

from ..formats import BLOCK, QMat4, QMat8, QVec4, QVec8, QVec16, QVec32
from ..formats import unpack_nibbles
from . import _core
from .mvm import _requant_output
from .quantize import restore_vec


def _nonzeros(x, k: int):
    """Indices and f32 values of the K largest-|value| entries of x (IHT
    guarantees at most K nonzeros; ties resolved by topk)."""
    vals = restore_vec(x).values
    mag = vals.abs()
    if x.length < mag.shape[-1]:
        keep = torch.arange(mag.shape[-1], device=mag.device) < x.length
        mag = torch.where(keep, mag, -1.0)
    idx = torch.topk(mag, k).indices
    return idx, vals[idx]


def mvm_sparse(AT, x, k: int, generator=None):
    """y = A @ x with x K-sparse, from the materialized transpose AT (rows
    of AT are columns of A), requantized to the standard output
    precision.  Matches ``mvm(A, x)`` up to the f32 summation order."""
    idx, vals = _nonzeros(x, k)
    if isinstance(AT, (QMat4, QMat8)):
        codes = AT.codes[idx]                               # (K, m_pad/pack)
        if isinstance(AT, QMat4):
            codes = unpack_nibbles(codes)
        mult = _core.div(AT.scales[idx // BLOCK], _core.qmax(AT.bits))
        rows = codes.to(torch.float32) * mult.repeat_interleave(BLOCK, dim=1)
    else:
        rows = AT.values[idx].to(torch.float32)
    with _core.ieee_fp32():
        y32 = vals @ rows
    return _requant_output(y32, AT.cols, _out_bits_sparse(AT, x), generator)


def _out_bits_sparse(AT, x) -> int:
    # the table of mvm's output precisions, with A = transpose(AT)
    if isinstance(x, QVec32):
        return 32
    if isinstance(AT, QMat4) and isinstance(x, QVec4):
        return 4
    if isinstance(AT, (QMat4, QMat8)) and isinstance(x, QVec8):
        return 8
    if isinstance(x, QVec16):
        return 16
    return 32
