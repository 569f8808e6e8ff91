"""Containers to and from NumPy, so state crosses between packages.

``to_numpy`` reads any container with the field names of
:mod:`clover_tpu_torch.formats` -- this package's or ``clover_tpu``'s, whose
leaves ``np.asarray`` accepts -- and ``from_numpy`` builds this package's
container from the same bytes::

    kind, codes, scales, meta = to_numpy(q)
    q2 = from_numpy(kind, codes, scales, **meta)

For 16- and 32-bit containers ``codes`` carries the values and ``scales``
is None.
"""

from __future__ import annotations

import numpy as np
import torch

from . import formats

_KINDS = {cls.__name__: cls for cls in (
    *formats.VECTOR_TYPES.values(), *formats.MATRIX_TYPES.values())}


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def to_numpy(q) -> tuple[str, np.ndarray, np.ndarray | None, dict]:
    """-> (kind, codes or values, scales or None, meta)."""
    kind = type(q).__name__
    if kind not in _KINDS:
        raise TypeError(f"not a quantized container: {kind}")
    meta = ({"length": int(q.length)} if kind.startswith("QVec")
            else {"rows": int(q.rows), "cols": int(q.cols)})
    if hasattr(q, "codes"):
        return kind, _host(q.codes), _host(q.scales), meta
    return kind, _host(q.values), None, meta


def from_numpy(kind: str, codes, scales=None, *, device=None, **meta):
    """Build the ``kind`` container of this package from NumPy arrays."""
    cls = _KINDS[kind]
    if cls.bits in (16, 32):
        dtype = torch.float16 if cls.bits == 16 else torch.float32
        values = torch.as_tensor(np.array(codes), dtype=dtype, device=device)
        return cls(values=values, **meta)
    return cls(codes=torch.as_tensor(np.array(codes), dtype=torch.int8,
                                     device=device),
               scales=torch.as_tensor(np.array(scales), dtype=torch.float32,
                                      device=device),
               **meta)
