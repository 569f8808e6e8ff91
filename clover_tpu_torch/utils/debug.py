"""Pretty-printers and side-by-side diff for debugging quantized data
(counterpart of clover_tpu/utils/debug.py).

Re-creates the capability of the reference's lib/simd_debug.cpp:10-94
(register printers + the string ``compare`` of every validation failure
dump) and the containers' ``toString`` methods (e.g.
CloverVector4.h:229-254), for arrays and tensors instead of AVX registers.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def format_blocks(x, per_row: int = 8, max_rows: int = 16) -> str:
    """Format a 1-D array in rows of ``per_row`` indexed values."""
    x = _host(x).ravel()
    lines = []
    for r in range(0, min(len(x), per_row * max_rows), per_row):
        vals = " ".join(f"{v:>12.6f}" if np.issubdtype(x.dtype, np.floating)
                        else f"{v:>6d}" for v in x[r:r + per_row])
        lines.append(f"[{r:6d}] {vals}")
    if len(x) > per_row * max_rows:
        lines.append(f"... ({len(x)} total)")
    return "\n".join(lines)


def format_qvec(q, max_elems: int = 64) -> str:
    """Dump a quantized vector: index | code | scale | value
    (the toString layout of CloverVector4.h:229-254)."""
    from ..formats import QVec16, QVec32, unpack_nibbles
    from ..ops.quantize import restore
    vals = _host(restore(q).values)
    lines = [f"{type(q).__name__}(length={q.length})"]
    if isinstance(q, (QVec16, QVec32)):
        for i in range(min(q.length, max_elems)):
            lines.append(f"[{i:6d}] {vals[i]:>14.7f}")
        return "\n".join(lines)
    codes = _host(unpack_nibbles(q.codes) if q.bits == 4 else q.codes)
    scales = _host(q.scales)
    for i in range(min(q.length, max_elems)):
        lines.append(f"[{i:6d}] code {codes[i]:>4d}  "
                     f"scale {scales[i // 64]:>12.6f}  "
                     f"value {vals[i]:>14.7f}")
    return "\n".join(lines)


def compare(a, b, max_rows: int = 32) -> str:
    """Side-by-side dump of two arrays with a mismatch marker per line
    (lib/simd_debug.cpp:83-94 semantics)."""
    a = _host(a).ravel()
    b = _host(b).ravel()
    n = max(len(a), len(b))
    lines = [f"{'idx':>8} | {'got':>16} | {'expected':>16} |"]
    shown = 0
    for i in range(n):
        av = a[i] if i < len(a) else "---"
        bv = b[i] if i < len(b) else "---"
        neq = (i >= len(a) or i >= len(b)
               or (av != bv and not (av != av and bv != bv)))
        if shown < max_rows or neq:
            mark = "  <-- mismatch" if neq else ""
            lines.append(f"{i:>8} | {av!s:>16} | {bv!s:>16} |{mark}")
            shown += 1
        if shown >= max_rows and neq:
            lines.append(f"... (first mismatch shown; {n} rows)")
            break
    return "\n".join(lines)
