"""Quantized linear-algebra ops on torch tensors (counterparts of
clover_tpu/ops).

This package exports the small ops (``dot``, ``mvm_sparse`` and the access
functions, as clover_tpu.ops does); the others are re-exported by the
package root, so ``ops.quantize``, ``ops.mvm``, ``ops.threshold`` and
``ops.transpose`` stay the modules.  ``_core`` is imported first: the
kernels' plain versions use it, and the ops below import the kernels.
"""

from . import _core  # noqa: F401  (first: see above)
from .access import (
    mat_get, random_floats, random_integers, vec_gather, vec_get,
    vec_get_code, vec_set_code,
)
from .dot import dot
from .sparse import mvm_sparse

__all__ = [
    "dot", "mvm_sparse",
    "vec_get", "vec_get_code", "vec_set_code", "mat_get", "vec_gather",
    "random_floats", "random_integers",
]
