"""clover_tpu_torch: block-scaled quantized linear algebra on PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of ``clover_tpu`` (JAX/Pallas), which stays the reference: the
containers are byte-compatible with it, deterministic quantize, transpose
and threshold agree with it bit for bit, and MVM/AXPY within one output
LSB.  CUDA tensors run the kernels in ``csrc/`` (built with nvcc on first
use); CPU tensors run each kernel's plain torch version.  Importing this
package imports neither jax nor clover_tpu, and builds nothing.
"""

from .formats import (
    BLOCK, PAD, QMat4, QMat8, QMat16, QMat32, QVec4, QVec8, QVec16, QVec32,
    pack_nibbles, pad_to, stack_vectors, to_device, unpack_nibbles,
    vector_at, zeros_vector,
)
from .models import (
    BatchSolveResult, SolveResult, gd, gd_batched, iht, iht_batched,
    make_gd_problem, make_iht_problem,
)
from .ops import (
    dot, mat_get, mvm_sparse, random_floats, random_integers, vec_gather,
    vec_get, vec_get_code, vec_set_code,
)
from .ops.axpy import scale_and_add
from .ops.gemm import gemm_f32, mvm_batched, mvm_batched_f32
from .ops.mvm import mvm, mvm_axpy, mvm_f32
from .ops.quantize import (
    quantize, quantize_mat, quantize_vec, restore, restore_mat, restore_vec,
)
from .ops.threshold import threshold
from .ops.transpose import transpose

__version__ = "0.1.0"

__all__ = [
    "BLOCK", "PAD",
    "QVec4", "QVec8", "QVec16", "QVec32",
    "QMat4", "QMat8", "QMat16", "QMat32",
    "pack_nibbles", "unpack_nibbles", "pad_to", "zeros_vector", "to_device",
    "stack_vectors", "vector_at",
    "quantize", "quantize_vec", "quantize_mat",
    "restore", "restore_vec", "restore_mat",
    "dot", "scale_and_add", "mvm", "mvm_axpy", "mvm_f32", "threshold",
    "transpose", "mvm_sparse", "mvm_batched", "mvm_batched_f32", "gemm_f32",
    "vec_get", "vec_get_code", "vec_set_code", "mat_get", "vec_gather",
    "random_floats", "random_integers",
    "iht", "gd", "SolveResult", "make_iht_problem", "make_gd_problem",
    "iht_batched", "gd_batched", "BatchSolveResult",
]
