"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) with their plain
torch versions.

Each ``*_cuda`` wrapper checks its operands, allocates the outputs, launches
on the current stream and adds one to its ``launches`` count.  Each
``*_plain`` function computes the same with torch ops on any device; the ops
take it for CPU tensors only.  Nothing here builds or loads CUDA code at
import time.
"""

from .axpy import axpy_cuda
from .dispatch import SEED_GOLD, SEED_OP, on_cuda, seed_from, wrap_i32
from .dot import dot_cuda, dot_plain, dot_terms
from .iteration import (
    iteration_chain_cuda, iteration_chain_eligible, iteration_chain_plain,
    iteration_cuda, iteration_eligible, iteration_plain,
)
from .mvm import (
    axpy_plain, mvm4_cuda, mvm4_plain, mvm8_cuda, mvm8_plain, mvm_f32_cuda,
    mvm_f32_plain,
)
from .mvm_batched import (
    MAX_BATCH, mvm_batched_cuda, mvm_batched_f32_cuda, mvm_batched_f32_plain,
    mvm_batched_plain,
)
from .probes import (
    dma_probe_cuda, dma_probe_plain, salted_probe_cuda, salted_probe_plain,
)
from .quantize import (
    quantize_mat_cuda, quantize_mat_plain, quantize_vec_cuda,
    quantize_vec_plain,
)
from .restore import (
    restore_mat_cuda, restore_mat_plain, restore_vec_cuda, restore_vec_plain,
)
from .threshold import (
    hist4_cuda, hist4_plain, mask4_cuda, mask4_plain, threshold4_cuda,
    threshold4_plain, threshold8_cuda, threshold8_plain,
)
from .transpose import (
    transpose4_cuda, transpose4_plain, transpose8_cuda, transpose8_plain,
)

# kernel name -> launch wrapper
KERNELS = {
    "quantize_mat": quantize_mat_cuda,
    "quantize_vec": quantize_vec_cuda,
    "transpose4": transpose4_cuda,
    "mvm4": mvm4_cuda,
    "threshold4": threshold4_cuda,
    "restore_vec": restore_vec_cuda,
    "transpose8": transpose8_cuda,
    "mvm8": mvm8_cuda,
    "threshold8": threshold8_cuda,
    "axpy": axpy_cuda,
    "mvm_batched": mvm_batched_cuda,
    "iteration": iteration_cuda,
    "iteration_chain": iteration_chain_cuda,
    "restore_mat": restore_mat_cuda,
    "dot": dot_cuda,
    "hist4": hist4_cuda,
    "mask4": mask4_cuda,
    "dma_probe": dma_probe_cuda,
    "salted_probe": salted_probe_cuda,
    "mvm_f32": mvm_f32_cuda,
    "mvm_batched_f32": mvm_batched_f32_cuda,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "SEED_GOLD", "SEED_OP", "on_cuda", "seed_from", "wrap_i32",
    "KERNELS", "launch_counts", "reset_launch_counts",
    "quantize_vec_cuda", "quantize_vec_plain",
    "quantize_mat_cuda", "quantize_mat_plain",
    "restore_vec_cuda", "restore_vec_plain",
    "restore_mat_cuda", "restore_mat_plain",
    "dot_cuda", "dot_plain", "dot_terms",
    "hist4_cuda", "hist4_plain", "mask4_cuda", "mask4_plain",
    "transpose4_cuda", "transpose4_plain",
    "transpose8_cuda", "transpose8_plain",
    "mvm4_cuda", "mvm4_plain", "mvm8_cuda", "mvm8_plain",
    "axpy_cuda", "axpy_plain",
    "mvm_f32_cuda", "mvm_f32_plain",
    "MAX_BATCH", "mvm_batched_cuda", "mvm_batched_plain",
    "mvm_batched_f32_cuda", "mvm_batched_f32_plain",
    "threshold4_cuda", "threshold4_plain",
    "threshold8_cuda", "threshold8_plain",
    "iteration_cuda", "iteration_plain", "iteration_eligible",
    "iteration_chain_cuda", "iteration_chain_plain",
    "iteration_chain_eligible",
    "dma_probe_cuda", "dma_probe_plain",
    "salted_probe_cuda", "salted_probe_plain",
]
