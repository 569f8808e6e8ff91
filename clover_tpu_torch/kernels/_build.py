"""Build the CUDA kernels with nvcc on first use and bind them with ctypes.

``clover_tpu_torch/csrc/*.cu`` compile with one ``nvcc`` per source, all
started together, and link into a shared library with a plain C interface,
under ``build/clover_tpu_torch/`` beside the package.  The file name
carries a hash of the sources and flags, so an edited source builds anew
and an unchanged one loads at once.  Each C entry
point returns ``cudaGetLastError()`` after its launch; :func:`launch`
raises when that is not 0.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "clover_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_U32, _F32 = ctypes.c_uint32, ctypes.c_float
# C entry points: argument types; every one returns a cudaError_t as int
SIGNATURES = {
    "clover_quantize_vec": (_P, _P, _P, _I64, _I32, _I32, _U32, _P),
    "clover_quantize_mat": (_P, _P, _P, _I64, _I64, _I32, _I32, _U32, _P),
    "clover_restore_vec": (_P, _P, _P, _I64, _I32, _P),
    "clover_restore_mat": (_P, _P, _P, _I64, _I64, _I32, _P),
    "clover_dot": (_P, _P, _P, _P, _P, _P, _I64, _I32, _P),
    "clover_hist4": (_P, _P, _I64, _P),
    "clover_mask4": (_P, _P, _P, _P, _P, _P, _I64, _P),
    "clover_transpose": (_P, _P, _I64, _I64, _I32, _P),
    "clover_mvm": (_P, _P, _P, _P, _P, _P, _F32, _P, _P, _I64, _I64,
                   _I32, _I32, _I32, _U32, _I32, _U32, _P),
    "clover_mvm_f32": (_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _P),
    "clover_threshold": (_P, _P, _P, _I64, _I64, _I32, _I64, _P),
    "clover_axpy": (_P, _P, _P, _P, _F32, _P, _P, _I64, _I32, _I32, _U32, _P),
    "clover_mvm_batched": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32,
                           _I32, _I32, _U32, _P),
    "clover_mvm_batched_f32": (_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32,
                               _I32, _P),
    "clover_iteration_occupancy": (_I32, _I32, _I32, _P),
    "clover_iteration": (*(_P,) * 12, _I64, _I64, _F32, _I32, _I32, _P, _P,
                         _I32, _P),
    "clover_iteration_chain": (*(_P,) * 15, _I64, _I64, _F32, _I64, _I32,
                               _I32, _I32, _P, _P, _I32, _P),
    "clover_dma_probe": (_P, _P, _I64, _I64, _P),
    "clover_salted_probe": (_P, _P, _P, _I64, _I64, _P),
}


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float      # 0.0 when an earlier build was loaded
    log: str                  # nvcc's output (ptxas register / spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(commands: list[list[str]], tmp: Path) -> str:
    """Start every command at once, each writing its output to a file in
    ``tmp``; wait for all; -> their joined output; raise if one failed."""
    procs = []
    for i, argv in enumerate(commands):
        log = open(tmp / f"{i}.log", "w+")
        procs.append((argv, log, subprocess.Popen(
            argv, stdout=log, stderr=subprocess.STDOUT, text=True)))
    outs, failed = [], []
    for argv, log, proc in procs:
        rc = proc.wait()
        log.seek(0)
        outs.append(log.read())
        log.close()
        if rc != 0:
            failed.append(f"{' '.join(argv)} ({rc}):\n{outs[-1][-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(outs)


def _compile_and_link(path: Path) -> str:
    """One nvcc per source, all started together, then one link into
    ``path``; -> nvcc's output (ptxas' per-kernel report)."""
    nvcc = _nvcc()
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    tmp.mkdir(exist_ok=True)
    try:
        objs = [tmp / f"{src.stem}.o" for src in _sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(_sources(), objs)], tmp)
        lib = tmp / "lib.so"
        log += _run_all([[nvcc, "-shared", "-o", str(lib),
                          *map(str, objs)]], tmp)
        os.replace(lib, path)
        return log
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.cache
def library() -> Library:
    """Build (once per source hash) and load the kernels' library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libclover_tpu_torch_{_digest()}.so"
    log_path = path.with_suffix(".log")
    seconds = 0.0
    if not path.is_file():
        t0 = time.perf_counter()
        log = _compile_and_link(path)
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.clover_error_string.argtypes = [ctypes.c_int]
    lib.clover_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.is_file() else ""
    return Library(lib=lib, path=path, build_seconds=seconds, log=log)


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` on ``device``'s current stream; raise on error.

    Pointer arguments are passed as ints (``tensor.data_ptr()``) or None.
    """
    built = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(built.lib, name)(*args, stream)
    _raise_on(built, name, rc)


def call(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name``, which takes no stream, with ``device``
    current; raise on error."""
    built = library()
    with torch.cuda.device(device):
        rc = getattr(built.lib, name)(*args)
    _raise_on(built, name, rc)


def _raise_on(built: Library, name: str, rc: int) -> None:
    if rc != 0:
        msg = built.lib.clover_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def check(t: torch.Tensor, shape: tuple, dtype: torch.dtype, name: str,
          device: torch.device | None = None):
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` and ``shape`` (on ``device`` when given)."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on "
                         f"{device or 'a CUDA device'}, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def ptr(t: torch.Tensor | None):
    """Device pointer of a contiguous tensor for a C argument."""
    return None if t is None else t.data_ptr()
