"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

The main paths are three IHT solves at m=8192, n=16384, K=4096, each with
the step size and iteration count of clover_tpu's tuned tables for that
size (copied as data in clover_tpu_torch/models/tuned.py): quantize Phi
and y, transpose Phi, then per iteration two fused MVM+AXPY legs and one
exact top-K threshold.

- pure 4-bit, untraced;
- mixed 4x8 (4-bit Phi, 8-bit y and x), traced: every iteration restores
  x and records ||x - x*|| / ||x*|| on the device;
- pure 8-bit, traced;

and, on the batching and serving path:

- a batched 4-bit IHT of B=8 problems against the same Phi (one batched
  MVM per leg, one AXPY per leg over the whole batch, one threshold of
  the batch per iteration), traced and untraced;
- an MVMServer on a resident 16384x16384 matrix answering bursts of
  requests from 4 client threads: 4-bit matrix with 4-bit and 8-bit
  requests (modes 4x4, 4x8), 8-bit matrix with 8-bit requests (8x8);

and, on the small-problem path (both padded sides multiples of 512, at
most 8192), where a 4x4 or 4x8 iteration is one whole-iteration launch
and an untraced solve one chained launch per 4 iterations:

- IHT at 4096x8192 and 2048x4096 (K = n/4, the tuned mu), 4x4 and 4x8,
  100 iterations untraced and traced;
- the accuracy protocol, ``python -m clover_tpu_torch -a``: the
  reference's 512x1024 instance, K=64, 200 epochs, five precisions,
  deterministic and SR;

and the validation mode, ``python -m clover_tpu_torch -v``: every op
against the golden oracle over the default size sweep; the large-n 4-bit
IHT (2048x524288, K=64), whose threshold is the hybrid (hist4, an exact
selector in torch, mask4); the performance mode, ``python -m
clover_tpu_torch -p --quick``, every op's device time against the card's
memory rate and the MVM against its probe floor (the dma and salted probe
kernels); the grid search, ``python -m clover_tpu_torch -g --quick``; a
checkpoint round trip; and the sharded path (clover_tpu_torch.parallel):
8 ranks sharing the card on a 2x4 mesh over gloo (the sharded IHT and GD,
the ShardedMVMServer, ``-p --sharded``'s rows), then ``-p --sharded``
on a 1x1 mesh in this process.

Phases, each of which raises on failure:

1. card and build: the card's name and power limit, its SM clocks,
   torch/CUDA versions, and the nvcc build of clover_tpu_torch/csrc/*.cu
   (into build/);
2. each kernel against its plain torch version on the card, at the main
   paths' shapes and at a ragged 200x300, deterministic and SR:
   quantize, restore, transpose, threshold and the MVM+AXPY (both legs
   of every mode, with and without the AXPY) bit-identical; the matrix
   quantize and the transposes also at the set-up kernels' edge shapes
   (SETUP_EDGES: tile counts no multiple of the persistent grid's share or
   of the transpose's 4x4-tile strips) on edge_matrix data (an all-zero
   tile, a tile on +-absmax, subnormal tiles), det and SR, 4- and 8-bit,
   and the quantize on forced 64-bit Philox counters, and at the solve
   cell's 16384x32768 (CELL_PHI); the MVM at
   the shapes its launch geometry makes edge cases (MVM_EDGES,
   F32_EDGES: one and two bands, 5 and 10 bands, rows of >= 16 chunks,
   partial last chunks) in every mode at every rows-per-warp geometry of
   csrc/mvm.cu, det and SR, with and without the AXPY, bit-identical;
   the standalone AXPY
   bit-identical (single and stacked), and mvm -> scale_and_add equal to
   the fused mvm_axpy; the batched MVM bit-identical to per-vector plain
   MVMs with seeds seed + j (16384x16384 at B = 2, 3, 8, 32 and at the
   partial n-tiles B = 1, 5, 9, 31; 8192x16384 at B = 8; 200x300 at B =
   3; 128x16512 and 640x1152, a partial chunk and 10 bands, at B = 1, 5,
   9, 31, 32); the batched threshold bit-identical to
   per-row plain ones; the select at its edge cases (n = 16256, 16384,
   16512 around the resident path's limit, 2^19 with K = 300, stacked
   B = 1 and 32, 8-bit codes at +-127, subnormal and zero s/qmax, blocks
   whose order needs the IEEE s/qmax) bit-identical; the whole-iteration
   and chained kernels (4x4, 4x8; 4096x8192, 2048x4096, 512x1024; chains
   of 4 with k = n/4 and GD) bit-identical to their plain versions and to
   the unfused kernel sequence, the whole iteration at 1 and 7 clusters
   and the default grid, the chain also at chains of 1 and 16, at 1 and
   7 clusters and at 8192x8192; the matrix restore bit-identical
   (8192x16384 and 200x300, SR codes); the dot bit-identical to its
   plain version in the kernel's order at grids 2, 7 and the default,
   within 1e-5 of its terms' absolute sum of the torch-order plain
   version, bit-identical on a repeated call, and within 0.02 max(1,
   |ref|/10) of golden.dot at n <= 65536 (n = 16384, 2^24, 1000), timed
   back to back and rotating past the L2; hist4 and mask4
   bit-identical, and the hybrid through ``tt.threshold`` byte-identical
   to the radix kernel
   and its plain version (n = 2^19, 2^20, 2^23; K = 1, 64, 256; uniform,
   integer-valued and k > nnz data) and free of host syncs (torch's sync
   debug mode), with the hybrid's split (hist4, selector, mask4) timed
   beside the radix kernel; the dma, cluster dma and salted probes
   bit-identical (4- and 8-bit 8192x16384 and 200x300; the cluster probe
   also at MVM_EDGES and 2048x4096, the others on the 512 MB stack), with
   dma_probe_stream's p and bytes; the f32-output modes bit-identical
   (mvm_f32 4x4, 4x8, 8x8 at 8192x16384, on a 4096x4096 shard's block and
   on 64-multiple ragged blocks; mvm_batched_f32 at B = 2, 8, 32 and 1,
   5, 9, 31 on 16384x16384, B = 8 at 8192x16384, B = 3 on a ragged block,
   B = 1, 5, 9, 31, 32 at 128x16512 and 640x1152); the TF32
   pin: with TF32 requested, the
   16/32-bit tt.mvm, mvm_f32, mvm_sparse and gemm_f32 bit-identical to
   their TF32-off results and the caller's settings restored; device
   times by CUDA events (``harness/timing.median_ms``: median of 5
   windows of 20 back-to-back launches queued behind a spin kernel; plain
   versions 3 single calls), and the batched MVM's per-vector time at
   B = 1 ... 32 against single-kernel calls;
3. the main paths through the public entry points: Phi and y quantized
   with a seeded generator (stochastic rounding), deterministic
   iterations as in the search that tuned mu; exact launch counts,
   relative recovery error (the trace's last entry against a host-side
   restore), iterations/s traced and untraced; for the untraced 4-bit
   solve also the wall time of the whole solve from quantize(Phi) to the
   result (median of WHOLE_SOLVES) beside its kernels' set-up and
   iteration times;
4. a deterministic solve per configuration, kernels against plain
   versions;
5. the batched IHT: exact launch counts, every problem's error below
   1.0, the trace's last row against host-side restores, the solutions
   bit-identical to 8 single solves, problem-iterations/s beside the
   single solves';
6. the server: every result bit-identical to ``tt.mvm``, batched-kernel
   launches in every mode, requests/s and p50/p99 latency;
7. the small IHT: exact launch counts (an untraced 100-iteration solve is
   25 chained launches and nothing else; a traced one an iteration, a
   threshold and a restore per iteration), the chained, traced and
   unfused solves bit-identical, the error after the tuned iteration
   count below 1.0, iterations/s by host clock and CUDA events beside
   the unfused kernel sequence, with the device's busy share;
8. ``-a`` through the CLI, deterministic then SR: exact launch counts
   (200 whole-iteration launches in each of the 4 and 4x8
   configurations), every deterministic final error below 1.0, the SR
   finals printed beside them, and the deterministic 4 and 4x8 traces
   against the plain versions' on the card within 1e-6;
9. ``-v`` through the CLI: exit 0, ``N checks, 0 failures`` with no
   ``Failed`` line, N equal to the same sweep's count on the CPU (run in
   this process after it), and a launch of every 4/8-bit kernel the
   sweep reaches (``VALIDATE_KERNELS``), matrix restore and dot
   included; the phase's wall time;
10. the large-n 4-bit IHT through ``tt.iht``: Phi and y quantized with SR,
    10 deterministic iterations with mu = 1/m; exact launch counts (two
    MVM+AXPY legs, one hist4 and one mask4 per iteration, no threshold4),
    the solution bit-identical to an unfused loop through the radix
    threshold kernel, no host sync in the solve; both MVM legs
    (2048x524288 Phi, 524288x2048 PhiT) bit-identical to mvm4_plain on the
    card, det and SR, with their times and TB/s; the error (finite),
    iterations/s and the device's busy share;
11. ``-p --quick`` through the CLI: exit 0, every row printed, none but
    the L2-warm rows above 100% of the card's memory rate, each 4/8-bit
    MVM row with its % of the cluster probe floor (the MVM's own launch
    geometry), none above FLOOR_SHARE_MAX, a launch of every kernel -p
    reaches, the wall time;
12. ``-g --quick`` through the CLI: exit 0, a row for every kind (GD and
    IHT, pure and mixed), size (256, 384) and precision; each kind's
    4-bit (iterations, mu) at size 256 equal to the same search on the
    CPU in this process, its quality target within rtol 1e-5; the wall
    time;
13. a checkpoint round trip: CUDA containers of every type saved and
    loaded onto a CUDA ``like``, bytes equal;
14. the sharded path: 8 spawned ranks on the one card (gloo, since NCCL
    refuses two ranks on one GPU), a 2x4 mesh, each rank building the
    same 8192x16384 problem (a checksum all_reduce shows the copies
    equal): the exact-integer mvm_psum bit-identical to the integer
    product; an SR requant's col replicas equal; one exact sharded
    iteration bit-identical to this process's single-device iteration;
    the sharded IHT (4, 4x8, 8-bit) and the mixed 4x8 GD at their tuned
    mu and iterations, traced, each trace within the regime rule of
    tests/test_parallel.py against the single solve and every rank's
    solution the same bytes; the 4-bit IHT's iterations/s and a per-leg
    split; a ShardedMVMServer on 16384x16384 (4x4, 4x8, 8x8; bursts from
    4 client threads on rank 0; every result within 1 LSB of tt.mvm,
    scales within rtol 1e-6; requests/s, p50/p99); ``-p --sharded``'s
    rows on the 2x4 mesh.  The ranks send back their launch counts.
    These times measure 8 processes time-slicing one card and gloo's
    host-staged collectives, not a multi-GPU node;
15. ``-p --sharded --quick`` through the CLI: a world of one, a 1x1 mesh;
    every row, and the sharded IHT bit-identical to the single solve.

The line before the last is ``{"kernels": [...]}``, each kernel with its
bound: the larger of its bytes (every input read once, every output
written once) over the card's memory rate and its int8 operations over
the int8 peak (NVIDIA's data sheet); mvm4's entry also carries phase
10's 2048x524288 Phi leg (``large_n_phi_ms``, ``large_n_phi_bound_ms``),
the dot's its 2^24 4-bit time rotating past the L2 (``rotating_ms``);
the last is ``{"ok": true,
"device": {...}}``.  Without a CUDA device it prints no result and exits
2.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import time

from clover_tpu_torch.harness.timing import (HOST_SPIN_CYCLES, median_ms,
                                              wall_time)

M, N, K = 8192, 16384, 4096
NS = 16384                    # the served matrices' side
BATCH = 8                     # problems of the batched IHT
BATCH_SIZES = (2, 3, 8, 32)   # batched-MVM checks at NS x NS
# partial n-tiles of csrc/mvm_batched.cu (8 vectors a tile), checked at
# NS x NS and, with B = 32, at the MVM_EDGES shapes
PARTIAL_BATCHES = (1, 5, 9, 31)
SWEEP = (1, 2, 4, 8, 16, 24, 32)  # batched-MVM timing
MODES = ((4, 4), (4, 8), (8, 8))
CLIENTS = 4
WAIT_S = 60.0                 # bound on every wait for a future or thread
TIMED_ITERS = 100
WHOLE_SOLVES = 5              # phase 3's timed whole solves, set-up included
SEED = 0
MVM_SCALE_RTOL = 1e-6
SOLVE_ERR_TOL = 0.01
TRACE_TOL = 1e-6
CONFIGS = ("4", "4x8", "8")
TRACED = {"4": False, "4x8": True, "8": True}
SMALL = ((4096, 8192), (2048, 4096), (512, 1024))  # whole-iteration sizes
SMALL_SOLVES = SMALL[:2]      # bench.py's small IHT sizes
CHAIN = 4                     # iterations per chained launch (the solver's)
EPOCHS = 200                  # the accuracy protocol's
INT8_OPS = 1979e12            # H100 SXM int8 tensor-core peak, ops/s
DOT_SIZES = (16384, 1 << 24, 1000)
DOT_RTOL = 1e-5               # of sum |t_b|: torch's f32 sum order differs
RING_BYTES = 256 << 20        # rotating copies of an operand pass the L2
                              # (at most 4096 copies: 75 MB at n = 16384)
# csrc/threshold.cu resident_path: the select holds n_pad <= this many
# elements in registers; the edge checks straddle it
SELECT_RESIDENT = 16384
SELECT_EDGES = (SELECT_RESIDENT - 128, SELECT_RESIDENT, SELECT_RESIDENT + 128)
# blocks (scale a, scale b, code a, code b), as f32 bit patterns, whose
# values order one way with s / qmax divided in IEEE and tie with s * (1 /
# qmax) (tests/test_torch_threshold.py DIVISION_ORDER)
DIVISION_ORDER = {4: (1071573821, 1066704083, 2, 3),
                  8: (1061287518, 1073648478, 63, 24)}
# the chain's edge cases: (m, n, y/x bits, chain, grid in clusters): chains
# of 1 and MAX_CHAIN, one and seven clusters, and the largest eligible
# shape (phase C's x of 8192; the pair past the 50 MB L2)
CHAIN_EDGES = ((4096, 8192, 4, 1, None), (2048, 4096, 8, 16, None),
               (4096, 8192, 4, 4, 1), (4096, 8192, 8, 4, 7),
               (8192, 8192, 4, 4, None), (8192, 8192, 8, 2, None))
HYBRID_SIZES = (1 << 19, 1 << 20, 1 << 23)
HYBRID_KS = (1, 64, 256)
HYBRID_TIMED = ((1 << 20, 64), (1 << 23, 256))
LARGE = (2048, 524288, 64)    # the large-n 4-bit IHT: m, n = 2^19, K
LARGE_ITERS = 10
# kernels the -v sweep must reach on the card (not the batched MVM and the
# hybrid threshold's: the sweep's vectors are at most 2047 long)
VALIDATE_KERNELS = ("quantize_mat", "quantize_vec", "transpose4",
                    "transpose8", "mvm4", "mvm8", "threshold4", "threshold8",
                    "restore_vec", "axpy", "iteration", "iteration_chain",
                    "restore_mat", "dot")

# kernels -p --quick must reach (not restore_mat: no -p table restores a
# matrix), and those -g's unfused probes at sizes 256 and 384 must reach
PERF_KERNELS = ("quantize_mat", "quantize_vec", "transpose4", "transpose8",
                "mvm4", "mvm8", "threshold4", "threshold8", "restore_vec",
                "axpy", "mvm_batched", "iteration", "iteration_chain", "dot",
                "hist4", "mask4", "dma_probe", "dma_probe_cluster",
                "salted_probe")
SEARCH_KERNELS = ("quantize_mat", "quantize_vec", "transpose4", "transpose8",
                  "mvm4", "mvm8", "threshold4", "threshold8", "restore_vec")
SEARCH_RTOL = 1e-5            # -g quality targets, card against CPU
FLOOR_SHARE_MAX = 105.0       # % of the cluster probe floor an MVM row may
                              # read: the two share a geometry, and two
                              # timings of one stream spread by a few %

# kernel -> (CUDA source, pallas_call it replaces)
KERNEL_INFO = {
    "quantize_mat": ("clover_tpu_torch/csrc/quantize.cu",
                     "clover_tpu/kernels/quantize.py:248"),
    "quantize_vec": ("clover_tpu_torch/csrc/quantize.cu",
                     "clover_tpu/kernels/quantize.py:174"),
    "transpose4": ("clover_tpu_torch/csrc/transpose.cu",
                   "clover_tpu/kernels/transpose.py:94"),
    "mvm4": ("clover_tpu_torch/csrc/mvm.cu", "clover_tpu/kernels/mvm.py:552"),
    "threshold4": ("clover_tpu_torch/csrc/threshold.cu",
                   "clover_tpu/kernels/threshold.py:394"),
    "restore_vec": ("clover_tpu_torch/csrc/restore.cu",
                    "clover_tpu/kernels/restore.py:79"),
    "transpose8": ("clover_tpu_torch/csrc/transpose.cu",
                   "clover_tpu/kernels/transpose.py:94"),
    "mvm8": ("clover_tpu_torch/csrc/mvm.cu", "clover_tpu/kernels/mvm.py:552"),
    "threshold8": ("clover_tpu_torch/csrc/threshold.cu",
                   "clover_tpu/kernels/threshold.py:180"),
    "axpy": ("clover_tpu_torch/csrc/axpy.cu",
             "clover_tpu/kernels/quantize.py:371"),
    "mvm_batched": ("clover_tpu_torch/csrc/mvm_batched.cu",
                    "clover_tpu/kernels/mvm_batched.py:314"),
    "iteration": ("clover_tpu_torch/csrc/iteration.cu",
                  "clover_tpu/kernels/iteration.py:311"),
    "iteration_chain": ("clover_tpu_torch/csrc/iteration.cu",
                        "clover_tpu/kernels/iteration.py:549"),
    "restore_mat": ("clover_tpu_torch/csrc/restore.cu",
                    "clover_tpu/kernels/restore.py:134"),
    "dot": ("clover_tpu_torch/csrc/dot.cu", "clover_tpu/kernels/dot.py:158"),
    "hist4": ("clover_tpu_torch/csrc/threshold_hybrid.cu",
              "clover_tpu/kernels/threshold.py:489"),
    "mask4": ("clover_tpu_torch/csrc/threshold_hybrid.cu",
              "clover_tpu/kernels/threshold.py:596"),
    "dma_probe": ("clover_tpu_torch/csrc/probes.cu",
                  "clover_tpu/kernels/probes.py:46"),
    "dma_probe_cluster": ("clover_tpu_torch/csrc/probes.cu",
                          "clover_tpu/kernels/probes.py:46"),
    "salted_probe": ("clover_tpu_torch/csrc/probes.cu",
                     "clover_tpu/kernels/probes.py:80"),
    "mvm_f32": ("clover_tpu_torch/csrc/mvm.cu",
                "clover_tpu/kernels/mvm.py:705"),
    "mvm_batched_f32": ("clover_tpu_torch/csrc/mvm_batched.cu",
                        "clover_tpu/kernels/mvm_batched.py:390"),
}
# shapes that csrc/mvm.cu's geometry makes edge cases, (rows, cols): the
# requantizing MVM's (sides multiples of 128) -- two bands with rows of
# 16512 columns (>= 16 chunks a group, a partial last chunk), 10 bands (no
# multiple of 4 or 8) with a partial chunk -- and its f32 mode's
# (multiples of 64) -- one band with a partial chunk, 5 bands of 16448
MVM_EDGES = ((128, 16512), (640, 1152))
# shapes whose tile counts are no multiple of csrc/quantize.cu's persistent
# grid share nor of csrc/transpose.cu's 4x4-tile strips (short strips on
# both sides)
SETUP_EDGES = ((128, 384), (384, 640), (8320, 16512))
# the benchmark's solve cell's Phi (iht4-16384x32768), which it quantizes
# with SR on every request: 2^29 elements on 32-bit Philox counters
CELL_PHI = (16384, 32768)
F32_EDGES = ((64, 576), (320, 16448))
F32_BATCHES = (2, 8, 32)      # mvm_batched_f32 checks at NS x NS
SHARD = (M // 2, N // 4)      # a 2x4 mesh's block of the M x N matrix
# the other blocks phase 14 gives the f32 modes on its 2x4 mesh: the
# served NS x NS matrices' (batches of 1 take mvm_f32, 2-32 the batched
# kernel), and -p --sharded's: the n=4096 mvm_psum, the 2048x4096 IHT's
# Phi and PhiT legs, the overlapped psum's 4 column chunks
SERVER_SHARD = (NS // 2, NS // 4)
SERVER_BATCHES = (1, 2, 8, 32)
PERF_SHARDS = ((2048, 1024), (1024, 1024), (2048, 256))


@functools.cache
def config(name: str):
    """-> (Phi bits, y/x bits, iterations, mu, quality) from the tuned
    tables at (M, N)."""
    from clover_tpu_torch.models import tuned
    if name == "4":
        row = tuned.IHT_4BIT[(M, N)]
        return 4, 4, row["iters"], row["mu"], row["quality"]
    if name == "4x8":
        row = tuned.IHT_MIXED_4X8[(M, N)]
        target = tuned.IHT_MIXED_FAMILY[(M, N)]["quality_target"]
        return 4, 8, row["iters"], row["mu"], target
    row = tuned.IHT_PURE_FAMILY[(M, N)]
    return 8, 8, *row[8], row["quality_target"]


def codes_of(codes, bits: int):
    """Element codes of raw 4-bit (packed) or 8-bit codes."""
    from clover_tpu_torch.formats import unpack_nibbles
    return unpack_nibbles(codes) if bits == 4 else codes


def dequant(codes, scales, bits: int = 4):
    """f32 values of raw codes/scales, for measuring kernel-plain gaps."""
    c = codes_of(codes, bits).float()
    s = scales / (7.0 if bits == 4 else 127.0)
    s = (s.repeat_interleave(64) if s.dim() == 1
         else s.repeat_interleave(64, 0).repeat_interleave(64, 1))
    return c * s


@functools.cache
def hbm_rate() -> float:
    """The card's memory rate from its data sheet, by device name."""
    import torch
    from clover_tpu_torch.harness.sysinfo import hbm_spec
    name = torch.cuda.get_device_name(0)
    rate = hbm_spec(name)
    if rate is None:
        raise RuntimeError(f"no memory rate known for {name}")
    return rate


def qbytes(n: int, bits: int) -> int:
    """Bytes of n quantized elements with their 64-block scales."""
    return n * bits // 8 + n // 16


class Report:
    """Per-kernel comparison results, times and bounds."""

    def __init__(self):
        self.err = {name: 0.0 for name in KERNEL_INFO}
        self.ms = {}
        self.plain_ms = {}
        self.bound = {}      # name -> (ms, "bytes" or "operations")
        self.library_ms = dict.fromkeys(KERNEL_INFO)
        self.leg_ms = {}     # (mode, leg) -> kernel ms of an MVM+AXPY leg
        self.large = {}      # leg -> (ms, bound ms) of the large-n 4x4 legs
        self.sweep = {}      # B -> batched MVM ms, 4x4 at NS x NS
        self.rotating_ms = {}  # name -> ms through copies past the L2

    def exact(self, name: str, what: str, got, want, bits: int = 4,
              say: bool = True):
        """Kernel output must equal the plain one: (codes, scales) pairs,
        or f32 values compared bit for bit."""
        import torch
        if isinstance(got, tuple):
            (gc, gs), (wc, ws) = got, want
            same = torch.equal(gc, wc) and torch.equal(gs, ws)
            bad = f"{int((gc != wc).sum())} code bytes differ"
            got, want = dequant(gc, gs, bits), dequant(wc, ws, bits)
        else:
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            bad = f"{int((got != want).sum())} values differ"
        if not same:
            raise AssertionError(f"{name} {what}: kernel != plain ({bad})")
        self.err[name] = max(self.err[name],
                             float((got - want).abs().max()))
        if say:
            print(f"  {name:13s} {what:40s} bit-identical")

    def time(self, name: str, kernel, plain, nbytes: int, ops: float = 0.0,
             library=None):
        """Kernel and plain times of one call; its bound from the bytes it
        must move and the int8 operations it must do; ``library``, one
        PyTorch call computing the same function, timed as the kernel."""
        self.ms[name] = median_ms(kernel, 5, 20)
        self.plain_ms[name] = median_ms(plain, 3, 1)
        by_bytes, by_ops = nbytes / hbm_rate() * 1e3, ops / INT8_OPS * 1e3
        self.bound[name] = ((by_bytes, "bytes") if by_bytes >= by_ops
                            else (by_ops, "operations"))
        lib = ""
        if library is not None:
            self.library_ms[name] = median_ms(library, 5, 20)
            lib = f"   library {self.library_ms[name]:.4f} ms"
        print(f"  {name:13s} kernel {self.ms[name]:.4f} ms   plain "
              f"{self.plain_ms[name]:.4f} ms   bound "
              f"{self.bound[name][0]:.4f} ms ({self.bound[name][1]}){lib}")

    def time_leg(self, mode: str, leg: str, kernel):
        self.leg_ms[mode, leg] = median_ms(kernel, 5, 20)
        print(f"  {'mvm ' + mode:13s} {leg} leg kernel "
              f"{self.leg_ms[mode, leg]:.4f} ms")


def phase_build():
    import torch
    from clover_tpu_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print("== 1. card and build")
    print(smi.splitlines()[0])
    # the SM clock bounds an issue-bound kernel (PERF.md's SR issue bound)
    print(f"SM clock max, now: {clocks.splitlines()[0]}")
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")
    built = _build.library()
    print(f"built {built.path.name} in {built.build_seconds:.1f} s")
    for line in built.log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            print("  ptxas:", line.strip())


def mvm_forms(bits_a: int, bits_x: int):
    """(kernel form, plain version) of the MVM for one mode."""
    from clover_tpu_torch.kernels import (mvm4_cuda, mvm4_plain, mvm8_cuda,
                                          mvm8_plain)
    if bits_x == 4:
        return mvm4_cuda, mvm4_plain
    return (functools.partial(mvm8_cuda, bits_a),
            functools.partial(mvm8_plain, bits_a))


def mvm_bytes(m: int, n: int, bits_a: int, bits_x: int) -> int:
    """Bytes an MVM+AXPY leg must move: A and its scales, x, u and the
    output, each once."""
    bits_out = 4 if bits_a == bits_x == 4 else 8
    return (m * n * bits_a // 8 + 4 * (m // 64) * (n // 64)
            + qbytes(n, bits_x) + 2 * qbytes(m, bits_out))


@contextlib.contextmanager
def rows_forced(rows: int):
    """csrc/mvm.cu launched at ``rows`` rows per warp whatever the shape
    (kernels/mvm.py rows_per_warp is the rule otherwise)."""
    from clover_tpu_torch.kernels import mvm as kmvm
    rule = kmvm.rows_per_warp
    kmvm.rows_per_warp = lambda m_pad, sms: rows
    try:
        yield
    finally:
        kmvm.rows_per_warp = rule


def check_mvm_edges(rep: Report, gen, modes):
    """The MVM kernel's edge shapes (MVM_EDGES, F32_EDGES) in every mode
    and at every rows-per-warp geometry, det and SR, with and without the
    AXPY: bit-identical to the plain versions."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch.kernels import mvm_f32_cuda, mvm_f32_plain
    from clover_tpu_torch.kernels.mvm import ROWS_PER_WARP
    dev = gen.device
    every = ",".join(map(str, ROWS_PER_WARP))
    for bits_a, bits_x in MODES:
        mode, name = f"{bits_a}x{bits_x}", f"mvm{bits_x}"
        cuda, plain = mvm_forms(bits_a, bits_x)
        for m, n in MVM_EDGES:
            a = tt.quantize(torch.rand(m, n, generator=gen, device=dev) * 2
                            - 1, bits_a)
            x = tt.quantize(torch.randn(n, generator=gen, device=dev), bits_x)
            u = tt.quantize(torch.rand(m, generator=gen, device=dev) * 2 - 1,
                            bits_x)
            for what, seed, noise in modes:
                args = (a.codes, a.scales, x.codes, x.scales, u.codes,
                        u.scales, -0.61)
                for axpy, ops in (("AXPY", args), ("no AXPY", args[:4])):
                    sr = dict(seed1=seed, noise1=noise)
                    if axpy == "AXPY":
                        sr.update(seed2=seed + 1, noise2=noise)
                    want = plain(*ops, **sr)
                    for rows in ROWS_PER_WARP:
                        with rows_forced(rows):
                            rep.exact(name, f"{mode} {m}x{n} R={rows}",
                                      cuda(*ops, **sr), want, bits_x,
                                      say=False)
                    print(f"  {name:13s} {mode} {m}x{n} {axpy} {what}: "
                          f"bit-identical at R={every}")
        for m, n in F32_EDGES:
            ops = f32_operands(
                torch.rand(m, n, generator=gen, device=dev) * 2 - 1,
                torch.randn(n, generator=gen, device=dev), bits_a, bits_x,
                (m, n))
            want = mvm_f32_plain(bits_a, bits_x, *ops)
            for rows in ROWS_PER_WARP:
                with rows_forced(rows):
                    rep.exact("mvm_f32", f"{mode} {m}x{n} R={rows}",
                              mvm_f32_cuda(bits_a, bits_x, *ops), want,
                              say=False)
            print(f"  {'mvm_f32':13s} {mode} {m}x{n}: bit-identical at "
                  f"R={every}")


def check_quantize(rep: Report, phi, y, xf, modes):
    from clover_tpu_torch.kernels import (quantize_mat_cuda,
                                          quantize_mat_plain,
                                          quantize_vec_cuda,
                                          quantize_vec_plain)
    for bits in (4, 8):
        for mode, seed, noise in modes:
            rep.exact("quantize_mat", f"{M}x{N} {bits}-bit {mode}",
                      quantize_mat_cuda(phi, bits, seed, noise),
                      quantize_mat_plain(phi, bits, seed, noise), bits)
            for v in (y, xf):
                rep.exact("quantize_vec", f"{v.numel()} {bits}-bit {mode}",
                          quantize_vec_cuda(v, bits, seed, noise),
                          quantize_vec_plain(v, bits, seed, noise), bits)
    rep.time("quantize_mat", lambda: quantize_mat_cuda(phi, 4, 1, True),
             lambda: quantize_mat_plain(phi, 4, 1, True),
             4 * M * N + M * N // 2 + 4 * (M // 64) * (N // 64))
    rep.time("quantize_vec", lambda: quantize_vec_cuda(y, 4, 1, True),
             lambda: quantize_vec_plain(y, 4, 1, True), 4 * M + qbytes(M, 4))


def edge_matrix(gen, m: int, n: int):
    """A uniform (m, n) f32 matrix whose first tiles are the set-up
    kernels' value edges: tile (0, 0) all zero (scale 1.0, codes 0), tile
    (0, 1) every element on +-absmax (codes +-qmax in both nibbles), tile
    (1, 0) nonzero subnormals only (qmax / s overflows to inf: codes
    +-qmax), tile (1, 1) subnormals beside one normal absmax (a finite
    multiplier on subnormal inputs)."""
    import torch
    a = torch.rand(m, n, generator=gen, device=gen.device) * 2 - 1
    a[:64, :64] = 0.0
    a[:64, 64:128] = torch.where(a[:64, 64:128] < 0, -2.5, 2.5)
    sub = a[64:128, :128]
    a[64:128, :128] = torch.where(sub < 0, -1.0, 1.0) * (0.5 + sub.abs() / 2
                                                         ) * 1e-39
    a[64, 100] = 3e-37
    return a


@contextlib.contextmanager
def counters_forced(bits: int):
    """csrc/quantize.cu's matrix kernel on ``bits``-bit Philox counters
    whatever the shape (kernels/quantize.py counter_bits is the rule
    otherwise)."""
    from clover_tpu_torch.kernels import quantize as kq
    rule = kq.counter_bits
    kq.counter_bits = lambda m_pad, n_pad: bits
    try:
        yield
    finally:
        kq.counter_bits = rule


def check_setup_edges(rep: Report, gen, modes):
    """quantize_mat and the transposes at SETUP_EDGES on edge_matrix data,
    det and SR, 4- and 8-bit, and quantize_mat on 64-bit counters (forced
    at 384x640: an operand of 2^32 elements and its plain version do not
    fit beside the rest): bit-identical to the plain versions."""
    from clover_tpu_torch import kernels as kn
    for m, n in SETUP_EDGES:
        a = edge_matrix(gen, m, n)
        for bits in (4, 8):
            for mode, seed, noise in modes:
                want = kn.quantize_mat_plain(a, bits, seed, noise)
                rep.exact("quantize_mat", f"{m}x{n} edges {bits}-bit {mode}",
                          kn.quantize_mat_cuda(a, bits, seed, noise), want,
                          bits)
                if (m, n) == SETUP_EDGES[1]:
                    with counters_forced(64):
                        rep.exact("quantize_mat", f"{m}x{n} edges {bits}-bit "
                                  f"{mode} 64-bit counters",
                                  kn.quantize_mat_cuda(a, bits, seed, noise),
                                  want, bits)
            codes, scales = want
            st = scales.T.contiguous()
            cuda, plain = ((kn.transpose4_cuda, kn.transpose4_plain)
                           if bits == 4 else
                           (kn.transpose8_cuda, kn.transpose8_plain))
            rep.exact(f"transpose{bits}", f"{m}x{n} edges (+-qmax, 0)",
                      (cuda(codes), st), (plain(codes), st), bits)


def check_cell_quantize(rep: Report, gen, seed: int):
    """quantize_mat at the solve cell's CELL_PHI, 4- and 8-bit, SR and
    deterministic: bit-identical to its plain version (whose int64 Philox
    words take ~40 GB here, so it runs last in phase 2, with the
    allocator's cache emptied)."""
    import torch
    from clover_tpu_torch import kernels as kn
    torch.cuda.empty_cache()
    m, n = CELL_PHI
    a = torch.rand(m, n, generator=gen, device=gen.device) * 2 - 1
    for bits in (4, 8):
        for mode, noise in (("SR", True), ("det", False)):
            want = kn.quantize_mat_plain(a, bits, seed, noise)
            torch.cuda.empty_cache()
            rep.exact("quantize_mat", f"{m}x{n} {bits}-bit {mode}",
                      kn.quantize_mat_cuda(a, bits, seed, noise), want, bits)
            del want
            torch.cuda.empty_cache()


def check_transpose(rep: Report, qphi):
    """-> {bits: (PhiT codes, PhiT scales)} from the kernels."""
    from clover_tpu_torch.kernels import (transpose4_cuda, transpose4_plain,
                                          transpose8_cuda, transpose8_plain)
    phit = {}
    for bits, cuda, plain in ((4, transpose4_cuda, transpose4_plain),
                              (8, transpose8_cuda, transpose8_plain)):
        q, name = qphi[bits], f"transpose{bits}"
        st = q.scales.T.contiguous()
        phit[bits] = (cuda(q.codes), st)
        rep.exact(name, f"{M}x{N}", phit[bits], (plain(q.codes), st), bits)
        # 8-bit codes transpose as a byte matrix: one torch call does it
        rep.time(name, lambda: cuda(q.codes), lambda: plain(q.codes),
                 2 * M * N * bits // 8,
                 library=(lambda: q.codes.t().contiguous()) if bits == 8
                 else None)
    return phit


def check_mvm(rep: Report, qphi, phit, qy, qx, modes):
    """Both legs of every mode, with and without the AXPY; -> {mode: the
    PhiT leg's output}, a solver iterate."""
    iterates = {}
    for bits_a, bits_x in ((4, 4), (4, 8), (8, 8)):
        mode, name = f"{bits_a}x{bits_x}", f"mvm{bits_x}"
        cuda, plain = mvm_forms(bits_a, bits_x)
        a, y, x = qphi[bits_a], qy[bits_x], qx[bits_x]
        leg1 = (a.codes, a.scales, x.codes, x.scales, y.codes, y.scales, -1.0)
        mu = config("4" if bits_x == 4 else "8" if bits_a == 8 else "4x8")[3]
        for what, seed, noise in modes:
            s2 = seed + 1
            t2 = cuda(*leg1, seed, noise, s2, noise)
            rep.exact(name, f"{mode} Phi leg alpha=-1 {what}", t2,
                      plain(*leg1, seed, noise, s2, noise), bits_x)
            leg2 = (*phit[bits_a], *t2, x.codes, x.scales, mu)
            rep.exact(name, f"{mode} PhiT leg alpha=mu {what}",
                      cuda(*leg2, seed, noise, s2, noise),
                      plain(*leg2, seed, noise, s2, noise), bits_x)
            rep.exact(name, f"{mode} Phi mvm (no AXPY) {what}",
                      cuda(*leg1[:4], seed1=seed, noise1=noise),
                      plain(*leg1[:4], seed1=seed, noise1=noise), bits_x)
        leg2 = (*phit[bits_a], *cuda(*leg1), x.codes, x.scales, mu)
        iterates[mode] = cuda(*leg2)
        # the per-kernel time is the Phi leg of its heaviest mode (8x8 for
        # mvm8); every leg's time is printed
        if mode != "4x8":
            rep.time(name, lambda: cuda(*leg1, 1, True, 2, True),
                     lambda: plain(*leg1, 1, True, 2, True),
                     mvm_bytes(M, N, bits_a, bits_x), ops=2 * M * N)
        rep.time_leg(mode, "Phi", lambda: cuda(*leg1, 1, True, 2, True))
        rep.time_leg(mode, "PhiT", lambda: cuda(*leg2, 1, True, 2, True))
    return iterates


def f32_operands(a, x, bits_a: int, bits_x: int, shape=None):
    """(codes, scales) of a bits_a-bit matrix and bits_x-bit vectors x
    (1-D, or a stack), cut to ``shape`` = (rows, cols), multiples of 64
    (a shard's block; the quantizers pad to 128)."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch.formats import pad_to
    qa = a if isinstance(a, tt.QMat4 | tt.QMat8) else tt.quantize(a, bits_a)
    m, n = shape or (qa.rows_pad, qa.cols_pad)
    ac = qa.codes[:m, :n * bits_a // 8].contiguous()
    asc = qa.scales[:m // 64, :n // 64].contiguous()
    rows = x if x.dim() == 2 else x[None]
    xq = [tt.quantize(torch.nn.functional.pad(r, (0, pad_to(n) - r.shape[0]))
                      if r.shape[0] < n else r[:n], bits_x) for r in rows]
    xc = torch.stack([q.codes[:n * bits_x // 8] for q in xq]).contiguous()
    xs = torch.stack([q.scales[:n // 64] for q in xq]).contiguous()
    return ac, asc, (xc if x.dim() == 2 else xc[0]), \
        (xs if x.dim() == 2 else xs[0])


def check_mvm_f32(rep: Report, qphi, mats, gen):
    """The f32-output modes: mvm_f32 (4x4, 4x8, 8x8) at M x N, on every
    block phase 14 gives it (SHARD, SERVER_SHARD, PERF_SHARDS) and on
    64-multiple ragged blocks, and mvm_batched_f32 at NS x NS (B = 2, 8,
    32), M x N (B = 8), the served matrices' block (SERVER_BATCHES) and a
    ragged block (B = 3), all bit-identical to their plain versions; times
    of the single mode at M x N and on the shard, and of the batched mode
    at M x N, B = BATCH."""
    import torch
    from clover_tpu_torch.kernels import (mvm_batched_f32_cuda,
                                          mvm_batched_f32_plain,
                                          mvm_f32_cuda, mvm_f32_plain)
    dev = gen.device
    xf = torch.rand(max(32, BATCH), NS, generator=gen, device=dev) * 2 - 1
    ragged = torch.rand(200, 300, generator=gen, device=dev) * 2 - 1
    for bits_a, bits_x in MODES:
        mode = f"{bits_a}x{bits_x}"
        cases = [(f"{M}x{N}", qphi[bits_a], None),
                 (f"{SHARD[0]}x{SHARD[1]} shard", qphi[bits_a], SHARD),
                 (f"{SERVER_SHARD[0]}x{SERVER_SHARD[1]} server shard",
                  mats[bits_a], SERVER_SHARD),
                 *((f"{r}x{c} -p shard", qphi[bits_a], (r, c))
                   for r, c in PERF_SHARDS),
                 ("192x320 block", ragged, (192, 320)),
                 ("200x300 padded", ragged, None)]
        for shape, a, cut in cases:
            ops = f32_operands(a, xf[0], bits_a, bits_x, cut)
            rep.exact("mvm_f32", f"{mode} {shape}", mvm_f32_cuda(
                bits_a, bits_x, *ops), mvm_f32_plain(bits_a, bits_x, *ops))
        bcases = [(f"{NS}x{NS} B={b}", mats[bits_a], xf[:b], None)
                  for b in F32_BATCHES + PARTIAL_BATCHES]
        for m, n in MVM_EDGES:
            edge = torch.rand(m, n, generator=gen, device=dev) * 2 - 1
            xe = torch.rand(32, n, generator=gen, device=dev) * 2 - 1
            bcases += [(f"{m}x{n} B={b}", edge, xe[:b], None)
                       for b in PARTIAL_BATCHES + (32,)]
        bcases += [(f"{M}x{N} B={BATCH}", qphi[bits_a], xf[:BATCH, :N], None),
                   ("192x320 block B=3", ragged, xf[:3, :320], (192, 320))]
        bcases += [(f"{SERVER_SHARD[0]}x{SERVER_SHARD[1]} server shard B={b}",
                    mats[bits_a], xf[:b], SERVER_SHARD)
                   for b in SERVER_BATCHES]
        for shape, a, x, cut in bcases:
            ops = f32_operands(a, x, bits_a, bits_x, cut)
            rep.exact("mvm_batched_f32", f"{mode} {shape}",
                      mvm_batched_f32_cuda(bits_a, bits_x, *ops).reshape(-1),
                      mvm_batched_f32_plain(bits_a, bits_x, *ops).reshape(-1))
    single = f32_operands(qphi[4], xf[0, :N], 4, 4)
    rep.time("mvm_f32", lambda: mvm_f32_cuda(4, 4, *single),
             lambda: mvm_f32_plain(4, 4, *single),
             M * N // 2 + 4 * (M // 64) * (N // 64) + qbytes(N, 4) + 4 * M,
             ops=2 * M * N)
    # the shard's 8.4 MB would stay in the 50 MB L2: launches rotate
    # through copies that together pass 512 MB, as -p's rows do
    shard = f32_operands(qphi[4], xf[0, :N], 4, 4, SHARD)
    rows, cols = SHARD
    nbytes = rows * cols // 2 + 4 * (rows // 64) * (cols // 64) + \
        qbytes(cols, 4) + 4 * rows
    ring = [[t.clone() for t in shard] for _ in range(-(-(512 << 20)
                                                       // nbytes))]
    turn = iter(range(1 << 30))
    ms = median_ms(lambda: mvm_f32_cuda(4, 4, *ring[next(turn) % len(ring)]),
                   5, 20)
    del ring
    from clover_tpu_torch.kernels import mvm as kmvm
    ctas = kmvm.launch_geometry(rows, kmvm.rows_per_warp(
        rows, torch.cuda.get_device_properties(0).multi_processor_count))[0]
    print(f"  mvm_f32       4x4 {rows}x{cols} (a 2x4 shard, {ctas} CTAs, a "
          f"ring of copies past the L2): kernel {ms:.4f} ms, "
          f"{nbytes / ms / 1e6:.1f} GB/s, bytes bound "
          f"{nbytes / hbm_rate() * 1e3:.4f} ms")
    batch = f32_operands(qphi[4], xf[:BATCH, :N], 4, 4)
    rep.time("mvm_batched_f32",
             lambda: mvm_batched_f32_cuda(4, 4, *batch),
             lambda: mvm_batched_f32_plain(4, 4, *batch),
             M * N // 2 + 4 * (M // 64) * (N // 64)
             + BATCH * (qbytes(N, 4) + 4 * M), ops=2 * M * N * BATCH)


def check_threshold(rep: Report, iterates, xf, gen):
    """A solver iterate, integer-valued data, a tie storm, k > nnz, dense
    SR data; k in {K, 1, 0}."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch.kernels import (threshold4_cuda, threshold4_plain,
                                          threshold8_cuda, threshold8_plain)
    dev = xf.device
    ints = torch.randint(-3, 4, (N,), generator=gen, device=dev).float()
    storm = torch.rand(N // 64, generator=gen, device=dev).repeat_interleave(64)
    sparse = torch.zeros(N, device=dev)
    sparse[torch.randperm(N, generator=gen, device=dev)[:K // 2]] = 1.0
    for bits, it, cuda, plain in (
            (4, iterates["4x4"], threshold4_cuda, threshold4_plain),
            (8, iterates["8x8"], threshold8_cuda,
             lambda c, s, k: threshold8_plain(c, s, k, N))):
        name = f"threshold{bits}"
        cases = [("solver iterate", it),
                 ("integer-valued", tt.quantize(ints, bits)),
                 ("tie storm", tt.quantize(storm, bits)),
                 ("k > nnz", tt.quantize(sparse, bits)),
                 ("dense SR", tt.quantize(xf, bits, generator=gen))]
        for what, q in cases:
            c, s = (q if isinstance(q, tuple) else (q.codes, q.scales))
            for k in (K, 1, 0):
                rep.exact(name, f"n={N} k={k} {what}",
                          (cuda(c, s, k), s), (plain(c, s, k), s), bits)
        rep.time(name, lambda: cuda(*it, K), lambda: plain(*it, K),
                 qbytes(N, bits) + N * bits // 8)


def check_select_edges(rep: Report, gen):
    """The thresholds at the select's edge cases, bit-identical to the
    plain versions: n just under, at and just over the resident path's
    limit; n = 2^19 with K = 300 (the radix select; the hybrid takes K <=
    256 only); stacked B = 1 and 32; 8-bit codes all at +-127; subnormal
    and vanishing s / qmax."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch.kernels import (threshold4_cuda, threshold4_plain,
                                          threshold8_cuda, threshold8_plain)
    dev = gen.device
    for bits, cuda, plain in (
            (4, threshold4_cuda, threshold4_plain),
            (8, threshold8_cuda,
             lambda c, s, k: threshold8_plain(c, s, k, c.shape[-1]))):
        name = f"threshold{bits}"

        def exact(what, c, s, k):
            rep.exact(name, what, flat((cuda(c, s, k), s)),
                      flat((plain(c, s, k), s)), bits, say=False)

        for n in SELECT_EDGES + (1 << 19,):
            dense = tt.quantize(torch.randn(n, generator=gen, device=dev),
                                bits, generator=gen)
            storm = tt.quantize(torch.rand(n // 64, generator=gen,
                                           device=dev).repeat_interleave(64),
                                bits)
            for k in ((300, 64) if n == 1 << 19 else (1, n // 4, n)):
                for what, q in (("dense SR", dense), ("tie storm", storm)):
                    exact(f"n={n} k={k} {what}", q.codes, q.scales, k)
            print(f"  {name:13s} n={n}: dense SR and tie storm "
                  f"bit-identical")
        for b in (1, 32):
            q = tt.stack_vectors([tt.quantize(torch.randn(
                N, generator=gen, device=dev), bits, generator=gen)
                for _ in range(b)])
            for k in (K, 1):
                exact(f"B={b} n={N} k={k} stacked", q.codes, q.scales, k)
        q = tt.quantize(torch.randn(N, generator=gen, device=dev), bits,
                        generator=gen)
        cases = [("subnormal s/qmax", q.codes,
                  torch.full_like(q.scales, 1e-40)),
                 ("s/qmax = 0", q.codes, torch.full_like(q.scales, 1e-45))]
        if bits == 8:
            sign = torch.rand(N, generator=gen, device=dev) < 0.5
            top = torch.where(sign, 127, -127).to(torch.int8)
            cases.append(("every code +-127", top, q.scales))
        sa, sb, ca, cb = DIVISION_ORDER[bits]
        pair = torch.tensor([ca] * 64 + [cb] * 64, dtype=torch.int8,
                            device=dev).repeat(N // 128)
        scales = torch.tensor([sa, sb], dtype=torch.int32,
                              device=dev).view(torch.float32).repeat(N // 128)
        cases.append(("IEEE s/qmax order", tt.pack_nibbles(pair)
                      if bits == 4 else pair, scales))
        for what, c, s in cases:
            for k in (K, 1, N):
                exact(f"n={N} k={k} {what}", c, s, k)
        print(f"  {name:13s} stacked B = 1, 32; "
              f"{', '.join(w for w, _, _ in cases)}: bit-identical")


def check_restore(rep: Report, y, xf, gen):
    import clover_tpu_torch as tt
    from clover_tpu_torch.kernels import restore_vec_cuda, restore_vec_plain
    for bits in (4, 8):
        for v in (y, xf):
            for what, g in (("det", None), ("SR", gen)):
                q = tt.quantize(v, bits, generator=g)
                rep.exact("restore_vec", f"{v.numel()} {bits}-bit {what}",
                          restore_vec_cuda(q.codes, q.scales, bits),
                          restore_vec_plain(q.codes, q.scales, bits))
    q = tt.quantize(xf, 8)
    rep.time("restore_vec", lambda: restore_vec_cuda(q.codes, q.scales, 8),
             lambda: restore_vec_plain(q.codes, q.scales, 8),
             qbytes(N, 8) + 4 * N)


def check_ragged(rep: Report, gen, modes):
    """A logical 200x300: padding through every kernel."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch import kernels as kn
    dev = gen.device
    a = torch.rand(200, 300, generator=gen, device=dev) * 2 - 1
    ap = tt.formats.pad_matrix(a).contiguous()
    vp = tt.formats.pad_vector(a[0]).contiguous()
    for mode, seed, noise in modes:
        g = seed if noise else None
        for bits in (4, 8):
            rep.exact("quantize_mat", f"200x300 {bits}-bit {mode}",
                      kn.quantize_mat_cuda(ap, bits, seed, noise),
                      kn.quantize_mat_plain(ap, bits, seed, noise), bits)
            rep.exact("quantize_vec", f"300 {bits}-bit {mode}",
                      kn.quantize_vec_cuda(vp, bits, seed, noise),
                      kn.quantize_vec_plain(vp, bits, seed, noise), bits)
            qa = tt.quantize(a, bits, generator=g)
            sat = qa.scales.T.contiguous()
            cuda = kn.transpose4_cuda if bits == 4 else kn.transpose8_cuda
            plain = kn.transpose4_plain if bits == 4 else kn.transpose8_plain
            rep.exact(f"transpose{bits}", f"200x300 {mode}",
                      (cuda(qa.codes), sat), (plain(qa.codes), sat), bits)
            qv = tt.quantize(a[1], bits, generator=g)
            rep.exact("restore_vec", f"300 {bits}-bit {mode}",
                      kn.restore_vec_cuda(qv.codes, qv.scales, bits),
                      kn.restore_vec_plain(qv.codes, qv.scales, bits))
            cuda, plain = ((kn.threshold4_cuda, kn.threshold4_plain)
                           if bits == 4 else
                           (kn.threshold8_cuda,
                            lambda c, s, k: kn.threshold8_plain(c, s, k, 300)))
            rep.exact(f"threshold{bits}", f"n=300 k=50 {mode}",
                      (cuda(qv.codes, qv.scales, 50), qv.scales),
                      (plain(qv.codes, qv.scales, 50), qv.scales), bits)
        for bits_a, bits_x in ((4, 4), (4, 8), (8, 8)):
            qa = tt.quantize(a, bits_a, generator=g)
            qv = tt.quantize(a[1], bits_x)
            qu = tt.quantize(a[:, 2], bits_x)
            cuda, plain = mvm_forms(bits_a, bits_x)
            args = (qa.codes, qa.scales, qv.codes, qv.scales, qu.codes,
                    qu.scales, 0.37, seed, noise, seed + 1, noise)
            rep.exact(f"mvm{bits_x}", f"{bits_a}x{bits_x} 200x300 alpha=0.37 "
                      f"{mode}", cuda(*args), plain(*args), bits_x)
            rep.exact(f"mvm{bits_x}", f"{bits_a}x{bits_x} 200x300 no AXPY "
                      f"{mode}", cuda(*args[:4], seed1=seed, noise1=noise),
                      plain(*args[:4], seed1=seed, noise1=noise), bits_x)


def flat(pair):
    """(codes, scales) of a stacked batch as one flat vector, for
    Report.exact."""
    codes, scales = pair
    return codes.reshape(-1), scales.reshape(-1)


def check_axpy(rep: Report, gen, qphi, qy, qx, modes):
    """The standalone AXPY against its plain version, single and stacked;
    mvm -> scale_and_add through two kernels against the fused mvm_axpy."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch.kernels import axpy_cuda, axpy_plain
    dev = gen.device
    stacked = {}
    for bits in (4, 8):
        us, vs = (tt.stack_vectors([
            tt.quantize(torch.randn(N, generator=gen, device=dev), bits,
                        generator=gen) for _ in range(BATCH)])
            for _ in range(2))
        stacked[bits] = (*flat((us.codes, us.scales)),
                         *flat((vs.codes, vs.scales)))
        single = (us.codes[0], us.scales[0], vs.codes[0], vs.scales[0])
        for what, seed, noise in modes:
            for shape, ops in ((f"{N}", single),
                               (f"{BATCH}x{N} stacked", stacked[bits])):
                args = (*ops, -0.73, bits, seed, noise)
                rep.exact("axpy", f"{shape} {bits}-bit {what}",
                          axpy_cuda(*args), axpy_plain(*args), bits)
    for bits_a, bits_x in MODES:
        a, x, u = qphi[bits_a], qx[bits_x], qy[bits_x]
        for what, seed, noise in modes:
            g1, g2 = (seed, seed + 1) if noise else (None, None)
            two = tt.scale_and_add(u, tt.mvm(a, x, g1), -1.0, g2)
            fused = tt.mvm_axpy(a, x, u, -1.0, g1, g2)
            rep.exact("axpy", f"{bits_a}x{bits_x} mvm+axpy = mvm_axpy {what}",
                      (two.codes, two.scales), (fused.codes, fused.scales),
                      bits_x)
    args = (*stacked[4], -0.73, 4, 1, True)
    rep.time("axpy", lambda: axpy_cuda(*args), lambda: axpy_plain(*args),
             3 * BATCH * qbytes(N, 4))


def stacked_requests(gen, count: int, n: int, bits: int):
    """``count`` quantized random vectors of length n, stacked."""
    import torch
    import clover_tpu_torch as tt
    f = torch.rand(count, n, generator=gen, device=gen.device) * 2 - 1
    return tt.stack_vectors([tt.quantize(f[j], bits) for j in range(count)])


def check_mvm_batched(rep: Report, gen, qphi, mats, modes):
    """The batched MVM against B per-vector plain MVMs (seeds seed + j),
    and its per-vector time against single-kernel calls."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch.kernels import (mvm4_cuda, mvm_batched_cuda,
                                          mvm_batched_plain)
    dev = gen.device
    xs = {bits: stacked_requests(gen, max(BATCH_SIZES), NS, bits)
          for bits in (4, 8)}
    ragged = torch.rand(200, 300, generator=gen, device=dev) * 2 - 1
    for bits_a, bits_x in MODES:
        mode, bits_out = f"{bits_a}x{bits_x}", 4 if bits_x == 4 else 8
        x = xs[bits_x]
        cases = [(f"{NS}x{NS} B={b}", mats[bits_a], x.codes[:b],
                  x.scales[:b]) for b in BATCH_SIZES + PARTIAL_BATCHES]
        cases.append((f"{M}x{N} B={BATCH}", qphi[bits_a], x.codes[:BATCH],
                      x.scales[:BATCH]))
        for m, n in MVM_EDGES:
            qa = tt.quantize(torch.rand(m, n, generator=gen, device=dev) * 2
                             - 1, bits_a)
            xe = stacked_requests(gen, 32, n, bits_x)
            cases += [(f"{m}x{n} B={b}", qa, xe.codes[:b], xe.scales[:b])
                      for b in PARTIAL_BATCHES + (32,)]
        for what, seed, noise in modes:
            qa = tt.quantize(ragged, bits_a, generator=seed if noise else None)
            xr = tt.stack_vectors([tt.quantize(ragged[j], bits_x)
                                   for j in range(3)])
            for shape, a, xc, xsc in cases + [
                    ("200x300 B=3", qa, xr.codes, xr.scales)]:
                args = (bits_a, bits_x, a.codes, a.scales, xc, xsc, seed,
                        noise)
                rep.exact("mvm_batched", f"{mode} {shape} {what}",
                          flat(mvm_batched_cuda(*args)),
                          flat(mvm_batched_plain(*args)), bits_out)
    a, x = qphi[4], xs[4]
    args = (4, 4, a.codes, a.scales, x.codes[:BATCH], x.scales[:BATCH], 1,
            True)
    rep.time("mvm_batched", lambda: mvm_batched_cuda(*args),
             lambda: mvm_batched_plain(*args),
             M * N // 2 + 4 * (M // 64) * (N // 64)
             + BATCH * (qbytes(N, 4) + qbytes(M, 4)), ops=2 * M * N * BATCH)
    a = mats[4]
    single = median_ms(lambda: mvm4_cuda(a.codes, a.scales, x.codes[0],
                                         x.scales[0], seed1=1, noise1=True),
                       5, 20)
    print(f"  mvm_batched 4x4 {NS}x{NS} SR: single-vector kernel "
          f"{single:.4f} ms")
    for b in SWEEP:
        ms = median_ms(lambda: mvm_batched_cuda(4, 4, a.codes, a.scales,
                                                x.codes[:b], x.scales[:b], 1,
                                                True), 5, 20)
        rep.sweep[b] = ms
        print(f"  mvm_batched 4x4 {NS}x{NS} B={b:2d}: {ms:.4f} ms, "
              f"{ms / b:.4f} ms per vector, {single * b / ms:.2f}x the "
              f"throughput of {b} single-kernel calls")


def check_threshold_batched(rep: Report, gen):
    """Stacked thresholds (dense SR rows, integer-valued, tie storm,
    k > nnz) against the per-row plain versions."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch.kernels import (threshold4_cuda, threshold4_plain,
                                          threshold8_cuda, threshold8_plain)
    dev = gen.device
    ints = torch.randint(-3, 4, (N,), generator=gen, device=dev).float()
    storm = torch.rand(N // 64, generator=gen, device=dev).repeat_interleave(64)
    sparse = torch.zeros(N, device=dev)
    sparse[torch.randperm(N, generator=gen, device=dev)[:K // 2]] = 1.0
    for bits, cuda, plain in (
            (4, threshold4_cuda, threshold4_plain),
            (8, threshold8_cuda,
             lambda c, s, k: threshold8_plain(c, s, k, N))):
        rows = [tt.quantize(torch.randn(N, generator=gen, device=dev), bits,
                            generator=gen) for _ in range(BATCH - 3)]
        rows += [tt.quantize(v, bits) for v in (ints, storm, sparse)]
        q = tt.stack_vectors(rows)
        for k in (K, 1, 0):
            rep.exact(f"threshold{bits}", f"B={BATCH} n={N} k={k} stacked",
                      flat((cuda(q.codes, q.scales, k), q.scales)),
                      flat((plain(q.codes, q.scales, k), q.scales)), bits)
        ms = median_ms(lambda: cuda(q.codes, q.scales, K), 5, 20)
        print(f"  threshold{bits}   B={BATCH} n={N} K={K} stacked: kernel "
              f"{ms:.4f} ms")


def small_problem(gen, m: int, n: int, bits_x: int):
    """(Phi, PhiT, y, x) operand pairs of an m x n 4-bit problem with
    bits_x-bit y and x: Phi quantized with SR, x a dense iterate."""
    import torch
    import clover_tpu_torch as tt
    dev = gen.device
    q = tt.quantize(torch.rand(m, n, generator=gen, device=dev) * 2 - 1, 4,
                    generator=gen)
    qy = tt.quantize(torch.rand(m, generator=gen, device=dev) * 2 - 1, bits_x)
    qx = tt.quantize(torch.randn(n, generator=gen, device=dev), bits_x)
    return [(v.codes, v.scales) for v in (q, tt.transpose(q), qy, qx)]


def unfused_chain(bits_x: int, ops, mu: float, k, seeds, noise: bool):
    """The chain's iterations through the MVM and threshold kernels."""
    from clover_tpu_torch import kernels as kn
    cuda = mvm_forms(4, bits_x)[0]
    phi, phit, y, x = ops
    for it in range(len(seeds) // 4):
        s = seeds[4 * it:4 * it + 4]
        t2 = cuda(*phi, *x, *y, -1.0, s[0], noise, s[1], noise)
        x = cuda(*phit, *t2, *x, mu, s[2], noise, s[3], noise)
        if k is not None:
            thr = kn.threshold4_cuda if bits_x == 4 else kn.threshold8_cuda
            x = thr(*x, k), x[1]
    return x


def check_iteration(rep: Report, gen, modes):
    """The whole-iteration and chained kernels against their plain
    versions and the unfused kernel sequence; the whole iteration at 1 and
    7 clusters and the default grid (a cluster per band of the larger leg,
    capped by the co-resident CTAs)."""
    from clover_tpu_torch.kernels import iteration as it
    mu = 0.0005050158681869508   # the tuned 4-bit mu at 4096x8192
    print("  iteration     co-resident CTAs (clusters x CTAs): " + ", ".join(
        f"4x{bx} {'chain' if chained else 'whole'} "
        f"{it.co_resident(0, 4, bx, chained)}"
        for bx in (4, 8) for chained in (False, True)))
    for m, n in SMALL:
        for bits_x in (4, 8):
            ops = small_problem(gen, m, n, bits_x)
            mode = f"4x{bits_x} {m}x{n}"
            for what, seed, noise in modes:
                seeds = [seed + 17 * j for j in range(4 * CHAIN)]
                flags = (noise,) * 4
                want = it.iteration_plain(4, bits_x, *ops, mu, seeds[:4],
                                          flags)
                for grid in (None, it.CHAIN_CLUSTER, 7 * it.CHAIN_CLUSTER):
                    rep.exact("iteration", f"{mode} grid={grid} {what}",
                              it.iteration_cuda(4, bits_x, *ops, mu,
                                                seeds[:4], flags, grid=grid),
                              want, bits_x)
                rep.exact("iteration", f"{mode} = unfused {what}", want,
                          unfused_chain(bits_x, ops, mu, None, seeds[:4],
                                        noise), bits_x)
                for k in (n // 4, None):
                    got = it.iteration_chain_cuda(4, bits_x, *ops, mu, k,
                                                  seeds, flags)
                    rep.exact("iteration_chain", f"{mode} k={k} {what}", got,
                              it.iteration_chain_plain(4, bits_x, *ops, mu, k,
                                                       seeds, flags), bits_x)
                    rep.exact("iteration_chain", f"{mode} k={k} = unfused "
                              f"{what}", got, unfused_chain(
                                  bits_x, ops, mu, k, seeds, noise), bits_x)
            one = median_ms(lambda: it.iteration_cuda(
                4, bits_x, *ops, mu, [1, 2, 3, 4], (True,) * 4), 5, 20)
            chain = median_ms(lambda: it.iteration_chain_cuda(
                4, bits_x, *ops, mu, n // 4, list(range(4 * CHAIN)),
                (True,) * 4), 5, 20)
            legs = median_ms(lambda: unfused_chain(
                bits_x, ops, mu, n // 4, [1, 2, 3, 4], True), 5, 20)
            print(f"  iteration     4x{bits_x} {m}x{n} SR: whole iteration "
                  f"{one:.4f} ms, chain of {CHAIN} {chain:.4f} ms "
                  f"({chain / CHAIN:.4f} per iteration), unfused legs + "
                  f"threshold {legs:.4f} ms")
            if (m, n, bits_x) == (*SMALL[0], 4):
                pair = 2 * (m * n // 2 + 4 * (m // 64) * (n // 64))
                vecs = qbytes(m, 4) + 2 * qbytes(n, 4)
                rep.time("iteration", lambda: it.iteration_cuda(
                    4, 4, *ops, mu, [1, 2, 3, 4], (True,) * 4),
                    lambda: it.iteration_plain(4, 4, *ops, mu, [1, 2, 3, 4],
                                               (True,) * 4),
                    pair + vecs, ops=4 * m * n)
                # every input read once (the pair fits in the 50 MB L2)
                rep.time("iteration_chain", lambda: it.iteration_chain_cuda(
                    4, 4, *ops, mu, n // 4, list(range(4 * CHAIN)),
                    (True,) * 4),
                    lambda: it.iteration_chain_plain(
                        4, 4, *ops, mu, n // 4, list(range(4 * CHAIN)),
                        (True,) * 4),
                    pair + vecs, ops=4 * m * n * CHAIN)
    for m, n, bits_x, chain, clusters in CHAIN_EDGES:
        ops = small_problem(gen, m, n, bits_x)
        grid = None if clusters is None else clusters * it.CHAIN_CLUSTER
        mode = f"4x{bits_x} {m}x{n} chain={chain} grid={grid}"
        for what, seed, noise in modes:
            seeds = [seed + 17 * j for j in range(4 * chain)]
            flags = (noise,) * 4
            for k in (n // 4, None):
                rep.exact("iteration_chain", f"{mode} k={k} {what}",
                          it.iteration_chain_cuda(4, bits_x, *ops, mu, k,
                                                  seeds, flags, grid=grid),
                          it.iteration_chain_plain(4, bits_x, *ops, mu, k,
                                                   seeds, flags), bits_x)
        if (m, n) == (8192, 8192):
            ms = median_ms(lambda: it.iteration_chain_cuda(
                4, bits_x, *ops, mu, n // 4, list(range(4 * chain)),
                (True,) * 4), 5, 20)
            print(f"  iteration     4x{bits_x} {m}x{n} SR: chain of {chain} "
                  f"{ms:.4f} ms ({ms / chain:.4f} per iteration)")


def check_restore_mat(rep: Report, phi, gen):
    """Matrix restore at the main path's 8192x16384 and a ragged 200x300,
    on SR-quantized matrices: bit-identical."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch.kernels import restore_mat_cuda, restore_mat_plain
    ragged = torch.rand(200, 300, generator=gen, device=gen.device) * 2 - 1
    for a, shape in ((phi, f"{M}x{N}"), (ragged, "200x300")):
        for bits in (4, 8):
            q = tt.quantize(a, bits, generator=gen)
            rep.exact("restore_mat", f"{shape} {bits}-bit SR",
                      restore_mat_cuda(q.codes, q.scales, bits),
                      restore_mat_plain(q.codes, q.scales, bits))
    q = tt.quantize(phi, 4, generator=gen)
    rep.time("restore_mat", lambda: restore_mat_cuda(q.codes, q.scales, 4),
             lambda: restore_mat_plain(q.codes, q.scales, 4),
             M * N // 2 + 4 * (M // 64) * (N // 64) + 4 * M * N)


def check_dot(rep: Report, gen):
    """The dot kernel bit-identical to its plain version in the kernel's
    order (dot_plain_ordered) at the default grid and at 2 and 7 CTAs,
    within DOT_RTOL of the terms' absolute sum of the torch-order plain
    version, two calls bit-identical, and against the port's golden.dot at
    n <= 65536 within the reference's 0.02 max(1, |ref|/10); timed at n =
    16384 and 2^24, back to back (the 2^24 pair fits in the 50 MB L2) and
    rotating through copies past the L2."""
    import itertools
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch import golden
    from clover_tpu_torch.kernels import (dot_cuda, dot_plain,
                                          dot_plain_ordered, dot_terms)
    dev = gen.device
    timed = {}
    for n in DOT_SIZES:
        for bits in (4, 8):
            u, v = (tt.quantize(torch.rand(n, generator=gen, device=dev) * 2
                                - 1, bits, generator=gen) for _ in range(2))
            ops = (u.codes, u.scales, v.codes, v.scales, bits)
            got, again = dot_cuda(*ops), dot_cuda(*ops)
            for grid in (2, 7):
                rep.exact("dot", f"n={n} {bits}-bit grid={grid}",
                          dot_cuda(*ops, grid=grid), got, say=False)
            rep.exact("dot", f"n={n} {bits}-bit = ordered plain", got,
                      dot_plain_ordered(*ops), say=False)
            terms = dot_terms(*ops)
            gap = float((got - terms.sum()).abs())
            tol = DOT_RTOL * float(terms.abs().sum())
            if gap > tol or not torch.equal(got.view(torch.int32),
                                            again.view(torch.int32)):
                raise AssertionError(f"dot n={n} {bits}-bit: |kernel - "
                                     f"plain| {gap} > {tol}, or two calls "
                                     f"differ")
            line = (f"  dot           n={n} {bits}-bit: {float(got):.7g}, "
                    f"bit-identical to the ordered plain version at grids "
                    f"2, 7 and the default; |kernel - torch-order plain| "
                    f"{gap:.3g} <= {tol:.3g}, repeat bit-identical")
            if n <= 65536:
                ref = float(golden.dot(*(codes_of(c, bits).cpu().numpy()
                                         if c.dtype == torch.int8
                                         else c.cpu().numpy()
                                         for c in ops[:4]), bits))
                lim = 0.02 * max(1.0, abs(ref) / 10)
                if abs(float(got) - ref) > lim:
                    raise AssertionError(f"dot n={n} {bits}-bit: {float(got)}"
                                         f" vs golden {ref}")
                line += f", golden {ref:.7g}"
            print(line)
            if n >= 16384:
                timed[n, bits] = ops
    for (n, bits), ops in timed.items():
        warm = median_ms(lambda: dot_cuda(*ops), 5, 20)
        per = sum(t.nbytes for t in ops[:4])
        ring = [[t.clone() for t in ops[:4]]
                for _ in range(min(4096, -(-RING_BYTES // per)))]
        turn = itertools.count()
        rot = median_ms(lambda: dot_cuda(*ring[next(turn) % len(ring)],
                                         bits), 5, 20)
        print(f"  dot           n={n} {bits}-bit: back to back {warm:.4f} "
              f"ms, rotating through {len(ring)} copies {rot:.4f} ms, "
              f"bound {per / hbm_rate() * 1e3:.4f} ms")
        del ring
        if (n, bits) == (1 << 24, 4):
            rep.rotating_ms["dot"] = rot
    ops = timed[1 << 24, 4]
    rep.time("dot", lambda: dot_cuda(*ops), lambda: dot_plain(*ops),
             2 * qbytes(1 << 24, 4) + 4)


def hybrid_data(gen, n: int, k: int):
    """Uniform, integer-valued in [-3, 3] (tie storms) and k > nnz data."""
    import torch
    dev = gen.device
    sparse = torch.zeros(n, device=dev)
    sparse[torch.randperm(n, generator=gen, device=dev)[:max(1, k // 2)]] = 1.0
    return (("uniform", torch.rand(n, generator=gen, device=dev) * 2 - 1),
            ("integer", torch.randint(-3, 4, (n,), generator=gen,
                                      device=dev).float()),
            ("k > nnz", sparse))


def check_hybrid(rep: Report, gen):
    """hist4 bit-identical to its plain version; mask4 likewise on the
    selector's (tau, fill, offsets); the whole hybrid through tt.threshold
    byte-identical to the radix kernel and its plain version; times of the
    split beside the radix kernel."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch import kernels as kn
    from clover_tpu_torch.ops import _core
    from clover_tpu_torch.ops.threshold import hybrid_select
    for n in HYBRID_SIZES:
        for k in HYBRID_KS:
            for what, v in hybrid_data(gen, n, k):
                q = tt.quantize(v, 4)
                h = kn.hist4_cuda(q.codes)
                if k == HYBRID_KS[0]:
                    rep.exact("hist4", f"n={n} {what}", h,
                              kn.hist4_plain(q.codes))
                m7 = _core.div(q.scales, 7.0)
                sel = hybrid_select(h, m7, k)
                rep.exact("mask4", f"n={n} k={k} {what}",
                          (kn.mask4_cuda(q.codes, m7, *sel), q.scales),
                          (kn.mask4_plain(q.codes, m7, *sel), q.scales))
                got = tt.threshold(q, k).codes
                radix = kn.threshold4_cuda(q.codes, q.scales, k)
                plain = kn.threshold4_plain(q.codes, q.scales, k)
                if not (torch.equal(got, radix) and torch.equal(got, plain)):
                    raise AssertionError(f"hybrid n={n} k={k} {what}: codes "
                                         f"differ from the radix kernel's or "
                                         f"its plain version's")
            print(f"  hybrid        n={n} k={k}: uniform, integer, k > nnz "
                  f"byte-identical to threshold4_cuda and threshold4_plain")
    for n, k in ((LARGE[1], LARGE[2]),) + HYBRID_TIMED:
        q = tt.quantize(torch.rand(n, generator=gen, device=gen.device) * 2
                        - 1, 4, generator=gen)
        m7 = _core.div(q.scales, 7.0)
        h = kn.hist4_cuda(q.codes)
        sel = hybrid_select(h, m7, k)
        without_host_sync(lambda: tt.threshold(q, k), f"hybrid n={n} k={k}")
        if (n, k) == (LARGE[1], LARGE[2]):
            # the large-n IHT's shape (phase 10) for the kernels line
            rep.time("hist4", lambda: kn.hist4_cuda(q.codes),
                     lambda: kn.hist4_plain(q.codes), n // 2 + 32 * (n // 64))
            rep.time("mask4", lambda: kn.mask4_cuda(q.codes, m7, *sel),
                     lambda: kn.mask4_plain(q.codes, m7, *sel),
                     n + 12 * (n // 64) + 12)
        t0 = time.perf_counter()
        for _ in range(20):
            tt.threshold(q, k)
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        torch.cuda.synchronize()
        # the whole op and the selector take longer to enqueue than to run:
        # the long spin keeps their windows on the device's clock
        split = {
            "whole op": median_ms(lambda: tt.threshold(q, k), 5, 20,
                                  HOST_SPIN_CYCLES),
            "hist4": median_ms(lambda: kn.hist4_cuda(q.codes), 5, 20),
            "selector": median_ms(lambda: hybrid_select(h, m7, k), 5, 20,
                                  HOST_SPIN_CYCLES),
            "mask4": median_ms(lambda: kn.mask4_cuda(q.codes, m7, *sel), 5,
                               20),
            "radix threshold4_cuda": median_ms(
                lambda: kn.threshold4_cuda(q.codes, q.scales, k), 5, 20)}
        print(f"  hybrid        n={n} K={k} device ms: " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in split.items())
            + f"; host {host_ms:.4f} ms to enqueue the whole op; no host "
              f"sync")


def without_host_sync(fn, what: str):
    """fn() with torch's sync debug mode raising on any host sync."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        raise AssertionError(f"{what} synchronizes with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")


def check_probes(rep: Report, qphi, gen):
    """dma_probe_cluster, dma_probe and salted_probe against their plain
    versions (bit for bit: an int32 band sum plus the salt) on the 4- and
    8-bit 8192x16384 codes and a ragged 200x300, the cluster probe also at
    MVM_EDGES and 2048x4096, the others on the 512 MB stack;
    dma_probe_stream's p and bytes; the launch probe; times over the 4-bit
    codes (the two dma probes, the Phi leg's stream) and their 512 MB stack
    (salted_probe)."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch.kernels import probes as pr
    dev = gen.device
    salt = torch.full((1,), 0.375, device=dev)
    ragged = torch.rand(200, 300, generator=gen, device=dev) * 2 - 1
    cases = [(f"{M}x{N} {b}-bit", qphi[b].codes) for b in (4, 8)]
    cases += [(f"200x300 {b}-bit", tt.quantize(ragged, b).codes)
              for b in (4, 8)]
    q = qphi[4]
    stacked, p = pr.stacked_codes(q)
    # the cluster probe also at the MVM's edge shapes (one band, 10 bands:
    # clusters of 8, 4 and 2 CTAs by csrc/mvm.cu's rule) and the large-n
    # leg's 2048 rows
    cluster_cases = [(f"{m}x{n} 4-bit", tt.quantize(
        torch.rand(m, n, generator=gen, device=dev) * 2 - 1, 4).codes)
        for m, n in (*MVM_EDGES, (2048, 4096))]
    for what, codes in cases + cluster_cases:
        rep.exact("dma_probe_cluster", what, pr.dma_probe_cluster_cuda(codes),
                  pr.dma_probe_cluster_plain(codes))
    for what, codes in cases + [(f"{p} x {M}x{N} 4-bit stacked", stacked)]:
        rep.exact("dma_probe", what, pr.dma_probe_cuda(codes),
                  pr.dma_probe_plain(codes))
        rep.exact("salted_probe", f"{what} salt 0.375",
                  pr.salted_probe_cuda(codes, salt),
                  pr.salted_probe_plain(codes, salt))
    make, nbytes, p_stream = pr.dma_probe_stream(q)
    want_p = -(-pr.RING_BYTES // q.codes.nbytes)
    if (p_stream, nbytes) != (want_p, want_p * q.codes.nbytes) or \
            p_stream != p:
        raise AssertionError(f"dma_probe_stream: p {p_stream}, {nbytes} "
                             f"bytes; expected p {want_p}")
    ends = {"dma_probe_stream make(3)": make(3)(),
            "launch_probe make(3)": pr.launch_probe()(3)(),
            "dma_probe_call make(3)": pr.dma_probe_call(q)[0](3)()}
    if not all(math.isfinite(v) for v in ends.values()):
        raise AssertionError(f"a probe chain ended in a non-finite {ends}")
    print(f"  probes        dma_probe_stream: p = {p_stream}, {nbytes} bytes "
          f"stacked; " + ", ".join(f"{k} -> {v:.7g}" for k, v in
                                   ends.items()))
    rep.time("dma_probe_cluster", lambda: pr.dma_probe_cluster_cuda(q.codes),
             lambda: pr.dma_probe_cluster_plain(q.codes),
             q.codes.nbytes + 4 * (M // 64))
    rep.time("dma_probe", lambda: pr.dma_probe_cuda(q.codes),
             lambda: pr.dma_probe_plain(q.codes),
             q.codes.nbytes + 4 * (M // 64))
    rep.time("salted_probe", lambda: pr.salted_probe_cuda(stacked, salt),
             lambda: pr.salted_probe_plain(stacked, salt),
             stacked.nbytes + 4 + 4 * (stacked.shape[0] // 64))
    one = torch.ones(64, 128, dtype=torch.int8, device=dev)
    print(f"  salted_probe  launch probe (one 64x128 tile): kernel "
          f"{median_ms(lambda: pr.salted_probe_cuda(one, salt), 5, 20):.4f} "
          f"ms")


def matmul_settings():
    """The caller's TF32 switches and fp32 matmul precision."""
    import torch
    try:
        precision = torch.get_float32_matmul_precision()
    except RuntimeError as e:          # legacy and new switches mixed
        precision = f"unreadable ({e})"
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, precision)


def set_tf32(on: bool):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


def check_tf32(phi, gen):
    """With TF32 requested by the caller, the port's f32 products (16- and
    32-bit tt.mvm, mvm_f32 of a 4-bit matrix and an f32 vector,
    mvm_sparse, and gemm_f32 with 8 columns) equal their results with TF32
    off bit for bit, and the caller's settings come back."""
    import torch
    import clover_tpu_torch as tt
    dev = phi.device
    x = torch.rand(N, generator=gen, device=dev) * 2 - 1
    q4 = tt.quantize(phi, 4)
    q16, q32 = tt.quantize(phi, 16), tt.quantize(phi, 32)
    x16, x32 = tt.quantize(x, 16), tt.quantize(x, 32)
    at = tt.transpose(tt.quantize(phi, 8))
    xs = tt.threshold(tt.quantize(x, 8), K)
    b = torch.rand(N, 8, generator=gen, device=dev) * 2 - 1
    cases = {
        "tt.mvm 16-bit": lambda: tt.mvm(q16, x16).values,
        "tt.mvm 32-bit": lambda: tt.mvm(q32, x32).values,
        "mvm_f32 4-bit A, f32 x": lambda: tt.mvm_f32(q4, x32),
        "mvm_sparse 8-bit, K nonzeros": lambda: (lambda y: torch.cat(
            [y.codes.view(torch.uint8), y.scales.view(torch.uint8)]))(
                tt.mvm_sparse(at, xs, K)),
        "gemm_f32 4-bit A, 8 columns": lambda: tt.gemm_f32(q4, b),
    }
    before = matmul_settings()
    try:
        set_tf32(False)
        want = {name: fn() for name, fn in cases.items()}
        set_tf32(True)
        asked = matmul_settings()
        got = {name: fn() for name, fn in cases.items()}
        after = matmul_settings()
        bare = q32.values @ b             # a product outside the pin
        set_tf32(False)
        ieee = q32.values @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        if not before[2].startswith("unreadable"):
            torch.set_float32_matmul_precision(before[2])
        torch.backends.cudnn.allow_tf32 = before[1]
    for name in cases:
        g, w = got[name].contiguous(), want[name].contiguous()
        if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
            raise AssertionError(f"{name}: with TF32 requested the result "
                                 f"differs from the IEEE one")
        print(f"  tf32          {name:32s} bit-identical with TF32 "
              f"requested")
    if after != asked:
        raise AssertionError(f"settings {asked} came back as {after}")
    print(f"  tf32          caller's settings {asked} restored; a bare "
          f"product with TF32 on differs from IEEE by "
          f"{float((bare - ieee).abs().max()):.3g} (the pin's reason)")



def phase_kernels(rep: Report, phi, mats, gen):
    """Every kernel against its plain version, on the main paths' shapes."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch.kernels import seed_from
    print("== 2. kernels against their plain versions on the card")
    dev = phi.device
    y = torch.rand(M, generator=gen, device=dev) * 2 - 1
    xf = torch.randn(N, generator=gen, device=dev)
    modes = [("det", 0, False), ("SR", seed_from(gen)[0], True)]
    check_quantize(rep, phi, y, xf, modes)
    check_restore(rep, y, xf, gen)
    qphi = {bits: tt.quantize(phi, bits) for bits in (4, 8)}
    phit = check_transpose(rep, qphi)
    check_setup_edges(rep, gen, modes)
    qy = {bits: tt.quantize(y, bits) for bits in (4, 8)}
    qx = {bits: tt.quantize(xf, bits) for bits in (4, 8)}
    iterates = check_mvm(rep, qphi, phit, qy, qx, modes)
    check_mvm_edges(rep, gen, modes)
    check_threshold(rep, iterates, xf, gen)
    check_select_edges(rep, gen)
    check_ragged(rep, gen, modes)
    check_axpy(rep, gen, qphi, qy, qx, modes)
    check_mvm_batched(rep, gen, qphi, mats, modes)
    check_mvm_f32(rep, qphi, mats, gen)
    check_threshold_batched(rep, gen)
    check_iteration(rep, gen, modes)
    check_restore_mat(rep, phi, gen)
    check_dot(rep, gen)
    check_hybrid(rep, gen)
    check_probes(rep, qphi, gen)
    check_tf32(phi, gen)
    check_cell_quantize(rep, gen, seed_from(gen)[0])


def recovery_error(x, x_star) -> float:
    """||restore(x) - x*|| / ||x*||, restored on the host."""
    import torch
    import clover_tpu_torch as tt
    xr = tt.restore(tt.to_device(x, "cpu")).values[:x_star.shape[0]]
    xs = x_star.cpu()
    return float(torch.linalg.norm(xr - xs) / torch.linalg.norm(xs))


def expected_counts(bits_a: int, bits_v: int, iters: int, traced: bool):
    counts = dict.fromkeys(KERNEL_INFO, 0)
    counts["quantize_mat"] = counts["quantize_vec"] = 1
    counts[f"transpose{bits_a}"] = 1
    counts[f"mvm{bits_v}"] = 2 * iters
    counts[f"threshold{bits_v}"] = iters
    counts["restore_vec"] = iters if traced else 0
    return counts


def timed_solve(qphi, qphit, qy, iters, mu, xs) -> tuple[float, float]:
    """-> (host-clock ms, CUDA-event ms) per iteration of a solve of
    TIMED_ITERS iterations, after a 5-iteration warm-up."""
    import torch
    import clover_tpu_torch as tt
    tt.iht(qphi, qphit, qy, 5, K, mu, x_star=xs)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    tt.iht(qphi, qphit, qy, TIMED_ITERS, K, mu, x_star=xs)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    return wall * 1e3 / TIMED_ITERS, start.elapsed_time(end) / TIMED_ITERS


def whole_solve_ms(phi, y, name: str, runs: int = WHOLE_SOLVES) -> float:
    """Median host-clock ms of configuration ``name``'s whole untraced
    solve, from quantize(Phi) to the result (a synchronize), over ``runs``
    runs after a warm-up: the set-up kernels and the iterations."""
    import statistics
    import torch
    import clover_tpu_torch as tt
    bits_a, bits_v, iters, mu, _ = config(name)
    times = []
    for _ in range(runs + 1):
        gen = torch.Generator(device=phi.device).manual_seed(SEED + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qphi = tt.quantize(phi, bits_a, generator=gen)
        qy = tt.quantize(y, bits_v, generator=gen)
        tt.iht(qphi, tt.transpose(qphi), qy, iters, K, mu)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def phase_main_path(rep: Report, name: str, phi, x_star, y):
    """One configuration's solve through the public entry points; ->
    its launch counts."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch import kernels
    bits_a, bits_v, iters, mu, quality = config(name)
    traced = TRACED[name]
    print(f"== 3. main path: {name} IHT {M}x{N} K={K} mu={mu} "
          f"iterations={iters} {'traced' if traced else 'untraced'}")
    xs = tt.QVec32(values=x_star, length=N) if traced else None
    kernels.reset_launch_counts()
    gen = torch.Generator(device=phi.device).manual_seed(SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qphi = tt.quantize(phi, bits_a, generator=gen)
    qy = tt.quantize(y, bits_v, generator=gen)
    qphit = tt.transpose(qphi)
    # deterministic iterations: the tuned mu comes from a search with
    # stochastic rounding off, and SR iterations diverge at that mu
    res = tt.iht(qphi, qphit, qy, iters, K, mu, x_star=xs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    expected = expected_counts(bits_a, bits_v, iters, traced)
    print(f"  launches {counts} in {wall * 1e3:.2f} ms")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    err = recovery_error(res.x, x_star)
    print(f"  relative recovery error after {iters} iterations: {err:.6f} "
          f"(table quality {quality:.4f})")
    if not math.isfinite(err) or err >= 1.0:
        raise AssertionError(f"recovery error {err} not below 1.0")
    if traced:
        last = float(res.trace[-1])
        print(f"  trace {[round(float(t), 6) for t in res.trace]}, last "
              f"{last:.7f} vs host-restored {err:.7f}")
        if res.trace.shape != (iters,) or abs(last - err) > TRACE_TOL:
            raise AssertionError(f"trace {res.trace} does not end at {err}")
    width = N // 2 if bits_v == 4 else N
    if res.x.codes.shape != (width,) or res.x.scales.shape != (N // 64,):
        raise AssertionError("solution container has the wrong shape")

    mode = f"{bits_a}x{bits_v}"
    busy = (rep.leg_ms[mode, "Phi"] + rep.leg_ms[mode, "PhiT"]
            + rep.ms[f"threshold{bits_v}"])
    for label, x_star_arg in ((("traced", xs), ("untraced", None))
                              if traced else (("untraced", None),)):
        host_ms, dev_ms = timed_solve(qphi, qphit, qy, iters, mu, x_star_arg)
        kern = busy + (rep.ms["restore_vec"] if x_star_arg is not None
                       else 0.0)
        print(f"  {TIMED_ITERS} {label} iterations: {1e3 / host_ms:.1f} "
              f"iterations/s (host clock, {host_ms:.4f} ms/iteration; CUDA "
              f"events {dev_ms:.4f} ms/iteration); kernels {kern:.4f} ms "
              f"per iteration (phase 2 medians): device busy "
              f"~{kern / host_ms:.2f} of the loop")
    if not traced:
        whole = whole_solve_ms(phi, y, name)
        setup = (rep.ms["quantize_mat"] + rep.ms["quantize_vec"]
                 + rep.ms[f"transpose{bits_a}"])
        print(f"  whole solve, quantize(Phi) to the result: {whole:.4f} ms "
              f"(host clock, median of {WHOLE_SOLVES}); its kernels: set-up "
              f"{setup:.4f} ms (quantize_mat, quantize_vec, transpose"
              f"{bits_a}) + {iters} iterations x {busy:.4f} ms (phase 2 "
              f"medians)")
    return counts


def plain_iht(name: str, phi, y):
    """The deterministic solve through the plain versions, on the card."""
    import clover_tpu_torch as tt
    from clover_tpu_torch import kernels as kn
    bits_a, bits_v, iters, mu, _ = config(name)
    pc, ps = kn.quantize_mat_plain(phi, bits_a)
    yc, ys = kn.quantize_vec_plain(y, bits_v)
    tc = (kn.transpose4_plain if bits_a == 4 else kn.transpose8_plain)(pc)
    ts = ps.T.contiguous()
    x = tt.zeros_vector(bits_v, N, device=phi.device)
    xc, xs = x.codes, x.scales
    _, mvm = mvm_forms(bits_a, bits_v)
    for _ in range(iters):
        t2 = mvm(pc, ps, xc, xs, yc, ys, -1.0)
        xc, xs = mvm(tc, ts, *t2, xc, xs, mu)
        xc = (kn.threshold4_plain(xc, xs, K) if bits_v == 4
              else kn.threshold8_plain(xc, xs, K, N))
    return type(x)(codes=xc, scales=xs, length=N)


def phase_solve_parity(name: str, phi, x_star, y):
    import torch
    import clover_tpu_torch as tt
    bits_a, bits_v, iters, mu, _ = config(name)
    print(f"== 4. deterministic {name} {iters}-iteration solve, kernels vs "
          f"plain")
    qphi = tt.quantize(phi, bits_a)
    res = tt.iht(qphi, tt.transpose(qphi), tt.quantize(y, bits_v), iters, K,
                 mu)
    plain = plain_iht(name, phi, y)
    ek, ep = recovery_error(res.x, x_star), recovery_error(plain, x_star)
    same = (torch.equal(res.x.codes, plain.codes)
            and torch.equal(res.x.scales, plain.scales))
    print(f"  error kernels {ek:.6f}  plain {ep:.6f}  solutions "
          f"{'bit-identical' if same else 'differ'}")
    # The kernels match their plain versions bit for bit by construction;
    # the tolerance leaves room for the contract's 1-LSB MVM allowance to
    # flip a few of the 4096 kept elements (each moves the error by < 1e-3).
    if abs(ek - ep) > SOLVE_ERR_TOL:
        raise AssertionError(f"solve errors differ: {ek} vs {ep}")


def serving_matrices(gen):
    """The served NS x NS matrices, 4- and 8-bit, SR-quantized."""
    import torch
    import clover_tpu_torch as tt
    a = torch.rand(NS, NS, generator=gen, device=gen.device) * 2 - 1
    mats = {bits: tt.quantize(a, bits, generator=gen) for bits in (4, 8)}
    del a
    torch.cuda.empty_cache()
    return mats


def batched_expected(iters: int, traced: bool):
    counts = dict.fromkeys(KERNEL_INFO, 0)
    counts.update(quantize_mat=1, quantize_vec=BATCH, transpose4=1,
                  mvm_batched=2 * iters, axpy=2 * iters, threshold4=iters,
                  restore_vec=iters if traced else 0)
    return counts


def timed(fn) -> tuple[float, float]:
    """-> (host-clock ms, CUDA-event ms) of one call of ``fn`` after a
    synchronize, ending in one."""
    import torch
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def phase_batched_iht(phi):
    """The batched 4-bit IHT of BATCH problems through the public entry
    points; -> its launch counts."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch import kernels
    bits_a, bits_v, iters, mu, quality = config("4")
    dev = phi.device
    print(f"== 5. batched IHT: B={BATCH} problems, {M}x{N} K={K} mu={mu} "
          f"iterations={iters}, traced")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    stars = torch.zeros(BATCH, N, device=dev)
    for j in range(BATCH):
        stars[j, torch.randperm(N, generator=g, device=dev)[:K]] = 1.0
    yf = (phi @ stars.T).T.contiguous()               # y_j = Phi x*_j
    xs_star = tt.QVec32(values=stars, length=N)
    kernels.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qphi = tt.quantize(phi, bits_a, generator=gen)
    qys = [tt.quantize(yf[j], bits_v, generator=gen) for j in range(BATCH)]
    qphit = tt.transpose(qphi)
    ys = tt.stack_vectors(qys)
    res = tt.iht_batched(qphi, qphit, ys, iters, K, mu, xs_star=xs_star)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    expected = batched_expected(iters, True)
    print(f"  launches {counts} in {wall * 1e3:.2f} ms")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    errs = [recovery_error(tt.vector_at(res.xs, j), stars[j])
            for j in range(BATCH)]
    last = [float(t) for t in res.trace[-1]]
    print(f"  errors after {iters} iterations {[round(e, 6) for e in errs]} "
          f"(table quality {quality:.4f}); trace's last row "
          f"{[round(t, 6) for t in last]}")
    if res.trace.shape != (iters, BATCH):
        raise AssertionError(f"trace shape {tuple(res.trace.shape)}")
    for e, t in zip(errs, last):
        if not math.isfinite(e) or e >= 1.0 or abs(e - t) > TRACE_TOL:
            raise AssertionError(f"error {e} (trace {t}) not below 1.0 or "
                                 f"off the trace")
    for j in range(BATCH):
        single = tt.iht(qphi, qphit, qys[j], iters, K, mu)
        if not (torch.equal(single.x.codes, res.xs.codes[j])
                and torch.equal(single.x.scales, res.xs.scales[j])):
            raise AssertionError(f"problem {j}: batched != single solve")
    print(f"  all {BATCH} solutions bit-identical to single tt.iht solves")

    tt.iht_batched(qphi, qphit, ys, 5, K, mu, xs_star=xs_star)   # warm-up
    for label, star in (("untraced", None), ("traced", xs_star)):
        host, dev_ms = timed(lambda: tt.iht_batched(
            qphi, qphit, ys, TIMED_ITERS, K, mu, xs_star=star))
        rate = BATCH * TIMED_ITERS * 1e3
        print(f"  batched {label}: {rate / host:.1f} problem-iterations/s "
              f"(host clock, {host / TIMED_ITERS:.4f} ms per batched "
              f"iteration; CUDA events {rate / dev_ms:.1f}, "
              f"{dev_ms / TIMED_ITERS:.4f} ms)")

    def singles():
        for q in qys:
            tt.iht(qphi, qphit, q, TIMED_ITERS, K, mu)
    host, dev_ms = timed(singles)
    rate = BATCH * TIMED_ITERS * 1e3
    print(f"  {BATCH} single solves untraced: {rate / host:.1f} "
          f"problem-iterations/s (host clock; CUDA events "
          f"{rate / dev_ms:.1f})")
    return counts


def serve(server, requests):
    """Bursts from CLIENTS threads, each submitting every CLIENTS-th
    request and then waiting for its results in order; a latency runs
    from submit to the result on the card.  -> (results, wall s, sorted
    latencies s)."""
    import threading
    import torch
    import clover_tpu_torch as tt
    results = [None] * requests.codes.shape[0]
    lat: list[float] = []
    errors: list[Exception] = []

    def client(c):
        try:
            futs = [(i, time.perf_counter(),
                     server.submit(tt.vector_at(requests, i)))
                    for i in range(c, len(results), CLIENTS)]
            for i, t0, fut in futs:
                results[i] = fut.result(timeout=WAIT_S)
                torch.cuda.current_stream().synchronize()
                lat.append(time.perf_counter() - t0)
        except Exception as e:          # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client thread did not finish")
    if errors:
        raise errors[0]
    return results, wall, sorted(lat)


def phase_server(mats, gen):
    """MVMServer on the NS x NS matrices in modes 4x4, 4x8 and 8x8; ->
    the launch counts of the three runs."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch import kernels
    from clover_tpu_torch.serving import MVMServer
    print(f"== 6. MVMServer on {NS}x{NS}, max_batch=32, max_wait_s=0.002, "
          f"{CLIENTS} client threads")
    req = {4: stacked_requests(gen, 512, NS, 4),
           8: stacked_requests(gen, 128, NS, 8)}
    totals = dict.fromkeys(KERNEL_INFO, 0)
    s4 = MVMServer(mats[4], max_batch=32, max_wait_s=0.002)
    s8 = MVMServer(mats[8], max_batch=32, max_wait_s=0.002)
    try:
        for mode, server, a, reqs in (("4x4", s4, mats[4], req[4]),
                                      ("4x8", s4, mats[4], req[8]),
                                      ("8x8", s8, mats[8], req[8])):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            results, wall, lat = serve(server, reqs)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            if counts["mvm_batched"] == 0:
                raise AssertionError(f"{mode}: no batched-MVM launch")
            for name, n in counts.items():
                totals[name] += n
            n = len(results)
            bad = 0
            for i, y in enumerate(results):
                want = tt.mvm(a, tt.vector_at(reqs, i))
                bad += not (torch.equal(y.codes, want.codes)
                            and torch.equal(y.scales, want.scales))
            if bad:
                raise AssertionError(f"{mode}: {bad} of {n} results differ "
                                     f"from tt.mvm")
            p99 = lat[min(n - 1, math.ceil(0.99 * n) - 1)]
            print(f"  {mode}: {n} requests in {wall * 1e3:.2f} ms, "
                  f"{n / wall:.1f} requests/s, latency p50 "
                  f"{lat[n // 2] * 1e3:.3f} ms p99 {p99 * 1e3:.3f} ms; "
                  f"launches mvm_batched {counts['mvm_batched']}, mvm4 "
                  f"{counts['mvm4']}, mvm8 {counts['mvm8']}; all results "
                  f"bit-identical to tt.mvm")
    finally:
        s4.close()
        s8.close()
    return totals


def small_config(name: str, m: int, n: int):
    """-> (y/x bits, tuned iterations, mu, K) of the 4 or 4x8 tuned IHT."""
    from clover_tpu_torch.models import tuned
    table = tuned.IHT_4BIT if name == "4" else tuned.IHT_MIXED_4X8
    row = table[(m, n)]
    return (4 if name == "4" else 8), row["iters"], row["mu"], row["K"]


def unfused_iht(qphi, qphit, qy, iters: int, k: int, mu: float,
                threshold=None):
    """The deterministic IHT through the public fused MVM+AXPY op and
    ``threshold`` (default ``tt.threshold``): two MVM launches and one
    threshold per iteration."""
    import clover_tpu_torch as tt
    threshold = threshold or tt.threshold
    x = tt.zeros_vector(qy.bits, qphi.cols, device=qy.codes.device)
    for _ in range(iters):
        t2 = tt.mvm_axpy(qphi, x, qy, -1.0)
        x = threshold(tt.mvm_axpy(qphit, t2, x, mu), k)
    return x


def radix_threshold4(x, k: int):
    """A 4-bit vector thresholded by the radix-select kernel, whatever its
    length."""
    from clover_tpu_torch.kernels import threshold4_cuda
    return type(x)(codes=threshold4_cuda(x.codes, x.scales, k),
                   scales=x.scales, length=x.length)


def launched(fn, expected: dict):
    """Run ``fn`` with every count at 0; raise unless the counts are
    ``expected`` (absent kernels 0); -> (fn's result, the counts)."""
    import torch
    from clover_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = dict.fromkeys(KERNEL_INFO, 0) | expected
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    return out, counts


def same(a, b) -> bool:
    import torch
    return torch.equal(a.codes, b.codes) and torch.equal(a.scales, b.scales)


def phase_small_iht():
    """The small IHT through ``tt.iht``: chained untraced, whole-iteration
    traced, against the unfused ops; -> the launch counts of its runs."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch.kernels import iteration as it
    totals = dict.fromkeys(KERNEL_INFO, 0)
    print(f"== 7. small IHT: whole-iteration and chained kernels, "
          f"{TIMED_ITERS} iterations")
    for m, n in SMALL_SOLVES:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        phi, x_star, y = tt.make_iht_problem(m, n, n // 4, generator=gen)
        xs = tt.QVec32(values=x_star, length=n)
        for name in ("4", "4x8"):
            bits, iters, mu, k = small_config(name, m, n)
            qphi = tt.quantize(phi, 4, generator=gen)
            qphit = tt.transpose(qphi)
            qy = tt.quantize(y, bits, generator=gen)
            thr = f"threshold{bits}"
            chained, c1 = launched(
                lambda: tt.iht(qphi, qphit, qy, TIMED_ITERS, k, mu),
                {"iteration_chain": TIMED_ITERS // CHAIN})
            traced, c2 = launched(
                lambda: tt.iht(qphi, qphit, qy, TIMED_ITERS, k, mu,
                               x_star=xs),
                {"iteration": TIMED_ITERS, thr: TIMED_ITERS,
                 "restore_vec": TIMED_ITERS})
            tuned, c3 = launched(
                lambda: tt.iht(qphi, qphit, qy, iters, k, mu, x_star=xs),
                {"iteration": iters, thr: iters, "restore_vec": iters})
            unfused, c4 = launched(
                lambda: unfused_iht(qphi, qphit, qy, TIMED_ITERS, k, mu),
                {f"mvm{bits}": 2 * TIMED_ITERS, thr: TIMED_ITERS})
            for c in (c1, c2, c3, c4):
                for kname, count in c.items():
                    totals[kname] += count
            if not (same(chained.x, traced.x) and same(chained.x, unfused)):
                raise AssertionError(f"4x{bits} {m}x{n}: chained, traced and "
                                     f"unfused solves differ")
            err = recovery_error(tuned.x, x_star)
            last = float(tuned.trace[-1])
            print(f"  4x{bits} {m}x{n} K={k} mu={mu}: error after the tuned "
                  f"{iters} iteration(s) {err:.6f} (trace {last:.6f}); after "
                  f"{TIMED_ITERS}: {recovery_error(chained.x, x_star):.6f}; "
                  f"chained, traced and unfused solves bit-identical; "
                  f"launches exact")
            if not math.isfinite(err) or err >= 1.0 or abs(err - last) > \
                    TRACE_TOL:
                raise AssertionError(f"error {err} (trace {last}) not below "
                                     f"1.0 or off the trace")
            x = chained.x
            ops = [(v.codes, v.scales) for v in (qphi, qphit, qy, x)]
            kern = {
                "chained": median_ms(lambda: it.iteration_chain_cuda(
                    4, bits, *ops, mu, k, [0] * 4 * CHAIN), 5, 20) / CHAIN,
                "traced": median_ms(lambda: tt.restore_vec(tt.threshold(
                    type(x)(*it.iteration_cuda(4, bits, *ops, mu), n), k)),
                    5, 20),
                "unfused": median_ms(lambda: unfused_chain(
                    bits, ops, mu, k, [0] * 4, False), 5, 20)}
            runs = {"chained": lambda: tt.iht(qphi, qphit, qy, TIMED_ITERS,
                                              k, mu),
                    "traced": lambda: tt.iht(qphi, qphit, qy, TIMED_ITERS,
                                             k, mu, x_star=xs),
                    "unfused": lambda: unfused_iht(qphi, qphit, qy,
                                                   TIMED_ITERS, k, mu)}
            for label, fn in runs.items():
                fn()                                   # warm-up
                host, dev_ms = timed(fn)
                host, dev_ms = host / TIMED_ITERS, dev_ms / TIMED_ITERS
                print(f"    {label:8s} {1e3 / host:9.1f} iterations/s (host "
                      f"clock, {host:.4f} ms/iteration; CUDA events "
                      f"{1e3 / dev_ms:.1f}/s, {dev_ms:.4f} ms); kernels "
                      f"{kern[label]:.4f} ms/iteration: device busy "
                      f"~{kern[label] / dev_ms:.2f}")
    return totals


def plain_accuracy_trace(config: str):
    """The deterministic -a trace of the 4 or 4x8 configuration through the
    plain versions, on the card."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch import kernels as kn
    from clover_tpu_torch.models import ACCURACY_MU, make_iht_problem_reference
    bits = 8 if config == "4x8" else 4
    mu = ACCURACY_MU["4x8" if config == "4x8" else 4]
    phi, x_star, y = make_iht_problem_reference(device="cuda")
    pc, ps = kn.quantize_mat_plain(phi, 4)
    phi_t = (kn.transpose4_plain(pc), ps.T.contiguous())
    yq = kn.quantize_vec_plain(y, bits)
    x = tt.zeros_vector(bits, x_star.shape[0], device="cuda")
    x = x.codes, x.scales
    errs, norm = [], torch.linalg.norm(x_star)
    for _ in range(EPOCHS):
        x = kn.iteration_plain(4, bits, (pc, ps), phi_t, yq, x, mu)
        codes = (kn.threshold4_plain(x[0], x[1], 64) if bits == 4 else
                 kn.threshold8_plain(x[0], x[1], 64, x_star.shape[0]))
        x = codes, x[1]
        values = kn.restore_vec_plain(codes, x[1], bits)
        errs.append(torch.linalg.norm(values - x_star) / norm)
    return torch.stack(errs)


def cli_output(argv) -> str:
    """``python -m clover_tpu_torch`` in this process; -> its standard
    output, after raising unless it exited 0."""
    import contextlib
    import io
    from clover_tpu_torch import cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"clover_tpu_torch {' '.join(argv)} exited {rc}:"
                             f"\n{out.getvalue()[-4000:]}")
    return out.getvalue()


def run_cli(argv):
    """``-a`` through the CLI; -> {config name: final error}."""
    finals, name = {}, None
    for line in cli_output(argv).splitlines():
        if line.startswith("=== "):
            name = line.split(": ", 1)[1].split(" (", 1)[0]
        elif line.startswith("  final: "):
            finals[name] = float(line.split(": ")[1])
    return finals


def phase_accuracy():
    """-a through the CLI on the card, deterministic and SR; -> the launch
    counts of the deterministic run."""
    import torch
    from clover_tpu_torch.models import run_iht_accuracy
    print(f"== 8. python -m clover_tpu_torch -a: the accuracy protocol, "
          f"512x1024 K=64, {EPOCHS} epochs, five precisions")
    # traced: each epoch restores x (4x8, 4, 8); the 4 and 4x8 iterations
    # are one whole-iteration launch each, 8-bit two MVM launches
    expected = {"quantize_mat": 3, "quantize_vec": 3, "transpose4": 2,
                "transpose8": 1, "iteration": 2 * EPOCHS,
                "threshold4": EPOCHS, "threshold8": 2 * EPOCHS,
                "mvm8": 2 * EPOCHS, "restore_vec": 3 * EPOCHS}
    argv = ["-a", "--epochs", str(EPOCHS)]
    det, counts = launched(lambda: run_cli([*argv, "--no-sr"]), expected)
    sr, _ = launched(lambda: run_cli(argv), expected)
    print(f"  launches per run {counts} (exact)")
    for name in det:
        print(f"  {name:7s} final error: deterministic {det[name]:.6f}, SR "
              f"{sr[name]:.6f} (SR seed 0)")
    if len(det) != 5 or not all(math.isfinite(e) and e < 1.0
                                for e in det.values()):
        raise AssertionError(f"deterministic finals {det}: not all five "
                             f"below 1.0")
    for config in ("4", "4x8"):
        got, _ = launched(
            lambda: run_iht_accuracy(4 if config == "4" else "4x8",
                                     epochs=EPOCHS),
            {"quantize_mat": 1, "quantize_vec": 1, "transpose4": 1,
             "iteration": EPOCHS, f"threshold{8 if config == '4x8' else 4}":
             EPOCHS, "restore_vec": EPOCHS})
        want = plain_accuracy_trace(config)
        gap = float((got - want).abs().max())
        print(f"  {config:3s} deterministic trace: {EPOCHS} iteration "
              f"launches; kernels against plain versions max |diff| "
              f"{gap:.3g}; final {float(got[-1]):.6f}")
        if got.shape != (EPOCHS,) or not gap <= TRACE_TOL:
            raise AssertionError(f"{config}: trace differs from the plain "
                                 f"versions' by {gap}")
    return counts


def validation_count(out: str) -> int:
    """-> N of the ``N checks, F failures`` line ending ``-v``'s output,
    after raising on a failed check."""
    last = out.rstrip().splitlines()[-1]
    checks, failures = (int(w) for w in last.replace(",", "").split()[::2])
    if failures or "Failed" in out or last != f"{checks} checks, 0 failures":
        failed = [line for line in out.splitlines() if "Failed" in line]
        raise AssertionError(f"-v: {last!r}; {failed[:10]}")
    return checks


def phase_validate():
    """-v through the CLI on the card, then the same sweep on the CPU; ->
    the launch counts of the card's run."""
    import torch
    from clover_tpu_torch import kernels
    print("== 9. python -m clover_tpu_torch -v: every op against the golden "
          "oracle, the default sweep")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = cli_output(["-v"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    t1 = time.perf_counter()
    cpu = validation_count(cli_output(["-v", "--device", "cpu"]))
    cpu_wall = time.perf_counter() - t1
    card = validation_count(out)
    print(f"  card: {card} checks, 0 failures in {wall:.2f} s; CPU (plain "
          f"versions): {cpu} checks, 0 failures in {cpu_wall:.2f} s")
    print(f"  launches {counts}")
    if card != cpu:
        raise AssertionError(f"-v ran {card} checks on the card, {cpu} on the "
                             f"CPU")
    idle = [name for name in VALIDATE_KERNELS if counts[name] == 0]
    if idle:
        raise AssertionError(f"-v launched no {idle} kernel")
    return counts


def phase_large_iht(rep: Report):
    """The large-n 4-bit IHT through ``tt.iht``: the hybrid threshold; both
    MVM legs against the plain version, their times and TB/s; -> the
    launch counts of its solve."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch import kernels as kn
    m, n, k = LARGE
    mu = 1.0 / m
    print(f"== 10. large-n 4-bit IHT: {m}x{n} K={k} mu=1/m "
          f"iterations={LARGE_ITERS}, untraced (hybrid threshold)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    phi, x_star, y = tt.make_iht_problem(m, n, k, generator=gen)
    operands = {}

    def solve():
        operands["phi"] = tt.quantize(phi, 4, generator=gen)
        operands["y"] = tt.quantize(y, 4, generator=gen)
        operands["phit"] = tt.transpose(operands["phi"])
        return tt.iht(operands["phi"], operands["phit"], operands["y"],
                      LARGE_ITERS, k, mu)

    t0 = time.perf_counter()
    res, counts = launched(solve, {
        "quantize_mat": 1, "quantize_vec": 1, "transpose4": 1,
        "mvm4": 2 * LARGE_ITERS, "hist4": LARGE_ITERS, "mask4": LARGE_ITERS})
    wall = time.perf_counter() - t0
    del phi
    torch.cuda.empty_cache()
    qphi, qphit, qy = operands["phi"], operands["phit"], operands["y"]
    err = recovery_error(res.x, x_star)
    print(f"  launches {counts} in {wall * 1e3:.2f} ms (exact); relative "
          f"recovery error after {LARGE_ITERS} iterations {err:.6f}")
    if not math.isfinite(err):
        raise AssertionError(f"recovery error {err} is not finite")
    radix, _ = launched(
        lambda: unfused_iht(qphi, qphit, qy, LARGE_ITERS, k, mu,
                            radix_threshold4),
        {"mvm4": 2 * LARGE_ITERS, "threshold4": LARGE_ITERS})
    if not same(res.x, radix):
        raise AssertionError("large-n IHT: solution differs from the unfused "
                             "radix-threshold loop")
    print(f"  solution bit-identical to the unfused loop through "
          f"threshold4_cuda")

    without_host_sync(lambda: tt.iht(qphi, qphit, qy, LARGE_ITERS, k, mu),
                      "the large-n untraced solve")
    print("  the untraced solve makes no host sync (torch's sync debug mode)")
    x = res.x
    leg1 = (qphi.codes, qphi.scales, x.codes, x.scales, qy.codes, qy.scales,
            -1.0)
    t2 = kn.mvm4_cuda(*leg1)
    leg2 = (qphit.codes, qphit.scales, *t2, x.codes, x.scales, mu)
    for leg, args, (rows, cols) in (("Phi", leg1, (m, n)),
                                    ("PhiT", leg2, (n, m))):
        for what, seeds in (("det", ()), ("SR", (7, True, 8, True))):
            rep.exact("mvm4", f"{rows}x{cols} {leg} leg {what}",
                      kn.mvm4_cuda(*args, *seeds),
                      kn.mvm4_plain(*args, *seeds))
        torch.cuda.empty_cache()
        ms = median_ms(lambda: kn.mvm4_cuda(*args), 5, 20)
        nbytes = mvm_bytes(rows, cols, 4, 4)
        rep.large[leg] = (ms, nbytes / hbm_rate() * 1e3)
        print(f"  {leg} leg {rows}x{cols}: {ms:.4f} ms, "
              f"{nbytes / ms / 1e9:.2f} TB/s (bound {rep.large[leg][1]:.4f} "
              f"ms, {nbytes / 1e6:.1f} MB)")
    kern = {"Phi leg": rep.large["Phi"][0],
            "PhiT leg": rep.large["PhiT"][0],
            "hybrid threshold": median_ms(lambda: tt.threshold(x, k), 5, 20,
                                          HOST_SPIN_CYCLES),
            "radix threshold4_cuda": median_ms(
                lambda: kn.threshold4_cuda(x.codes, x.scales, k), 5, 20)}
    busy = sum(kern[name] for name in ("Phi leg", "PhiT leg",
                                       "hybrid threshold"))
    print("  kernel ms: " + ", ".join(f"{name} {ms:.4f}"
                                      for name, ms in kern.items()))
    run = lambda: tt.iht(qphi, qphit, qy, LARGE_ITERS, k, mu)  # noqa: E731
    run()                                                       # warm-up
    host, dev_ms = (t / LARGE_ITERS for t in timed(run))
    print(f"  {LARGE_ITERS} untraced iterations: {1e3 / host:.1f} "
          f"iterations/s (host clock, {host:.4f} ms/iteration; CUDA events "
          f"{dev_ms:.4f} ms/iteration); kernels {busy:.4f} ms per iteration: "
          f"device busy ~{busy / host:.2f} of the loop")
    return counts


def perf_quick_rows() -> list[str]:
    """The names of every rate row ``-p --quick`` prints, in order."""
    from clover_tpu_torch.harness import perf
    vec, mvm = perf.VEC_SIZES[:2], perf.MVM_SIZES[:2]
    rows = [f"quantize {b:2d}-bit n={n}" for n in vec for b in (4, 8, 16, 32)]
    rows += [f"restore {b:2d}-bit n={n}" for n in vec for b in (4, 8, 16)]
    rows += [f"dot {b:2d}-bit n={n}" for n in vec for b in (32, 4, 8, 16)]
    rows += [f"scaleAndAdd {b:2d}-bit n={n}" for n in vec
             for b in (32, 4, 8, 16)]
    for n in perf.WARM_SIZES:
        rows += [f"L2-warm dot 32-bit n={n}", f"L2-warm axpy 32-bit n={n}"]
        rows += [f"L2-warm {op} {b:2d}-bit n={n}" for b in (4, 8)
                 for op in ("dot", "axpy")]
    rows += [f"{'L2-warm ' if n <= perf.WARM_THRESHOLD_N else ''}threshold "
             f"{b:2d}-bit n={n}" for n in vec for b in (4, 8, 16, 32)]
    for n in mvm:
        rows.append(f"mvm 32-bit (matmul) n={n}")
        for ba, bxs in ((4, (4, 8)), (8, (8,)), (16, (16,))):
            if ba < 16:
                rows += [f"dma probe cluster {ba}-bit n={n}",
                         f"dma probe {ba}-bit n={n}",
                         f"dma probe stream {ba}-bit n={n}"]
            rows += [f"mvm {ba:2d}x{bx:2d}-bit n={n}" for bx in bxs]
    rows += [f"transpose {b:2d}-bit n={n}" for n in mvm
             for b in (32, 4, 8, 16)]
    m, n = perf.IHT_SIZES[0]
    rows += [f"IHT {name:>4s}-bit {m}x{n}" for name, _, _ in perf.IHT_CONFIGS]
    return rows


def perf_rows(out: str) -> dict:
    """-> {row name: (% of spec, the probe-floor line after it or None)}
    of every rate row in -p's output."""
    lines = out.splitlines()
    rates = {}
    for i, line in enumerate(lines):
        if " ms " in line and " GB/s " in line:
            floor = lines[i + 1] if i + 1 < len(lines) else ""
            rates[line[:36].strip()] = (
                line.split(" GB/s ")[1].split()[0],
                floor if "probe floor" in floor else None)
    return rates


def phase_perf():
    """``-p --quick`` through the CLI: every row printed, none but the
    L2-warm ones above the card's memory rate, each 4/8-bit MVM row beside
    its probe floor, and a launch of every kernel -p reaches; -> the
    launch counts."""
    import torch
    from clover_tpu_torch import kernels
    print("== 11. python -m clover_tpu_torch -p --quick: every op against "
          "the card's memory rate and the probe floor")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = cli_output(["-p", "--quick"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(out.rstrip())
    lines = out.splitlines()
    rates = perf_rows(out)
    want = perf_quick_rows()
    missing = [name for name in want if name not in rates]
    if missing or len(rates) != len(want):
        raise AssertionError(f"-p --quick: rows missing {missing}; "
                             f"{len(rates)} printed, {len(want)} expected")
    for name, (pct, floor) in rates.items():
        warm = name.startswith("L2-warm")
        if warm != (pct == "L2") or (not warm and not (
                pct.endswith("%") and float(pct[:-1]) <= 100.0)):
            raise AssertionError(f"-p row {name!r}: % of spec {pct}")
        bits_a = (name.split("x")[0].split()[-1]
                  if name.startswith("mvm ") and "matmul" not in name
                  else None)
        if bits_a in ("4", "8") and (
                floor is None or f"of the {bits_a}-bit cluster probe floor"
                not in floor):
            raise AssertionError(f"-p row {name!r}: no probe floor line")
        if floor is not None and float(floor.split("%")[0].split()[-1]) > \
                FLOOR_SHARE_MAX:
            raise AssertionError(f"-p row {name!r} above its floor: "
                                 f"{floor.strip()}")
    floors = sum("probe floor" in line for line in lines)
    if floors != 6 or not any(line.startswith("launch probe")
                              for line in lines):
        raise AssertionError(f"-p: {floors} probe-floor lines (6 expected) "
                             f"or no launch probe line")
    idle = [k for k in PERF_KERNELS if counts[k] == 0]
    print(f"  -p --quick: {len(rates)} rows, exit 0, every row that is not "
          f"L2-warm at or below 100% of spec, {floors} MVM rows at or below "
          f"{FLOOR_SHARE_MAX:.0f}% of the cluster probe floor; wall "
          f"{wall:.2f} s")
    print(f"  launches {counts}")
    if idle:
        raise AssertionError(f"-p launched no {idle} kernel")
    return counts


def search_tables(out: str) -> dict:
    """-> {kind: {(bits, m, n): (iters, mu, target)}} from -g's tables."""
    tables, kind = {}, None
    for line in out.splitlines():
        if line.startswith("=== "):
            kind = line.strip("= ")
            tables[kind] = {}
        elif kind and line.split()[:1] in (["4"], ["8"], ["16"], ["32"]):
            bits, m, n, _, it, mu, target = line.split()
            tables[kind][int(bits), int(m), int(n)] = (it, mu, target)
    return tables


def phase_search():
    """``-g --quick`` through the CLI: a row for every kind, size and
    precision; each kind's 4-bit column at the first size against the same
    search_family run on the CPU in this process; -> the launch counts."""
    import torch
    from clover_tpu_torch import kernels
    from clover_tpu_torch.harness import search
    sizes = search.SEARCH_SIZES_FULL[:2]
    kinds = ("gd", "iht", "gd_mixed", "iht_mixed")
    print(f"== 12. python -m clover_tpu_torch -g --quick: sizes {sizes}, "
          f"{', '.join(kinds)}")
    card = {}
    real = search.run_search_full

    def keep(**kwargs):
        card.update(real(**kwargs))
        return card
    search.run_search_full = keep          # the CLI's rows, unrounded
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = cli_output(["-g", "--quick"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        search.run_search_full = real
    counts = kernels.launch_counts()
    print(out.rstrip())
    tables = search_tables(out)
    for kind in kinds:
        got = sorted(tables.get(kind, {}))
        want = sorted((b, r["m"], r["n"]) for r in card[kind]
                      for b in (4, 8, 16, 32))
        if len(got) != 2 * 4 or got != want or any(
                c is None for r in card[kind] for c in r["cols"].values()):
            raise AssertionError(f"-g {kind}: rows {got}, columns "
                                 f"{[r['cols'] for r in card[kind]]}")
    print(f"  -g --quick: {len(kinds)} kinds x {len(sizes)} sizes x 4 "
          f"precisions printed, exit 0; wall {wall:.2f} s")
    t1 = time.perf_counter()
    for kind in kinds:
        cpu = search.search_family(kind, sizes[0], log=lambda *a: None,
                                   device="cpu")
        got = card[kind][0]
        rel = abs(got["quality_target"] - cpu["quality_target"]) / \
            cpu["quality_target"]
        print(f"  {kind:9s} size {sizes[0]}: 4-bit (iterations, mu) card "
              f"{got['cols'][4]}, CPU {cpu['cols'][4]}; quality target card "
              f"{got['quality_target']:.9g}, CPU {cpu['quality_target']:.9g} "
              f"(rtol {rel:.3g})")
        if got["cols"][4] != cpu["cols"][4] or not rel <= SEARCH_RTOL:
            raise AssertionError(f"-g {kind}: the card's 4-bit column "
                                 f"differs from the CPU's")
    print(f"  the CPU's four searches at size {sizes[0]}: "
          f"{time.perf_counter() - t1:.2f} s")
    print(f"  launches {counts}")
    idle = [k for k in SEARCH_KERNELS if counts[k] == 0]
    if idle:
        raise AssertionError(f"-g launched no {idle} kernel")
    return counts


def phase_checkpoint(gen):
    """CUDA containers of every type saved and loaded onto a CUDA ``like``:
    every tensor back on the card, bytes equal."""
    import os
    import tempfile
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch.utils import checkpoint
    print("== 13. checkpoint round trip on the card")
    a = torch.rand(1000, 3000, generator=gen, device="cuda") * 2 - 1
    state = {f"mat{b}": tt.quantize(a, b) for b in (4, 8, 16, 32)}
    state |= {f"vec{b}": tt.quantize(a[0], b) for b in (4, 8, 16, 32)}
    state |= {"trace": torch.rand(50, device="cuda"), "step": 50}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.pt")
        checkpoint.save(path, state)
        size = os.path.getsize(path)
        got = checkpoint.load(path, like=state)
    tensors = 0
    for name, want in state.items():
        pairs = ([(got[name], want)] if not hasattr(want, "__dataclass_fields__")
                 else [(getattr(got[name], f), getattr(want, f))
                       for f in want.__dataclass_fields__])
        for g, w in pairs:
            if isinstance(w, torch.Tensor):
                tensors += 1
                if g.device != w.device or not torch.equal(
                        g.contiguous().view(torch.uint8),
                        w.contiguous().view(torch.uint8)):
                    raise AssertionError(f"checkpoint: {name} came back "
                                         f"changed or off the card")
            elif g != w:
                raise AssertionError(f"checkpoint: {name} {g} != {w}")
    print(f"  {len(state)} entries ({tensors} tensors, {size} bytes): every "
          f"tensor back on {a.device}, bytes equal")



# -- phase 14: the sharded path, RANKS ranks on the one card ---------------

RANKS = 8                     # a 2x4 mesh, every rank on cuda:0
RANK_TIMEOUT_S = 300          # the whole of phase 14's ranks
SHARDED_CONFIGS = (("iht", "4"), ("iht", "4x8"), ("iht", "8"),
                   ("gd", "4x8"))
SHARDED_TIMED_ITERS = 20
SHARDED_REQUESTS = 128        # per server mode


def sharded_config(kind: str, name: str, problems: dict):
    """-> (Phi bits, y/x bits, iterations, mu, k, (phi, x*, y)) of one
    sharded configuration: the tuned IHT of the main path (its problem),
    or the tuned mixed 4x8 GD on a row-normalized Phi."""
    import torch
    from clover_tpu_torch.models import make_gd_problem, make_iht_problem
    from clover_tpu_torch.models import tuned
    if kind not in problems:
        gen = torch.Generator(device="cuda").manual_seed(
            SEED if kind == "iht" else SEED + 6)
        make = (functools.partial(make_iht_problem, M, N, K)
                if kind == "iht" else functools.partial(make_gd_problem, M, N))
        problems[kind] = make(generator=gen)
    if kind == "iht":
        bits_a, bits_v, iters, mu, _ = config(name)
        return bits_a, bits_v, iters, mu, K, problems[kind]
    row = tuned.GD_MIXED_4X8[(M, N)]
    return 4, 8, row["iters"], row["mu"], None, problems[kind]


def sharded_operands(bits_a: int, bits_v: int, phi, y):
    """(Phi, PhiT, y) quantized as the main path does (SR, one generator
    seeded SEED + 1, Phi first): the same bytes on every rank."""
    import torch
    import clover_tpu_torch as tt
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    qphi = tt.quantize(phi, bits_a, generator=gen)
    qy = tt.quantize(y, bits_v, generator=gen)
    return qphi, tt.transpose(qphi), qy


def integer_problem(seed: int, iteration: bool):
    """4-bit integer codes (scale 7) of an M x N matrix and of x (length
    N), or of y (length M) with +-7 planted per block (tests/
    test_parallel.py's exactness-by-construction problems)."""
    import torch
    import clover_tpu_torch as tt
    g = torch.Generator(device="cuda").manual_seed(seed)
    ac = torch.randint(-7, 8, (M, N), generator=g, device="cuda",
                       dtype=torch.int8)
    vc = torch.randint(-7, 8, (M if iteration else N,), generator=g,
                       device="cuda", dtype=torch.int8)
    if iteration:
        vc[::64] = 7
    qa = tt.QMat4(codes=tt.pack_nibbles(ac), scales=torch.full(
        (M // 64, N // 64), 7.0, device="cuda"), rows=M, cols=N)
    qv = tt.QVec4(codes=tt.pack_nibbles(vc), scales=torch.full(
        (vc.shape[0] // 64,), 7.0, device="cuda"), length=vc.shape[0])
    return ac, vc, qa, qv


def leaves_of(q) -> list:
    return [q.values] if q.bits in (16, 32) else [q.codes, q.scales]


def replicas_equal(tensors, mesh, axes) -> bool:
    """Every rank's copy of ``tensors`` along each of ``axes`` equal to
    this rank's, byte for byte (a collective)."""
    import torch
    from clover_tpu_torch.parallel.mesh import gather
    ok = True
    for axis in axes:
        for g in gather(tensors, mesh, axis):
            flat = g.reshape(g.shape[0], -1)
            ok &= bool(torch.equal(flat, flat[:1].expand_as(flat)))
    return ok


def sharded_rank(rank: int, port: int, queue):
    """One rank of phase 14: everything below runs on every rank in the
    same order (SPMD); rank 0 also serves and reports.  Puts its results
    (numbers, lists and NumPy arrays) on ``queue``."""
    import traceback
    import torch.distributed as dist
    out = {"rank": rank}
    try:
        out.update(sharded_rank_work(rank, port))
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        queue.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def sharded_rank_work(rank: int, port: int) -> dict:
    import torch
    import torch.distributed as dist
    import clover_tpu_torch as tt
    from clover_tpu_torch import kernels, parallel as par
    from clover_tpu_torch.harness import perf
    from clover_tpu_torch.ops import _core
    from clover_tpu_torch.ops.axpy import scale_and_add
    from clover_tpu_torch.ops.mvm import mvm_f32_fast, requant_output
    from clover_tpu_torch.parallel import ops as pops
    from clover_tpu_torch.parallel import solvers
    from clover_tpu_torch.parallel.mesh import vec_block
    par.initialize(f"127.0.0.1:{port}", RANKS, rank)
    mesh = par.make_mesh()
    ROW, COL = par.ROW, par.COL
    out = {"backend": dist.get_backend(), "shape": tuple(mesh.shape),
           "device": str(par.local_device())}
    counts = dict.fromkeys(KERNEL_INFO, 0)

    def counted(fn):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        for name, n in kernels.launch_counts().items():
            counts[name] += n
        return result

    # the same problem on every rank: a checksum's max and min agree
    problems = {}
    phi = sharded_config("iht", "4", problems)[5][0]
    c = int(phi.view(torch.int32).to(torch.int64).sum())
    t = torch.tensor([c, -c], device="cuda")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    out["copies equal"] = t.tolist() == [c, -c]

    # the exact-integer mvm_psum
    ac, xc, qa, qx = integer_problem(SEED + 7, iteration=False)
    A_l = par.shard_matrix(qa, mesh).local
    x_l = par.shard_vector(qx, mesh, COL).local
    y = counted(lambda: pops.mvm_psum(A_l, x_l, COL, None, 32, ROW, mesh))
    full = par.gather_vector(y, mesh, ROW, M).values
    with _core.ieee_fp32():
        want = ac.float() @ xc.float()        # integer sums below 2^24
    out["psum exact"] = bool(torch.equal(full, want))
    # an SR requant owned by ROW: its col replicas are equal
    q4 = counted(lambda: pops.mvm_psum(A_l, x_l, COL, 12345, 4, ROW, mesh))
    out["psum replicas equal"] = replicas_equal(leaves_of(q4), mesh, (COL,))
    del ac, xc, qa, qx, A_l, x_l, want

    # one exact iteration
    _, _, qa, qy = integer_problem(SEED + 9, iteration=True)
    res = counted(lambda: solvers.iht(
        par.shard_matrix(qa, mesh), par.shard_matrix(tt.transpose(qa), mesh,
                                                     True),
        par.shard_vector(qy, mesh, ROW), 1, K, 0.25, mesh))
    out["iteration"] = [t.cpu().numpy() for t in leaves_of(res.x)]
    del qa, qy

    # the sharded solves at their tuned mu and iterations, traced
    for kind, name in SHARDED_CONFIGS:
        bits_a, bits_v, iters, mu, k, (phi, x_star, y) = sharded_config(
            kind, name, problems)
        qphi, qphit, qy = sharded_operands(bits_a, bits_v, phi, y)
        shards = (par.shard_matrix(qphi, mesh),
                  par.shard_matrix(qphit, mesh, True),
                  par.shard_vector(qy, mesh, ROW))
        xs = tt.QVec32(values=x_star, length=N)
        solve = (functools.partial(solvers.iht, *shards, iters, k, mu, mesh)
                 if kind == "iht" else
                 functools.partial(solvers.gd, *shards, iters, mu, mesh))
        res = counted(lambda: solve(x_star=xs))
        out[f"{kind} {name}"] = {
            "trace": res.trace.tolist(),
            "replicas equal": replicas_equal(leaves_of(res.x), mesh,
                                             (ROW, COL))}
        if (kind, name) != ("iht", "4"):
            continue
        # the 4-bit IHT timed, and its legs one by one
        run = functools.partial(solvers.iht, *shards, SHARDED_TIMED_ITERS,
                                k, mu, mesh)
        counted(run)                                     # warm-up
        host, dev_ms = timed(lambda: counted(run))
        phi_l, y_l = shards[0].local, shards[2].local
        c = mesh.get_local_rank(COL)
        nl = phi_l.cols_pad
        x_l = vec_block(res.x, c * nl, (c + 1) * nl)
        y32 = mvm_f32_fast(phi_l, x_l)
        t1 = requant_output(y32.clone(), phi_l.rows, 4, None)
        out["timed"] = {
            "iterations/s": SHARDED_TIMED_ITERS * 1e3 / host,
            "host ms": host / SHARDED_TIMED_ITERS,
            "events ms": dev_ms / SHARDED_TIMED_ITERS,
            "f32 kernel ms": median_ms(lambda: mvm_f32_fast(phi_l, x_l), 5,
                                       20),
            "all_reduce ms": 1e3 * wall_time(lambda: dist.all_reduce(
                y32.clone(), group=mesh.get_group(COL))),
            "requant ms": median_ms(lambda: requant_output(
                y32, phi_l.rows, 4, None), 5, 20),
            "axpy ms": median_ms(lambda: scale_and_add(y_l, t1, -1.0), 5,
                                 20),
            "threshold_global ms": 1e3 * wall_time(
                lambda: pops.threshold_global(x_l, k, COL, mesh)),
        }
    del problems, phi, x_star, y, qphi, qphit, qy, shards
    torch.cuda.empty_cache()

    # the sharded server on NS x NS matrices
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    a = torch.rand(NS, NS, generator=gen, device="cuda") * 2 - 1
    mats = {bits: tt.quantize(a, bits) for bits in (4, 8)}
    del a
    torch.cuda.empty_cache()
    served = {}
    for bits_a, modes in ((4, ("4x4", "4x8")), (8, ("8x8",))):
        shard = par.shard_matrix(mats[bits_a], mesh)
        if rank != 0:          # the follower loop, until rank 0 closes
            counted(lambda: par.ShardedMVMServer(shard, mesh, max_batch=32,
                                                 max_wait_s=0.002))
            continue
        server = par.ShardedMVMServer(shard, mesh, max_batch=32,
                                      max_wait_s=0.002)
        try:
            for mode in modes:
                bits_x = int(mode.split("x")[1])
                reqs = stacked_requests(gen, SHARDED_REQUESTS, NS, bits_x)
                results, wall, lat = counted(lambda: serve(server, reqs))
                worst_lsb, worst_rtol = 0, 0.0
                for i, y in enumerate(results):
                    want = tt.mvm(mats[bits_a], tt.vector_at(reqs, i))
                    worst_lsb = max(worst_lsb, int((
                        codes_of(y.codes, want.bits).int()
                        - codes_of(want.codes, want.bits).int()).abs().max()))
                    worst_rtol = max(worst_rtol, float(
                        ((y.scales - want.scales).abs()
                         / want.scales.abs()).max()))
                n = len(results)
                served[mode] = {
                    "requests": n, "wall s": wall, "lsb": worst_lsb,
                    "rtol": worst_rtol, "p50 ms": lat[n // 2] * 1e3,
                    "p99 ms": lat[min(n - 1, math.ceil(0.99 * n) - 1)] * 1e3}
        finally:
            server.close()
    out["server"] = served
    del mats
    torch.cuda.empty_cache()

    # -p --sharded's rows on the 2x4 mesh
    lines = []
    counted(lambda: perf.run_perf(lines.append, quick=True, sharded=True))
    out["perf"] = lines
    out["counts"] = counts
    return out


def run_ranks() -> list[dict]:
    """Spawn RANKS ranks of ``sharded_rank`` (the library is built
    already, so they load it); -> their results, in rank order.  Raises
    if a rank fails or RANK_TIMEOUT_S passes; every rank is ended on the
    way out."""
    import queue as queues
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=sharded_rank, args=(r, port, q))
             for r in range(RANKS)]
    results = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.start()
        while len(results) < RANKS:
            try:
                res = q.get(timeout=1.0)
            except queues.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise AssertionError(f"phase 14: ranks got {sorted(results)}"
                                         f"; exit codes {dead} or timed out")
                continue
            if "error" in res:
                raise AssertionError(f"rank {res['rank']} failed:\n"
                                     f"{res['error']}")
            results[res["rank"]] = res
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return [results[r] for r in range(RANKS)]


def regime_rule(tp, ts, what: str):
    """tests/test_parallel.py:52-58: the first iteration within 5%
    (+1e-4), the last within max(1.3x, +0.05) of the reference ts."""
    if not (all(math.isfinite(t) for t in tp)
            and abs(tp[0] - ts[0]) <= 0.05 * ts[0] + 1e-4
            and tp[-1] <= max(1.3 * ts[-1], ts[-1] + 0.05)):
        raise AssertionError(f"{what}: sharded trace {tp} off the single "
                             f"solve's {ts}")


def phase_sharded():
    """The sharded path on RANKS ranks sharing the card; -> the launch
    counts of its runs, summed over the ranks."""
    import numpy as np
    import torch
    import clover_tpu_torch as tt
    print(f"== 14. the sharded path: {RANKS} ranks sharing the card, a 2x4 "
          f"mesh ({M}x{N}, K={K})")
    # the references, on this process before the ranks start: the single
    # solves of each configuration and the single exact iteration
    problems, refs = {}, {}
    for kind, name in SHARDED_CONFIGS:
        bits_a, bits_v, iters, mu, k, (phi, x_star, y) = sharded_config(
            kind, name, problems)
        qphi, qphit, qy = sharded_operands(bits_a, bits_v, phi, y)
        xs = tt.QVec32(values=x_star, length=N)
        res = (tt.iht(qphi, qphit, qy, iters, k, mu, x_star=xs)
               if kind == "iht" else
               tt.gd(qphi, qphit, qy, iters, mu, x_star=xs))
        refs[kind, name] = [float(t) for t in res.trace]
    del problems, phi, x_star, y, qphi, qphit, qy
    _, _, qa, qy = integer_problem(SEED + 9, iteration=True)
    single = tt.iht(qa, tt.transpose(qa), qy, 1, K, 0.25).x
    single = [t.cpu().numpy() for t in leaves_of(single)]
    del qa, qy
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks()
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"  {RANKS} ranks: backend {r0['backend']}, mesh "
          f"{'x'.join(map(str, r0['shape']))}, devices "
          f"{sorted({r['device'] for r in ranks})}; wall {wall:.2f} s")
    if any(r["backend"] != "gloo" or r["shape"] != (2, 4) for r in ranks):
        raise AssertionError("phase 14: not a 2x4 gloo mesh")
    for what in ("copies equal", "psum exact", "psum replicas equal"):
        if not all(r[what] for r in ranks):
            raise AssertionError(f"phase 14: {what} fails on a rank")
    print(f"  every rank built the same {M}x{N} problem (checksum max = "
          f"min); the exact-integer mvm_psum bit-identical to the integer "
          f"product on every rank; an SR requant's col replicas equal")
    got = r0["iteration"]
    if not all(np.array_equal(g, w) for g, w in zip(got, single)):
        raise AssertionError("phase 14: the exact sharded iteration differs "
                             "from the single-device one")
    kept = int(np.count_nonzero(codes_of(torch.from_numpy(got[0]), 4)))
    if kept != K:
        raise AssertionError(f"exact iteration kept {kept}, not {K}")
    print(f"  one exact sharded 4-bit iteration bit-identical to this "
          f"process's single-device iteration ({kept} kept)")
    for kind, name in SHARDED_CONFIGS:
        key = f"{kind} {name}"
        tp = r0[key]["trace"]
        regime_rule(tp, refs[kind, name], f"sharded {key}")
        if not all(r[key]["replicas equal"] and r[key]["trace"] == tp
                   for r in ranks):
            raise AssertionError(f"phase 14: {key}: the ranks' solutions or "
                                 f"traces differ")
        print(f"  {key:8s} sharded trace {[round(t, 6) for t in tp]} vs "
              f"single {[round(t, 6) for t in refs[kind, name]]}; solution "
              f"replicated bit for bit on all {RANKS} ranks")
    tm = r0["timed"]
    print(f"  4-bit IHT, {SHARDED_TIMED_ITERS} untraced iterations on "
          f"{RANKS} ranks sharing the card over gloo: "
          f"{tm['iterations/s']:.1f} iterations/s (host clock, "
          f"{tm['host ms']:.4f} ms/iteration; CUDA events "
          f"{tm['events ms']:.4f} ms)")
    print("  per-leg split (rank 0, the Phi leg): " + ", ".join(
        f"{k} {v:.4f}" for k, v in tm.items()
        if k.endswith(" ms") and k not in ("host ms", "events ms")))
    for mode, sv in r0["server"].items():
        if sv["lsb"] > 1 or sv["rtol"] > MVM_SCALE_RTOL:
            raise AssertionError(f"sharded server {mode}: {sv['lsb']} LSB, "
                                 f"scale rtol {sv['rtol']} from tt.mvm")
        print(f"  ShardedMVMServer {mode} {NS}x{NS}: {sv['requests']} "
              f"requests in {sv['wall s'] * 1e3:.2f} ms, "
              f"{sv['requests'] / sv['wall s']:.1f} requests/s, p50 "
              f"{sv['p50 ms']:.3f} ms p99 {sv['p99 ms']:.3f} ms; within "
              f"{sv['lsb']} LSB of tt.mvm, scales rtol {sv['rtol']:.3g}")
    if len(r0["server"]) != len(MODES):
        raise AssertionError("phase 14: a server mode did not run")
    print("\n".join(f"  {line}" for line in r0["perf"]))
    rows = ("mvm 4x4 direct n=4096", "mvm_psum 4x4 n=4096 2x4",
            "mvm_psum-ovl4 4x4 n=4096 2x4", "IHT 4-bit single 2048x4096",
            "IHT 4-bit sharded 2048x4096 2x4")
    missing = [row for row in rows if not any(
        line.startswith(row) for line in r0["perf"])]
    if missing:
        raise AssertionError(f"-p --sharded on 2x4: rows {missing} missing")
    counts = {name: sum(r["counts"][name] for r in ranks)
              for name in KERNEL_INFO}
    print(f"  launches, summed over the ranks {counts}")
    return counts


def phase_sharded_cli():
    """``-p --sharded --quick`` through the CLI in this process: a world of
    one, a 1x1 mesh; -> its launch counts."""
    import torch
    import torch.distributed as dist
    from clover_tpu_torch import kernels
    print("== 15. python -m clover_tpu_torch -p --sharded --quick: a 1x1 "
          "mesh in this process")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = cli_output(["-p", "--sharded", "--quick"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(out.rstrip())
    rows = ("mvm 4x4 direct n=4096", "mvm_psum 4x4 n=4096 1x1",
            "mvm_psum-ovl4 4x4 n=4096 1x1", "IHT 4-bit single 2048x4096",
            "IHT 4-bit sharded 2048x4096 1x1",
            "sharded solution bit-identical to the single solve")
    missing = [row for row in rows if row not in out]
    print(f"  backend {dist.get_backend()}; exit 0; wall {wall:.2f} s; "
          f"launches {counts}")
    dist.destroy_process_group()
    if missing:
        raise AssertionError(f"-p --sharded: {missing} missing")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from clover_tpu_torch.models import make_iht_problem
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phi, x_star, y = make_iht_problem(M, N, K, generator=gen)
    mats = serving_matrices(gen)
    rep = Report()
    phase_kernels(rep, phi, mats, gen)
    runs = [phase_main_path(rep, name, phi, x_star, y) for name in CONFIGS]
    for name in CONFIGS:
        phase_solve_parity(name, phi, x_star, y)
    runs.append(phase_batched_iht(phi))
    runs.append(phase_server(mats, gen))
    del phi, x_star, y, mats
    torch.cuda.empty_cache()
    runs.append(phase_small_iht())
    runs.append(phase_accuracy())
    runs.append(phase_validate())
    runs.append(phase_large_iht(rep))
    runs.append(phase_perf())
    runs.append(phase_search())
    phase_checkpoint(torch.Generator(device="cuda").manual_seed(SEED + 5))
    t0 = time.perf_counter()
    runs.append(phase_sharded())
    runs.append(phase_sharded_cli())
    print(f"  phases 14-15: {time.perf_counter() - t0:.2f} s")
    launches = {kernel: sum(run[kernel] for run in runs)
                for kernel in KERNEL_INFO}
    for kernel, n in launches.items():
        if n == 0:
            raise AssertionError(f"{kernel} never launched on a main path")
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": rep.err[name], "ms": rep.ms[name],
                "plain_ms": rep.plain_ms[name],
                "bound_ms": rep.bound[name][0],
                "bound_by": rep.bound[name][1],
                "library_ms": rep.library_ms[name]}
               for name, (src, replaces) in KERNEL_INFO.items()]
    # beside mvm4's 8192x16384 leg: phase 10's 2048x524288 Phi leg
    large = kernels[list(KERNEL_INFO).index("mvm4")]
    large["large_n_phi_ms"], large["large_n_phi_bound_ms"] = rep.large["Phi"]
    # beside the dot's back-to-back time (its pair fits in the L2): the same
    # call rotating through copies past the L2
    dot = kernels[list(KERNEL_INFO).index("dot")]
    dot["rotating_ms"] = rep.rotating_ms["dot"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
