"""Time the MVM legs, the set-up kernels, the thresholds, the iteration
kernels and the dot of two checkouts of clover_tpu_torch on one card.

    python3 kernel_ab.py OTHER_TREE
    python3 kernel_ab.py --sass OTHER_TREE
    python3 kernel_ab.py --rows
    python3 kernel_ab.py --e2e OTHER_TREE

Runs OTHER_TREE (A) and this tree (B) in turns -- A, B, B, A -- each in a
fresh process that builds its own tree's kernels and times both legs of
the 8192x16384 IHT for mvm4 (4x4) and mvm8 (4x8, 8x8), both legs of the
2048x524288 4-bit IHT (chip_smoke.py's phase 10), the f32-output MVM on a
4096x4096 block (a 2x4 shard of the 8192x16384 matrix, through a ring of
copies past the 50 MB L2), the main path's set-up kernels at 8192x16384
(csrc/quantize.cu quantize_mat, 4- and 8-bit, det and SR;
csrc/transpose.cu, 4- and 8-bit) and quantize_mat at the solve cell's
16384x32768 (SR 4-bit, last and alone), the exact thresholds
(csrc/threshold.cu: 4- and 8-bit at the main path's n = 16384, K = 4096,
single and stacked B = 8, and the 4-bit radix select at n = 2^19, K =
64), the whole-iteration kernel of the small IHT at 4096x8192, 2048x4096
and 512x1024 and the chained one (4 iterations) at 4096x8192, 4x4 and
4x8, SR on, the dot (csrc/dot.cu: 4- and 8-bit at n = 2^24 and 16384 back to back, and at 2^24
rotating through 256 MB of copies, past the 50 MB L2), and the batched MVM
(csrc/mvm_batched.cu: 4x4, 4x8 and 8x8 at 8192x16384 with B = 8, 4x4 at
16384x16384 with B = 2, 8 and 32, SR on; the f32-output mode, 4x4 at
8192x16384 with B = 8), each set-up, threshold, iteration, dot and batched
leg first held bit for bit to its plain version (the dot to its plain
version in the kernel's order), as chip_smoke.py's phase 2 does:
the median of 5 windows
of 20 back-to-back launches queued behind a spin kernel.  It also times
the host's side of one mvm4_cuda call on a 128x256 problem ("mvm4
host-call": the median of 5 windows of 1000 calls enqueued back to back,
where the device's 0.003 ms per call hides behind the host's).  Prints
the card, one JSON line per run and, last, each kernel's mean time in A
and B with B's change, and A's own spread.

With ``--rows`` it times this tree alone: every MVM leg above at each
rows-per-warp geometry of csrc/mvm.cu (kernels/mvm.py ROWS_PER_WARP),
each output held bit for bit to the plain version first, and marks the
geometry kernels/mvm.py rows_per_warp picks.

With ``--e2e`` it runs each tree's own chip_smoke.py phases, each run a
fresh process: E2E_ROUNDS rounds of A, B, B, A runs of phase 3's
untraced 4-bit 8192x16384 solve (iterations/s, the wall ms of 5 whole
solves from quantize(Phi) to the result, set-up included, and one whole
solve's device ms by torch.profiler), phase 5 (the batched
IHT, and its device time per batched iteration by torch.profiler), phase
6 (the MVMServer), phase 7 (the small IHT: chained and traced
iterations/s at 4096x8192 and 2048x4096, 4x4 and 4x8), phase 8 (the wall
time of a deterministic -a), phase 9 (the wall time of -v) and phase 10
(the large-n 4-bit IHT, 2048x524288), then phase 14 (the sharded path
on 8 ranks sharing the card) once in each tree, and prints each tree's
median of every rate over its runs.  The batching and serving paths are
host-bound where their kernels are fast, and one run of them spreads by
tens of percent between processes; phase 5's 8 single solves run the
same kernels in both trees and show the host's drift.

With ``--sass`` it times nothing: it builds both trees' libraries and
compares the machine code (``cuobjdump -sass``) of every kernel, printing
for each whether A's and B's instructions are the same, differ, or exist
in one tree only, and for each kernel whose code is not in both trees,
in either tree, its count of tensor-core (IMMA, IGMMA, HMMA) and IDP.4A
instructions, of all its instructions, and of those of its longest loop
with their commonest opcodes (a persistent kernel's work per step).
"""

from __future__ import annotations

import functools
import hashlib
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

M, N, K = 8192, 16384, 4096
MU = 0.0002138596817016602      # the tuned 4-bit mu at this size
SMALL = ((4096, 8192), (2048, 4096), (512, 1024))  # the iteration kernels'
SMALL_MU = 0.0005050158681869508
DOT_SIZES = (1 << 24, 16384)    # the dot: chip_smoke.py's timed sizes
DOT_RING_BYTES = 256 << 20      # rotating copies of a dot's operands
LARGE = (2048, 524288)          # the large-n IHT (chip_smoke.py phase 10)
SHARD = (4096, 4096)            # a 2x4 mesh's block of the M x N matrix
BATCHED = 8                     # the batched IHT's B (chip_smoke.py phase 5)
SERVED = (16384, (2, 8, 32))    # the served matrices' side, batch sizes
RING_BYTES = 512 << 20          # copies of the shard pass the 50 MB L2
HOST_CALLS = 1000
E2E_ROUNDS = 4
# chip_smoke.py's printed rates that --e2e collects: name -> pattern
E2E_RATES = {
    "phase 5 batched untraced": r"batched untraced: ([\d.]+) problem-iter",
    "phase 5 batched traced": r"batched traced: ([\d.]+) problem-iter",
    "phase 5 8 single solves": r"8 single solves untraced: ([\d.]+) problem",
    "phase 6 server 4x4": r"^  4x4: .* ([\d.]+) requests/s",
    "phase 6 server 4x8": r"^  4x8: .* ([\d.]+) requests/s",
    "phase 6 server 8x8": r"^  8x8: .* ([\d.]+) requests/s",
    "phase 10 large-n IHT": r"^  10 untraced iterations: ([\d.]+) "
                            r"iterations/s",
    "phase 14 sharded IHT": r"gloo: ([\d.]+) iterations/s",
    "phase 14 sharded server 4x4": r"MVMServer 4x4 .* ([\d.]+) requests/s",
}
# phase 7's header line of a size and mode, and its rates below it
SMALL_HEADER = re.compile(r"^  (4x\d) (\d+x\d+) K=")
SMALL_RATE = re.compile(r"^    (chained|traced)\s+([\d.]+) iterations/s")
SPIN_CYCLES = 1 << 23
CELL_PHI = (16384, 32768)       # the solve cell's Phi, quantized per request


def median_ms(fn, reps: int = 5, inner: int = 20) -> float:
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[reps // 2]


def legs(tt, kn, torch) -> dict:
    """Leg name -> (one MVM launch at the shapes of the module note, SR on;
    its plain version on the same operands; A's rows), the operands made
    once, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    phi = torch.rand(M, N, generator=gen, device="cuda") * 2 - 1
    y = torch.rand(M, generator=gen, device="cuda") * 2 - 1
    xf = torch.randn(N, generator=gen, device="cuda")
    out = {}

    def add(name, cuda, plain, leg):
        out[name] = (functools.partial(cuda, *leg),
                     functools.partial(plain, *leg), leg[0].shape[0])

    for bits_a, bits_x in ((4, 4), (4, 8), (8, 8)):
        a = tt.quantize(phi, bits_a)
        at = tt.transpose(a)
        qy, qx = tt.quantize(y, bits_x), tt.quantize(xf, bits_x)
        cuda, plain = ((kn.mvm4_cuda, kn.mvm4_plain) if bits_x == 4 else
                       (functools.partial(kn.mvm8_cuda, bits_a),
                        functools.partial(kn.mvm8_plain, bits_a)))
        leg1 = (a.codes, a.scales, qx.codes, qx.scales, qy.codes, qy.scales,
                -1.0, 1, True, 2, True)
        leg2 = (at.codes, at.scales, *cuda(*leg1), qx.codes, qx.scales, MU,
                1, True, 2, True)
        mode = f"mvm{bits_x} {bits_a}x{bits_x}"
        add(f"{mode} Phi", cuda, plain, leg1)
        add(f"{mode} PhiT", cuda, plain, leg2)
    rows, cols = SHARD
    q = tt.quantize(phi[:rows, :cols].contiguous(), 4)
    qx = tt.quantize(xf[:cols].contiguous(), 4)
    one = (q.codes, q.scales, qx.codes, qx.scales)
    ring = [[t.clone() for t in one]
            for _ in range(-(-RING_BYTES // sum(t.nbytes for t in one)))]
    turn = itertools.count()
    out["mvm_f32 4x4 shard"] = (
        lambda: kn.mvm_f32_cuda(4, 4, *ring[next(turn) % len(ring)]),
        functools.partial(kn.mvm_f32_plain, 4, 4, *one), rows)
    del phi
    m, n = LARGE
    big = torch.rand(m, n, generator=gen, device="cuda") * 2 - 1
    a = tt.quantize(big, 4)
    del big
    at = tt.transpose(a)
    qy = tt.quantize(torch.rand(m, generator=gen, device="cuda") * 2 - 1, 4)
    qx = tt.quantize(torch.randn(n, generator=gen, device="cuda"), 4)
    leg1 = (a.codes, a.scales, qx.codes, qx.scales, qy.codes, qy.scales,
            -1.0, 1, True, 2, True)
    leg2 = (at.codes, at.scales, *kn.mvm4_cuda(*leg1), qx.codes, qx.scales,
            1.0 / m, 1, True, 2, True)
    add("mvm4 4x4 large Phi", kn.mvm4_cuda, kn.mvm4_plain, leg1)
    add("mvm4 4x4 large PhiT", kn.mvm4_cuda, kn.mvm4_plain, leg2)
    return out


def batched_legs(tt, kn, torch) -> dict:
    """Leg name -> (one batched MVM launch, SR on; its plain version on the
    same operands), the operands made once, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(2)

    def operands(m, n, bits_a, bits_x, b):
        a = tt.quantize(torch.rand(m, n, generator=gen, device="cuda") * 2
                        - 1, bits_a)
        xs = tt.stack_vectors([tt.quantize(torch.randn(
            n, generator=gen, device="cuda"), bits_x) for _ in range(b)])
        return a.codes, a.scales, xs.codes, xs.scales

    out = {}
    for bits_a, bits_x in ((4, 4), (4, 8), (8, 8)):
        args = (bits_a, bits_x, *operands(M, N, bits_a, bits_x, BATCHED),
                1, True)
        out[f"mvm_batched {bits_a}x{bits_x} B={BATCHED}"] = (
            functools.partial(kn.mvm_batched_cuda, *args),
            functools.partial(kn.mvm_batched_plain, *args))
        if (bits_a, bits_x) == (4, 4):
            f32 = args[:6]
            out[f"mvm_batched_f32 4x4 B={BATCHED}"] = (
                functools.partial(kn.mvm_batched_f32_cuda, *f32),
                functools.partial(kn.mvm_batched_f32_plain, *f32))
    side, sizes = SERVED
    a_codes, a_scales, x_codes, x_scales = operands(side, side, 4, 4,
                                                    max(sizes))
    for b in sizes:
        args = (4, 4, a_codes, a_scales, x_codes[:b], x_scales[:b], 1, True)
        out[f"mvm_batched 4x4 {side}^2 B={b}"] = (
            functools.partial(kn.mvm_batched_cuda, *args),
            functools.partial(kn.mvm_batched_plain, *args))
    return out


def threshold_legs(tt, kn, torch) -> dict:
    """Leg name -> (one threshold launch on dense SR data; its plain
    version), the operands made once, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def vector(n, bits):
        return tt.quantize(torch.randn(n, generator=gen, device="cuda"),
                           bits, generator=gen)

    out = {}
    for bits in (4, 8):
        cuda = kn.threshold4_cuda if bits == 4 else kn.threshold8_cuda
        plain = (kn.threshold4_plain if bits == 4 else
                 lambda c, s, k: kn.threshold8_plain(c, s, k, c.shape[-1]))
        q = vector(N, bits)
        stack = tt.stack_vectors([vector(N, bits) for _ in range(BATCHED)])
        for name, v in ((f"n={N} K={K}", q),
                        (f"B={BATCHED} n={N} K={K}", stack)):
            out[f"threshold{bits} {name}"] = (
                functools.partial(cuda, v.codes, v.scales, K),
                functools.partial(plain, v.codes, v.scales, K))
    q = vector(LARGE[1], 4)
    out["threshold4 n=2^19 K=64"] = (
        functools.partial(kn.threshold4_cuda, q.codes, q.scales, 64),
        functools.partial(kn.threshold4_plain, q.codes, q.scales, 64))
    return out


def iteration_legs(tt, kn, torch) -> dict:
    """Leg name -> (one whole-iteration launch of the small IHT at each of
    SMALL's sizes, or a chained one (4 iterations, k = n/4) at the first,
    4x4 and 4x8, SR on; its plain version)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for m, n in SMALL:
        q = tt.quantize(torch.rand(m, n, generator=gen, device="cuda") * 2
                        - 1, 4)
        qt = tt.transpose(q)
        y = torch.rand(m, generator=gen, device="cuda") * 2 - 1
        x = torch.randn(n, generator=gen, device="cuda")
        size = "" if (m, n) == SMALL[0] else f" {m}x{n}"
        for bits_x in (4, 8):
            ops = [(v.codes, v.scales) for v in (
                q, qt, tt.quantize(y, bits_x), tt.quantize(x, bits_x))]
            one = (4, bits_x, *ops, SMALL_MU, [1, 2, 3, 4], (True,) * 4)
            out[f"iteration 4x{bits_x}{size}"] = (
                functools.partial(kn.iteration_cuda, *one),
                functools.partial(kn.iteration_plain, *one))
            if (m, n) == SMALL[0]:
                chain = (4, bits_x, *ops, SMALL_MU, n // 4, list(range(16)),
                         (True,) * 4)
                out[f"iteration_chain 4x{bits_x}"] = (
                    functools.partial(kn.iteration_chain_cuda, *chain),
                    functools.partial(kn.iteration_chain_plain, *chain))
    return out


def dot_legs(tt, kn, torch) -> dict:
    """Leg name -> (one dot launch at each of DOT_SIZES, 4- and 8-bit, back
    to back, and at 2^24 also rotating through copies past the 50 MB L2;
    its plain version in the kernel's order, dot_plain_ordered).  A tree
    without that version (whose kernel sums in no plain version's order)
    holds its kernel to a second call and within 1e-5 of sum |t_b| of
    dot_plain."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    ordered = getattr(kn, "dot_plain_ordered", None)
    out = {}
    for n in DOT_SIZES:
        for bits in (4, 8):
            ops = tuple(t for q in (tt.quantize(torch.rand(
                n, generator=gen, device="cuda") * 2 - 1, bits,
                generator=gen) for _ in range(2))
                for t in (q.codes, q.scales)) + (bits,)
            call = functools.partial(kn.dot_cuda, *ops)
            if ordered is not None:
                plain = functools.partial(ordered, *ops)
            else:
                def plain(ops=ops, call=call):
                    got, terms = call(), kn.dot_terms(*ops)
                    if float((got - terms.sum()).abs()) > \
                            1e-5 * float(terms.abs().sum()):
                        raise AssertionError("dot: kernel far from plain")
                    return got
            name = f"dot {bits}-bit n={'2^24' if n == 1 << 24 else n}"
            out[name] = (call, plain)
            if n == 1 << 24:
                per = sum(t.nbytes for t in ops[:4])
                ring = [[t.clone() for t in ops[:4]]
                        for _ in range(-(-DOT_RING_BYTES // per))]
                turn = itertools.count()
                out[f"{name} rotating"] = (
                    lambda ring=ring, turn=turn, bits=bits: kn.dot_cuda(
                        *ring[next(turn) % len(ring)], bits), plain)
    return out


def setup_legs(tt, kn, torch) -> dict:
    """Leg name -> (one launch of a main path's set-up kernel at 8192x16384:
    quantize_mat, 4- and 8-bit, det and SR, and transpose4 and transpose8
    of SR codes; its plain version), the operands made once, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    phi = torch.rand(M, N, generator=gen, device="cuda") * 2 - 1
    out = {}
    for bits in (4, 8):
        for mode, noise in (("det", False), ("SR", True)):
            args = (phi, bits, 1, noise)
            out[f"quantize_mat {bits}-bit {mode}"] = (
                functools.partial(kn.quantize_mat_cuda, *args),
                functools.partial(kn.quantize_mat_plain, *args))
        codes = kn.quantize_mat_cuda(phi, bits, 1, True)[0]
        cuda, plain = ((kn.transpose4_cuda, kn.transpose4_plain) if bits == 4
                       else (kn.transpose8_cuda, kn.transpose8_plain))
        out[f"transpose{bits}"] = (functools.partial(cuda, codes),
                                   functools.partial(plain, codes))
    return out


def cell_leg(tt, kn, torch) -> tuple:
    """(one SR 4-bit quantize_mat launch at the solve cell's CELL_PHI, 2^29
    elements on 32-bit Philox counters; its plain version), the operand
    made on the card.  Timed last and alone: the plain version's int64
    Philox words take ~40 GB there."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    phi = torch.rand(*CELL_PHI, generator=gen, device="cuda") * 2 - 1
    args = (phi, 4, 1, True)
    return (functools.partial(kn.quantize_mat_cuda, *args),
            functools.partial(kn.quantize_mat_plain, *args))


def same(got, want, torch) -> bool:
    """Kernel output equal to the plain one: (codes, scales), or f32 bits."""
    if isinstance(got, tuple):
        return all(torch.equal(g, w) for g, w in zip(got, want))
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def host_call_ms(tt, kn, torch, reps: int = 5) -> float:
    """Host time of one mvm4_cuda call on a 128x256 problem (ms): the
    median over ``reps`` windows of the mean of HOST_CALLS calls enqueued
    back to back, each window ending in a synchronize."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = tt.quantize(torch.rand(128, 256, generator=gen, device="cuda"), 4)
    x = tt.quantize(torch.rand(256, generator=gen, device="cuda"), 4)
    args = (a.codes, a.scales, x.codes, x.scales)
    times = []
    for _ in range(reps + 1):                 # the first window warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            kn.mvm4_cuda(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / HOST_CALLS * 1e3)
    return sorted(times[1:])[reps // 2]


def load_tree(tree: str):
    sys.path[0] = tree
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch import kernels as kn
    if not Path(tt.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {tt.__file__}, not {tree}")
    kn._build.library()
    return tt, kn, torch


def child(tree: str) -> None:
    """Time the legs with the package of ``tree``; print one JSON line."""
    tt, kn, torch = load_tree(tree)
    out = {name: median_ms(call)
           for name, (call, _, _) in legs(tt, kn, torch).items()}
    torch.cuda.empty_cache()
    checked = {**setup_legs(tt, kn, torch),
               **threshold_legs(tt, kn, torch),
               **iteration_legs(tt, kn, torch),
               **dot_legs(tt, kn, torch),
               **batched_legs(tt, kn, torch)}
    for name, (call, plain) in checked.items():
        if not same(call(), plain(), torch):
            raise AssertionError(f"{tree}: {name}: kernel != plain")
        out[name] = median_ms(call)
    del checked
    torch.cuda.empty_cache()
    call, plain = cell_leg(tt, kn, torch)
    if not same(call(), plain(), torch):
        raise AssertionError(f"{tree}: the cell's quantize_mat: kernel != "
                             f"plain")
    torch.cuda.empty_cache()
    out["quantize_mat 4-bit SR 16384x32768"] = median_ms(call, inner=5)
    out["mvm4 host-call"] = host_call_ms(tt, kn, torch)
    print(json.dumps({"tree": tree, "ms": out}), flush=True)


def sweep_rows() -> None:
    """This tree's MVM legs at every rows-per-warp geometry, each output
    first held bit for bit to its plain version."""
    here = str(Path(__file__).resolve().parent)
    tt, kn, torch = load_tree(here)
    from clover_tpu_torch.kernels import mvm as kmvm
    chosen = kmvm.rows_per_warp
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (call, plain, m_pad) in legs(tt, kn, torch).items():
        want, times = plain(), {}
        for rows in kmvm.ROWS_PER_WARP:
            kmvm.rows_per_warp = lambda m_pad, sms, rows=rows: rows
            try:
                got = call()
                if not same(got, want, torch):
                    raise AssertionError(f"{name} rows={rows}: kernel != "
                                         f"plain")
                times[rows] = median_ms(call)
            finally:
                kmvm.rows_per_warp = chosen
        del want
        pick = chosen(m_pad, sms)
        print(f"{name:22s} " + "  ".join(
            f"R={r} {ms:.4f}{'*' if r == pick else ' '}"
            for r, ms in times.items()) + " ms (* the rule's), bit-identical",
            flush=True)


def batched_device_ms(cs, phi, iters: int = 20) -> float:
    """Device time (kernels and copies, torch.profiler) per iteration of
    the untraced batched IHT of chip_smoke.py phase 5, on its operands."""
    import torch
    import clover_tpu_torch as tt
    bits_a, bits_v, _, mu, _ = cs.config("4")
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)
    stars = torch.zeros(cs.BATCH, cs.N, device="cuda")
    for j in range(cs.BATCH):
        stars[j, torch.randperm(cs.N, generator=g, device="cuda")[:cs.K]] = 1
    yf = (phi @ stars.T).T.contiguous()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    qphi = tt.quantize(phi, bits_a, generator=gen)
    ys = tt.stack_vectors([tt.quantize(yf[j], bits_v, generator=gen)
                           for j in range(cs.BATCH)])
    qphit = tt.transpose(qphi)
    tt.iht_batched(qphi, qphit, ys, 5, cs.K, mu)
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        tt.iht_batched(qphi, qphit, ys, iters, cs.K, mu)
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        us += e.self_cuda_time_total if t is None else t
    return us / iters / 1e3


def untraced_4bit(cs, phi, y) -> float:
    """Iterations/s of phase 3's untraced 4-bit 8192x16384 solve (host
    clock, TIMED_ITERS iterations after a warm-up)."""
    import torch
    import clover_tpu_torch as tt
    bits_a, bits_v, iters, mu, _ = cs.config("4")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    qphi = tt.quantize(phi, bits_a, generator=gen)
    qy = tt.quantize(y, bits_v, generator=gen)
    host_ms, _ = cs.timed_solve(qphi, tt.transpose(qphi), qy, iters, mu,
                                None)
    return 1e3 / host_ms


def whole_solve_ms(cs, phi, y, runs: int = 5) -> list:
    """Host-clock ms of each of ``runs`` whole untraced 4-bit solves of
    phase 3, from quantize(Phi) to the result (a synchronize), after a
    warm-up: the set-up kernels and the tuned iterations."""
    import torch
    import clover_tpu_torch as tt
    bits_a, bits_v, iters, mu, _ = cs.config("4")
    times = []
    for _ in range(runs + 1):
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qphi = tt.quantize(phi, bits_a, generator=gen)
        qy = tt.quantize(y, bits_v, generator=gen)
        tt.iht(qphi, tt.transpose(qphi), qy, iters, cs.K, mu)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times[1:]


def whole_solve_device_ms(cs, phi, y) -> float:
    """Device time (kernels and copies, torch.profiler) of one whole
    untraced 4-bit solve of phase 3, from quantize(Phi) to the result,
    after a warm-up: what the card spends, whatever the host adds."""
    import torch
    whole_solve_ms(cs, phi, y, 1)
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        whole_solve_ms(cs, phi, y, 0)
    us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        us += e.self_cuda_time_total if t is None else t
    return us / 1e3


def small_rates(text: str) -> dict:
    """Phase 7's chained and traced iterations/s by mode and size."""
    rates, head = {}, None
    for line in text.splitlines():
        found = SMALL_HEADER.match(line)
        if found:
            head = f"{found.group(1)} {found.group(2)}"
        found = SMALL_RATE.match(line)
        if found and head:
            rates[f"phase 7 {found.group(1)} {head}"] = [
                float(found.group(2))]
    return rates


def cli_wall_s(cs, argv) -> float:
    """Wall seconds of one ``python -m clover_tpu_torch`` run in this
    process (chip_smoke.py's cli_output, which raises unless it exits 0)."""
    t0 = time.perf_counter()
    cs.cli_output(argv)
    return time.perf_counter() - t0


def e2e_child(tree: str, sharded: bool) -> None:
    """Run ``tree``'s chip_smoke.py phases 3 (the untraced 4-bit solve and
    its whole solves), 5, 6, 7, 8 (the wall time of -a, deterministic), 9
    (the wall time of -v on the card) and 10 once (or, ``sharded``, phase
    14) and time the batched IHT's device work; print one JSON line of the
    rates each phase printed."""
    import contextlib
    import io
    sys.path[0] = tree
    import torch
    import chip_smoke as cs
    if not Path(cs.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {cs.__file__}, not {tree}")
    from clover_tpu_torch.models import make_iht_problem
    out, extra = io.StringIO(), {}
    with contextlib.redirect_stdout(out):
        cs.phase_build()
        if sharded:
            cs.phase_sharded()
        else:
            gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
            phi, _, y = make_iht_problem(cs.M, cs.N, cs.K, generator=gen)
            mats = cs.serving_matrices(gen)
            extra["phase 3 untraced 4-bit"] = [untraced_4bit(cs, phi, y)]
            extra["phase 3 whole solve ms"] = whole_solve_ms(cs, phi, y)
            extra["phase 3 whole solve device ms"] = [
                whole_solve_device_ms(cs, phi, y)]
            cs.phase_batched_iht(phi)
            cs.phase_server(mats, gen)
            extra["phase 5 device ms per batched iteration"] = [
                batched_device_ms(cs, phi)]
            del phi, y, mats
            torch.cuda.empty_cache()
            small = io.StringIO()
            with contextlib.redirect_stdout(small):
                cs.phase_small_iht()
            extra.update(small_rates(small.getvalue()))
            extra["phase 8 -a deterministic wall s"] = [cli_wall_s(
                cs, ["-a", "--epochs", str(cs.EPOCHS), "--no-sr"])]
            extra["phase 9 -v wall s"] = [cli_wall_s(cs, ["-v"])]
            cs.phase_large_iht(cs.Report())
    rates = {name: [float(v) for v in re.findall(pattern, out.getvalue(),
                                                 re.MULTILINE)]
             for name, pattern in E2E_RATES.items()}
    rates = {k: v for k, v in {**rates, **extra}.items() if v}
    print(json.dumps({"tree": tree, "rates": rates}), flush=True)


def e2e(trees: dict) -> None:
    """E2E_ROUNDS rounds of A, B, B, A runs of e2e_child (phases 3, 5, 6,
    7, 8, 9 and 10), then phase 14 once in A and in B; each tree's median
    of every rate."""
    import statistics
    runs = {"A": {}, "B": {}}
    order = [(label, False) for _ in range(E2E_ROUNDS) for label in "ABBA"]
    for label, sharded in order + [("A", True), ("B", True)]:
        argv = [sys.executable, __file__, "--e2e-child", trees[label]]
        proc = subprocess.run(argv + ["14"] * sharded, capture_output=True,
                              text=True, check=True, timeout=900)
        line = proc.stdout.strip().splitlines()[-1]
        print(label, line, flush=True)
        for name, values in json.loads(line)["rates"].items():
            runs[label].setdefault(name, []).extend(values)
    for name in runs["A"]:
        a, b = (statistics.median(runs[k][name]) for k in "AB")
        print(f"{name:28s} A {a:.4f}  B {b:.4f}  B/A - 1 = "
              f"{100 * (b / a - 1):+.2f}%  (A {min(runs['A'][name]):.4f}-"
              f"{max(runs['A'][name]):.4f}, B {min(runs['B'][name]):.4f}-"
              f"{max(runs['B'][name]):.4f}; {len(runs['A'][name])} runs "
              f"each)")


LIBRARY_OF = """
import sys
sys.path.insert(0, sys.argv[1])
import clover_tpu_torch
from pathlib import Path
from clover_tpu_torch.kernels import _build
assert Path(clover_tpu_torch.__file__).resolve().is_relative_to(
    Path(sys.argv[1]).resolve())
print(_build.library().path)
"""
# an instruction's line (its address, text and low 64 bits) and the line
# after it (its high 64 bits: the control bits)
INSTRUCTION = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/")
CONTROL = re.compile(r"^\s+/\* 0x[0-9a-f]{16} \*/\s*$")
# instructions counted in each kernel of B only: tensor-core products and
# the CUDA-core int8 dot
MIX = ("IMMA", "IGMMA", "HMMA", "IDP.4A")


def sass(tree: str) -> dict:
    """Kernel symbol -> its SASS instructions (``cuobjdump -sass``) in
    ``tree``'s library, built in a process of its own: each instruction's
    text and both 64-bit words of its encoding, with runs of blanks made
    one (cuobjdump pads every line to the widest instruction of the whole
    library, so the padding changes with kernels elsewhere)."""
    lib = subprocess.run([sys.executable, "-c", LIBRARY_OF, tree],
                         capture_output=True, text=True, check=True,
                         timeout=600).stdout.strip().splitlines()[-1]
    tool = shutil.which("cuobjdump") or str(Path(os.environ.get(
        "CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    bodies, name = {}, None
    for line in text.splitlines():
        found = re.match(r"\s*Function : (\S+)", line)
        if found:
            name = found.group(1)
            bodies[name] = []
        elif name is not None and (INSTRUCTION.match(line)
                                   or CONTROL.match(line)):
            bodies[name].append(" ".join(line.split()))
    return bodies


def count_instructions(body: list) -> int:
    return sum(1 for x in body if re.match(r"/\*[0-9a-f]+\*/", x))


def opcode(line: str) -> str:
    """The opcode of an instruction line (its predicate and modifiers
    dropped)."""
    found = re.match(r"/\*[0-9a-f]+\*/ (?:@!?U?P\w+ )?([A-Z0-9_]+)", line)
    return found.group(1) if found else ""


def longest_loop(body: list) -> list:
    """The instructions from the target of a backward branch to the branch,
    of the longest such span in a kernel's body (none when no branch goes
    back): a persistent kernel's per-tile work."""
    lines = [(int(m.group(1), 16), x) for x in body
             if (m := re.match(r"/\*([0-9a-f]+)\*/", x))]
    longest = []
    for at, x in lines:
        found = re.match(r"/\*[0-9a-f]+\*/.*\bBRA\b.*?0x([0-9a-f]+)", x)
        if found and int(found.group(1), 16) < at:
            span = [y for a, y in lines if int(found.group(1), 16) <= a <= at]
            longest = max(longest, span, key=len)
    return longest


def digest(body: list) -> tuple:
    return hashlib.sha256("\n".join(body).encode()).hexdigest()[:16], \
        len(body)


def show_diff(a_body: list, b_name: str, b_body: list) -> None:
    """How far A's kernel is from B's kernel ``b_name``: the count of
    differing instructions and the first of them."""
    import difflib
    lines = [x for x in difflib.unified_diff(a_body, b_body, lineterm="",
                                             n=0)
             if x[:1] in "+-" and x[:3] not in ("+++", "---")]
    print(f"    nearest in B: {b_name}: {len(lines)} lines differ")
    for x in lines[:12]:
        print(f"      {x[:110]}")


def compare_sass(trees: dict) -> None:
    """One line per kernel: same, DIFF, or only in A or B; a kernel of one
    tree only whose code equals a kernel of the other tree only (a
    template parameter added, say) is "renamed" and names it.  A DIFF, or
    a kernel of A left without a twin, is shown beside its nearest kernel
    of B."""
    import difflib
    bodies_a, bodies_b = sass(trees["A"]), sass(trees["B"])
    a = {k: digest(v) for k, v in bodies_a.items()}
    b = {k: digest(v) for k, v in bodies_b.items()}
    a_only = {a[k]: k for k in a if k not in b}
    b_only = {b[k]: k for k in b if k not in a}
    unmatched_b = [k for k in b if k not in a and b[k] not in a_only]
    tally = {}
    for name in sorted(set(a) | set(b)):
        nearest = None
        if name in a and name in b:
            verdict = "same" if a[name] == b[name] else "DIFF"
            nearest = name if verdict == "DIFF" else None
        elif name in b:
            twin = a_only.get(b[name])
            verdict = "only B" if twin is None else f"renamed from {twin}"
        else:
            if a[name] in b_only:
                continue                  # printed with its B twin
            verdict = "only A"
            nearest = max(unmatched_b, default=None, key=lambda k: (
                difflib.SequenceMatcher(None, bodies_a[name], bodies_b[k],
                                        autojunk=False).quick_ratio()))
        tally[verdict.split(" from ")[0]] = tally.get(
            verdict.split(" from ")[0], 0) + 1
        print(f"{verdict}: {name}  A {a.get(name)}  B {b.get(name)}")
        if nearest is not None:
            show_diff(bodies_a[name], nearest, bodies_b[nearest])
    print(f"{sum(tally.values())} kernels: " + ", ".join(
        f"{n} {v}" for v, n in sorted(tally.items())))
    for tree, name, body in (
            [("B", k, bodies_b[k]) for k in sorted(b) if bodies_a.get(k)
             != bodies_b[k]]
            + [("A", k, bodies_a[k]) for k in sorted(a) if bodies_b.get(k)
               != bodies_a[k]]):
        mix = {op: sum(1 for x in body
                       if re.search(rf"\b{re.escape(op)}\b", x))
               for op in MIX}
        loop = [opcode(x) for x in longest_loop(body)]
        top = sorted(((loop.count(op), op) for op in set(loop)),
                     reverse=True)[:12]
        print(f"{tree}'s {name}: " + ", ".join(f"{op} {n}" for op, n in
                                              mix.items())
              + f"; {count_instructions(body)} instructions, the longest "
              f"loop {len(loop)}: " + " ".join(f"{op} {n}" for n, op in top))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--e2e-child":
        e2e_child(sys.argv[2], sharded=sys.argv[3:] == ["14"])
        return 0
    if sys.argv[1:] == ["--rows"]:
        print(card())
        sweep_rows()
        return 0
    if len(sys.argv) == 3 and sys.argv[1] in ("--sass", "--e2e"):
        here = str(Path(__file__).resolve().parent)
        trees = {"A": str(Path(sys.argv[2]).resolve()), "B": here}
        print(card())
        (compare_sass if sys.argv[1] == "--sass" else e2e)(trees)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    here = str(Path(__file__).resolve().parent)
    trees = {"A": str(Path(sys.argv[1]).resolve()), "B": here}
    print(card())
    runs = {"A": [], "B": []}
    for label in "ABBA":
        proc = subprocess.run([sys.executable, __file__, "--child",
                               trees[label]], capture_output=True, text=True,
                              check=True, timeout=600)
        line = proc.stdout.strip().splitlines()[-1]
        print(label, line, flush=True)
        runs[label].append(json.loads(line)["ms"])
    for leg in runs["A"][0]:
        a = sum(r[leg] for r in runs["A"]) / 2
        b = sum(r[leg] for r in runs["B"]) / 2
        spread = abs(runs["A"][0][leg] - runs["A"][1][leg])
        print(f"{leg:22s} A {a:.4f} ms  B {b:.4f} ms  B/A - 1 = "
              f"{100 * (b / a - 1):+.2f}%  (A's runs {spread:.4f} ms apart)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
