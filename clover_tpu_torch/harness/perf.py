"""``-p`` performance mode: per-op time, bandwidth and share of the card's
memory rate (counterpart of clover_tpu/harness/perf.py, with its row names
and byte counts).

Every row is timed on the device (``harness/timing``: CUDA events around a
window of launches behind a spin kernel); on the CPU the rows are the plain
versions' host times and carry no share of any rate.  Columns: time per
op, GB/s (the row's bytes, every input read once and every output written
once, over that time), % of the card's data-sheet memory rate ("%spec"),
and the speedup over the fp32 row of the same op.

The L2 rule.  The H100's L2 holds 50 MB, so an op that reads the same
operands launch after launch reads L2, not device memory, whenever they
total less than about 200 MB.  Such a row rotates its launches through
``p = _slots(bytes)`` copies of its operands (together at least
``RING_BYTES``) and keeps each launch's output alive until its slot comes
round again, so no byte is touched twice within 512 MB of traffic.  The
rows meant to be warm -- the latency regime (``bench_small_warm``) and the
thresholds at n <= 2^20 -- say "L2-warm" in their name and give no %spec.
Any other row above 100% of spec raises: it would be reading a cache.

The fused MVM rows sit beside the probe floor (``kernels/probes.py``): the
cluster dma probe streams the same matrices through the fused MVM's own
launch geometry (a band over a cluster of CTAs, its rows per warp, its
ring of loads), and each 4/8-bit MVM row prints its rate as a share of
that floor, measured in the same run, as bench.py reports its headline
against the TPU's probe.  The dma probe of one CTA per 64-row band (the
whole-iteration kernels' layout) and the 512 MB salted stream print
beside it.
The fp32 baselines are torch calls (cuBLAS for the MVM) in IEEE fp32.
"""

from __future__ import annotations

import time

import torch

from .. import formats
from ..formats import QMat16, QMat32, QVec16, QVec32
from ..kernels import probes
from ..ops import _core
from ..ops.access import vec_gather
from ..ops.axpy import scale_and_add
from ..ops.dot import dot
from ..ops.gemm import mvm_batched
from ..ops.mvm import mvm
from ..ops.quantize import quantize, quantize_vec, restore_vec
from ..ops.threshold import threshold
from ..ops.transpose import transpose
from .timing import (
    HOST_SPIN_CYCLES, SPIN_CYCLES, call_time, gbs, memory_rate,
    pct_roofline, wall_time,
)

VEC_SIZES = [1 << 16, 1 << 20, 1 << 22, 1 << 24]
MVM_SIZES = [2048, 4096, 8192, 16384]
IHT_SIZES = [(2048, 4096), (4096, 8192), (8192, 16384)]
WARM_SIZES = [1 << 16, 1 << 17, 1 << 18]
GET = (1 << 20, 4096)         # gather: vector length, indices per call

RING_BYTES = 512 << 20
L2_REUSE_BYTES = 200 << 20    # operands below this would be read from L2
WARM_THRESHOLD_N = 1 << 20    # thresholds up to here are meant to be warm
IHT_ITERS = 20                # iterations of a timed solve
NAME_WIDTH = 36


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _row(log, name, nbytes, dt, base_dt=None, device="cuda",
         warm=False) -> float:
    """One table row; on the card, raise for a row that is not L2-warm
    and reads above 100% of the memory rate."""
    speed = f"{base_dt / dt:6.2f}x" if base_dt else "   ---"
    if not _cuda(device):
        pct = "---"
    elif warm:
        pct = "L2"
    else:
        share = pct_roofline(nbytes, dt, device)
        if share > 100.0:
            raise RuntimeError(f"{name}: above the card's memory rate, so "
                               f"it reads a cache; rotate its operands")
        pct = f"{share:.1f}%"
    log(f"{name:{NAME_WIDTH}s} {dt * 1e3:9.4f} ms {gbs(nbytes, dt):9.1f} GB/s "
        f"{pct:>6s} {speed}")
    return dt


def _slots(bytes_each: int, device, cap: int = 4096) -> int:
    """Operand copies a row rotates through: 1 on the CPU or when one
    launch already moves L2_REUSE_BYTES, else enough for RING_BYTES."""
    if not _cuda(device) or bytes_each >= L2_REUSE_BYTES:
        return 1
    return int(min(cap, -(-RING_BYTES // max(bytes_each, 1))))


def _time(fn, device, spin: int = SPIN_CYCLES) -> float:
    """Seconds per call of ``fn``: on the card the device time of a window
    of 20 calls behind the spin, median of MEASURE_REPETITIONS windows; on
    the CPU the host time of one call after a warm-up call."""
    if _cuda(device):
        return call_time(fn, device, spin=spin)
    return call_time(fn, device, k=1, reps=1)


def _ring_time(device, p: int, op, spin: int = SPIN_CYCLES) -> float:
    """Seconds per launch of ``op(j)``, launch i taking slot j = i % p and
    its output kept until the slot comes round again."""
    outs = [None] * p
    count = [0]

    def step():
        j = count[0] % p
        count[0] += 1
        outs[j] = op(j)
    return _time(step, device, spin)


def _copies(t: torch.Tensor, p: int) -> torch.Tensor:
    """p contiguous copies of ``t`` along a new leading dim."""
    return t.unsqueeze(0).repeat(p, *([1] * t.dim())).contiguous()


def _uniform(gen, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) * 2 - 1


def _vec_slots(q, p: int):
    """p copies of vector container q -> function slot j -> container."""
    if isinstance(q, (QVec16, QVec32)):
        values = _copies(q.values, p)
        return lambda j: type(q)(values=values[j], length=q.length)
    codes, scales = _copies(q.codes, p), _copies(q.scales, p)
    return lambda j: type(q)(codes=codes[j], scales=scales[j],
                             length=q.length)


def _mat_slots(q, p: int):
    """p copies of matrix container q -> function slot j -> container."""
    if isinstance(q, (QMat16, QMat32)):
        values = _copies(q.values, p)
        return lambda j: type(q)(values=values[j], rows=q.rows, cols=q.cols)
    codes, scales = _copies(q.codes, p), _copies(q.scales, p)
    return lambda j: type(q)(codes=codes[j], scales=scales[j], rows=q.rows,
                             cols=q.cols)


def _generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def bench_quantize(log, sizes=VEC_SIZES, device="cuda"):
    log("\n== vector quantize (fp32 -> q) — bytes = fp32 read + codes write")
    gen = _generator(device)
    for n in sizes:
        for bits in (4, 8, 16, 32):
            nbytes = 4 * n + quantize_vec(torch.zeros(n, device=device),
                                          bits).nbytes
            p = _slots(nbytes, device)
            X = _uniform(gen, (p, n), device)
            if bits == 32:
                # fp32 "quantize" is a copy (the reference's
                # CloverVector32 quantize)
                def op(j, X=X):
                    return X[j].clone()
            else:
                def op(j, X=X, bits=bits):
                    # an int seed: stochastic rounding with no host sync
                    return quantize_vec(X[j], bits, 7 + j)
            dt = _ring_time(device, p, op)
            del X
            _row(log, f"quantize {bits:2d}-bit n={n}", nbytes, dt,
                 device=device)


def bench_restore(log, sizes=VEC_SIZES, device="cuda"):
    log("\n== restore (q -> fp32) — bytes = codes read + fp32 write")
    gen = _generator(device)
    for n in sizes:
        for bits in (4, 8, 16):
            q = quantize_vec(_uniform(gen, n, device), bits)
            nbytes = q.nbytes + 4 * n
            p = _slots(nbytes, device)
            slot = _vec_slots(q, p)
            dt = _ring_time(device, p, lambda j: restore_vec(slot(j)))
            del slot
            _row(log, f"restore {bits:2d}-bit n={n}", nbytes, dt,
                 device=device)


def bench_dot(log, sizes=VEC_SIZES, device="cuda"):
    log("\n== dot — bytes = 2 vector reads")
    gen = _generator(device)
    for n in sizes:
        u, v = _uniform(gen, n, device), _uniform(gen, n, device)
        p = _slots(8 * n, device)
        U, V = _copies(u, p), _copies(v, p)
        with _core.ieee_fp32():
            t32 = _ring_time(device, p, lambda j: torch.dot(U[j], V[j]))
        del U, V
        _row(log, f"dot 32-bit n={n}", 8 * n, t32, device=device)
        for bits in (4, 8, 16):
            qu, qv = quantize(u, bits), quantize(v, bits)
            nbytes = 2 * qu.nbytes
            p = _slots(nbytes, device)
            su, sv = _vec_slots(qu, p), _vec_slots(qv, p)
            dt = _ring_time(device, p, lambda j: dot(su(j), sv(j)))
            del su, sv
            _row(log, f"dot {bits:2d}-bit n={n}", nbytes, dt, t32,
                 device=device)


def bench_axpy(log, sizes=VEC_SIZES, device="cuda"):
    log("\n== scaleAndAdd (dequant-FMA-requant) — bytes = 2 reads + 1 write")
    gen = _generator(device)
    for n in sizes:
        x, y = _uniform(gen, n, device), _uniform(gen, n, device)
        p = _slots(12 * n, device)
        X, Y = _copies(x, p), _copies(y, p)
        t32 = _ring_time(device, p,
                         lambda j: torch.add(Y[j], X[j], alpha=-0.5))
        del X, Y
        _row(log, f"scaleAndAdd 32-bit n={n}", 12 * n, t32, device=device)
        for bits in (4, 8, 16):
            qx, qy = quantize(x, bits), quantize(y, bits)
            nbytes = 3 * qx.nbytes
            p = _slots(nbytes, device)
            sx, sy = _vec_slots(qx, p), _vec_slots(qy, p)
            dt = _ring_time(device, p,
                            lambda j: scale_and_add(sx(j), sy(j), -0.5))
            del sx, sy
            _row(log, f"scaleAndAdd {bits:2d}-bit n={n}", nbytes, dt, t32,
                 device=device)


def bench_small_warm(log, sizes=WARM_SIZES, device="cuda"):
    """The latency regime: dot and AXPY on the same operands call after
    call, fp32 and quantized alike, so both sides read L2 (the reference's
    warm symmetric chains; its 15 warm repetitions of small N)."""
    log("\n== latency regime: warm symmetric single-op chains")
    gen = _generator(device)
    for n in sizes:
        u, v = _uniform(gen, n, device), _uniform(gen, n, device)
        with _core.ieee_fp32():
            tdf = _time(lambda: torch.dot(u, v), device)
        _row(log, f"L2-warm dot 32-bit n={n}", 8 * n, tdf, device=device,
             warm=True)
        taf = _time(lambda: torch.add(u, v, alpha=-0.5), device)
        _row(log, f"L2-warm axpy 32-bit n={n}", 12 * n, taf, device=device,
             warm=True)
        for bits in (4, 8):
            qu, qv = quantize(u, bits), quantize(v, bits)
            _row(log, f"L2-warm dot {bits:2d}-bit n={n}", 2 * qu.nbytes,
                 _time(lambda: dot(qu, qv), device), tdf, device=device,
                 warm=True)
            _row(log, f"L2-warm axpy {bits:2d}-bit n={n}", 3 * qu.nbytes,
                 _time(lambda: scale_and_add(qu, qv, -0.5), device), taf,
                 device=device, warm=True)


def bench_threshold(log, sizes=VEC_SIZES[:2], k: int = 64, device="cuda"):
    log(f"\n== threshold (top-K, K={k}) — bytes = 1 read + 1 write")
    gen = _generator(device)
    for n in sizes:
        x = _uniform(gen, n, device)
        warm = n <= WARM_THRESHOLD_N
        for bits in (4, 8, 16, 32):
            q = quantize(x, bits)
            nbytes = 2 * q.nbytes
            p = 1 if warm else _slots(nbytes, device)
            slot = _vec_slots(q, p)
            # the 4-bit hybrid (n >= 2^19) and the 16/32-bit thresholds are
            # ~20 torch launches each: the long spin covers their enqueue
            dt = _ring_time(device, p, lambda j: threshold(slot(j), k),
                            spin=HOST_SPIN_CYCLES)
            del slot
            name = f"threshold {bits:2d}-bit n={n}"
            _row(log, f"L2-warm {name}" if warm else name, nbytes, dt,
                 device=device, warm=warm)


def bench_get(log, n=GET[0], r=GET[1], device="cuda"):
    """Element access: one gather of r random indices, dequantized
    (ops/access.vec_gather), per element."""
    log(f"\n== element get (gather of {r} random indices, n={n}) — ns/elem")
    gen = _generator(device)
    x = _uniform(gen, n, device)
    idx = torch.randint(0, n, (r,), generator=gen, device=device)
    for bits in (4, 8, 16, 32):
        q = quantize(x, bits)
        dt = _time(lambda: vec_gather(q, idx), device)
        log(f"get {bits:2d}-bit                     {dt * 1e3:9.4f} ms "
            f"{dt / r * 1e9:9.2f} ns/elem")


def _probe_rows(log, n: int, q, p: int, device) -> float:
    """The probe floors of matrix q: the cluster dma probe (the fused
    MVM's geometry) and the dma probe (one CTA per band) over the p copies
    the MVM rows rotate through (the same bytes), and the salted probe over
    q's codes stacked to RING_BYTES, one launch per time; -> the cluster
    dma probe's bytes/s, the MVM's floor."""
    ring = _copies(q.codes, p)
    dc = _ring_time(device, p, lambda j: probes.dma_probe_cluster(ring[j]))
    dt = _ring_time(device, p, lambda j: probes.dma_probe(ring[j]))
    del ring
    nbytes = q.codes.nbytes
    _row(log, f"dma probe cluster {q.bits}-bit n={n}", nbytes, dc,
         device=device)
    _row(log, f"dma probe {q.bits}-bit n={n}", nbytes, dt, device=device)
    stacked, slabs = probes.stacked_codes(q, RING_BYTES if _cuda(device)
                                          else 0)
    salt = torch.zeros(1, device=device)
    ds = _time(lambda: probes.salted_probe(stacked, salt), device)
    del stacked
    _row(log, f"dma probe stream {q.bits}-bit n={n}", nbytes, ds / slabs,
         device=device)
    return nbytes / dc


def bench_mvm(log, sizes=MVM_SIZES, device="cuda"):
    log("\n== fused MVM (quantized in, requantized out) — bytes = matrix")
    gen = _generator(device)
    one = torch.ones(64, 128, dtype=torch.int8, device=device)
    salt = torch.zeros(1, device=device)
    dl = _time(lambda: probes.salted_probe(one, salt), device)
    log(f"{'launch probe (one 64x128 tile)':{NAME_WIDTH}s} {dl * 1e3:9.4f} ms"
        f"   the fixed cost of one launch")
    for n in sizes:
        A = _uniform(gen, (n, n), device)
        x = _uniform(gen, n, device)
        p = _slots(4 * n * n, device)
        ring = _copies(A, p) if p > 1 else A[None]
        with _core.ieee_fp32():
            t32 = _ring_time(device, p, lambda j: ring[j] @ x)
        del ring
        _row(log, f"mvm 32-bit (matmul) n={n}", 4 * n * n, t32,
             device=device)
        for ba, bxs in ((4, (4, 8)), (8, (8,)), (16, (16,))):
            qA = quantize(A, ba)
            p = _slots(qA.nbytes, device)
            # the floor is timed next to the MVM rows of the same matrix
            floor = _probe_rows(log, n, qA, p, device) if ba < 16 else None
            slot = _mat_slots(qA, p)
            for bx in bxs:
                qx = quantize(x, bx)
                dt = _ring_time(device, p, lambda j: mvm(slot(j), qx))
                _row(log, f"mvm {ba:2d}x{bx:2d}-bit n={n}", qA.nbytes, dt,
                     t32, device=device)
                if floor:
                    log(f"{'':{NAME_WIDTH}s} -> "
                        f"{100.0 * qA.nbytes / dt / floor:5.1f}% of the "
                        f"{ba}-bit cluster probe floor "
                        f"({floor / 1e9:.1f} GB/s)")
            del slot
        del A


def bench_mvm_batched(log, sizes=MVM_SIZES[-2:], batches=(1, 4, 16),
                      device="cuda"):
    """Serving throughput: B requests ride one matrix stream
    (kernels/mvm_batched.py)."""
    log("\n== batched MVM (one matrix stream per batch) — mvm/s")
    gen = _generator(device)
    for n in sizes:
        A = _uniform(gen, (n, n), device)
        x = _uniform(gen, n, device)
        for (ba, bx) in ((4, 4), (8, 8)):
            qA, qx = quantize(A, ba), quantize(x, bx)
            p = _slots(qA.nbytes, device)
            slot = _mat_slots(qA, p)
            base = None
            for b in batches:
                xs = formats.stack_vectors([qx] * b)
                dt = _ring_time(device, p,
                                lambda j: mvm_batched(slot(j), xs))
                base = base or dt
                log(f"mvm_batched {ba}x{bx} n={n} B={b:<3d}"
                    f"   {dt * 1e3:10.4f} ms/batch {b / dt:10.0f} mvm/s"
                    f"  {b * base / dt:5.1f}x vs B=1")
            del slot


def bench_transpose(log, sizes=MVM_SIZES, device="cuda"):
    log("\n== transpose — bytes = 1 matrix read + 1 write")
    gen = _generator(device)
    for n in sizes:
        A = _uniform(gen, (n, n), device)
        p = _slots(8 * n * n, device)
        ring = _copies(A, p) if p > 1 else A[None]
        t32 = _ring_time(device, p, lambda j: ring[j].t().contiguous())
        del ring
        _row(log, f"transpose 32-bit n={n}", 8 * n * n, t32, device=device)
        for bits in (4, 8, 16):
            qA = quantize(A, bits)
            nbytes = 2 * qA.nbytes
            p = _slots(nbytes, device)
            slot = _mat_slots(qA, p)
            if bits == 16:
                def op(j):
                    return slot(j).values.t().contiguous()
            else:
                def op(j):
                    return transpose(slot(j))
            dt = _ring_time(device, p, op)
            del slot
            _row(log, f"transpose {bits:2d}-bit n={n}", nbytes, dt, t32,
                 device=device)
        del A


IHT_CONFIGS = (("4x8", 4, 8), ("4", 4, 4), ("8", 8, 8),
               ("16", 16, 16), ("32", 32, 32))


def _solve_time(solve, device, iters: int) -> tuple[float, float | None]:
    """-> (host-clock s, CUDA-event s or None) per iteration of
    ``solve(iters)``, after a 2-iteration warm-up."""
    solve(2)
    cuda = _cuda(device)
    if cuda:
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    solve(iters)
    if cuda:
        end.record()
        end.synchronize()
    host = (time.perf_counter() - t0) / iters
    return host, (start.elapsed_time(end) / 1e3 / iters if cuda else None)


def _iht_problem(gen, m: int, n: int, device):
    """Phi ~ U(-1, 1) and y = Phi x / max|Phi x| for a dense x ~ U(0, 1)."""
    phi = _uniform(gen, (m, n), device)
    with _core.ieee_fp32():
        y = phi @ torch.rand(n, generator=gen, device=device)
    return phi, y / y.abs().max()


def _events_note(ev) -> str:
    return (f"; CUDA events {ev * 1e3:.4f} ms/iteration" if ev is not None
            else "")


def bench_iht(log, sizes=IHT_SIZES, configs=IHT_CONFIGS, device="cuda"):
    """All five precision configurations (4x8 mixed, pure 4/8/16/32):
    whole solves of IHT_ITERS stochastic-rounding iterations at mu = 1e-4
    (timing only: the iterate may drift), by host clock and CUDA events."""
    log("\n== IHT end-to-end (iters/s; bytes = 2 matrix streams / iter)")
    from ..models.solvers import iht
    gen = _generator(device)
    for (m, n) in sizes:
        phi, y = _iht_problem(gen, m, n, device)
        for (name, mat_bits, vec_bits) in configs:
            qphi = quantize(phi, mat_bits)
            qphit = transpose(qphi)
            qy = quantize(y, vec_bits)

            def solve(iters):
                return iht(qphi, qphit, qy, iters, n // 4, 1e-4,
                           generator=_generator(device))
            host, ev = _solve_time(solve, device, IHT_ITERS)
            _row(log, f"IHT {name:>4s}-bit {m}x{n}", 2 * qphi.nbytes, host,
                 device=device)
            log(f"{'':{NAME_WIDTH}s} -> {1 / host:10.0f} iters/s (host "
                f"clock){_events_note(ev)}")


def bench_iht_batched(log, sizes=IHT_SIZES[:2], b: int = 8, device="cuda"):
    """Per-problem throughput of the batched solver (models/batch.py): B
    problems share one matrix stream per MVM leg, beside the single solver
    measured in the same run."""
    log(f"\n== batched IHT (B={b} problems, one matrix stream) — "
        "iters/s per problem")
    from ..models.batch import iht_batched
    from ..models.solvers import iht
    gen = _generator(device)
    for (m, n) in sizes:
        phi, y = _iht_problem(gen, m, n, device)
        qphi = quantize(phi, 4)
        qphit = transpose(qphi)
        qy = quantize(y, 4)
        k = n // 4
        t1, _ = _solve_time(lambda it: iht(qphi, qphit, qy, it, k, 1e-4,
                                           generator=_generator(device)),
                            device, IHT_ITERS)
        ys = formats.stack_vectors([qy] * b)
        tb, ev = _solve_time(
            lambda it: iht_batched(qphi, qphit, ys, it, k, 1e-4,
                                   generator=_generator(device)),
            device, IHT_ITERS)
        log(f"IHT_batched 4-bit {m}x{n} B={b}:"
            f" {tb / b * 1e6:7.1f} us/prob/iter"
            f" ({b / tb:8.0f} solves*iters/s,"
            f" {t1 / (tb / b):4.2f}x vs single @ {t1 * 1e6:.1f} us; host "
            f"clock{_events_note(ev)} per batched iteration)")


def bench_sharded(log, sizes=(8192,), iht_size=(4096, 8192), device="cuda"):
    """``-p --sharded``: the sharded path (parallel/ops.mvm_psum, its
    overlapped form, parallel/solvers.iht) over ``make_mesh()`` of the
    running world -- a 1x1 mesh in one process, R x C under torchrun --
    beside the direct kernel and the single solve, with per-shard GB/s
    and the overhead against them.  Every rank runs it; rank 0 prints.
    The sharded rows are host-clock times (their collectives wait on the
    host); on a world of one the sharded solution must equal the single
    solve's bit for bit."""
    import torch.distributed as dist
    from ..models.solvers import iht
    from ..parallel import (
        COL, ROW, initialize, is_coordinator, make_mesh, shard_matrix,
        shard_vector, solvers,
    )
    from ..parallel.mesh import axis_size
    from ..parallel.ops import (
        mvm_psum, mvm_psum_overlapped, prepare_psum_chunks,
    )
    initialize(device=None if _cuda(device) else device)
    mesh = make_mesh()
    R, C = axis_size(mesh, ROW), axis_size(mesh, COL)
    n_dev = R * C
    if not is_coordinator():
        log = lambda *a: None                                 # noqa: E731
    log(f"\n== sharded path: mesh {R}x{C} ({n_dev} rank(s), "
        f"{dist.get_backend()}) -- mvm_psum / sharded IHT")
    gen = _generator(device)
    for n in sizes:
        qA = quantize(_uniform(gen, (n, n), device), 4)
        qx = quantize(_uniform(gen, n, device), 4)
        p = _slots(qA.nbytes, device)
        slot = _mat_slots(qA, p)
        t_direct = _ring_time(device, p, lambda j: mvm(slot(j), qx))
        del slot
        _row(log, f"mvm 4x4 direct n={n}", qA.nbytes, t_direct,
             device=device)
        A_l = shard_matrix(qA, mesh).local
        x_l = shard_vector(qx, mesh, COL).local
        ready = prepare_psum_chunks(A_l, 4)
        legs = (("psum", lambda: mvm_psum(A_l, x_l, COL, None, 4, ROW, mesh)),
                ("psum-ovl4", lambda: mvm_psum_overlapped(
                    A_l, x_l, COL, None, 4, ROW, mesh, chunks=4,
                    prepared=ready)))
        for label, fn in legs:
            dt = wall_time(fn, device)
            _row(log, f"mvm_{label} 4x4 n={n} {R}x{C}", qA.nbytes, dt,
                 t_direct, device=device)
            log(f"{'':{NAME_WIDTH}s} -> per-shard "
                f"{gbs(qA.nbytes // n_dev, dt):9.1f} GB/s, overhead vs "
                f"direct {dt / t_direct:5.2f}x")

    m, n = iht_size
    phi, y = _iht_problem(gen, m, n, device)
    qphi = quantize(phi, 4)
    qphit = transpose(qphi)
    qy = quantize(y, 4)
    k = n // 4
    shards = (shard_matrix(qphi, mesh), shard_matrix(qphit, mesh, True),
              shard_vector(qy, mesh, ROW))
    # full-length solves first: warm-ups of the chained path both rows take
    single = iht(qphi, qphit, qy, IHT_ITERS, k, 1e-4).x
    shard = solvers.iht(*shards, IHT_ITERS, k, 1e-4, mesh).x
    t1, _ = _solve_time(lambda it: iht(qphi, qphit, qy, it, k, 1e-4),
                        device, IHT_ITERS)
    _row(log, f"IHT 4-bit single {m}x{n}", 2 * qphi.nbytes, t1,
         device=device)
    ts, _ = _solve_time(lambda it: solvers.iht(*shards, it, k, 1e-4, mesh),
                        device, IHT_ITERS)
    _row(log, f"IHT 4-bit sharded {m}x{n} {R}x{C}", 2 * qphi.nbytes, ts,
         device=device)
    log(f"{'':{NAME_WIDTH}s} -> per-shard "
        f"{gbs(2 * qphi.nbytes // n_dev, ts):9.1f} GB/s, overhead vs single "
        f"{ts / t1:5.2f}x")
    if n_dev == 1:
        if not (torch.equal(single.codes, shard.codes)
                and torch.equal(single.scales, shard.scales)):
            raise RuntimeError("1x1 mesh: the sharded IHT differs from the "
                               "single solve")
        log(f"{'':{NAME_WIDTH}s} -> sharded solution bit-identical to the "
            f"single solve")


def run_perf(log=print, quick: bool = False, sharded: bool = False,
             device="cuda", sizes: dict | None = None):
    """Every table of ``-p`` on ``device``.  ``quick`` takes the first
    sizes of each sweep; ``sizes`` overrides the sweeps (keys "vec",
    "mvm", "iht", "warm", "get"), for tests at small sizes.  ``sharded``
    runs only :func:`bench_sharded`, at the last quick MVM size (4096 and
    8192 without ``quick``) and the first IHT size."""
    if sharded:
        bench_sharded(log, sizes=(MVM_SIZES[1],) if quick else
                      tuple(MVM_SIZES[1:3]), iht_size=IHT_SIZES[0],
                      device=device)
        return
    sizes = sizes or {}
    vec = sizes.get("vec", VEC_SIZES[:2] if quick else VEC_SIZES)
    mvm_n = sizes.get("mvm", MVM_SIZES[:2] if quick else MVM_SIZES)
    iht_sizes = sizes.get("iht", IHT_SIZES[:1] if quick else IHT_SIZES)
    full = not quick and "vec" not in sizes
    if _cuda(device):
        name = torch.cuda.get_device_name(device)
        log(f"device {name}: memory {memory_rate(device) / 1e12:.2f} TB/s "
            f"(data sheet); %spec = bytes / time / that rate; L2-warm rows "
            f"read the 50 MB L2 and have none")
    else:
        log(f"device {torch.device(device)}: the plain versions' host times; "
            f"no device rate")
    log(f"\n{'op':{NAME_WIDTH}s} {'time':>12} {'bandwidth':>14} {'%spec':>6} "
        f"{'vs f32':>7}")
    bench_quantize(log, vec, device=device)
    bench_restore(log, vec, device=device)
    bench_dot(log, vec + [1 << 25] if full else vec, device=device)
    bench_axpy(log, vec, device=device)
    bench_small_warm(log, sizes.get("warm", WARM_SIZES), device=device)
    bench_threshold(log, vec[:2], device=device)
    bench_get(log, *sizes.get("get", GET), device=device)
    bench_mvm(log, mvm_n, device=device)
    bench_mvm_batched(log, mvm_n[:1] if not full else MVM_SIZES[-2:],
                      device=device)
    bench_transpose(log, mvm_n, device=device)
    bench_iht(log, iht_sizes, device=device)
    bench_iht_batched(log, iht_sizes[:1] if not full else IHT_SIZES[:2],
                      device=device)
