"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The main path is the pure 4-bit IHT solve at m=8192, n=16384, K=4096 with
the step size of clover_tpu's tuned table for that size: quantize Phi and
y, transpose Phi, then per iteration two fused MVM+AXPY legs and one exact
top-K threshold.  Phases, each of which raises on failure:

1. card and build: the card's name and power limit, torch/CUDA versions,
   and the nvcc build of clover_tpu_torch/csrc/*.cu (into build/);
2. each kernel against its plain torch version on the card, at the main
   path's shapes and at a ragged 200x300, deterministic and SR:
   quantize, transpose and threshold bit-identical, MVM/AXPY codes within
   1 LSB and scales within rtol 1e-6; times by CUDA events (median of 5
   windows of 20 back-to-back launches; plain versions 3 single calls);
3. the main path through the public entry points: Phi and y quantized
   with a seeded generator (stochastic rounding), deterministic
   iterations as in the search that tuned mu; launch counts, relative
   recovery error, iterations/s;
4. a deterministic 2-iteration solve, kernels against plain versions.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device it prints no
result and exits 2.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

M, N, K = 8192, 16384, 4096
MU = 0.0002138596817016602    # clover_tpu/models/tuned.py IHT_4BIT[(8192, 16384)]
ITERS = 2                     # the tuned iteration count for that size
TIMED_ITERS = 100
SEED = 0
MVM_SCALE_RTOL = 1e-6
SOLVE_ERR_TOL = 0.01

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
}


def median_ms(fn, reps: int, inner: int) -> float:
    """Median over ``reps`` windows of the mean CUDA-event time of
    ``inner`` back-to-back calls, after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def dequant(codes, scales, bits: int = 4):
    """f32 values of raw codes/scales, for measuring kernel-plain gaps."""
    import torch
    from clover_tpu_torch.formats import unpack_nibbles
    c = (unpack_nibbles(codes) if bits == 4 else codes).to(torch.float32)
    s = scales / (7.0 if bits == 4 else 127.0)
    s = (s.repeat_interleave(64) if s.dim() == 1
         else s.repeat_interleave(64, 0).repeat_interleave(64, 1))
    return c * s


class Report:
    """Per-kernel comparison results and times."""

    def __init__(self):
        self.err = {name: 0.0 for name in KERNEL_INFO}
        self.ms = {}
        self.plain_ms = {}
        self.leg2_ms = 0.0

    def exact(self, name: str, what: str, got, want, bits: int = 4):
        """Kernel output (codes, scales) must equal the plain one."""
        import torch
        (gc, gs), (wc, ws) = got, want
        if not (torch.equal(gc, wc) and torch.equal(gs, ws)):
            bad = int((gc != wc).sum())
            raise AssertionError(f"{name} {what}: kernel != plain "
                                 f"({bad} code bytes differ)")
        self.err[name] = max(self.err[name], float(
            (dequant(gc, gs, bits) - dequant(wc, ws, bits)).abs().max()))
        print(f"  {name:13s} {what:34s} bit-identical")

    def close(self, name: str, what: str, got, want):
        """MVM/AXPY: codes within 1 LSB, scales within MVM_SCALE_RTOL."""
        from clover_tpu_torch.formats import unpack_nibbles
        (gc, gs), (wc, ws) = got, want
        lsb = int((unpack_nibbles(gc).int() - unpack_nibbles(wc).int())
                  .abs().max())
        rel = float(((gs - ws).abs() / ws.abs()).max())
        if lsb > 1 or rel > MVM_SCALE_RTOL:
            raise AssertionError(f"{name} {what}: codes differ by {lsb} LSB, "
                                 f"scales by rtol {rel:.3g}")
        self.err[name] = max(self.err[name], float(
            (dequant(gc, gs) - dequant(wc, ws)).abs().max()))
        print(f"  {name:13s} {what:34s} max {lsb} LSB, scale rtol {rel:.3g}")

    def time(self, name: str, kernel, plain):
        self.ms[name] = median_ms(kernel, 5, 20)
        self.plain_ms[name] = median_ms(plain, 3, 1)
        print(f"  {name:13s} kernel {self.ms[name]:.4f} ms   plain "
              f"{self.plain_ms[name]:.4f} ms")


def phase_build():
    import torch
    from clover_tpu_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print("== 1. card and build")
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")
    built = _build.library()
    print(f"built {built.path.name} in {built.build_seconds:.1f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def phase_kernels(rep: Report, phi, gen):
    """Every kernel against its plain version, on the main path's shapes."""
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch.kernels import (
        mvm4_cuda, mvm4_plain, quantize_mat_cuda, quantize_mat_plain,
        quantize_vec_cuda, quantize_vec_plain, seed_from, threshold4_cuda,
        threshold4_plain, transpose4_cuda, transpose4_plain)
    print("== 2. kernels against their plain versions on the card")
    dev = phi.device
    y = torch.rand(M, generator=gen, device=dev) * 2 - 1
    xf = torch.randn(N, generator=gen, device=dev)
    modes = [("det", 0, False), ("SR", seed_from(gen)[0], True)]

    for mode, seed, noise in modes:
        rep.exact("quantize_mat", f"{M}x{N} {mode}",
                  quantize_mat_cuda(phi, 4, seed, noise),
                  quantize_mat_plain(phi, 4, seed, noise))
        for n in (M, N):
            v = y if n == M else xf
            rep.exact("quantize_vec", f"{n} {mode}",
                      quantize_vec_cuda(v, 4, seed, noise),
                      quantize_vec_plain(v, 4, seed, noise))
    rep.time("quantize_mat", lambda: quantize_mat_cuda(phi, 4, 1, True),
             lambda: quantize_mat_plain(phi, 4, 1, True))
    rep.time("quantize_vec", lambda: quantize_vec_cuda(y, 4, 1, True),
             lambda: quantize_vec_plain(y, 4, 1, True))

    qphi = tt.quantize(phi, 4)
    ct_k, st = transpose4_cuda(qphi.codes), qphi.scales.T.contiguous()
    rep.exact("transpose4", f"{M}x{N}", (ct_k, st),
              (transpose4_plain(qphi.codes), st))
    rep.time("transpose4", lambda: transpose4_cuda(qphi.codes),
             lambda: transpose4_plain(qphi.codes))
    phit = (ct_k, st)

    qy, qx = tt.quantize(y, 4), tt.quantize(xf, 4)
    leg1 = (qphi.codes, qphi.scales, qx.codes, qx.scales, qy.codes, qy.scales,
            -1.0)
    for mode, seed, noise in modes:
        s2 = seed + 1
        t2 = mvm4_cuda(*leg1, seed, noise, s2, noise)
        rep.close("mvm4", f"Phi leg {M}x{N} alpha=-1 {mode}", t2,
                  mvm4_plain(*leg1, seed, noise, s2, noise))
        leg2 = (*phit, *t2, qx.codes, qx.scales, MU)
        rep.close("mvm4", f"PhiT leg {N}x{M} alpha=mu {mode}",
                  mvm4_cuda(*leg2, seed, noise, s2, noise),
                  mvm4_plain(*leg2, seed, noise, s2, noise))
        rep.close("mvm4", f"Phi mvm (no AXPY) {mode}",
                  mvm4_cuda(*leg1[:4], seed1=seed, noise1=noise),
                  mvm4_plain(*leg1[:4], seed1=seed, noise1=noise))
    rep.time("mvm4", lambda: mvm4_cuda(*leg1, 1, True, 2, True),
             lambda: mvm4_plain(*leg1, 1, True, 2, True))
    leg2 = (*phit, *mvm4_cuda(*leg1), qx.codes, qx.scales, MU)
    rep.leg2_ms = median_ms(lambda: mvm4_cuda(*leg2, 1, True, 2, True), 5, 20)
    print(f"  {'mvm4':13s} PhiT leg kernel {rep.leg2_ms:.4f} ms")

    # threshold: a solver iterate, integer-valued data, a tie storm, k > nnz
    ints = torch.randint(-3, 4, (N,), generator=gen, device=dev).float()
    storm = torch.rand(N // 64, generator=gen, device=dev).repeat_interleave(64)
    sparse = torch.zeros(N, device=dev)
    sparse[torch.randperm(N, generator=gen, device=dev)[:K // 2]] = 1.0
    iterate = tt.QVec4(*mvm4_cuda(*leg2), length=N)
    cases = [("solver iterate", iterate), ("integer-valued", tt.quantize(ints, 4)),
             ("tie storm", tt.quantize(storm, 4)),
             ("k > nnz", tt.quantize(sparse, 4)), ("dense SR", tt.quantize(
                 xf, 4, generator=gen))]
    for what, q in cases:
        for k in (K, 1, 0):
            rep.exact("threshold4", f"n={N} k={k} {what}",
                      (threshold4_cuda(q.codes, q.scales, k), q.scales),
                      (threshold4_plain(q.codes, q.scales, k), q.scales))
    rep.time("threshold4", lambda: threshold4_cuda(iterate.codes,
                                                    iterate.scales, K),
             lambda: threshold4_plain(iterate.codes, iterate.scales, K))

    # ragged logical size: padding through every kernel
    a = torch.rand(200, 300, generator=gen, device=dev) * 2 - 1
    ap = tt.formats.pad_matrix(a).contiguous()
    for mode, seed, noise in modes:
        rep.exact("quantize_mat", f"200x300 {mode}",
                  quantize_mat_cuda(ap, 4, seed, noise),
                  quantize_mat_plain(ap, 4, seed, noise))
        rep.exact("quantize_mat", f"200x300 8-bit {mode}",
                  quantize_mat_cuda(ap, 8, seed, noise),
                  quantize_mat_plain(ap, 8, seed, noise), bits=8)
        vp = tt.formats.pad_vector(a[0]).contiguous()
        rep.exact("quantize_vec", f"300 {mode}",
                  quantize_vec_cuda(vp, 4, seed, noise),
                  quantize_vec_plain(vp, 4, seed, noise))
        rep.exact("quantize_vec", f"300 8-bit {mode}",
                  quantize_vec_cuda(vp, 8, seed, noise),
                  quantize_vec_plain(vp, 8, seed, noise), bits=8)
        qa = tt.quantize(a, 4, generator=seed if noise else None)
        sat = qa.scales.T.contiguous()
        rep.exact("transpose4", f"200x300 {mode}",
                  (transpose4_cuda(qa.codes), sat),
                  (transpose4_plain(qa.codes), sat))
        qv, qu = tt.quantize(a[1], 4), tt.quantize(a[:, 2], 4)
        args = (qa.codes, qa.scales, qv.codes, qv.scales, qu.codes,
                qu.scales, 0.37, seed, noise, seed + 1, noise)
        rep.close("mvm4", f"200x300 alpha=0.37 {mode}", mvm4_cuda(*args),
                  mvm4_plain(*args))
        rep.exact("threshold4", f"n=300 k=50 {mode}",
                  (threshold4_cuda(qv.codes, qv.scales, 50), qv.scales),
                  (threshold4_plain(qv.codes, qv.scales, 50), qv.scales))


def recovery_error(x, x_star) -> float:
    """||restore(x) - x*|| / ||x*||, restored on the host."""
    import torch
    import clover_tpu_torch as tt
    xr = tt.restore(tt.to_device(x, "cpu")).values[:N]
    xs = x_star.cpu()
    return float(torch.linalg.norm(xr - xs) / torch.linalg.norm(xs))


def phase_main_path(rep: Report, phi, x_star, y):
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch import kernels
    print(f"== 3. main path: 4-bit IHT {M}x{N} K={K} mu={MU}")
    kernels.reset_launch_counts()
    gen = torch.Generator(device=phi.device).manual_seed(SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qphi = tt.quantize(phi, 4, generator=gen)
    qy = tt.quantize(y, 4, generator=gen)
    qphit = tt.transpose(qphi)
    # deterministic iterations: the tuned mu comes from a search with
    # stochastic rounding off, and SR iterations diverge at that mu
    res = tt.iht(qphi, qphit, qy, ITERS, K, MU)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    expected = {"quantize_mat": 1, "quantize_vec": 1, "transpose4": 1,
                "mvm4": 2 * ITERS, "threshold4": ITERS}
    print(f"  launches {counts} in {wall * 1e3:.2f} ms")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    err = recovery_error(res.x, x_star)
    print(f"  relative recovery error after {ITERS} iterations: {err:.6f}")
    if not math.isfinite(err) or err >= 1.0:
        raise AssertionError(f"recovery error {err} not below 1.0")
    if res.x.codes.shape != (N // 2,) or res.x.scales.shape != (N // 64,):
        raise AssertionError("solution container has the wrong shape")

    tt.iht(qphi, qphit, qy, 5, K, MU)                     # warm-up
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    tt.iht(qphi, qphit, qy, TIMED_ITERS, K, MU)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    dev_ms = start.elapsed_time(end)
    print(f"  {TIMED_ITERS} iterations: {TIMED_ITERS / wall:.1f} iterations/s "
          f"(host clock, {wall * 1e3 / TIMED_ITERS:.4f} ms/iteration; CUDA "
          f"events {dev_ms / TIMED_ITERS:.4f} ms/iteration)")
    busy = rep.ms["mvm4"] + rep.leg2_ms + rep.ms["threshold4"]
    print(f"  kernel time per iteration {busy:.4f} ms (phase 2 medians): "
          f"device busy ~{busy * TIMED_ITERS / (wall * 1e3):.2f} of the loop")
    return counts


def plain_iht(phi, y, iterations: int):
    """The deterministic solve through the plain versions, on the card."""
    import torch
    from clover_tpu_torch import QVec4, zeros_vector
    from clover_tpu_torch.kernels import (
        mvm4_plain, quantize_mat_plain, quantize_vec_plain, threshold4_plain,
        transpose4_plain)
    pc, ps = quantize_mat_plain(phi, 4)
    yc, ys = quantize_vec_plain(y, 4)
    tc, ts = transpose4_plain(pc), ps.T.contiguous()
    x = zeros_vector(4, N, device=phi.device)
    xc, xs = x.codes, x.scales
    for _ in range(iterations):
        t2 = mvm4_plain(pc, ps, xc, xs, yc, ys, -1.0)
        xc, xs = mvm4_plain(tc, ts, *t2, xc, xs, MU)
        xc = threshold4_plain(xc, xs, K)
    return QVec4(codes=xc, scales=xs, length=N)


def phase_solve_parity(phi, x_star, y):
    import torch
    import clover_tpu_torch as tt
    print(f"== 4. deterministic {ITERS}-iteration solve, kernels vs plain")
    qphi = tt.quantize(phi, 4)
    res = tt.iht(qphi, tt.transpose(qphi), tt.quantize(y, 4), ITERS, K, MU)
    plain = plain_iht(phi, y, ITERS)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from clover_tpu_torch.models import make_iht_problem
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phi, x_star, y = make_iht_problem(M, N, K, generator=gen)
    rep = Report()
    phase_kernels(rep, phi, gen)
    counts = phase_main_path(rep, phi, x_star, y)
    phase_solve_parity(phi, x_star, y)
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": rep.err[name], "ms": rep.ms[name],
                "plain_ms": rep.plain_ms[name]}
               for name, (src, replaces) in KERNEL_INFO.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
