"""``-v`` validation mode: the ops against the golden oracle (counterpart
of clover_tpu/harness/validate.py).

The reference's validation suite (test/validate/02_vector.cpp:557-641,
03_matrix.cpp:576-645): size sweeps across padding phases, bit-exact
checks where the reference is bit-exact (quantize, restore, the transpose
round trip), tolerance checks where it is tolerance-based (dot 0.02, MVM
one LSB, threshold top-K within 10%).  Prints ``Validating <name>
Good|Failed`` per check, dumps a failed check's values side by side
(``utils.compare``), and ends in ``N checks, F failures``.

The checks, their NumPy draws and their order are clover_tpu's, so one
seed gives both packages the same data.  Every input goes onto ``device``
before the op, so on ``cuda`` each check runs the kernels.  What differs:
the sweep is the default one on every device (clover_tpu's compact TPU set
existed because every shape was an XLA compile); the int4 MVM rows have no
counterpart (Hopper has no int4 MMA); the whole-iteration and chain rows
run wherever the port's iteration kernels are eligible, on the CPU through
their plain versions, and the chain row runs the solver's chain length
(``ITER_CHAIN``, 4), where clover_tpu's ran 2.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import golden
from ..formats import BLOCK, pad_to, unpack_nibbles
from ..kernels import iteration as fused
from ..models.solvers import ITER_CHAIN, _fused
from ..ops import dot
from ..ops.axpy import scale_and_add
from ..ops.mvm import mvm, mvm_axpy, mvm_f32
from ..ops.quantize import quantize, restore
from ..ops.threshold import threshold
from ..ops.transpose import transpose
from ..utils.debug import compare

DEFAULT_VEC_SIZES = list(range(128, 192)) + [255, 256, 384, 511, 512, 1000,
                                             1024, 2047]
DEFAULT_MAT_SHAPES = [(128, 128), (128, 256), (192, 320), (256, 128),
                      (384, 640), (512, 512), (1000, 200), (1280, 1280)]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _codes(q) -> np.ndarray:
    """Element codes of a 4/8-bit container as a NumPy array."""
    return _np(unpack_nibbles(q.codes) if q.bits == 4 else q.codes)


def _pad_vec(x: np.ndarray) -> np.ndarray:
    return np.pad(x, (0, pad_to(x.shape[0]) - x.shape[0]))


def _pad_mat(a: np.ndarray) -> np.ndarray:
    m, n = a.shape
    return np.pad(a, ((0, pad_to(m) - m), (0, pad_to(n) - n)))


def _same(a, b) -> bool:
    return (torch.equal(a.codes, b.codes)
            and torch.equal(a.scales, b.scales))


class Validator:
    def __init__(self, log=print, device="cuda"):
        self.log = log
        self.device = torch.device(device)
        self.failures = 0
        self.checks = 0

    def T(self, x: np.ndarray) -> torch.Tensor:
        """A NumPy input as a tensor on the validated device."""
        return torch.as_tensor(x, device=self.device)

    def check(self, name, ok, a=None, b=None):
        self.checks += 1
        if ok:
            self.log(f"Validating {name:60s} Good")
        else:
            self.failures += 1
            self.log(f"Validating {name:60s} Failed")
            if a is not None:
                self.log(compare(a, b))
        return ok

    # -- vector ops (ref 02_vector.cpp) ------------------------------------

    def vector_quantize(self, rng, bits, n):
        x = (rng.random(n, dtype=np.float32) * 2 - 1)
        q = quantize(self.T(x), bits)
        gc, gs = golden.quantize_vec(_pad_vec(x), bits, noise=0.0)
        codes = _codes(q)
        ok = np.array_equal(codes, gc) and np.array_equal(_np(q.scales), gs)
        return self.check(f"quantize  {bits:2d}-bit n={n}", ok, codes, gc)

    def vector_consistency(self, rng, bits, n):
        # integer data in [-7, 7] (ref setRandomInteger(7),
        # 02_vector.cpp:193): |x - restore(quantize(x))| <= 1
        x = rng.integers(-7, 8, n).astype(np.float32)
        q = quantize(self.T(x), bits)
        xr = _np(restore(q).values)[:n]
        ok = np.all(np.abs(x - xr) <= 1.0)
        return self.check(f"consistency {bits:2d}-bit n={n}", ok, xr, x)

    def vector_restore(self, rng, bits, n):
        """Standalone restore bit-exactness, with SR on like the reference
        (test/validate/02_vector.cpp:224-256): whatever codes SR produced,
        restore must be bit-identical to codes*scale/qmax."""
        x = (rng.random(n, dtype=np.float32) * 2 - 1)
        q = quantize(self.T(x), bits, generator=n)
        got = _np(restore(q).values)
        ref = golden.restore_vec(_codes(q), _np(q.scales), bits)
        ok = np.array_equal(got, ref)
        return self.check(f"restore   {bits:2d}-bit n={n} (SR on)", ok,
                          got, ref)

    def vector_dot(self, rng, bits, n):
        u = (rng.random(n, dtype=np.float32) * 2 - 1)
        v = (rng.random(n, dtype=np.float32) * 2 - 1)
        qu, qv = quantize(self.T(u), bits), quantize(self.T(v), bits)
        got = float(dot(qu, qv))
        if bits in (16, 32):
            ref = float(np.dot(_np(restore(qu).values),
                               _np(restore(qv).values)))
            ok = abs(got - ref) <= 0.02 * max(1.0, abs(ref))
        else:
            ref = float(golden.dot(_codes(qu), _np(qu.scales), _codes(qv),
                                   _np(qv.scales), bits))
            ok = abs(got - ref) <= 0.02   # ref tolerance 02_vector.cpp:280
        return self.check(f"dot       {bits:2d}-bit n={n}", ok,
                          [got], [ref])

    def vector_scale_and_add(self, rng, bits, n):
        u = (rng.random(n, dtype=np.float32) * 2 - 1)
        v = (rng.random(n, dtype=np.float32) * 2 - 1)
        qu, qv = quantize(self.T(u), bits), quantize(self.T(v), bits)
        r = scale_and_add(qu, qv, -0.5)
        if bits in (16, 32):
            ref = _np(restore(qu).values) - 0.5 * _np(restore(qv).values)
            got = _np(restore(r).values)
            ok = np.allclose(got, ref.astype(got.dtype), rtol=1e-3, atol=1e-3)
            return self.check(f"scaleAndAdd {bits:2d}-bit n={n}", ok, got, ref)
        gc, gs = golden.scale_and_add(_codes(qu), _np(qu.scales), _codes(qv),
                                      _np(qv.scales), -0.5, bits, 0.0)
        rc = _codes(r)
        # 1-ulp fma freedom (see tests/test_kernels_quantize.py)
        diff = rc.astype(np.int32) - gc.astype(np.int32)
        ok = np.abs(diff).max(initial=0) <= 1 and (diff != 0).mean() <= 0.005
        return self.check(f"scaleAndAdd {bits:2d}-bit n={n}", ok, rc, gc)

    def vector_threshold(self, rng, bits, n):
        k = max(1, n // 8)
        x = (rng.random(n, dtype=np.float32) * 2 - 1)
        q = quantize(self.T(x), bits)
        t = threshold(q, k)
        vals = np.abs(_np(restore(t).values)[:n])
        ref_vals = np.abs(_np(restore(q).values)[:n])
        top_got = np.sort(vals[vals > 0])[::-1]
        top_ref = np.sort(ref_vals)[::-1][:len(top_got)]
        # top-K within 10% relative (ref 02_vector.cpp:449-554)
        ok = (np.count_nonzero(vals) <= k and len(top_got) > 0
              and np.all(top_got >= top_ref * 0.9 - 1e-6))
        return self.check(f"threshold {bits:2d}-bit n={n} K={k}", ok)

    # -- matrix ops (ref 03_matrix.cpp) ------------------------------------

    def matrix_quantize(self, rng, bits, m, n):
        a = (rng.random((m, n), dtype=np.float32) * 2 - 1)
        q = quantize(self.T(a), bits)
        gc, gs = golden.quantize_mat(_pad_mat(a), bits, noise=0.0)
        ok = (np.array_equal(_codes(q), gc)
              and np.array_equal(_np(q.scales), gs))
        return self.check(f"mat quantize {bits:2d}-bit {m}x{n}", ok)

    def matrix_mvm(self, rng, bits_a, bits_x, m, n):
        a = (rng.random((m, n), dtype=np.float32) * 2 - 1)
        x = (rng.random(n, dtype=np.float32) * 2 - 1)
        qa = quantize(self.T(a), bits_a)
        qx = quantize(self.T(x), bits_x)
        y = mvm(qa, qx)
        got = _np(restore(y).values)
        if bits_x == 32 and bits_a in (4, 8):
            # dequant-on-the-fly x32 MVM vs an independent float64
            # reference (ref: 03_matrix.cpp:419-489, |delta| <= 0.01)
            ra = _np(restore(qa).values).astype(np.float64)
            ref = (ra[:m, :n] @ x.astype(np.float64)).astype(np.float32)
            ok = bool(np.all(np.abs(got[:m] - ref) <= 0.01))
            return self.check(
                f"mvm {bits_a:2d}x{bits_x:2d}-bit {m}x{n}", ok,
                got[:8], ref[:8])
        ref = _np(mvm_f32(qa, qx))
        if y.bits in (16, 32):
            ok = np.allclose(got, ref, rtol=1e-3, atol=1e-3)
        else:
            lsb = np.repeat(_np(y.scales), BLOCK) / (
                7.0 if y.bits == 4 else 127.0)
            ok = np.all(np.abs(got - ref) <= lsb * (1 + 1e-3) + 1e-5)
        return self.check(
            f"mvm {bits_a:2d}x{bits_x:2d}-bit {m}x{n}", ok, got[:8], ref[:8])

    def _iteration_operands(self, rng, bits_a, bits_x, m, n):
        a = (rng.random((m, n), dtype=np.float32) * 2 - 1)
        yv = a @ (rng.random(n, dtype=np.float32) * 2 - 1)
        xv = rng.random(n, dtype=np.float32) * 2 - 1
        qa = quantize(self.T(a), bits_a)
        qat = transpose(qa)
        qy = quantize(self.T(yv / np.abs(yv).max()), bits_x)
        qx = quantize(self.T(xv), bits_x)
        return qa, qat, qy, qx

    def solver_iteration(self, rng, bits_a, bits_x, m, n):
        """The whole-iteration kernel (kernels/iteration.py) must be
        bit-identical to the two fused MVM+AXPY launches, the invariant
        the solver's dispatch relies on.  No check where the kernel is not
        eligible."""
        qa, qat, qy, qx = self._iteration_operands(rng, bits_a, bits_x, m, n)
        if not fused.iteration_eligible(qa, qat, qy, qx):
            return True
        got = _fused(fused.iteration_cuda, fused.iteration_plain, qa, qat,
                     qy, qx, 1e-3, seeds=(None,) * 4)
        t2 = mvm_axpy(qa, qx, qy, -1.0)
        want = mvm_axpy(qat, t2, qx, 1e-3)
        return self.check(
            f"iteration {bits_a:2d}x{bits_x:2d}-bit {m}x{n}", _same(got, want))

    def solver_chain(self, rng, bits_a, bits_x, m, n):
        """The chained kernel (ITER_CHAIN iterations with the in-kernel
        threshold) against the unchained [whole iteration -> threshold]
        sequence: bit-identical, with SR on."""
        qa, qat, qy, qx = self._iteration_operands(rng, bits_a, bits_x, m, n)
        k = max(1, n // 4)
        if not fused.iteration_chain_eligible(qa, qat, qy, qx, k):
            return True
        seeds = tuple(7 + 13 * j for j in range(4 * ITER_CHAIN))
        got = _fused(fused.iteration_chain_cuda, fused.iteration_chain_plain,
                     qa, qat, qy, qx, 1e-3, k, seeds=seeds)
        want = qx
        for it in range(ITER_CHAIN):
            want = _fused(fused.iteration_cuda, fused.iteration_plain, qa,
                          qat, qy, want, 1e-3, seeds=seeds[4 * it:4 * it + 4])
            want = threshold(want, k)
        return self.check(
            f"chain{ITER_CHAIN} {bits_a:2d}x{bits_x:2d}-bit {m}x{n}",
            _same(got, want))

    def matrix_transpose(self, rng, bits, m, n):
        a = (rng.random((m, n), dtype=np.float32) * 2 - 1)
        q = quantize(self.T(a), bits)
        t = transpose(q)
        ra = _np(restore(q).values)
        rt = _np(restore(t).values)
        ok = np.array_equal(ra, rt.T)        # bit-exact round trip (ref
        return self.check(                   # 03_matrix.cpp:153-245)
            f"transpose {bits:2d}-bit {m}x{n}", ok)


def _skip_int4_draws(rng, m, n, b=4):
    """Take the draws of clover_tpu's int4 MVM rows (mvm-i4: A and x;
    mvm-b-i4: A and b vectors), which have no counterpart here, so every
    later check sees clover_tpu's data."""
    rng.random((m, n), dtype=np.float32)
    rng.random(n, dtype=np.float32)
    rng.random((m, n), dtype=np.float32)
    for _ in range(b):
        rng.random(n, dtype=np.float32)


def run_validation(full: bool = False, seed: int = 1, log=print,
                   vec_sizes=None, mat_shapes=None, device="cuda") -> bool:
    """Run the sweep on ``device``; True when every check passed.

    ``vec_sizes``/``mat_shapes`` override the sweep sets; ``full`` gives
    the exhaustive sweep (every n in 128..2047, every 128-multiple shape up
    to 1280x1280)."""
    rng = np.random.default_rng(seed)
    v = Validator(log=log, device=device)
    if vec_sizes is not None or mat_shapes is not None:
        vec_sizes = vec_sizes or []
        mat_shapes = mat_shapes or []
    elif full:
        vec_sizes = list(range(128, 2048))
        mat_shapes = [(mm, nn) for mm in range(128, 1281, 128)
                      for nn in range(128, 1281, 128)]
    else:
        vec_sizes, mat_shapes = DEFAULT_VEC_SIZES, DEFAULT_MAT_SHAPES

    for n in vec_sizes:
        for bits in (4, 8):
            v.vector_quantize(rng, bits, n)
            v.vector_restore(rng, bits, n)
            v.vector_consistency(rng, bits, n)
            v.vector_dot(rng, bits, n)
            v.vector_scale_and_add(rng, bits, n)
        for bits in (4, 8, 16, 32):
            v.vector_threshold(rng, bits, n)

    for (m, n) in mat_shapes:
        for bits in (4, 8):
            v.matrix_quantize(rng, bits, m, n)
            v.matrix_transpose(rng, bits, m, n)
        for (ba, bx) in ((4, 4), (4, 8), (8, 8), (16, 16), (32, 32),
                         (4, 32), (8, 32)):
            v.matrix_mvm(rng, ba, bx, m, n)
        for (ba, bx) in ((4, 4), (4, 8)):
            v.solver_iteration(rng, ba, bx, m, n)
            v.solver_chain(rng, ba, bx, m, n)
        _skip_int4_draws(rng, m, n)

    log(f"\n{v.checks} checks, {v.failures} failures")
    return v.failures == 0
