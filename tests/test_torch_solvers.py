"""clover_tpu_torch solvers (the slice as a whole, plain versions on the
CPU) against clover_tpu.

Tolerances: each stage of an iteration -- the two fused MVM+AXPY legs and
the threshold -- agrees with clover_tpu within the MVM allowance (1 LSB,
rtol 1e-5) or exactly (threshold) when fed the same inputs.  A whole
iteration agrees within 1 LSB whenever the MVM intermediates do.  Where
an intermediate's band absmax lands on the other side of a floor (the
absmax element's |y| * (7/s) is within an ulp of 7, so a 1-ulp sum-order
difference moves its code 7 <-> 6 and the next band scale by 1/7), the
trajectories part, so long solves are compared by their recovery regime,
as tests/test_solvers.py compares batched and single solves.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.models import run_gd_accuracy, run_iht_accuracy
from clover_tpu.models.accuracy import ACCURACY_MU, GD_MU
from clover_tpu.models.problems import (make_gd_problem_reference,
                                        make_iht_problem_reference)
from clover_tpu.models.solvers import _iteration as jax_iteration
from clover_tpu.models.solvers import iht as jax_iht
from clover_tpu_torch.models.solvers import _iteration, _op_seeds
from torch_helpers import assert_same, assert_within_lsb, to_torch


def _instance(seed, m, n, k, bits_a=4, bits_v=4):
    rng = np.random.default_rng(seed)
    phi = rng.random((m, n), dtype=np.float32) * 2 - 1
    xs = np.zeros(n, np.float32)
    xs[rng.permutation(n)[:k]] = 1.0
    x0 = rng.random(n, dtype=np.float32) * 2 - 1
    jq = ct.quantize(jnp.asarray(phi), bits_a)
    return (jq, ct.transpose(jq), ct.quantize(jnp.asarray(phi @ xs), bits_v),
            ct.quantize(jnp.asarray(x0), bits_v))


def test_iteration_matches_jax():
    mu, agreed = 0.004, 0
    for seed, (m, n, k) in enumerate([(128, 256, 16), (128, 256, 16),
                                      (256, 512, 32), (512, 1024, 64)]):
        jargs = _instance(seed, m, n, k)
        jPhi, jPhiT, jy, jx = jargs
        Phi, PhiT, y, x = (to_torch(q) for q in jargs)
        # stage by stage, from the same inputs
        t2 = tt.mvm_axpy(Phi, x, y, -1.0)
        jt2 = ct.mvm_axpy(jPhi, jx, jy, -1.0)
        x1 = tt.mvm_axpy(PhiT, to_torch(jt2), x, mu)
        jx1 = ct.mvm_axpy(jPhiT, jt2, jx, jnp.float32(mu))
        assert_within_lsb(tt.mvm(Phi, x), ct.mvm(jPhi, jx))
        assert_within_lsb(tt.mvm(PhiT, to_torch(jt2)), ct.mvm(jPhiT, jt2))
        assert_same(tt.threshold(to_torch(jx1), k), ct.threshold(jx1, k))
        # the port's iteration is exactly the composition of its ops
        got = _iteration(Phi, PhiT, y, x, mu, k, None)
        assert_same(got, tt.threshold(tt.mvm_axpy(PhiT, t2, x, mu), k))
        # whole iteration within 1 LSB where the intermediates agree
        same = (np.array_equal(t2.codes.numpy(), np.asarray(jt2.codes))
                and np.array_equal(x1.codes.numpy(), np.asarray(jx1.codes)))
        if same:
            assert_within_lsb(got, jax_iteration(*jargs, jnp.float32(mu), k,
                                                 None))
            agreed += 1
    assert agreed >= 2


def test_iht_reference_instance_trace():
    """200-epoch deterministic traced IHT on the reference's accuracy
    instance (512x1024, K=64, tuned mu): same first step within 5%, same
    plateau regime (final within max(1.3x, +0.05) both ways)."""
    phi, xs, y = make_iht_problem_reference()
    want = np.asarray(run_iht_accuracy(4, epochs=200, key=None))
    q = tt.quantize(torch.from_numpy(phi), 4)
    res = tt.iht(q, tt.transpose(q), tt.quantize(torch.from_numpy(y), 4),
                 200, 64, ACCURACY_MU[4],
                 x_star=tt.QVec32(values=tt.formats.pad_vector(
                     torch.from_numpy(xs)), length=1024))
    got = res.trace.numpy()
    assert got.shape == (200,) and np.all(np.isfinite(got))
    assert abs(got[0] - want[0]) <= 0.05 * want[0]
    assert got[-1] <= max(1.3 * want[-1], want[-1] + 0.05)
    assert want[-1] <= max(1.3 * got[-1], got[-1] + 0.05)
    assert got[-1] < 0.5 * got[0]
    assert isinstance(res.x, tt.QVec4) and res.x.length == 1024
    assert int((tt.unpack_nibbles(res.x.codes) != 0).sum()) <= 64


@pytest.mark.parametrize("bits_a", [4, 8])
def test_iteration_8bit_vectors_matches_jax(bits_a):
    """Mixed 4x8 (4-bit Phi, 8-bit y and x) and pure 8-bit: stage by
    stage from the same inputs, as test_iteration_matches_jax."""
    mu, agreed = 0.004, 0
    for seed, (m, n, k) in enumerate([(128, 256, 16), (128, 256, 16),
                                      (256, 512, 32), (512, 1024, 64)]):
        jargs = _instance(seed, m, n, k, bits_a, 8)
        jPhi, jPhiT, jy, jx = jargs
        Phi, PhiT, y, x = (to_torch(q) for q in jargs)
        t2 = tt.mvm_axpy(Phi, x, y, -1.0)
        jt2 = ct.mvm_axpy(jPhi, jx, jy, -1.0)
        assert isinstance(t2, tt.QVec8)
        assert_within_lsb(t2, jt2)
        x1 = tt.mvm_axpy(PhiT, to_torch(jt2), x, mu)
        jx1 = ct.mvm_axpy(jPhiT, jt2, jx, jnp.float32(mu))
        assert_within_lsb(x1, jx1)
        assert_within_lsb(tt.mvm(Phi, x), ct.mvm(jPhi, jx))
        assert_within_lsb(tt.mvm(PhiT, to_torch(jt2)), ct.mvm(jPhiT, jt2))
        assert_same(tt.threshold(to_torch(jx1), k), ct.threshold(jx1, k))
        got = _iteration(Phi, PhiT, y, x, mu, k, None)
        assert isinstance(got, tt.QVec8)
        assert_same(got, tt.threshold(tt.mvm_axpy(PhiT, t2, x, mu), k))
        same = (np.array_equal(t2.codes.numpy(), np.asarray(jt2.codes))
                and np.array_equal(x1.codes.numpy(), np.asarray(jx1.codes)))
        if same:
            assert_within_lsb(got, jax_iteration(*jargs, jnp.float32(mu), k,
                                                 None))
            agreed += 1
    assert agreed >= (2 if bits_a == 4 else 1)    # 3 and 1 at these seeds


@pytest.mark.parametrize("config", ["4x8", 8])
def test_iht_reference_instance_trace_8bit_vectors(config):
    """As test_iht_reference_instance_trace for the mixed 4x8 and pure
    8-bit accuracy configurations: deterministic traced IHT on the
    reference's instance, x starting at 8 bits; same first step within
    5%, same plateau regime (final within max(1.3x, +0.05) both ways)."""
    phi, xs, y = make_iht_problem_reference()
    want = np.asarray(run_iht_accuracy(config, epochs=200, key=None))
    q = tt.quantize(torch.from_numpy(phi), 4 if config == "4x8" else 8)
    res = tt.iht(q, tt.transpose(q), tt.quantize(torch.from_numpy(y), 8),
                 200, 64, ACCURACY_MU[config],
                 x_star=tt.QVec32(values=tt.formats.pad_vector(
                     torch.from_numpy(xs)), length=1024))
    got = res.trace.numpy()
    assert got.shape == (200,) and np.all(np.isfinite(got))
    assert abs(got[0] - want[0]) <= 0.05 * want[0]
    assert got[-1] <= max(1.3 * want[-1], want[-1] + 0.05)
    assert want[-1] <= max(1.3 * got[-1], got[-1] + 0.05)
    assert got[-1] < 0.5 * got[0]
    assert isinstance(res.x, tt.QVec8) and res.x.length == 1024
    assert int((res.x.codes != 0).sum()) <= 64


@pytest.mark.parametrize("bits", [8, 4])
def test_gd_converges(bits):
    """GD on the reference's GD instance: 8-bit converges as clover_tpu
    does (final within max(1.3x, +0.01)); 4-bit makes progress."""
    phi, xs, y = make_gd_problem_reference()
    q = tt.quantize(torch.from_numpy(phi), bits)
    res = tt.gd(q, tt.transpose(q), tt.quantize(torch.from_numpy(y), bits),
                100, GD_MU, x_star=tt.QVec32(values=tt.formats.pad_vector(
                    torch.from_numpy(xs)), length=256))
    tr = res.trace.numpy()
    assert np.all(np.isfinite(tr))
    if bits == 8:
        want = np.asarray(run_gd_accuracy(8, iterations=100, key=None))
        assert tr[-1] < 0.3 * tr[0]
        assert tr[-1] <= max(1.3 * want[-1], want[-1] + 0.01)
    else:
        assert tr.min() < tr[0]


def test_iht_seeded_solves_reproduce():
    jargs = _instance(7, 128, 256, 16)
    Phi, PhiT, y, _ = (to_torch(q) for q in jargs)
    a = tt.iht(Phi, PhiT, y, 5, 16, 0.004, generator=123)
    b = tt.iht(Phi, PhiT, y, 5, 16, 0.004, generator=123)
    c = tt.iht(Phi, PhiT, y, 5, 16, 0.004,
               generator=torch.Generator().manual_seed(1))
    assert_same(a.x, b.x)
    assert not np.array_equal(a.x.codes.numpy(), c.x.codes.numpy())
    assert np.all(a.trace.numpy() == 0)        # untraced: zeros, like JAX


# The chained 100-iteration solve against clover_tpu's solver on the same
# quantized operands (512x1024, K 256, mu 1e-3, deterministic
# quantization).  The two trajectories part within a few iterations where a
# band's absmax element floors to the other code (module docstring), so the
# final recovery errors are compared.  Relative gap over seeds 0-7: at most
# 0.0145; a plain solve one precision below, 3 bits, against clover_tpu's:
# at least 0.129.  CHAIN_GAP lies between, with more than 2.5x of room each
# way.  The chain's exact agreement with the unchained iterations is
# tests/test_torch_iteration.py's.
CHAIN_GAP = 0.04


def _plain_quant(v, bits, axes):
    """Restored values of ``v`` quantized by truncation, one absmax scale
    over ``axes`` of each block (an all-zero block takes scale 1)."""
    qmax = np.float32(2 ** (bits - 1) - 1)
    s = np.abs(v).max(axis=axes, keepdims=True)
    s = np.where(s == 0, np.float32(1), s)
    return np.sign(v) * np.minimum(np.floor(np.abs(v) / s * qmax), qmax) \
        * (s / qmax)


def _plain_iht(phi, y, iterations, k, mu, bits):
    """Deterministic block-scaled IHT at ``bits`` in plain numpy: 64x64
    tiles, 64-element vector blocks, every MVM and AXPY requantized."""
    m, n = phi.shape

    def mat(a):
        r, c = a.shape
        return _plain_quant(a.reshape(r // 64, 64, c // 64, 64), bits,
                            (1, 3)).reshape(r, c)

    def vec(v):
        return _plain_quant(v.reshape(-1, 64), bits, 1).reshape(v.shape)

    a, at, yq = mat(phi), mat(np.ascontiguousarray(phi.T)), vec(y)
    x = np.zeros(n, np.float32)
    for _ in range(iterations):
        t2 = vec(yq - vec(a @ x))
        x = vec(x + np.float32(mu) * vec(at @ t2))
        keep = np.argsort(-np.abs(x), kind="stable")[:k]
        x = np.where(np.isin(np.arange(n), keep), x, np.float32(0))
    return x


@pytest.mark.parametrize("seed", range(4))
def test_chained_solve_against_plain_reference(seed):
    """The port's chained solve ends within CHAIN_GAP of clover_tpu's
    solve of the same operands; a plain 3-bit solve ends outside it."""
    from clover_tpu_torch import tracing
    m, n, k, mu, iterations = 512, 1024, 256, 1e-3, 100
    rng = np.random.default_rng(seed)
    phi = rng.random((m, n), dtype=np.float32) * 2 - 1
    xs = np.zeros(n, np.float32)
    xs[rng.permutation(n)[:k]] = 1.0
    y = phi @ xs
    jq = ct.quantize(jnp.asarray(phi), 4)
    jargs = (jq, ct.transpose(jq), ct.quantize(jnp.asarray(y), 4))

    def rel(x):
        return float(np.linalg.norm(x[:n] - xs) / np.linalg.norm(xs))

    before = tracing.counters().get("solver.chained_iterations", 0)
    res = tt.iht(*(to_torch(q) for q in jargs), iterations, k, mu)
    assert (tracing.counters()["solver.chained_iterations"] - before
            == iterations)
    got = rel(tt.restore_vec(res.x).values.numpy())
    want = rel(np.asarray(ct.restore_vec(
        jax_iht(*jargs, iterations, k, mu).x).values))
    control = rel(_plain_iht(phi, y, iterations, k, mu, 3))
    assert abs(got - want) / want <= CHAIN_GAP, (got, want)
    assert abs(control - want) / want > CHAIN_GAP, (control, want)


def test_op_seeds_wrap_like_jax():
    """Per-op seeds are int32 seed + (j+1)*SEED_OP with wrap-around, the
    arithmetic of clover_tpu's _op_seeds."""
    from clover_tpu.models.solvers import _op_seeds as jax_op_seeds
    for seed in (0, 5, 2 ** 31 - 10, -2 ** 31):
        want = [int(np.asarray(s).reshape(())) for s in jax_op_seeds(
            jnp.asarray([seed], jnp.int32))]
        assert list(_op_seeds(seed)) == want
    assert _op_seeds(None) == (None,) * 4


def test_untraced_solve_never_syncs(monkeypatch):
    """The solver loop reads nothing back from the device: with every
    tensor-to-host conversion disabled, an untraced solve still runs."""
    jargs = _instance(3, 128, 256, 16)
    Phi, PhiT, y, _ = (to_torch(q) for q in jargs)

    def refuse(*_a, **_k):
        raise AssertionError("host sync inside the solver loop")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    res = tt.iht(Phi, PhiT, y, 3, 16, 0.004, generator=9)
    monkeypatch.undo()
    assert isinstance(res.x, tt.QVec4)


def test_make_iht_problem():
    g = torch.Generator().manual_seed(0)
    phi, x, y = tt.make_iht_problem(128, 256, 16, generator=g)
    assert phi.shape == (128, 256) and x.shape == (256,) and y.shape == (128,)
    assert float(phi.min()) >= -1.0 and float(phi.max()) < 1.0
    assert int(x.count_nonzero()) == 16 and set(x.unique().tolist()) == {0, 1}
    torch.testing.assert_close(phi @ x, y)
    p2, x2, _ = tt.make_iht_problem(128, 256, 16, device="cpu")
    p3, x3, _ = tt.make_iht_problem(128, 256, 16, device="cpu")
    assert torch.equal(p2, p3) and torch.equal(x2, x3)


def test_make_iht_problem_defaults_to_cuda(monkeypatch):
    """With neither a generator nor a device the problem is built on
    ``cuda`` (a generator seeded DEFAULT_SEED there); ``device="cpu"`` is
    the CPU generator with that seed; a device that contradicts the
    generator raises."""
    from clover_tpu_torch.models import problems
    asked = []
    real = torch.Generator

    def recording(device="cpu"):
        asked.append(torch.device(device))
        return real()                   # the data itself stays on the CPU

    monkeypatch.setattr(torch, "Generator", recording)
    tt.make_iht_problem(128, 256, 16)
    tt.make_gd_problem(128, 256)
    monkeypatch.undo()
    assert asked == [torch.device("cuda")] * 2
    want = torch.rand(128, 256, generator=real().manual_seed(
        problems.DEFAULT_SEED)) * 2 - 1
    assert torch.equal(tt.make_iht_problem(128, 256, 16, device="cpu")[0],
                       want)
    with pytest.raises(ValueError, match="differs"):
        tt.make_iht_problem(128, 256, 16, generator=real(), device="meta")


def test_mixed_4x8_small_solve_diverges_in_both_packages(monkeypatch):
    """The 4x8 2048x4096 IHT at its tuned mu (tuned for 1 iteration), run
    for 100 deterministic iterations on the same containers: both packages
    stay below 1.0 at the tuned iteration and diverge together after it
    (chip_smoke.py phase 7 saw ~9e9 at 100 on the card), so the divergence
    is the mu's, not the port's.  The traces part within a few iterations
    (floor boundaries), so they are held by regime: above 1e3 at 100, within
    10x of each other at 20, 50 and 100.  Prints both curves."""
    from clover_tpu.models.solvers import iht as jax_iht
    from clover_tpu_torch.models import tuned
    from torch_helpers import to_jax
    monkeypatch.setenv("CLOVER_PALLAS", "0")      # clover_tpu's XLA path
    m, n = 2048, 4096
    row = tuned.IHT_MIXED_4X8[(m, n)]
    k, mu = row["K"], row["mu"]
    gen = torch.Generator().manual_seed(3)
    phi, x_star, y = tt.make_iht_problem(m, n, k, generator=gen,
                                         device="cpu")
    qphi = tt.quantize(phi, 4, generator=gen)
    qphit, qy = tt.transpose(qphi), tt.quantize(y, 8, generator=gen)
    xs = tt.QVec32(values=tt.formats.pad_vector(x_star), length=n)
    got = tt.iht(qphi, qphit, qy, 100, k, mu, x_star=xs).trace.numpy()
    want = np.asarray(jax_iht(to_jax(qphi), to_jax(qphit), to_jax(qy), 100,
                              k, mu, key=None, x_star=to_jax(xs)).trace)
    at = (1, 2, 5, 10, 20, 30, 50, 75, 100)
    print("\niteration " + " ".join(f"{i:>10d}" for i in at))
    for name, t in (("port", got), ("clover_tpu", want)):
        print(f"{name:9s} " + " ".join(f"{t[i - 1]:10.4g}" for i in at))
    assert got[row["iters"] - 1] < 1.0 and want[row["iters"] - 1] < 1.0
    assert got[-1] > 1e3 and want[-1] > 1e3
    for i in (20, 50, 100):
        assert 0.1 < got[i - 1] / want[i - 1] < 10.0, i
