"""clover_tpu_torch batched IHT / GD (plain versions on the CPU) against
clover_tpu, and the stacked containers they run on.

A deterministic batched solve is bit-identical to B single solves of the
port (each problem follows the unfused single iteration, which equals the
fused one bit for bit).  Against clover_tpu's batched solvers, whose f32
sums run in another order, the checks are those of tests/test_solvers.py:
the same trace shape, the same first iteration within 5% (10% for 4-bit
IHT, see there) and the final error in the same regime.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.formats import QVec32 as JQVec32
from clover_tpu.models import gd_batched as jax_gd_batched
from clover_tpu.models import iht_batched as jax_iht_batched
from clover_tpu.models.problems import make_iht_problem as jax_problem
from clover_tpu_torch.kernels import threshold4_plain, threshold8_plain
from torch_helpers import assert_same, to_torch

B, M, N, K = 3, 256, 512, 32


def _setup(bits_a, bits_v, b=B, seed=0):
    """-> (jax (Phi, PhiT, ys, stars), port (Phi, PhiT, [y_j], [x*_j]))
    from clover_tpu's problem generator, y_j normalized as in
    tests/test_solvers.py."""
    phi, _, _ = jax_problem(M, N, K)
    phn = np.asarray(phi)
    rng = np.random.default_rng(seed)
    jphi = ct.quantize(jnp.asarray(phi), bits_a, key=None)
    jys, jstars = [], []
    for _ in range(b):
        xs = np.zeros(N, np.float32)
        xs[rng.choice(N, K, replace=False)] = 1.0
        y = phn @ xs
        s = float(np.abs(y).max())
        jys.append(ct.quantize(jnp.asarray(y / s), bits_v, key=None))
        jstars.append(JQVec32(values=jnp.asarray(
            np.pad(xs / s, (0, jphi.cols_pad - N))), length=N))
    stack = lambda qs: jax.tree.map(lambda *a: jnp.stack(a), *qs)
    jax_side = (jphi, ct.transpose(jphi), stack(jys), stack(jstars))
    port = (to_torch(jphi), to_torch(ct.transpose(jphi)),
            [to_torch(q) for q in jys], [to_torch(q) for q in jstars])
    return jax_side, port


@pytest.mark.parametrize("bits_a,bits_v", [(4, 4), (8, 8)])
def test_iht_batched_matches_jax(bits_a, bits_v):
    """clover_tpu's batched trace equals its single solves'; the port's
    first iterate is held to it within 5% at 8 bits and 10% at 4 bits.
    At 4 bits a 1-ulp difference in a band absmax of the first MVM moves a
    code 7 <-> 6 and the next AXPY band scale by 1/7 (ROADMAP.md queue 3),
    which parts the first iterate by up to 7.4% on this instance (the
    port's own single solves part from clover_tpu's alike)."""
    iters, mu = 30, 0.01
    first_tol = 0.10 if bits_v == 4 else 0.05
    (jphi, jphit, jys, jstars), (phi, phit, ys, stars) = _setup(bits_a,
                                                                 bits_v)
    res = tt.iht_batched(phi, phit, tt.stack_vectors(ys), iters, K, mu,
                         xs_star=tt.stack_vectors(stars))
    want = np.asarray(jax_iht_batched(jphi, jphit, jys, iters, K, mu,
                                      key=None, xs_star=jstars).trace)
    tr = res.trace.numpy()
    assert tr.shape == want.shape == (iters, B)
    assert np.all(np.isfinite(tr)) and np.all(tr[-1] < 0.7 * tr[0])
    assert np.all(np.abs(tr[0] - want[0]) <= first_tol * want[0])
    assert np.all(tr[-1] <= np.maximum(1.3 * want[-1], want[-1] + 0.05))
    assert np.all(want[-1] <= np.maximum(1.3 * tr[-1], tr[-1] + 0.05))
    assert type(res.xs) is type(ys[0]) and res.xs.codes.shape[0] == B


@pytest.mark.parametrize("bits_a,bits_v", [(4, 4), (4, 8), (8, 8)])
def test_iht_batched_bit_identical_to_single_solves(bits_a, bits_v):
    iters, mu = 12, 0.01
    _, (phi, phit, ys, stars) = _setup(bits_a, bits_v)
    res = tt.iht_batched(phi, phit, tt.stack_vectors(ys), iters, K, mu,
                         xs_star=tt.stack_vectors(stars))
    for j in range(B):
        single = tt.iht(phi, phit, ys[j], iters, K, mu, x_star=stars[j])
        assert_same(tt.vector_at(res.xs, j), single.x)
        np.testing.assert_allclose(res.trace[:, j].numpy(),
                                   single.trace.numpy(), rtol=1e-6)


def test_gd_batched_matches_jax():
    iters, mu = 40, 0.002
    (jphi, jphit, jys, jstars), (phi, phit, ys, stars) = _setup(8, 8, b=2)
    res = tt.gd_batched(phi, phit, tt.stack_vectors(ys), iters, mu,
                        xs_star=tt.stack_vectors(stars))
    want = np.asarray(jax_gd_batched(jphi, jphit, jys, iters, mu, key=None,
                                     xs_star=jstars).trace)
    tr = res.trace.numpy()
    assert tr.shape == want.shape == (iters, 2)
    assert np.all(np.isfinite(tr)) and np.all(tr[-1] < tr[0])
    assert np.all(np.abs(tr[0] - want[0]) <= 0.05 * want[0])
    assert np.all(tr[-1] <= np.maximum(1.3 * want[-1], want[-1] + 0.05))
    for j in range(2):
        single = tt.gd(phi, phit, ys[j], iters, mu)
        assert_same(tt.vector_at(res.xs, j), single.x)


def test_iht_batched_sr_seeds():
    """SR solves reproduce from one seed and differ between generators;
    untraced solves return a zero trace of shape (iterations, B)."""
    _, (phi, phit, ys, _) = _setup(4, 4, b=2)
    ys = tt.stack_vectors(ys)
    a = tt.iht_batched(phi, phit, ys, 5, K, 0.01, generator=11)
    b = tt.iht_batched(phi, phit, ys, 5, K, 0.01, generator=11)
    c = tt.iht_batched(phi, phit, ys, 5, K, 0.01,
                       generator=torch.Generator().manual_seed(1))
    d = tt.iht_batched(phi, phit, ys, 5, K, 0.01,
                       generator=torch.Generator().manual_seed(2))
    assert_same(a.xs, b.xs)
    assert not np.array_equal(c.xs.codes.numpy(), d.xs.codes.numpy())
    assert a.trace.shape == (5, 2) and np.all(a.trace.numpy() == 0)


def test_batched_iteration_launch_sequence(monkeypatch):
    """On CUDA one batched iteration launches 2 batched MVMs, 2 AXPYs and
    1 threshold, and one restore when traced, whatever B."""
    import clover_tpu_torch.ops.axpy as ops_axpy
    import clover_tpu_torch.ops.gemm as ops_gemm
    import clover_tpu_torch.ops.quantize as ops_quantize
    import clover_tpu_torch.ops.threshold as ops_threshold
    from clover_tpu_torch import kernels as kn
    calls = []

    def record(name, fn):
        def wrapper(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapper

    for mod in (ops_axpy, ops_gemm, ops_quantize, ops_threshold):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ops_gemm, "mvm_batched_cuda",
                        record("mvm_batched", kn.mvm_batched_plain))
    monkeypatch.setattr(ops_axpy, "axpy_cuda", record("axpy", kn.axpy_plain))
    monkeypatch.setattr(ops_threshold, "threshold4_cuda",
                        record("threshold4", threshold4_plain))
    monkeypatch.setattr(ops_quantize, "restore_vec_cuda",
                        record("restore_vec", kn.restore_vec_plain))
    _, (phi, phit, ys, stars) = _setup(4, 4, b=3)
    tt.iht_batched(phi, phit, tt.stack_vectors(ys), 2, K, 0.01,
                   xs_star=tt.stack_vectors(stars))
    per_iteration = ["mvm_batched", "axpy", "mvm_batched", "axpy",
                     "threshold4", "restore_vec"]
    assert calls == per_iteration * 2


def test_untraced_batched_solve_never_syncs(monkeypatch):
    _, (phi, phit, ys, _) = _setup(4, 4, b=2)
    ys = tt.stack_vectors(ys)

    def refuse(*_a, **_k):
        raise AssertionError("host sync inside the solver loop")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    res = tt.iht_batched(phi, phit, ys, 3, K, 0.01, generator=9)
    monkeypatch.undo()
    assert isinstance(res.xs, tt.QVec4)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("k", [0, 1, 40])
def test_threshold_batched_plain_equals_rows(rng, bits, k):
    rows = [rng.standard_normal(300).astype(np.float32),
            rng.integers(-3, 4, 300).astype(np.float32),
            np.repeat(rng.random(5, dtype=np.float32), 64)[:300]]
    qs = [tt.quantize(torch.from_numpy(v), bits) for v in rows]
    x = tt.stack_vectors(qs)
    got = tt.threshold(x, k)
    assert got.codes.shape == x.codes.shape and got.scales is x.scales
    for j, q in enumerate(qs):
        assert_same(tt.vector_at(got, j), tt.threshold(q, k))
    if bits == 4:
        assert torch.equal(threshold4_plain(x.codes, x.scales, k), got.codes)
    else:
        assert torch.equal(threshold8_plain(x.codes, x.scales, k, 300),
                           got.codes)


@pytest.mark.parametrize("bits", [4, 8])
def test_restore_vec_stacked_equals_rows(rng, bits):
    qs = [tt.quantize(torch.from_numpy(
        rng.standard_normal(300).astype(np.float32)), bits) for _ in range(3)]
    got = tt.restore_vec(tt.stack_vectors(qs))
    assert got.values.shape == (3, 384) and got.length == 300
    for j, q in enumerate(qs):
        assert torch.equal(got.values[j], tt.restore_vec(q).values)


def test_stack_vectors_and_vector_at():
    qs = [tt.quantize(torch.linspace(-1, j, 300), 4) for j in range(3)]
    x = tt.stack_vectors(qs)
    assert x.codes.shape == (3, 192) and x.scales.shape == (3, 6)
    assert x.length == 300 and x.length_pad == 384 and x.blocks == 6
    for j, q in enumerate(qs):
        assert_same(tt.vector_at(x, j), q)
    f = tt.stack_vectors([tt.QVec32(values=torch.ones(128), length=100)] * 2)
    assert f.values.shape == (2, 128)
    with pytest.raises(TypeError):
        tt.stack_vectors([qs[0], tt.quantize(torch.ones(300), 8)])
    with pytest.raises(TypeError):
        tt.stack_vectors([qs[0], tt.quantize(torch.ones(200), 4)])
