"""clover_tpu_torch batched MVM (the batched MVM kernel's plain version) and
the quantized GEMM against clover_tpu.

The batched MVM's vector j is the single MVM with seed ``seed + j``, so it
is bit-identical to per-vector ``tt.mvm``; against clover_tpu's batched
Pallas kernel (interpret mode) codes agree within 1 LSB, the f32 block sums
running in another order, as tests/test_kernels.py allows it against its
own single kernel.  ``gemm_f32`` and the int x f32 ``mvm_f32`` are held to
clover_tpu within rtol 1e-5 (f32 sums in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.kernels.mvm_batched import (mvm_batched_pallas,
                                            mvm_batched_pallas_eligible)
from clover_tpu_torch.kernels import mvm4_plain, mvm8_plain, mvm_batched_plain
from torch_helpers import assert_same, assert_within_lsb, to_jax, to_torch

MODES = [(4, 4), (4, 8), (8, 8)]


def _stack_jax(vecs):
    return jax.tree.map(lambda *a: jnp.stack(a), *vecs)


def _batch(rng, m, n, bits_a, bits_x, b):
    A = rng.random((m, n), dtype=np.float32) * 2 - 1
    jA = ct.quantize(jnp.asarray(A), bits_a)
    jvecs = [ct.quantize(jnp.asarray(rng.random(n, dtype=np.float32) * 2 - 1),
                         bits_x) for _ in range(b)]
    return jA, jvecs


@pytest.mark.parametrize("bits_a,bits_x", MODES)
@pytest.mark.parametrize("b", [2, 3, 8])
def test_mvm_batched_within_lsb_of_pallas(rng, bits_a, bits_x, b):
    """The plain route against clover_tpu's batched kernel (interpret
    mode), as tests/test_kernels.py holds that kernel to its single one."""
    jA, jvecs = _batch(rng, 256, 512, bits_a, bits_x, b)
    jxs = _stack_jax(jvecs)
    mode = f"{bits_a}x{bits_x}"
    assert mvm_batched_pallas_eligible(jA, (b,), mode)
    want = mvm_batched_pallas(jA, jxs, key=None)
    got = tt.mvm_batched(to_torch(jA), tt.stack_vectors(
        [to_torch(v) for v in jvecs]))
    assert got.codes.shape == tuple(want.codes.shape)
    for j in range(b):
        wj = jax.tree.map(lambda a: a[j], want)
        gj = tt.vector_at(got, j)
        np.testing.assert_allclose(gj.scales.numpy(), np.asarray(wj.scales),
                                   rtol=3e-7)
        assert_within_lsb(gj, wj)


@pytest.mark.parametrize("bits_a,bits_x", MODES)
@pytest.mark.parametrize("generator", [None, 2 ** 31 - 2])
def test_mvm_batched_equals_per_vector_mvm(rng, bits_a, bits_x, generator):
    """Vector j is tt.mvm(A, x_j, seed + j) bit for bit (det and SR; the
    seed wraps around int32)."""
    jA, jvecs = _batch(rng, 200, 300, bits_a, bits_x, 3)
    A = to_torch(jA)
    vecs = [to_torch(v) for v in jvecs]
    got = tt.mvm_batched(A, tt.stack_vectors(vecs), generator)
    assert got.length == 200 and got.codes.shape[0] == 3
    for j, x in enumerate(vecs):
        g = None if generator is None else tt.kernels.wrap_i32(generator + j)
        assert_same(tt.vector_at(got, j), tt.mvm(A, x, g))


def test_mvm_batched_plain_is_single_plain_per_vector(rng):
    jA, jvecs = _batch(rng, 128, 256, 4, 8, 2)
    A = to_torch(jA)
    xs = tt.stack_vectors([to_torch(v) for v in jvecs])
    codes, scales = mvm_batched_plain(4, 8, A.codes, A.scales, xs.codes,
                                      xs.scales, 40, True)
    for j in range(2):
        c, s = mvm8_plain(4, A.codes, A.scales, xs.codes[j], xs.scales[j],
                          seed1=40 + j, noise1=True)
        assert torch.equal(codes[j], c) and torch.equal(scales[j], s)


@pytest.mark.parametrize("b", [1, 33])
def test_mvm_batched_cuda_routes(monkeypatch, rng, b):
    """On CUDA, B = 1 takes the single MVM kernel and B = 33 two batched
    launches (32 + 1) with the global seeds seed and seed + 32; the result
    equals the plain route's."""
    import clover_tpu_torch.ops.gemm as ops_gemm
    import clover_tpu_torch.ops.mvm as ops_mvm
    jA, jvecs = _batch(rng, 128, 256, 4, 4, b)
    A = to_torch(jA)
    xs = tt.stack_vectors([to_torch(v) for v in jvecs])
    want = tt.mvm_batched(A, xs, 7)
    single, batched = [], []

    def fake_single(*args, **kw):
        single.append(kw["seed1"])
        return mvm4_plain(*args, **kw)

    def fake_batched(bits_a, bits_x, ac, as_, xc, xsc, seed, noise):
        batched.append((xc.shape[0], seed))
        return mvm_batched_plain(bits_a, bits_x, ac, as_, xc, xsc, seed,
                                 noise)

    for mod in (ops_gemm, ops_mvm):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ops_mvm, "mvm4_cuda", fake_single)
    monkeypatch.setattr(ops_gemm, "mvm_batched_cuda", fake_batched)
    got = tt.mvm_batched(A, xs, 7)
    assert_same(got, want)
    if b == 1:
        assert single == [7] and batched == []
    else:
        assert single == [] and batched == [(32, 7), (1, 39)]


@pytest.mark.parametrize("bits_a,bits_x", MODES)
def test_mvm_batched_f32_matches_jax(rng, bits_a, bits_x):
    jA, jvecs = _batch(rng, 256, 384, bits_a, bits_x, 3)
    got = tt.mvm_batched_f32(to_torch(jA), tt.stack_vectors(
        [to_torch(v) for v in jvecs]))
    want = np.asarray(ct.ops.gemm.mvm_batched_f32(jA, _stack_jax(jvecs)))
    assert got.shape == want.shape == (3, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_mvm_batched_fp_modes_match_jax(rng):
    """16- and 32-bit batches run one plain MVM per vector.  clover_tpu's
    default kernel selection reads ``A.codes``, which a 16/32-bit matrix
    lacks, so its vmapped path is asked for explicitly."""
    A = rng.random((128, 256), dtype=np.float32) * 2 - 1
    for bits in (16, 32):
        jA = ct.quantize(jnp.asarray(A), bits)
        jvecs = [ct.quantize(jnp.asarray(rng.random(256, dtype=np.float32)),
                             bits) for _ in range(2)]
        got = tt.mvm_batched(to_torch(jA), tt.stack_vectors(
            [to_torch(v) for v in jvecs]))
        want = ct.mvm_batched(jA, _stack_jax(jvecs), use_kernel=False)
        assert type(got).__name__ == type(want).__name__
        np.testing.assert_allclose(got.values.float().numpy(),
                                   np.asarray(want.values, np.float32),
                                   rtol=2e-3 if bits == 16 else 1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("r", [1, 5])
def test_gemm_f32_matches_jax(rng, bits, r):
    A = rng.random((200, 300), dtype=np.float32) * 2 - 1
    jA = ct.quantize(jnp.asarray(A), bits)
    B = rng.standard_normal((jA.cols_pad, r)).astype(np.float32)
    got = tt.gemm_f32(to_torch(jA), torch.from_numpy(B))
    want = np.asarray(ct.gemm_f32(jA, jnp.asarray(B)))
    assert got.shape == want.shape == (256, r)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [4, 8])
def test_mvm_f32_int_matrix_f32_vector_matches_jax(rng, bits):
    A = rng.random((200, 300), dtype=np.float32) * 2 - 1
    x = rng.standard_normal(300).astype(np.float32)
    jA = ct.quantize(jnp.asarray(A), bits)
    jx = ct.quantize(jnp.asarray(x), 32)
    got = tt.mvm_f32(to_torch(jA), to_torch(jx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ct.mvm_f32(jA, jx)),
                               rtol=1e-5, atol=1e-5)
    y = tt.mvm(to_torch(jA), to_torch(jx))
    assert isinstance(y, tt.QVec32) and y.length == 200
    np.testing.assert_allclose(y.values.numpy(),
                               np.asarray(ct.mvm(jA, jx).values),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [4, 8])
def test_mvm_f32_int_matrix_f32_vector_never_restores_the_matrix(
        monkeypatch, rng, bits):
    """The int x f32 product goes through gemm_f32, which forms no restored
    copy of A: with restore_mat made to raise it still runs."""
    import clover_tpu_torch.ops.mvm as ops_mvm
    A = tt.quantize(torch.rand(128, 256) * 2 - 1, bits)
    x = tt.quantize(torch.randn(256), 32)
    want = tt.restore_mat(A).values @ x.values

    def refuse(_q):
        raise AssertionError("restore_mat called")

    monkeypatch.setattr(ops_mvm, "restore_mat", refuse)
    got = tt.mvm_f32(A, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert isinstance(tt.mvm(A, x), tt.QVec32)
