"""IEEE fp32 in the port's f32 products (clover_tpu pins
``Precision.HIGHEST`` on each: ops/mvm.py, ops/gemm.py, ops/sparse.py).

``ops._core.ieee_fp32`` turns TF32 off for the product and restores the
caller's settings after it, also when the product raises.  The tolerances
against clover_tpu are those of the existing tests of each op:
test_torch_mvm.py (rtol 2e-3 at 16 bits, the fp16 output), test_torch_gemm
(rtol 1e-5) and test_torch_access.py (rtol 1e-5; codes within 1 LSB).
"""

import contextlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.ops.sparse import mvm_sparse as ct_mvm_sparse
from clover_tpu_torch.ops import _core
from torch_helpers import assert_within_lsb, to_jax, to_torch


def _settings():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.fixture
def tf32_requested():
    """A caller who asks for TF32 products; the defaults come back after."""
    before = _settings()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    yield _settings()
    torch.backends.cuda.matmul.allow_tf32 = before[0]
    torch.set_float32_matmul_precision(before[2])
    torch.backends.cudnn.allow_tf32 = before[1]


def test_ieee_fp32_sets_and_restores(tf32_requested):
    assert tf32_requested == (True, True, "high")
    with _core.ieee_fp32():
        assert _settings() == (False, False, "highest")
    assert _settings() == tf32_requested


def test_ieee_fp32_restores_on_an_exception(tf32_requested):
    with pytest.raises(ZeroDivisionError):
        with _core.ieee_fp32():
            assert _settings() == (False, False, "highest")
            raise ZeroDivisionError
    assert _settings() == tf32_requested


def test_ieee_fp32_keeps_ieee_callers_and_nests():
    before = _settings()
    with _core.ieee_fp32():
        with _core.ieee_fp32():
            assert _settings() == (False, False, "highest")
        assert _settings() == (False, False, "highest")
    assert _settings() == before


def _mat_vec(rng, bits_a, bits_x, m=128, n=256):
    a = rng.random((m, n), dtype=np.float32) * 2 - 1
    x = rng.random(n, dtype=np.float32) * 2 - 1
    return ct.quantize(jnp.asarray(a), bits_a), ct.quantize(jnp.asarray(x),
                                                            bits_x)


def _products(rng):
    """The five f32 products: (name, call, how many products it makes)."""
    A16, x16 = (to_torch(q) for q in _mat_vec(rng, 16, 16))
    A4 = to_torch(_mat_vec(rng, 4, 4)[0])
    x32 = to_torch(_mat_vec(rng, 4, 32)[1])
    A32 = to_torch(_mat_vec(rng, 32, 32)[0])
    xs = tt.threshold(tt.quantize(torch.linspace(-1, 1, 128), 8), 16)
    AT = tt.transpose(tt.quantize(torch.rand(256, 128) * 2 - 1, 8))
    return [("mvm.py af @ xf", lambda: tt.mvm(A16, x16), 1),
            ("gemm.py fp matrix @", lambda: tt.gemm_f32(
                A32, torch.ones(256, 3)), 1),
            ("gemm.py bmm and einsum", lambda: tt.mvm_f32(A4, x32), 2),
            ("sparse.py vals @ rows", lambda: tt.mvm_sparse(AT, xs, 16), 1)]


def test_each_product_runs_inside_the_pin(rng, monkeypatch):
    """A counting ieee_fp32 stand-in; every product (Tensor @, torch.bmm,
    torch.einsum) must find it entered."""
    depth, entered, outside = [0], [0], []

    @contextlib.contextmanager
    def counting():
        depth[0] += 1
        entered[0] += 1
        try:
            yield
        finally:
            depth[0] -= 1

    def watch(name, fn):
        def wrapped(*args, **kwargs):
            if not depth[0]:
                outside.append(name)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(_core, "ieee_fp32", counting)
    monkeypatch.setattr(torch.Tensor, "__matmul__",
                        watch("@", torch.Tensor.__matmul__))
    monkeypatch.setattr(torch, "bmm", watch("bmm", torch.bmm))
    monkeypatch.setattr(torch, "einsum", watch("einsum", torch.einsum))
    for name, call, products in _products(rng):
        entered[0] = 0
        call()
        assert entered[0] >= 1, name
        assert not outside, (name, outside)
    # the bmm and einsum of the int x f32 product share one pin
    entered[0] = 0
    _products(rng)[2][1]()
    assert entered[0] == 1


@pytest.mark.parametrize("bits", [16, 32])
def test_mvm_with_tf32_requested_matches_jax(rng, tf32_requested, bits):
    jA, jx = _mat_vec(rng, bits, bits)
    got = tt.mvm(to_torch(jA), to_torch(jx))
    np.testing.assert_allclose(got.values.numpy().astype(np.float32),
                               np.asarray(ct.mvm(jA, jx).values, np.float32),
                               rtol=2e-3, atol=1e-3)
    assert _settings() == tf32_requested


@pytest.mark.parametrize("bits", [4, 8])
def test_gemm_f32_with_tf32_requested_matches_jax(rng, tf32_requested, bits):
    jA, _ = _mat_vec(rng, bits, 4)
    B = rng.random((256, 5), dtype=np.float32) * 2 - 1
    got = tt.gemm_f32(to_torch(jA), torch.from_numpy(B))
    want = np.asarray(ct.gemm_f32(jA, jnp.asarray(B)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert _settings() == tf32_requested


@pytest.mark.parametrize("bits_a,bits_x", [(8, 8), (32, 32)])
def test_mvm_sparse_with_tf32_requested_matches_jax(rng, tf32_requested,
                                                    bits_a, bits_x):
    a = rng.random((256, 512), dtype=np.float32) * 2 - 1
    jA = ct.quantize(jnp.asarray(a), bits_a)
    jx = ct.threshold(ct.quantize(
        jnp.asarray(rng.random(512, dtype=np.float32) * 2 - 1), bits_x), 16)
    AT = tt.transpose(to_torch(jA))
    got = tt.mvm_sparse(AT, to_torch(jx), 16)
    want = ct_mvm_sparse(to_jax(AT), jx, 16)
    if bits_x == 32:
        np.testing.assert_allclose(got.values.numpy(),
                                   np.asarray(want.values),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert_within_lsb(got, want)
    assert _settings() == tf32_requested
