"""clover_tpu_torch standalone scaleAndAdd (the AXPY kernel's plain version)
against clover_tpu, on single and stacked containers.

Deterministic results are bit-identical to clover_tpu's XLA path: both
restore with the multiplier s/qmax divided first and add u + a * v in f32.
Against clover_tpu's Pallas AXPY (interpret mode), whose planes combine in
another fused order, codes agree within 1 LSB and scales within rtol 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.formats import BLOCK
from clover_tpu.kernels.quantize import (GRP, axpy_pallas,
                                         axpy_pallas_eligible)
from clover_tpu_torch.kernels import axpy_plain
from torch_helpers import assert_same, assert_within_lsb, to_torch


def _pair(rng, n, bits):
    u = rng.random(n, dtype=np.float32) * 2 - 1
    v = rng.standard_normal(n).astype(np.float32)
    v[: n // 5] = 0.0                         # a zero block on one side
    return (ct.quantize(jnp.asarray(u), bits),
            ct.quantize(jnp.asarray(v), bits))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [300, 4096])
@pytest.mark.parametrize("alpha", [-1.0, 0.37, 0.00513])
def test_scale_and_add_bit_identical_to_jax(rng, bits, n, alpha):
    ju, jv = _pair(rng, n, bits)
    got = tt.scale_and_add(to_torch(ju), to_torch(jv), alpha)
    assert isinstance(got, type(to_torch(ju))) and got.length == n
    assert_same(got, ct.scale_and_add(ju, jv, alpha))


@pytest.mark.parametrize("bits", [4, 8])
def test_scale_and_add_within_lsb_of_axpy_pallas(rng, bits):
    """clover_tpu's Pallas AXPY (interpret mode) at an eligible length."""
    n = 2 * GRP * BLOCK
    ju, jv = _pair(rng, n, bits)
    assert axpy_pallas_eligible(ju, jv)
    got = tt.scale_and_add(to_torch(ju), to_torch(jv), -0.61)
    assert_within_lsb(got, axpy_pallas(ju, jv, -0.61, None))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("generator", [None, 77])
def test_stacked_scale_and_add(rng, bits, generator):
    """A stacked batch is one flat vector of B * n_pad elements: it equals
    the AXPY of the concatenated vectors (SR counters run over the flat
    index), and, deterministic, each row's own AXPY."""
    pairs = [tuple(to_torch(q) for q in _pair(rng, 300, bits))
             for _ in range(3)]
    us = tt.stack_vectors([u for u, _ in pairs])
    vs = tt.stack_vectors([v for _, v in pairs])
    got = tt.scale_and_add(us, vs, 0.25, generator)
    assert got.codes.shape == us.codes.shape
    assert got.scales.shape == us.scales.shape and got.length == 300
    seed, noise = (0, False) if generator is None else (generator, True)
    codes, scales = axpy_plain(us.codes.reshape(-1), us.scales.reshape(-1),
                               vs.codes.reshape(-1), vs.scales.reshape(-1),
                               0.25, bits, seed, noise)
    assert torch.equal(got.codes.reshape(-1), codes)
    assert torch.equal(got.scales.reshape(-1), scales)
    if generator is None:
        for j, (u, v) in enumerate(pairs):
            assert_same(tt.vector_at(got, j), tt.scale_and_add(u, v, 0.25))


def test_scale_and_add_sr_reproducible_and_unbiased(rng):
    ju, jv = _pair(rng, 4096, 4)
    u, v = to_torch(ju), to_torch(jv)
    assert_same(tt.scale_and_add(u, v, 0.5, 9), tt.scale_and_add(u, v, 0.5, 9))
    exact = (tt.restore(u).values + 0.5 * tt.restore(v).values).numpy()
    outs = np.stack([tt.restore(tt.scale_and_add(u, v, 0.5, s)).values.numpy()
                     for s in range(64)])
    lsb = np.repeat(tt.scale_and_add(u, v, 0.5).scales.numpy(), 64) / 7.0
    assert np.all(np.abs(outs.mean(0) - exact) <= lsb)
    assert not np.array_equal(outs[0], outs[1])


@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_scale_and_add_reaches_the_kernel(monkeypatch, bits):
    """With operands taken for CUDA ones, a 4/8-bit scale_and_add calls the
    AXPY kernel once, on the flat operands of a stacked batch."""
    import clover_tpu_torch.ops.axpy as ops_axpy
    calls = []

    def kernel(uc, us, vc, vs, alpha, b, seed, noise):
        calls.append((uc.shape, us.shape, b, seed, noise))
        return axpy_plain(uc, us, vc, vs, alpha, b, seed, noise)

    monkeypatch.setattr(ops_axpy, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ops_axpy, "axpy_cuda", kernel)
    x = tt.stack_vectors([tt.quantize(torch.linspace(-1, j, 256), bits)
                          for j in range(4)])
    got = tt.scale_and_add(x, x, -0.5, 3)
    width = 4 * 256 * bits // 8
    assert calls == [((width,), (16,), bits, 3, True)]
    assert got.codes.shape == x.codes.shape


def test_scale_and_add_refuses_mismatches():
    u4 = tt.quantize(torch.ones(256), 4)
    with pytest.raises(TypeError):
        tt.scale_and_add(u4, tt.quantize(torch.ones(256), 8), 1.0)
    with pytest.raises(ValueError):
        tt.scale_and_add(u4, tt.quantize(torch.ones(384), 4), 1.0)


@pytest.mark.parametrize("bits", [16, 32])
def test_fp_scale_and_add_copies_nothing_from_the_host(rng, monkeypatch,
                                                       bits):
    """alpha is filled on the tensors' device: a host copy of it
    (torch.tensor) would synchronize the card's stream on every call."""
    ju, jv = _pair(rng, 1000, bits)
    want = ct.scale_and_add(ju, jv, -0.37)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.tensor called: a host-to-device copy")
    monkeypatch.setattr(torch, "tensor", refuse)
    got = tt.scale_and_add(to_torch(ju), to_torch(jv), -0.37)
    np.testing.assert_array_equal(
        got.values.numpy(), np.asarray(want.values).view(
            got.values.numpy().dtype))
