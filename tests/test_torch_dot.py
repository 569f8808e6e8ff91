"""clover_tpu_torch dot (the dot kernel's plain version) against clover_tpu
and golden.py.

Tolerances: against clover_tpu's dot (its XLA path, and its Pallas kernel
in interpret mode), 1e-5 of the sum of |terms|: the per-block terms agree
bit for bit (exact integer block sums, the same two IEEE divides and two
products), and only the order of the f32 sum over blocks differs.  Against
golden.py, the reference's reordered-accumulation tolerance
0.02 * max(1, |ref| / 10) (tests/test_kernels.py).
"""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu import golden
from clover_tpu.kernels.dot import dot_pallas, dot_pallas_eligible
from clover_tpu_torch import golden as port_golden
from clover_tpu_torch.kernels import dot_cuda, dot_plain, dot_terms
from torch_helpers import element_codes, to_torch

SIZES = [128, 200, 1000, 4096, 65536]


def _pair(rng, n, bits):
    u = rng.random(n, dtype=np.float32) * 2 - 1
    v = rng.random(n, dtype=np.float32) * 2 - 1
    return [ct.quantize(jnp.asarray(w), bits) for w in (u, v)]


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("n", SIZES)
def test_dot_matches_jax(rng, bits, n):
    ju, jv = _pair(rng, n, bits)
    u, v = to_torch(ju), to_torch(jv)
    got = tt.dot(u, v)
    assert got.shape == () and got.dtype == torch.float32
    if bits in (4, 8):
        terms = dot_terms(u.codes, u.scales, v.codes, v.scales, bits)
        tol = 1e-5 * float(terms.abs().sum())
    else:
        tol = 1e-5 * float((u.values.float() * v.values.float()).abs().sum())
    assert abs(float(got) - float(ct.ops.dot(ju, jv))) <= tol
    if bits in (4, 8) and n <= 4096 and dot_pallas_eligible(ju, jv):
        assert abs(float(got) - float(dot_pallas(ju, jv))) <= tol


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", SIZES)
def test_dot_matches_golden(rng, bits, n):
    ju, jv = _pair(rng, n, bits)
    u, v = to_torch(ju), to_torch(jv)
    got = float(tt.dot(u, v))
    ref = float(golden.dot(element_codes(ju), np.asarray(ju.scales),
                           element_codes(jv), np.asarray(jv.scales), bits))
    assert abs(got - ref) <= 0.02 * max(1.0, abs(ref) / 10), (got, ref)
    # the port's own oracle copy gives the same reference
    assert float(port_golden.dot(element_codes(ju), np.asarray(ju.scales),
                                 element_codes(jv), np.asarray(jv.scales),
                                 bits)) == ref


def test_dot_terms_op_order(rng):
    """t_b = ((su/q) * (sv/q)) * acc_b, each quotient rounded first: bit for
    bit the NumPy f32 expression of golden.py."""
    ju, jv = _pair(rng, 4096, 8)
    u, v = to_torch(ju), to_torch(jv)
    su, sv = np.asarray(ju.scales), np.asarray(jv.scales)
    acc = (element_codes(ju).astype(np.int64).reshape(-1, 64)
           * element_codes(jv).astype(np.int64).reshape(-1, 64)).sum(axis=1)
    want = (su / np.float32(127.0)) * (sv / np.float32(127.0)) \
        * acc.astype(np.float32)
    got = dot_terms(u.codes, u.scales, v.codes, v.scales, 8).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert float(dot_plain(u.codes, u.scales, v.codes, v.scales, 8)) == \
        float(dot_terms(u.codes, u.scales, v.codes, v.scales, 8).sum())


@pytest.mark.parametrize("bits", [4, 8])
def test_dot_reaches_its_kernel(monkeypatch, bits):
    """CUDA operands go to dot_cuda (a counting stand-in here); the real
    wrapper refuses CPU tensors before it builds anything; mismatched
    precisions or lengths raise."""
    ops_dot = sys.modules["clover_tpu_torch.ops.dot"]
    u = tt.quantize(torch.linspace(-1, 1, 300), bits)
    calls = []

    def kernel(*args):
        calls.append(args[-1])
        return dot_plain(*args)

    with pytest.raises(ValueError, match="CUDA"):
        dot_cuda(u.codes, u.scales, u.codes, u.scales, bits)
    monkeypatch.setattr(ops_dot, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ops_dot, "dot_cuda", kernel)
    assert float(tt.dot(u, u)) == float(dot_plain(u.codes, u.scales, u.codes,
                                                  u.scales, bits))
    assert calls == [bits]
    with pytest.raises(ValueError, match="precision"):
        tt.dot(u, tt.quantize(torch.linspace(-1, 1, 300), 12 - bits))
    with pytest.raises(ValueError, match="precision"):
        tt.dot(u, tt.quantize(torch.linspace(-1, 1, 600), bits))
