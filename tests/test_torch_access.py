"""clover_tpu_torch element access, random data and the sparse-vector MVM
against clover_tpu.

Element reads, gathers, code writes and the random generators are bit for
bit clover_tpu's (the same codes, the same IEEE s/qmax, the same xorshift
stream).  mvm_sparse sums K products in another order than clover_tpu's
XLA dot and than the dense MVM's blocked sums, so its requantized output
is held within one LSB and scales within rtol 1e-5 (torch_helpers
assert_within_lsb, the MVM contract).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.ops import access as ct_access
from clover_tpu.ops.sparse import mvm_sparse as ct_mvm_sparse
from torch_helpers import assert_same, assert_within_lsb, to_jax, to_torch

INDICES = [0, 1, 31, 32, 33, 63, 64, 95, 96, 127, 150, 299]


def _vec(rng, bits, n=300):
    return ct.quantize(jnp.asarray(rng.random(n, dtype=np.float32) * 2 - 1),
                       bits)


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_vec_get_matches_jax(rng, bits):
    jq = _vec(rng, bits)
    q = to_torch(jq)
    for i in INDICES:
        if bits in (4, 8):
            assert tt.vec_get_code(q, i) == ct_access.vec_get_code(jq, i)
        assert tt.vec_get(q, i) == ct_access.vec_get(jq, i), i


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_vec_gather_matches_jax(rng, bits):
    jq = _vec(rng, bits)
    idx = np.array(INDICES + [5, 5, 200], np.int64)
    got = tt.vec_gather(to_torch(jq), torch.from_numpy(idx)).numpy()
    want = np.asarray(ct_access.vec_gather(jq, jnp.asarray(idx)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("bits", [4, 8])
def test_vec_set_code_matches_jax(rng, bits):
    jq = _vec(rng, bits)
    q = to_torch(jq)
    before = q.codes.clone()
    for i, code in ((0, -7), (31, 7), (32, -3), (63, 0), (100, -1),
                    (299, 5)):
        q = tt.vec_set_code(q, i, code)
        jq = ct_access.vec_set_code(jq, i, code)
        assert_same(q, jq)
        assert tt.vec_get_code(q, i) == code
    assert not torch.equal(before, q.codes)     # a new container each time


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_mat_get_matches_jax(rng, bits):
    a = rng.random((200, 300), dtype=np.float32) * 2 - 1
    jq = ct.quantize(jnp.asarray(a), bits)
    q = to_torch(jq)
    for i, j in ((0, 0), (5, 31), (63, 32), (64, 64), (127, 299),
                 (199, 150)):
        assert tt.mat_get(q, i, j) == ct_access.mat_get(jq, i, j), (i, j)


def test_random_generators_match_jax():
    for n in (1, 8, 100, 1001):
        got = tt.random_floats(5, 7, n, device="cpu").numpy()
        want = np.asarray(ct_access.random_floats(5, 7, n))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        assert np.all((got >= 0) & (got < 1))
    got = tt.random_integers(5, 7, 1000, 7, device="cpu").numpy()
    want = np.asarray(ct_access.random_integers(5, 7, 1000, 7))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= -7 and got.max() <= 7 and np.all(got == np.round(got))


@pytest.mark.parametrize("bits_a,bits_x", [(4, 4), (4, 8), (8, 8),
                                           (32, 32)])
@pytest.mark.parametrize("m,n,k", [(256, 512, 16), (200, 300, 40)])
def test_mvm_sparse_matches_jax_and_dense(rng, bits_a, bits_x, m, n, k):
    a = rng.random((m, n), dtype=np.float32) * 2 - 1
    jA = ct.quantize(jnp.asarray(a), bits_a)
    jx = ct.threshold(
        ct.quantize(jnp.asarray(rng.random(n, dtype=np.float32) * 2 - 1),
                    bits_x), k)
    A, x = to_torch(jA), to_torch(jx)
    AT = tt.transpose(A)
    got = tt.mvm_sparse(AT, x, k)
    want = ct_mvm_sparse(to_jax(AT), jx, k)
    dense = tt.mvm(A, x)
    if bits_x == 32:
        np.testing.assert_allclose(got.values.numpy(),
                                   np.asarray(want.values),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.values.numpy(), dense.values.numpy(),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert_within_lsb(got, want)
        assert_within_lsb(got, dense)
