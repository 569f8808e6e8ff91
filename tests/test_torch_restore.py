"""clover_tpu_torch vector and matrix restore (the restore kernels' plain
versions) against clover_tpu, and the CUDA routes of the ops.

Restore is bit-identical to clover_tpu's XLA path and to its Pallas
restore kernels in interpret mode: the multiplier s/qmax is divided first
(IEEE), then one product per element.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.kernels.restore import (restore_mat_pallas,
                                        restore_mat_pallas_eligible,
                                        restore_vec_pallas,
                                        restore_vec_pallas_eligible)
from clover_tpu_torch.kernels import restore_mat_plain, restore_vec_plain
from torch_helpers import assert_same, to_jax, to_torch


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [300, 512, 4000, 16384])
def test_restore_vec_matches_jax(rng, bits, n):
    x = rng.random(n, dtype=np.float32) * 2 - 1
    x[: n // 7] = 0.0                              # a zero block -> scale 1.0
    jq = ct.quantize(jnp.asarray(x), bits)
    sr = tt.quantize(torch.from_numpy(x), bits,
                     generator=torch.Generator().manual_seed(n))
    for q in (to_torch(jq), sr):
        jq = to_jax(q)
        got = tt.restore_vec(q)
        assert isinstance(got, tt.QVec32) and got.length == n
        assert_same(got, ct.restore(jq))           # XLA
        if restore_vec_pallas_eligible(jq):        # Pallas, interpret mode
            assert_same(got, restore_vec_pallas(jq))
        np.testing.assert_array_equal(
            restore_vec_plain(q.codes, q.scales, bits).numpy().view(np.uint32),
            got.values.numpy().view(np.uint32))
    assert restore_vec_pallas_eligible(jq) == (ct.pad_to(n) % 512 == 0)


def test_restore_vec_plain_op_order(rng):
    """code * (s/qmax) with the quotient rounded first, which differs from
    (code * s) / qmax for some scales."""
    s = torch.from_numpy(rng.random(1024, dtype=np.float32) + 0.5)
    codes = torch.from_numpy(rng.integers(-127, 128, 1024 * 64)
                             .astype(np.int8))
    got = restore_vec_plain(codes, s, 8).numpy()
    c = codes.numpy().astype(np.float32)
    s64 = np.repeat(s.numpy(), 64)
    np.testing.assert_array_equal(got, c * (s64 / np.float32(127.0)))
    assert np.any(got != (c * s64) / np.float32(127.0))


@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_routes_reach_the_kernels(monkeypatch, bits):
    """With operands taken for CUDA ones, each op of the traced solve
    reaches its kernel wrapper (which refuses the CPU tensors), the
    standalone AXPY included, and matrix restore."""
    A = tt.quantize(torch.ones(128, 256), bits)
    x = tt.quantize(torch.ones(256), 8)
    u = tt.quantize(torch.ones(128), 8)
    v = tt.quantize(torch.ones(256), bits)
    for mod in (tt.ops.quantize, tt.ops.mvm, tt.ops.threshold,
                tt.ops.transpose, tt.ops.axpy):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    calls = [lambda: tt.restore_vec(v), lambda: tt.transpose(A),
             lambda: tt.threshold(v, 3), lambda: tt.mvm(A, x),
             lambda: tt.mvm_axpy(A, x, u, -1.0),
             lambda: tt.scale_and_add(v, v, 0.5), lambda: tt.restore_mat(A)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,n", [(256, 512), (128, 1024), (200, 500)])
def test_restore_mat_matches_jax(rng, bits, m, n):
    """restore_mat_plain against clover_tpu's restore_mat (XLA) and its
    Pallas kernel in interpret mode, deterministic and SR codes: bit for
    bit (same op order, IEEE divide)."""
    a = rng.random((m, n), dtype=np.float32) * 2 - 1
    a[:64, :64] = 0.0                              # a zero tile -> scale 1.0
    det = to_torch(ct.quantize(jnp.asarray(a), bits))
    sr = tt.quantize(torch.from_numpy(a), bits,
                     generator=torch.Generator().manual_seed(m + n))
    for q in (det, sr):
        jq = to_jax(q)
        got = tt.restore_mat(q)
        assert isinstance(got, tt.QMat32) and (got.rows, got.cols) == (m, n)
        assert_same(got, ct.restore(jq))
        assert restore_mat_pallas_eligible(jq)
        assert_same(got, restore_mat_pallas(jq))
        np.testing.assert_array_equal(
            restore_mat_plain(q.codes, q.scales, bits).numpy().view(np.uint32),
            got.values.numpy().view(np.uint32))


@pytest.mark.parametrize("bits", [4, 8])
def test_restore_mat_reaches_its_kernel(monkeypatch, bits):
    """A CUDA matrix goes to restore_mat_cuda (here a stand-in that counts
    its calls and returns the plain result) and no longer raises."""
    import clover_tpu_torch.ops.quantize as ops_quantize
    q = tt.quantize(torch.linspace(-1, 1, 200 * 300).reshape(200, 300), bits)
    calls = []

    def kernel(codes, scales, b):
        calls.append(b)
        return restore_mat_plain(codes, scales, b)

    monkeypatch.setattr(ops_quantize, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ops_quantize, "restore_mat_cuda", kernel)
    got = tt.restore_mat(q)
    assert calls == [bits]
    assert torch.equal(got.values, restore_mat_plain(q.codes, q.scales, bits))
    assert tt.restore(q).values.shape == (256, 384) and calls == [bits] * 2
