"""clover_tpu_torch vector restore (the restore kernel's plain version)
against clover_tpu, and the CUDA routes of the ops.

Restore is bit-identical to clover_tpu's XLA path and to its Pallas
restore kernel in interpret mode: the multiplier s/qmax is divided first
(IEEE), then one product per element.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.kernels.restore import (restore_vec_pallas,
                                        restore_vec_pallas_eligible)
from clover_tpu_torch.kernels import restore_vec_plain
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
    standalone AXPY included; matrix restore raises, naming ROADMAP
    queue 2."""
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
             lambda: tt.scale_and_add(v, v, 0.5)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(NotImplementedError, match="queue 2"):
        tt.restore_mat(A)
