"""clover_tpu_torch transpose (the 4- and 8-bit kernels' plain versions)
against clover_tpu: bit-identical."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.kernels.transpose import (transpose_pallas,
                                          transpose_pallas_eligible)
from clover_tpu_torch.kernels import transpose4_plain, transpose8_plain
from torch_helpers import assert_same, element_codes, to_jax, to_torch

SHAPES = [(128, 128), (200, 300), (256, 384), (512, 1024), (1024, 512)]


@pytest.mark.parametrize("shape", SHAPES)
def test_transpose4_matches_jax(rng, shape):
    a = rng.random(shape, dtype=np.float32) * 2 - 1
    jq = ct.quantize(jnp.asarray(a), 4)
    got = tt.transpose(to_torch(jq))
    assert_same(got, ct.transpose(jq))
    if transpose_pallas_eligible(jq):
        assert_same(got, transpose_pallas(jq))
    # element (i, j) of T(A) is element (j, i) of A, scales included
    np.testing.assert_array_equal(element_codes(got),
                                  element_codes(jq).T)
    assert_same(tt.transpose(got), jq)


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_transpose_other_precisions_match_jax(rng, bits):
    a = rng.random((200, 300), dtype=np.float32) * 2 - 1
    jq = ct.quantize(jnp.asarray(a), bits)
    assert_same(tt.transpose(to_torch(jq)), ct.transpose(jq))


def test_transpose4_plain_on_raw_codes(rng):
    codes = torch.from_numpy(rng.integers(-128, 128, (256, 192))
                             .astype(np.int8))
    t = transpose4_plain(codes)
    assert t.shape == (384, 128) and t.dtype == torch.int8
    np.testing.assert_array_equal(
        tt.unpack_nibbles(t).numpy(), tt.unpack_nibbles(codes).numpy().T)


@pytest.mark.parametrize("shape", SHAPES)
def test_transpose8_matches_jax(rng, shape):
    """8-bit: the byte transpose is the result, bit-identical to
    clover_tpu's XLA path and its Pallas kernel in interpret mode, with
    deterministic and SR-quantized codes."""
    a = rng.random(shape, dtype=np.float32) * 2 - 1
    for tq in (to_torch(ct.quantize(jnp.asarray(a), 8)),
               tt.quantize(torch.from_numpy(a), 8, generator=sum(shape))):
        jq = to_jax(tq)
        got = tt.transpose(tq)
        assert isinstance(got, tt.QMat8)
        assert_same(got, ct.transpose(jq))
        if transpose_pallas_eligible(jq):
            assert_same(got, transpose_pallas(jq))
        np.testing.assert_array_equal(element_codes(got),
                                      element_codes(jq).T)
        assert_same(tt.transpose(got), jq)


def test_transpose8_plain_on_raw_codes(rng):
    codes = torch.from_numpy(rng.integers(-128, 128, (256, 384))
                             .astype(np.int8))
    t = transpose8_plain(codes)
    assert t.shape == (384, 256) and t.dtype == torch.int8
    assert t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), codes.numpy().T)
