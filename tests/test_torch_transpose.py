"""clover_tpu_torch transpose (the 4- and 8-bit kernels' plain versions)
against clover_tpu: bit-identical."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.kernels.transpose import (transpose_pallas,
                                          transpose_pallas_eligible)
from clover_tpu_torch.kernels import transpose4_plain, transpose8_plain
from torch_helpers import (assert_same, byte_perm, element_codes, to_jax,
                           to_torch)

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


TRANSPOSE_CU = (Path(tt.__file__).resolve().parent / "csrc" /
                "transpose.cu").read_text()
# the assignments of transpose4x4 in csrc/transpose.cu, in order:
# (target, x, y, selector) of target = __byte_perm(x, y, selector)
BYTE_PERMS = re.findall(
    r"(\w+(?:\[\d\])?) = __byte_perm\((\w+(?:\[\d\])?), (\w+(?:\[\d\])?), "
    r"(0x[0-9A-Fa-f]+)\);", TRANSPOSE_CU)


def _transpose4x4(r):
    env = {f"r[{i}]": r[i] for i in range(4)}
    for target, x, y, sel in BYTE_PERMS:
        env[target] = byte_perm(env[x], env[y], int(sel, 16))
    return [env[f"c[{e}]"] for e in range(4)]


def _transpose4_model(codes: np.ndarray) -> np.ndarray:
    """csrc/transpose.cu transpose4_kernel in NumPy, a lane at a time over
    every tile at once: tile row ti, tile column tj and word column k of a
    tile (bytes 4k..4k+3 of its rows 0-31, P, and 32-63, Q), the word
    reads, the 4x4 byte transposes by the source's __byte_perm selectors,
    the nibble merge by word masks, and the 16-byte stores at output rows
    64 tj + 4k + e and + 32, bytes 32 ti + 16 half ..."""
    m, wa = codes.shape
    n = 2 * wa
    words = codes.view(np.uint8).reshape(m // 64, 64, n // 64, 8, 4) \
        .astype(np.uint64)
    # words[ti, row, tj, k]: bytes 4k..4k+3 of the tile row, little-endian
    words = sum(words[..., i] << (8 * i) for i in range(4))
    out = np.zeros((n // 64, 64, m // 64, 32), np.uint8)
    for half in range(2):
        for g in range(4):
            j0 = half * 16 + g * 4
            tp = _transpose4x4([words[:, j0 + i] for i in range(4)])
            tq = _transpose4x4([words[:, 32 + j0 + i] for i in range(4)])
            for e in range(4):
                lo = (tp[e] & 0x0F0F0F0F) | \
                    (((tq[e] << 4) ^ 0x80808080) & 0xF0F0F0F0)
                hi = (((tp[e] >> 4) & 0x0F0F0F0F) ^ 0x08080808) | \
                    (tq[e] & 0xF0F0F0F0)
                for i in range(4):     # byte i of word g: J = j0 + i
                    # lo, hi: [ti, tj, k]; out[tj, c, ti, J] indexed by (k, tj, ti)
                    out[:, 4 * np.arange(8) + e, :, j0 + i] = (
                        (lo >> (8 * i)) & 0xFF).transpose(2, 1, 0)
                    out[:, 32 + 4 * np.arange(8) + e, :, j0 + i] = (
                        (hi >> (8 * i)) & 0xFF).transpose(2, 1, 0)
    return out.reshape(n, m // 2).view(np.int8)


@pytest.mark.parametrize("shape", [(128, 384), (384, 640), (320, 1152)])
def test_transpose4_kernel_model_matches_plain(rng, shape):
    """The kernel's word arithmetic, modelled from its source, gives the
    plain version's bytes (uniform data, and codes +-7 and 0 in both
    nibble positions)."""
    assert len(BYTE_PERMS) == 8
    a = rng.random(shape, dtype=np.float32) * 2 - 1
    a[:64, :64] = np.where(a[:64, :64] > 0, 1.0, -1.0)     # codes +-7
    a[64:128, :64] = 0.0                                   # codes 0
    codes = tt.quantize(torch.from_numpy(a), 4).codes
    want = transpose4_plain(codes).numpy()
    np.testing.assert_array_equal(_transpose4_model(codes.numpy()), want)
