"""The f32-output modes of the MVM and batched-MVM kernels (their plain
versions, modes 4x4, 4x8 and 8x8) against clover_tpu's mvm_pallas_f32 and
mvm_batched_pallas_f32 in interpret mode and its ops.mvm_f32.

Tolerances: on the integer problem (codes in range, scale = qmax, so every
term is an exact integer and every sum below 2^24) the outputs are equal
bit for bit; on random data the f32 sums over blocks run in another order
(the port's is its CUDA kernel's lane order), so each output is within
1e-6 of its row's absolute sum of block terms.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.kernels.mvm import mvm_pallas_eligible, mvm_pallas_f32
from clover_tpu.kernels.mvm_batched import mvm_batched_pallas_f32
from clover_tpu.ops.gemm import mvm_batched_f32_fast as jax_batched_f32_fast
from clover_tpu.ops.mvm import mvm_f32 as jax_mvm_f32
from clover_tpu_torch.kernels import (
    mvm4_cuda, mvm_batched_f32_cuda, mvm_batched_f32_plain, mvm_f32_cuda,
    mvm_f32_plain,
)
from clover_tpu_torch.kernels.mvm import blocked_products
from clover_tpu_torch.ops.gemm import mvm_batched_f32_fast
from clover_tpu_torch.ops.mvm import mvm_f32_fast
from torch_helpers import to_jax, to_torch, warp_order_sums
from torch_parallel_worker import int_matrix, int_vector

MODES = [(4, 4), (4, 8), (8, 8)]
SIZES = [(256, 512), (200, 300)]
BATCHES = [1, 2, 3, 8, 33]
RTOL_TERMS = 1e-6


def _random(rng, m, n, bits_a, bits_x, b=None):
    A = ct.quantize(jnp.asarray(rng.random((m, n), dtype=np.float32) * 2 - 1),
                    bits_a)
    draws = [ct.quantize(jnp.asarray(rng.random(n, dtype=np.float32) * 2 - 1),
                         bits_x) for _ in range(b or 1)]
    return A, draws


def _integer(rng, m, n, bits_a, bits_x, b=None):
    qa, qx = (7 if bits_a == 4 else 127), (7 if bits_x == 4 else 127)
    A = int_matrix(rng.integers(-qa, qa + 1, (m, n)).astype(np.int8), bits_a)
    xs = [int_vector(rng.integers(-qx, qx + 1, n).astype(np.int8), bits_x)
          for _ in range(b or 1)]
    return to_jax(A), [to_jax(x) for x in xs]


def _row_abs_sums(A, x) -> np.ndarray:
    return blocked_products(A.codes, A.scales, x.codes, x.scales, A.bits,
                            x.bits).abs().sum(dim=1).numpy()


def _close(got, want, A, x):
    """Within RTOL_TERMS of each row's absolute sum of block terms."""
    gap = np.abs(got.numpy() - np.asarray(want))
    assert (gap <= RTOL_TERMS * _row_abs_sums(A, x)).all(), gap.max()


@pytest.mark.parametrize("bits_a,bits_x", MODES)
@pytest.mark.parametrize("m,n", SIZES)
def test_mvm_f32_plain_matches_jax(rng, bits_a, bits_x, m, n):
    jA, (jx,) = _random(rng, m, n, bits_a, bits_x)
    assert mvm_pallas_eligible(jA, jx)
    A, x = to_torch(jA), to_torch(jx)
    got = mvm_f32_fast(A, x)
    assert got.dtype == torch.float32 and got.shape == (A.rows_pad,)
    assert torch.equal(got, mvm_f32_plain(bits_a, bits_x, A.codes, A.scales,
                                          x.codes, x.scales))
    _close(got, mvm_pallas_f32(jA, jx), A, x)
    _close(got, jax_mvm_f32(jA, jx), A, x)


@pytest.mark.parametrize("bits_a,bits_x", MODES)
def test_mvm_f32_exact_on_integers(rng, bits_a, bits_x):
    jA, (jx,) = _integer(rng, 256, 512, bits_a, bits_x)
    got = mvm_f32_fast(to_torch(jA), to_torch(jx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(mvm_pallas_f32(jA, jx)))
    np.testing.assert_array_equal(got, np.asarray(jax_mvm_f32(jA, jx)))


@pytest.mark.parametrize("bits_a,bits_x", MODES)
@pytest.mark.parametrize("b", BATCHES)
def test_mvm_batched_f32_plain_matches_jax(rng, monkeypatch, bits_a, bits_x,
                                           b):
    """Against clover_tpu's mvm_batched_f32_fast with its kernels on (the
    interpret-mode batched kernel for 2 <= B <= 32, ops.mvm_batched_f32
    beyond), on random and on integer data."""
    monkeypatch.setenv("CLOVER_PALLAS", "1")
    for make, exact in ((_random, False), (_integer, True)):
        jA, jxs = make(rng, 256, 384, bits_a, bits_x, b)
        jstack = ct.formats.QVec4 if bits_x == 4 else ct.formats.QVec8
        jstack = jstack(codes=jnp.stack([x.codes for x in jxs]),
                        scales=jnp.stack([x.scales for x in jxs]),
                        length=jxs[0].length)
        A = to_torch(jA)
        xs = tt.stack_vectors([to_torch(x) for x in jxs])
        got = mvm_batched_f32_fast(A, xs)
        assert got.shape == (b, A.rows_pad)
        assert torch.equal(got, mvm_batched_f32_plain(
            bits_a, bits_x, A.codes, A.scales, xs.codes, xs.scales))
        want = np.asarray(jax_batched_f32_fast(jA, jstack))
        if 2 <= b <= 32:
            np.testing.assert_array_equal(
                want, np.asarray(mvm_batched_pallas_f32(jA, jstack)))
        for j in range(b):
            if exact:
                np.testing.assert_array_equal(got[j].numpy(), want[j])
            else:
                _close(got[j], want[j], A, tt.vector_at(xs, j))


def test_f32_fast_routes_other_combinations(rng):
    """An int matrix times an f32 vector, and fp matrices, take mvm_f32."""
    jA, (jx,) = _random(rng, 128, 256, 4, 4)
    A = to_torch(jA)
    x32 = tt.quantize(torch.from_numpy(rng.random(256, dtype=np.float32)), 32)
    assert torch.equal(mvm_f32_fast(A, x32), tt.mvm_f32(A, x32))
    A16 = tt.quantize(torch.from_numpy(rng.random((128, 256),
                                                  dtype=np.float32)), 16)
    x16 = tt.quantize(x32.values, 16)
    assert torch.equal(mvm_f32_fast(A16, x16), tt.mvm_f32(A16, x16))
    xs = tt.stack_vectors([x16, x16])
    assert torch.equal(mvm_batched_f32_fast(A16, xs),
                       tt.mvm_batched_f32(A16, xs))


def test_f32_kernels_take_64_block_sides():
    """The f32 modes take sides that are multiples of 64 (a shard's, or an
    overlapped psum's column chunk): a 64x192 operand set passes their
    checks and stops only at the device check, where the requantizing MVM
    refuses it for its 128 padding."""
    a = torch.zeros(64, 96, dtype=torch.int8)
    s = torch.ones(1, 3)
    x, xs = torch.zeros(96, dtype=torch.int8), torch.ones(3)
    with pytest.raises(ValueError, match="CUDA"):
        mvm_f32_cuda(4, 4, a, s, x, xs)
    with pytest.raises(ValueError, match="CUDA"):
        mvm_batched_f32_cuda(4, 4, a, s, x[None], xs[None])
    with pytest.raises(ValueError, match="padded to 128"):
        mvm4_cuda(a, s, x, xs)
    with pytest.raises(ValueError, match="padded to 64"):
        mvm_f32_cuda(4, 4, torch.zeros(64, 80, dtype=torch.int8),
                     torch.ones(1, 3), x, xs)
    with pytest.raises(ValueError, match="modes"):
        mvm_f32_cuda(8, 4, a, s, x, xs)


# The f32 mode's edge shapes for csrc/mvm.cu's geometry (rows, cols), sides
# multiples of 64 as a shard's: one band with a partial last chunk (576
# columns: 9 blocks), and 5 bands with rows of 16448 columns (>= 16 chunks
# per lane group, a partial chunk).
F32_EDGES = [(64, 576), (320, 16448)]


def _cut(q, rows: int, cols: int):
    """(codes, scales) of a 4/8-bit container cut to rows x cols (a block
    whose sides are multiples of 64, as chip_smoke.py f32_operands)."""
    if q.codes.dim() == 2:
        return (q.codes[:rows, :cols * q.bits // 8].contiguous(),
                q.scales[:rows // 64, :cols // 64].contiguous())
    return (q.codes[:cols * q.bits // 8].contiguous(),
            q.scales[:cols // 64].contiguous())


@pytest.mark.parametrize("bits_a,bits_x", MODES)
@pytest.mark.parametrize("m,n", F32_EDGES)
def test_mvm_f32_edge_shapes(rng, bits_a, bits_x, m, n):
    """On the cut block, the plain f32 mode equals clover_tpu's ops.mvm_f32
    of the padded operands bit for bit on the integer problem and within
    RTOL_TERMS on random data, and its row sums are bit for bit a scalar
    emulation of the kernel's warp order."""
    from clover_tpu_torch.kernels.mvm import blocked_sum, groups
    for make, exact in ((_integer, True), (_random, False)):
        jA, (jx,) = make(rng, m, n, bits_a, bits_x)
        A, x = to_torch(jA), to_torch(jx)
        ac, asc = _cut(A, m, n)
        xc, xsc = _cut(x, m, n)
        got = mvm_f32_plain(bits_a, bits_x, ac, asc, xc, xsc)
        assert got.shape == (m,)
        want = np.asarray(jax_mvm_f32(jA, jx))[:m]
        if exact:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            gap = np.abs(got.numpy() - want)
            terms = blocked_products(ac, asc, xc, xsc, bits_a, bits_x)
            assert (gap <= RTOL_TERMS * terms.abs().sum(1).numpy()).all()
        prods = blocked_products(ac, asc, xc, xsc, bits_a, bits_x)
        G = groups(bits_a)
        assert prods.shape == (m, n // 64) and prods.shape[1] % G != 0
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32),
            warp_order_sums(prods, G).view(np.uint32))
        np.testing.assert_array_equal(
            blocked_sum(prods, G).numpy().view(np.uint32),
            got.numpy().view(np.uint32))
