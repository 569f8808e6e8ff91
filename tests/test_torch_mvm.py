"""clover_tpu_torch MVM, fused MVM+AXPY and scaleAndAdd (the MVM kernel's
plain versions, modes 4x4, 4x8 and 8x8) against clover_tpu.

Integer block dots are exact in both packages; the f32 sum over blocks
runs in another order (the port mirrors its CUDA kernel's lane order), so
codes may differ by 1 LSB and scales by rtol 1e-5 -- the allowance the
TPU kernels get against XLA in tests/test_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.kernels.mvm import (mvm_axpy_pallas, mvm_pallas,
                                    mvm_pallas_eligible)
from clover_tpu_torch.kernels import mvm4_plain, mvm8_plain
from clover_tpu_torch.kernels.mvm import blocked_products, blocked_sum, groups
from torch_helpers import (assert_same, assert_within_lsb, to_jax, to_torch,
                           warp_order_sums)

SIZES = [(128, 128), (200, 300), (256, 384), (512, 1024), (192, 2048)]


def _problem(rng, m, n, bits_a=4, bits_x=4, bits_u=4):
    A = rng.random((m, n), dtype=np.float32) * 2 - 1
    x = rng.random(n, dtype=np.float32) * 2 - 1
    u = rng.random(m, dtype=np.float32) * 2 - 1
    return (ct.quantize(jnp.asarray(A), bits_a),
            ct.quantize(jnp.asarray(x), bits_x),
            ct.quantize(jnp.asarray(u), bits_u))


@pytest.mark.parametrize("m,n", SIZES)
def test_mvm4_matches_jax(rng, m, n):
    jA, jx, _ = _problem(rng, m, n)
    got = tt.mvm(to_torch(jA), to_torch(jx))
    assert isinstance(got, tt.QVec4) and got.length == m
    assert_within_lsb(got, ct.mvm(jA, jx))
    assert_within_lsb(got, mvm_pallas(jA, jx))


@pytest.mark.parametrize("m,n", SIZES)
@pytest.mark.parametrize("alpha", [-1.0, 0.00513])
def test_mvm_axpy4_matches_jax(rng, m, n, alpha):
    """Each stage within the MVM tolerance.  The intermediate t1 may differ
    by 1 LSB; where it does at a band's absmax, the AXPY's new band scale
    moves by |alpha| s1/7, so the fused outputs are compared where the
    intermediates agree, and the AXPY stage always on the same t1."""
    jA, jx, ju = _problem(rng, m, n)
    A, x, u = to_torch(jA), to_torch(jx), to_torch(ju)
    t1 = tt.mvm(A, x)
    jt1 = ct.mvm(jA, jx)
    assert_within_lsb(t1, jt1)
    got = tt.mvm_axpy(A, x, u, alpha)
    assert_within_lsb(got, ct.scale_and_add(ju, to_jax(t1), alpha))
    same_t1 = np.array_equal(t1.codes.numpy(), np.asarray(jt1.codes))
    if same_t1:
        assert_within_lsb(got, ct.mvm_axpy(jA, jx, ju, alpha))
    if np.array_equal(t1.codes.numpy(), np.asarray(mvm_pallas(jA, jx).codes)):
        assert_within_lsb(got, mvm_axpy_pallas(jA, jx, ju, alpha))
    # at these sizes and seeds most cases agree: the comparison is not vacuous
    if (m, n) in ((128, 128), (256, 384)):
        assert same_t1


@pytest.mark.parametrize("gens", [(None, None), (3, None), (None, 4), (5, 6)])
def test_mvm_axpy_fused_equals_unfused(rng, gens):
    """The fused form is mvm then scaleAndAdd bit for bit, SR included:
    the MVM requant draws Philox leg 0, the AXPY requant leg 1."""
    A, x, u = (to_torch(q) for q in _problem(rng, 256, 512))
    got = tt.mvm_axpy(A, x, u, 0.25, *gens)
    want = tt.scale_and_add(u, tt.mvm(A, x, gens[0]), 0.25, gens[1])
    assert_same(got, want)


def test_blocked_sum_is_the_kernel_lane_order(rng):
    """blocked_sum reproduces, op for op, a scalar emulation of the CUDA
    kernel's warp: lane pair p accumulates blocks p, p+16, ... from 0, then
    the pair sums reduce by xor-shuffles 16, 8, 4, 2 (pairs p^8, p^4, p^2,
    p^1)."""
    for nb in (2, 6, 16, 40, 256):
        t = torch.from_numpy(rng.standard_normal((3, nb)).astype(np.float32))
        f = np.float32
        for row in range(3):
            acc = [f(0.0)] * 16
            for c in range(-(-nb // 16)):
                for p in range(16):
                    b = 16 * c + p
                    acc[p] = f(acc[p] + (t[row, b].item() if b < nb else f(0)))
            for off in (8, 4, 2, 1):
                acc = [f(acc[p] + acc[p ^ off]) for p in range(16)]
            assert blocked_sum(t)[row].numpy().view(np.uint32) == \
                np.float32(acc[0]).view(np.uint32)


def test_mvm_f32_matches_golden(rng):
    jA, jx, _ = _problem(rng, 256, 384)
    A, x = to_torch(jA), to_torch(jx)
    from clover_tpu import golden
    want = golden.mvm_f32_exact(
        np.asarray(ct.formats.unpack_nibbles(jA.codes)), np.asarray(jA.scales),
        np.asarray(ct.formats.unpack_nibbles(jx.codes)), np.asarray(jx.scales),
        4)
    np.testing.assert_allclose(tt.mvm_f32(A, x).numpy(), want, rtol=2e-5,
                               atol=1e-5)
    dots = blocked_products(A.codes, A.scales, x.codes, x.scales)
    assert dots.shape == (256, 6)
    np.testing.assert_allclose(blocked_sum(dots).numpy(), want, rtol=2e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bits_a,bits_x", [(4, 8), (8, 8)])
def test_mvm_mixed_and_8bit_match_jax(rng, bits_a, bits_x):
    jA, jx, ju = _problem(rng, 256, 512, bits_a, bits_x, 8)
    A, x = to_torch(jA), to_torch(jx)
    assert_within_lsb(tt.mvm(A, x), ct.mvm(jA, jx))
    assert_within_lsb(tt.mvm_axpy(A, x, to_torch(ju), -0.5),
                      ct.mvm_axpy(jA, jx, ju, -0.5))


@pytest.mark.parametrize("bits", [16, 32])
def test_mvm_fp_matches_jax(rng, bits):
    jA, jx, _ = _problem(rng, 128, 256, bits, bits, bits)
    got = tt.mvm(to_torch(jA), to_torch(jx))
    want = ct.mvm(jA, jx)
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_allclose(got.values.numpy().astype(np.float32),
                               np.asarray(want.values, np.float32),
                               rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("alpha", [-1.0, 0.37])
def test_scale_and_add_matches_jax(rng, bits, alpha):
    u = ct.quantize(jnp.asarray(rng.random(1000, dtype=np.float32) - 0.5), bits)
    v = ct.quantize(jnp.asarray(rng.random(1000, dtype=np.float32) - 0.5), bits)
    assert_within_lsb(tt.scale_and_add(to_torch(u), to_torch(v), alpha),
                      ct.scale_and_add(u, v, alpha))


def test_mvm_sr_unbiased(rng):
    """SR requant: the mean over 8 generators is within 1 LSB of the exact
    f32 product, and a fixed seed reproduces."""
    A, x, _ = (to_torch(q) for q in _problem(rng, 256, 512))
    y_ref = tt.mvm_f32(A, x).numpy()
    outs = [tt.restore(tt.mvm(A, x, torch.Generator().manual_seed(s)))
            .values.numpy() for s in range(8)]
    lsb = np.repeat(tt.mvm(A, x).scales.numpy(), 64) / 7.0
    assert np.all(np.abs(np.mean(outs, axis=0) - y_ref) <= lsb)
    assert any(not np.array_equal(outs[0], o) for o in outs[1:])
    assert_same(tt.mvm(A, x, 11), tt.mvm(A, x, 11))


def test_mvm4_plain_raw_interface(rng):
    A, x, u = (to_torch(q) for q in _problem(rng, 128, 256))
    codes, scales = mvm4_plain(A.codes, A.scales, x.codes, x.scales)
    assert codes.shape == (64,) and scales.shape == (2,)
    assert_same(tt.QVec4(codes=codes, scales=scales, length=128),
                tt.mvm(A, x))
    with pytest.raises(TypeError):
        tt.scale_and_add(u, tt.quantize(torch.zeros(128), 8), 1.0)


@pytest.mark.parametrize("bits_a", [4, 8])
@pytest.mark.parametrize("m,n", SIZES)
def test_mvm8_matches_jax(rng, bits_a, m, n):
    """4x8 and 8x8 against clover_tpu's XLA path and its Pallas kernel in
    interpret mode, at ragged and 128-multiple sizes."""
    jA, jx, _ = _problem(rng, m, n, bits_a, 8, 8)
    got = tt.mvm(to_torch(jA), to_torch(jx))
    assert isinstance(got, tt.QVec8) and got.length == m
    assert_within_lsb(got, ct.mvm(jA, jx))
    if mvm_pallas_eligible(jA, jx):
        assert_within_lsb(got, mvm_pallas(jA, jx))


@pytest.mark.parametrize("bits_a", [4, 8])
@pytest.mark.parametrize("m,n", SIZES)
@pytest.mark.parametrize("alpha", [-1.0, 0.00513])
def test_mvm_axpy8_matches_jax(rng, bits_a, m, n, alpha):
    """As test_mvm_axpy4_matches_jax, for the 8-bit output modes: the AXPY
    stage on the same intermediate, the fused output where the
    intermediates agree."""
    jA, jx, ju = _problem(rng, m, n, bits_a, 8, 8)
    A, x, u = to_torch(jA), to_torch(jx), to_torch(ju)
    t1 = tt.mvm(A, x)
    jt1 = ct.mvm(jA, jx)
    assert_within_lsb(t1, jt1)
    got = tt.mvm_axpy(A, x, u, alpha)
    assert isinstance(got, tt.QVec8)
    assert_within_lsb(got, ct.scale_and_add(ju, to_jax(t1), alpha))
    same_t1 = np.array_equal(t1.codes.numpy(), np.asarray(jt1.codes))
    if same_t1:
        assert_within_lsb(got, ct.mvm_axpy(jA, jx, ju, alpha))
    if (mvm_pallas_eligible(jA, jx) and np.array_equal(
            t1.codes.numpy(), np.asarray(mvm_pallas(jA, jx).codes))):
        assert_within_lsb(got, mvm_axpy_pallas(jA, jx, ju, alpha))
    # 8-bit codes part at 1 LSB more often than 4-bit ones; these sizes
    # agree, so the fused comparison is not vacuous
    if (m, n) in ((128, 128), (192, 2048)):
        assert same_t1


@pytest.mark.parametrize("bits_a", [4, 8])
@pytest.mark.parametrize("gens", [(None, None), (3, None), (5, 6)])
def test_mvm8_fused_equals_unfused(rng, bits_a, gens):
    A, x, u = (to_torch(q) for q in _problem(rng, 256, 512, bits_a, 8, 8))
    got = tt.mvm_axpy(A, x, u, 0.25, *gens)
    want = tt.scale_and_add(u, tt.mvm(A, x, gens[0]), 0.25, gens[1])
    assert_same(got, want)


@pytest.mark.parametrize("bits_a", [4, 8])
def test_mvm8_plain_sums_in_the_kernel_lane_order(rng, bits_a):
    """mvm8_plain's f32 row sums are a scalar emulation of the CUDA
    kernel's warp for its mode: G = 16 groups (a lane pair per packed
    4-bit block) or 8 (a lane quad per 8-bit block); group g accumulates
    blocks g, g+G, ... from 0, then the groups reduce by xor-shuffles
    (g, g^G/2), ..., (g, g^1).  The band requant of the emulated sums
    gives the plain version's bytes."""
    m, n = 128, 1536                               # nb = 24: a ragged chunk
    A, x, _ = (to_torch(q) for q in _problem(rng, m, n, bits_a, 8, 8))
    G = 16 if bits_a == 4 else 8
    assert groups(bits_a) == G
    prods = blocked_products(A.codes, A.scales, x.codes, x.scales, bits_a, 8)
    f = np.float32
    y = np.zeros(prods.shape[0], np.float32)
    for row in range(prods.shape[0]):
        acc = [f(0.0)] * G
        for c in range(-(-prods.shape[1] // G)):
            for g in range(G):
                b = G * c + g
                if b < prods.shape[1]:
                    acc[g] = f(acc[g] + prods[row, b].item())
        off = G // 2
        while off:
            acc = [f(acc[g] + acc[g ^ off]) for g in range(G)]
            off //= 2
        y[row] = acc[0]
    np.testing.assert_array_equal(
        blocked_sum(prods, G).numpy().view(np.uint32), y.view(np.uint32))
    codes, scales = mvm8_plain(bits_a, A.codes, A.scales, x.codes, x.scales)
    want = tt.quantize(torch.from_numpy(y), 8)
    assert torch.equal(codes, want.codes) and torch.equal(scales, want.scales)


# Shapes csrc/mvm.cu's launch geometry makes edge cases (rows, cols): two
# bands with rows of 16512 columns (>= 16 chunks per lane group, a partial
# last chunk), and 10 bands (a count no cluster of 4 or 8 CTAs divides)
# with a partial chunk.
EDGES = [(128, 16512), (640, 1152)]


@pytest.mark.parametrize("bits_a,bits_x", [(4, 4), (4, 8), (8, 8)])
@pytest.mark.parametrize("m,n", EDGES)
def test_mvm_edge_shapes(rng, bits_a, bits_x, m, n):
    """At the geometry's edge shapes: the MVM and the fused MVM+AXPY within
    1 LSB of clover_tpu, and the row sums bit for bit the kernel's warp
    order (blocked_sum against an emulation of it)."""
    jA, jx, ju = _problem(rng, m, n, bits_a, bits_x,
                          4 if bits_a == bits_x == 4 else 8)
    A, x, u = to_torch(jA), to_torch(jx), to_torch(ju)
    assert_within_lsb(tt.mvm(A, x), ct.mvm(jA, jx))
    t1 = tt.mvm(A, x)
    assert_within_lsb(tt.mvm_axpy(A, x, u, -0.61),
                      ct.scale_and_add(ju, to_jax(t1), -0.61))
    prods = blocked_products(A.codes, A.scales, x.codes, x.scales, bits_a,
                             bits_x)
    G = groups(bits_a)
    assert prods.shape[1] % G != 0            # a partial last chunk
    np.testing.assert_array_equal(
        blocked_sum(prods, G).numpy().view(np.uint32),
        warp_order_sums(prods, G).view(np.uint32))


def test_launch_geometry_covers_every_row_once():
    """Every geometry the kernel launches covers each row of A exactly once
    and its cluster divides the grid, for m_pad from 64 to 524288; the
    rule picks one of them, with a CTA for every SM where it can."""
    from clover_tpu_torch.kernels import mvm as kmvm
    sampled = {*range(64, 8193, 64), *(64 * 5 ** k for k in range(6)),
               *(1 << k for k in range(6, 20))}
    for m_pad in range(64, 524289, 64):
        for rows in kmvm.ROWS_PER_WARP:
            grid, cluster = kmvm.launch_geometry(m_pad, rows)
            per_cta = kmvm.WARPS * rows
            assert grid % cluster == 0 and cluster * per_cta == 64
            assert grid * per_cta == m_pad
            if m_pad in sampled:
                cta, warp, r = np.meshgrid(np.arange(grid),
                                           np.arange(kmvm.WARPS),
                                           np.arange(rows), indexing="ij")
                owned = (cta * per_cta + warp * rows + r).ravel()
                assert np.array_equal(np.sort(owned), np.arange(m_pad))
                band = owned // 64
                assert np.array_equal(band, (cta // cluster).ravel())
        for sms in (1, 132):
            rows = kmvm.rows_per_warp(m_pad, sms)
            assert rows in kmvm.ROWS_PER_WARP
            grid, _ = kmvm.launch_geometry(m_pad, rows)
            assert rows == kmvm.ROWS_PER_WARP[-1] or grid >= sms
    # on the H100 (132 SMs): the geometries kernel_ab.py --rows timed fastest
    assert [kmvm.rows_per_warp(m, 132) for m in
            (2048, 4096, 8192, 16384, 524288)] == [2, 2, 4, 8, 8]


def _bytes_of(words: np.ndarray) -> np.ndarray:
    """uint32 words -> their 4 bytes each, as int8 (little-endian)."""
    return words.astype("<u4").view(np.int8).reshape(*words.shape, 4)


def _unpack_word(w):
    """mvm.cuh unpack_word: (low codes, high codes) as int8 bytes."""
    lo = ((w & 0x0F0F0F0F).astype("<u4").view(np.uint8).astype(np.int16)
          - 8).astype(np.int8).view(np.uint32)
    u = (((w >> 4) & 0x0F0F0F0F) ^ 0x08080808).astype("<u4")
    hi = (u.view(np.uint8).astype(np.int16) - 8).astype(np.int8)
    return _bytes_of(lo), hi.reshape(*w.shape, 4)


def _dp4a(a_bytes, b_bytes, c, a_unsigned=False):
    a = a_bytes.view(np.uint8) if a_unsigned else a_bytes
    return c + (a.astype(np.int64) * b_bytes.astype(np.int64)).sum(-1)


@pytest.mark.parametrize("bits_x", [4, 8])
def test_kernel_block_dot_without_unpacking(rng, bits_x):
    """csrc/mvm.cu's lane dot for 4-bit A -- dp4a.u32.s32 of the masked low
    nibbles, minus 8 times the sum of x, plus a dp4a of the masked high
    nibbles shifted by 4 -- and its x unpacking (low_codes, high_codes)
    give the integers of mvm.cuh's unpack_word path, over every byte pair
    and random words (NumPy on uint32 words, as the kernel computes)."""
    pairs = np.arange(1 << 16, dtype=np.uint32)
    a = rng.integers(0, 1 << 32, (1 << 16, 4), dtype=np.uint32)
    x = rng.integers(0, 1 << 32, (1 << 16, 4), dtype=np.uint32)
    xb = rng.integers(0, 1 << 32, (1 << 16, 4), dtype=np.uint32)
    a[:, 0] = (a[:, 0] & 0xFFFFFF00) | (pairs & 0xFF)
    x[:, 0] = (x[:, 0] & 0xFFFFFF00) | (pairs >> 8)
    low = (((x & 0x0F0F0F0F) + 0x78787878) ^ 0x80808080).astype(np.uint32)
    high = (((((x >> 4) & 0x0F0F0F0F) ^ 0x08080808) + 0x78787878)
            ^ 0x80808080).astype(np.uint32)
    ref_lo, ref_hi = _unpack_word(x)
    if bits_x == 4:
        np.testing.assert_array_equal(_bytes_of(low), ref_lo)
        np.testing.assert_array_equal(_bytes_of(high), ref_hi)
        xl, xh = _bytes_of(low), _bytes_of(high)
    else:
        xl, xh = _bytes_of(x), _bytes_of(xb)
    al, ah = _unpack_word(a)
    want = _dp4a(al, xl, 0).sum(-1) + _dp4a(ah, xh, 0).sum(-1)
    bias = _dp4a(xl, np.full(4, -8, np.int8), 0).sum(-1)
    lo = bias + _dp4a(_bytes_of(a & 0x0F0F0F0F), xl, 0, True).sum(-1)
    hi = _dp4a(_bytes_of(a & 0xF0F0F0F0), xh, 0).sum(-1)
    assert (hi % 16 == 0).all()
    np.testing.assert_array_equal(lo + (hi >> 4), want)
