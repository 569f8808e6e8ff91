"""clover_tpu_torch quantize/restore (the quantize kernel's plain version)
against clover_tpu and its golden oracle.

Deterministic mode is bit-identical to clover_tpu's XLA path, its Pallas
kernels in interpret mode, and golden.py.  Stochastic rounding draws the
port's own Philox stream, so SR is held to statistics: unbiased within 1
LSB on average over generators, exactly reproducible per generator.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu import golden
from clover_tpu.kernels.quantize import quantize_mat_pallas, quantize_vec_pallas
from clover_tpu_torch.kernels import philox
from clover_tpu_torch.ops import _core
from torch_helpers import assert_same, byte_perm, element_codes, to_torch

# Random123 philox4x32-10 known answers: (counter, key) -> output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    words = [torch.tensor([c], dtype=torch.int64) for c in ctr]
    got = philox.philox4x32(*words, *key)
    assert tuple(int(w[0]) for w in got) == want


def test_philox_noise_is_24_bit_and_indexed():
    u = philox.uniform(123, (4, 256), leg=0)
    assert u.dtype == torch.float32 and u.shape == (4, 256)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.all(u * 2 ** 24 == torch.floor(u * 2 ** 24))
    # element i draws counter i whatever the shape: no geometry dependence
    assert torch.equal(u.reshape(-1), philox.uniform(123, (1024,), leg=0))
    assert not torch.equal(u, philox.uniform(123, (4, 256), leg=1))
    assert not torch.equal(u, philox.uniform(124, (4, 256), leg=0))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [128, 300, 1000, 4096])
def test_quantize_vec_matches_jax(rng, bits, n):
    x = rng.random(n, dtype=np.float32) * 2 - 1
    x[: n // 7] = 0.0                              # a zero block -> scale 1.0
    got = tt.quantize(torch.from_numpy(x), bits)
    assert_same(got, ct.quantize(jnp.asarray(x), bits))
    xp = np.pad(x, (0, ct.pad_to(n) - n))
    g_codes, g_scales = golden.quantize_vec(xp, bits, noise=0.0)
    np.testing.assert_array_equal(element_codes(got), g_codes)
    np.testing.assert_array_equal(got.scales.numpy(), g_scales)
    if ct.pad_to(n) % 512 == 0:                    # the Pallas kernel's tiling
        assert_same(got, quantize_vec_pallas(jnp.asarray(xp), n, bits))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(128, 128), (200, 300), (256, 384),
                                   (192, 512)])
def test_quantize_mat_matches_jax(rng, bits, shape):
    a = rng.random(shape, dtype=np.float32) * 2 - 1
    a[:64, :64] = 0.0
    got = tt.quantize(torch.from_numpy(a), bits)
    assert_same(got, ct.quantize(jnp.asarray(a), bits))
    ap = np.asarray(ct.formats.pad_matrix(jnp.asarray(a)))
    assert_same(got, quantize_mat_pallas(jnp.asarray(ap), *shape, bits))


@pytest.mark.parametrize("bits", [16, 32])
def test_quantize_fp_matches_jax(rng, bits):
    x = rng.random(300, dtype=np.float32) * 2 - 1
    a = rng.random((200, 300), dtype=np.float32) * 2 - 1
    assert_same(tt.quantize(torch.from_numpy(x), bits),
                ct.quantize(jnp.asarray(x), bits))
    assert_same(tt.quantize(torch.from_numpy(a), bits),
                ct.quantize(jnp.asarray(a), bits))


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_restore_matches_jax(rng, bits):
    x = rng.random(1000, dtype=np.float32) * 2 - 1
    a = rng.random((200, 300), dtype=np.float32) * 2 - 1
    for arr in (x, a):
        jq = ct.quantize(jnp.asarray(arr), bits)
        got = tt.restore(to_torch(jq))
        assert_same(got, ct.restore(jq))


def test_sr_codes_op_order_and_clamp():
    """mult = qm/s first, then floor(|x|*mult + u); the clamp binds when
    the absmax element plus noise crosses qm + 1."""
    s = torch.tensor([3.0, 3.0, 3.0, 0.1])
    x = torch.tensor([3.0, -3.0, 1.5, -0.05])
    u = torch.tensor([1 - 2 ** -24, 0.99, 0.0, 0.5])
    q = _core.sr_codes(x, s, 4, u)
    assert q.tolist() == [7, -7, 3, -4]
    # torch's scalar/tensor divide is reciprocal * scalar; the port divides
    # tensor by tensor so every quotient is the IEEE one
    s = torch.from_numpy(np.random.default_rng(1).random(1 << 16,
                                                         dtype=np.float32))
    np.testing.assert_array_equal(_core.div(7.0, s).numpy(),
                                  np.float32(7.0) / s.numpy())


def test_div_fills_float_operands_on_the_device(monkeypatch):
    """A float operand of the IEEE divide is filled where the tensor lives,
    never copied from the host: a host-to-device copy of a scalar
    synchronizes a CUDA stream (the large-n threshold must not)."""
    s = torch.from_numpy(np.random.default_rng(2).random(4096,
                                                         dtype=np.float32))
    want = (s.numpy() / np.float32(7.0), np.float32(127.0) / s.numpy())

    def refuse(*args, **kwargs):
        raise AssertionError("a scalar was copied from the host")

    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    np.testing.assert_array_equal(_core.div(s, 7.0).numpy(), want[0])
    np.testing.assert_array_equal(_core.div(127.0, s).numpy(), want[1])


@pytest.mark.parametrize("bits", [4, 8])
def test_sr_unbiased_and_reproducible(rng, bits):
    x = rng.random(2048, dtype=np.float32) * 2 - 1
    xt = torch.from_numpy(x)
    qm = 7.0 if bits == 4 else 127.0
    draws = []
    for s in range(16):
        q = tt.quantize(xt, bits, generator=torch.Generator().manual_seed(s))
        draws.append(tt.restore(q).values.numpy()[:2048])
    scales = tt.quantize(xt, bits).scales.numpy()
    lsb = np.repeat(scales / qm, 64)[:2048]
    err = np.mean(draws, axis=0) - x
    assert np.all(np.abs(err) <= lsb)              # mean within 1 LSB
    assert abs(float(np.mean(err / lsb))) < 0.05   # and centred
    assert np.all(np.abs(draws[0] - x) < lsb * (1 + 1e-6))
    assert any(not np.array_equal(draws[0], d) for d in draws[1:])
    again = tt.quantize(xt, bits, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tt.restore(again).values.numpy()[:2048],
                                  draws[0])
    np.testing.assert_array_equal(tt.restore(tt.quantize(xt, bits, 17))
                                  .values.numpy(),
                                  tt.restore(tt.quantize(xt, bits, 17))
                                  .values.numpy())


def test_sr_noise_follows_element_index(rng):
    """A prefix of a vector quantizes to a prefix of the codes under the
    same seed: the noise of an element depends on its index only."""
    x = torch.from_numpy(rng.random(1024, dtype=np.float32) * 2 - 1)
    full = tt.quantize(x, 4, generator=99)
    head = tt.quantize(x[:512], 4, generator=99)
    assert torch.equal(full.codes[:256], head.codes)
    a = torch.from_numpy(rng.random((128, 256), dtype=np.float32) - 0.5)
    qa = tt.quantize(a, 8, generator=5)
    u = philox.uniform(5, (128, 256), leg=0)
    want = _core.sr_codes(a, qa.scales.repeat_interleave(64, 0)
                          .repeat_interleave(64, 1), 8, u)
    assert torch.equal(qa.codes, want)


def test_quantize_keeps_device_and_container_shape():
    q = tt.quantize(torch.ones(200), 4)
    assert isinstance(q, tt.QVec4) and q.length == 200
    assert q.codes.shape == (128,) and q.scales.shape == (4,)
    assert q.codes.device.type == "cpu"
    m = tt.quantize(np.ones((130, 70), np.float32), 8)
    assert isinstance(m, tt.QMat8) and (m.rows, m.cols) == (130, 70)
    assert m.codes.shape == (256, 128) and m.scales.shape == (4, 2)
    with pytest.raises(ValueError):
        tt.quantize(torch.ones(2, 2, 2), 4)


def _philox_keys(seed: int) -> dict:
    """csrc/quantize.cu philox_keys: the launch constants of one seed."""
    k = philox.M0 * seed
    c3 = k & 0xFFFFFFFF
    return {"k0": [(seed + r * philox.W0) & 0xFFFFFFFF for r in range(10)],
            "c2_xor": (k >> 32) ^ philox.W1, "c3": c3,
            "c2_xor_2": c3 ^ ((2 * philox.W1) & 0xFFFFFFFF)}


_MASK, _SHIFT = np.uint64(0xFFFFFFFF), np.uint64(32)


def _mul(m, x):
    """The 64-bit product of uint32 words m and x, as (high, low) words."""
    p = np.uint64(m) * (np.asarray(x, np.uint64) & _MASK)
    return p >> _SHIFT, p & _MASK


def _philox_word0_32(seed: int, idx: np.ndarray) -> np.ndarray:
    """csrc/quantize.cu philox_word0_32 in NumPy, on uint32 words held in
    uint64: rounds 0-2 folded around the counter (index, 0, 0, 0), the key
    words from the host; round 0's product M0 * index."""
    return _philox_rounds_32(seed, np.uint64(philox.M0) *
                             (np.asarray(idx, np.uint64) & _MASK))


def _philox_rounds_32(seed: int, p: np.ndarray) -> np.ndarray:
    """Rounds 1-9 of philox_word0_32 from round 0's 64-bit product p."""
    key = _philox_keys(seed)
    hi, lo = p >> _SHIFT, p & _MASK                  # round 0
    hi1, lo1 = _mul(philox.M1, hi)                   # round 1
    c0, c1 = hi1 ^ np.uint64(key["k0"][1]), lo1
    c2 = lo ^ np.uint64(key["c2_xor"])
    q0h, q0l = _mul(philox.M0, c0)                   # round 2
    q1h, q1l = _mul(philox.M1, c2)
    c0, c1 = q1h ^ c1 ^ np.uint64(key["k0"][2]), q1l
    c2, c3 = q0h ^ np.uint64(key["c2_xor_2"]), q0l
    for r in range(3, philox.ROUNDS):
        s0h, s0l = _mul(philox.M0, c0)
        s1h, s1l = _mul(philox.M1, c2)
        c0, c1 = s1h ^ c1 ^ np.uint64(key["k0"][r]), s1l
        c2 = s0h ^ c3 ^ np.uint64((r * philox.W1) & 0xFFFFFFFF)
        c3 = s0l
    return c0


@pytest.mark.parametrize("seed", [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])
def test_folded_32_bit_counter_philox_gives_the_same_words(rng, seed):
    """The matrix kernel's 32-bit-counter Philox (counter word 1 zero,
    rounds 0-2 folded around launch constants) gives word 0 of the full
    generator at leg 0, the stream quantize_mat_plain draws."""
    idx = np.concatenate([rng.integers(0, 1 << 32, 4096, dtype=np.uint64),
                          np.array([0, 1, (1 << 32) - 1], np.uint64)])
    t = torch.from_numpy(idx.astype(np.int64))
    zeros = torch.zeros_like(t)
    want = philox.philox4x32(t, zeros, zeros, zeros, seed, 0)[0].numpy()
    np.testing.assert_array_equal(_philox_word0_32(seed, idx),
                                  want.astype(np.uint64))


def test_quantize_mat_kernel_threads_cover_a_tile_and_its_bytes():
    """csrc/quantize.cu's thread map: thread tid of 256 takes rows r, r +
    32 (r = tid / 8) and elements 4k..4k+3, 32+4k..32+4k+3 (k = tid % 8)
    of a 64x64 tile, and writes packed bytes 4k..4k+3 of its two rows,
    whose nibbles are exactly those elements: every element once, every
    code byte once."""
    elems, packed = np.zeros((64, 64), int), np.zeros((64, 32), int)
    for tid in range(256):
        r, k = tid >> 3, tid & 7
        for row in (r, r + 32):
            for j in range(4):
                # packed byte b holds elements b (low) and b + 32 (high)
                elems[row, [4 * k + j, 32 + 4 * k + j]] += 1
                packed[row, 4 * k + j] += 1
    assert (elems == 1).all() and (packed == 1).all()


@pytest.mark.parametrize("qm", [7.0, 127.0])
def test_rounding_with_one_conversion_equals_sr_codes(rng, qm):
    """csrc/quantize.cu sr_code_rd, (int) floor(min(mag, qm)), gives
    sr_code's (int) min(floor(mag), qm) for every mag the kernel forms:
    uniform, around every integer up to qm + 1, qm itself, +inf and NaN
    (0 * inf; fmin, like CUDA's fminf, takes qm from a NaN)."""
    f32 = np.float32
    ints = np.arange(0, qm + 2, dtype=f32)
    mag = np.concatenate([
        rng.random(4096, dtype=f32) * f32(qm + 2), ints,
        np.nextafter(ints, f32(-1)), np.nextafter(ints, f32(np.inf)),
        np.array([0.0, np.inf, np.nan], f32)])
    qm = f32(qm)
    with np.errstate(invalid="ignore"):
        want = np.fmin(np.floor(mag), qm).astype(np.int32)
        got = np.floor(np.fmin(mag, qm)).astype(np.int32)
    np.testing.assert_array_equal(got, want)


QUANTIZE_CU = (Path(tt.__file__).resolve().parent / "csrc" /
               "quantize.cu").read_text()


# the offsets from a thread's row base of the elements the SR path rounds:
# OFF .. OFF + 3 for each sr_quad<WIDE, OFF> of quantize_mat_kernel
SR_OFFSETS = sorted(int(off) + j for off in
                    re.findall(r"sr_quad<WIDE, (\d+)>", QUANTIZE_CU)
                    for j in range(4))
SR_MAGIC = float(re.search(r"constexpr float SR_MAGIC = ([\d.]+)f;",
                           QUANTIZE_CU).group(1))


@pytest.mark.parametrize("seed", [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])
def test_round_0_fold_gives_the_counter_product(rng, seed):
    """csrc/quantize.cu noise_word: round 0's product of element base +
    OFF is the base's product M0 * base (counter_of) plus M0 * OFF, one
    64-bit add, the offset folded into round 0.  Below 2^32, M0 * (base +
    OFF) = M0 * base + M0 * OFF exactly, so for every offset the SR thread
    map adds, at indices 0, 2^31 and 2^32 - 1 - OFF and at uniform ones,
    the product is round 0's and the word is the full generator's word 0
    at leg 0."""
    assert SR_OFFSETS == [0, 1, 2, 3, 32, 33, 34, 35]
    m0 = np.uint64(philox.M0)
    for off in SR_OFFSETS:
        base = np.concatenate([
            np.array([0, 1 << 31, (1 << 32) - 1 - off], np.uint64),
            rng.integers(0, (1 << 32) - off, 512, dtype=np.uint64)])
        folded = m0 * base + np.uint64(philox.M0 * off)
        idx = base + np.uint64(off)
        np.testing.assert_array_equal(folded, m0 * idx)
        t = torch.from_numpy(idx.astype(np.int64))
        zeros = torch.zeros_like(t)
        want = philox.philox4x32(t, zeros, zeros, zeros, seed, 0)[0].numpy()
        np.testing.assert_array_equal(_philox_rounds_32(seed, folded),
                                      want.astype(np.uint64))


@pytest.mark.parametrize("qm", [7.0, 127.0])
def test_noise_is_added_by_one_fused_add(rng, qm):
    """csrc/quantize.cu sr_bits: fmaf(float(w24), 2^-24, t) equals sr_code's
    fl(t + fl(float(w24) * 2^-24)) for all 2^24 noise words w24, t swept
    over [0, qm + 1]: the integers (up to 8, then the powers of two and
    the integers beside them, 63-65 and qm - 1 .. qm + 1) and their float
    neighbours, the least subnormal, uniform draws.  The product is exact,
    so the fused add rounds once, as the plain add does (the fused add is
    taken in float64, exact here, then rounded to float32)."""
    f32 = np.float32
    w = np.arange(1 << 24, dtype=np.uint32)
    u = w.astype(f32) * f32(2.0 ** -24)
    u64 = u.astype(np.float64)
    assert np.array_equal(u64, w.astype(np.float64) * 2.0 ** -24)
    ints = {float(i) for i in range(9)} | {qm - 1, qm, qm + 1, 63.0, 64.0,
                                          65.0}
    ints |= {float(2 ** e + d) for e in range(3, 8) for d in (-1, 0, 1)}
    ints = np.array(sorted(i for i in ints if i <= qm + 1), f32)
    ts = np.unique(np.concatenate([
        ints, np.nextafter(ints, f32(np.inf)),
        np.nextafter(ints[1:], f32(-1)),
        rng.random(16, dtype=f32) * f32(qm + 1)]))
    fused, plain = np.empty_like(u), np.empty_like(u)
    for t in ts:
        np.add(u64, np.float64(t), out=fused, casting="same_kind")
        np.add(u, t, out=plain)
        assert np.array_equal(fused, plain), f"t = {t!r}"


def _fadd_rd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a + b in float32 rounded toward -inf: the float64 sum (exact, or at
    most nudged between the same two float32 neighbours), rounded to
    nearest, then stepped down where that went above."""
    s = a.astype(np.float64) + b.astype(np.float64)
    f = s.astype(np.float32)
    return np.where(f.astype(np.float64) > s,
                    np.nextafter(f, np.float32(-np.inf)), f)


def _sr_bits_tail(x: np.ndarray, mag: np.ndarray, qm, magic: float):
    """csrc/quantize.cu sr_bits after the noise: the bits of
    rd(copysign(magic, x) + fmin(mag, qm))."""
    m = np.fmin(mag, np.float32(qm))
    return _fadd_rd(np.copysign(np.float32(magic), x), m).view(np.uint32)


@pytest.mark.parametrize("bits", [4, 8])
def test_signed_magic_add_leaves_the_code_byte(rng, bits):
    """sr_bits' last add, rd(+-(1.5 * 2^23 + bias) + min(mag, qm)), leaves
    sr_code's min(floor(mag), qm) * sign(x), plus the bias, in the low byte
    of its bits, for mag uniform, around every integer up to qm + 1, 0, the
    least subnormal, +inf and NaN, and x of both signs: bias 8 for a 4-bit
    low nibble, 0 for a high nibble (its low 4 bits) and 8-bit codes."""
    f32 = np.float32
    qm = f32(7 if bits == 4 else 127)
    ints = np.arange(0, qm + 2, dtype=f32)
    mag = np.concatenate([
        rng.random(4096, dtype=f32) * (qm + 2), ints,
        np.nextafter(ints[1:], f32(-1)), np.nextafter(ints, f32(np.inf)),
        np.array([np.inf, np.nan], f32)])
    mag = np.concatenate([mag, mag])
    x = np.concatenate([np.ones(mag.size // 2, f32),
                        -np.ones(mag.size // 2, f32)])
    with np.errstate(invalid="ignore"):
        q = np.fmin(np.floor(mag), qm).astype(np.int64)
    code = np.where(x < 0, -q, q)
    biases = [(SR_MAGIC + 8, 8), (SR_MAGIC, 0)] if bits == 4 else \
        [(SR_MAGIC, 0)]
    for magic, bias in biases:
        got = _sr_bits_tail(x, mag, qm, magic) & 0xFF
        np.testing.assert_array_equal(got, (code + bias) & 0xFF)
    # the magnitudes stay where a float's unit is 1
    assert 2 ** 23 <= SR_MAGIC - 127 and SR_MAGIC + 8 + 127 < 2 ** 24


# low_bytes in csrc/quantize.cu: __byte_perm(__byte_perm(a, b, S1),
# __byte_perm(c, d, S2), S3)
LOW_BYTES = re.search(
    r"return __byte_perm\(__byte_perm\(a, b, (0x[0-9A-Fa-f]+)\), "
    r"__byte_perm\(c, d, (0x[0-9A-Fa-f]+)\),\s*(0x[0-9A-Fa-f]+)\);",
    QUANTIZE_CU).groups()


def _low_bytes(a, b, c, d):
    s1, s2, s3 = (int(v, 16) for v in LOW_BYTES)
    return byte_perm(byte_perm(a, b, s1), byte_perm(c, d, s2), s3)


@pytest.mark.parametrize("bits", [4, 8])
def test_sr_words_hold_the_packed_codes(rng, bits):
    """quantize_mat_kernel's SR stores: thread words from the sr_bits of
    elements 4k..4k+3 (lo) and 32+4k..32+4k+3 (hi) by the source's
    low_bytes byte permutes -- for 4-bit lo | ((hi << 4) & 0xF0F0F0F0),
    for 8-bit lo and hi as two words -- are the bytes pack_nibbles (or
    the int8 codes) gives those codes, for every code a row can hold."""
    assert "((low_bytes(hi[0], hi[1], hi[2], hi[3]) << 4) & 0xF0F0F0F0u)" \
        in QUANTIZE_CU
    qm = 7 if bits == 4 else 127
    codes = rng.integers(-qm, qm + 1, (4096, 64)).astype(np.int8)
    codes[:2 * qm + 1, 0] = np.arange(-qm, qm + 1)
    codes[:2 * qm + 1, 32] = np.arange(qm, -qm - 1, -1)
    f32 = np.float32
    x = np.where(codes < 0, f32(-1), f32(1))
    mag = np.abs(codes).astype(f32) + f32(0.5)    # floor is |code|
    lo_magic = SR_MAGIC + 8 if bits == 4 else SR_MAGIC
    t_lo = _sr_bits_tail(x[:, :32], mag[:, :32], qm, lo_magic).astype(np.uint64)
    t_hi = _sr_bits_tail(x[:, 32:], mag[:, 32:], qm, SR_MAGIC).astype(np.uint64)
    for k in range(8):
        lo = _low_bytes(*(t_lo[:, 4 * k + j] for j in range(4)))
        hi = _low_bytes(*(t_hi[:, 4 * k + j] for j in range(4)))
        words = ([lo | ((hi << 4) & 0xF0F0F0F0)] if bits == 4 else [lo, hi])
        got = np.stack([(w >> (8 * j)) & 0xFF for w in words
                        for j in range(4)], axis=1).astype(np.uint8)
        if bits == 4:
            want = tt.formats.pack_nibbles(torch.from_numpy(codes)).numpy()
            want = want[:, 4 * k:4 * k + 4]
        else:
            want = np.concatenate([codes[:, 4 * k:4 * k + 4],
                                   codes[:, 32 + 4 * k:32 + 4 * k + 4]],
                                  axis=1)
        np.testing.assert_array_equal(got, want.view(np.uint8))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("shape", [(128, 256), (192, 384)])
def test_sr_counters_cover_each_element_once(wide, shape):
    """quantize_mat_kernel's SR counter walk over the thread map: thread
    tid of 256 (r = tid / 8, k = tid % 8) starts rows r and r + 32 of each
    tile at counter_of(row * n_pad + col) and counter_of(...) +
    counter_of(32 n_pad), col = 64 tj + 4k, and adds unit * OFF for each
    sr_quad offset.  Every element of the operand gets unit * its index
    (round 0's product M0 * index on 32-bit counters, the index on 64-bit
    ones), exactly once."""
    m, n = shape
    unit = 1 if wide else philox.M0
    got = np.zeros((m, n), np.uint64)
    hits = np.zeros((m, n), int)
    for ti in range(m // 64):
        for tj in range(n // 64):
            for tid in range(256):
                r, k = tid >> 3, tid & 7
                row, col = ti * 64 + r, tj * 64 + 4 * k
                c0 = unit * (row * n + col)
                for h in range(2):
                    c = c0 + h * unit * 32 * n
                    for off in SR_OFFSETS:
                        got[row + 32 * h, col + off] = c + unit * off
                        hits[row + 32 * h, col + off] += 1
    want = unit * np.arange(m * n, dtype=np.uint64).reshape(m, n)
    assert (hits == 1).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [4, 8])
def test_sr_kernel_model_equals_quantize_mat_plain(rng, bits):
    """quantize_mat_kernel's SR path in NumPy, thread by thread over every
    tile at once, on edge tiles (zero, +-absmax, subnormal) of a 192x256
    operand: the tile max and IEEE qm / s; the counter walk (round 0's
    product of the thread's first element in each of its rows, plus M0 *
    OFF an element); rounds 1-9; the fused noise add; the clamp and signed
    magic add; the byte permutes and the nibble merge.  Its codes and
    scales are quantize_mat_plain's, byte for byte."""
    f32 = np.float32
    m, n = 192, 256
    a = (rng.random((m, n), dtype=f32) * 2 - 1).astype(f32)
    a[:64, :64] = 0.0
    a[:64, 64:128] = np.where(a[:64, 64:128] < 0, f32(-2.5), f32(2.5))
    a[64:128, :128] = np.sign(a[64:128, :128]) * f32(1e-39)
    a[64, 100] = f32(3e-37)
    seed, qm = 0x9E3779B9, f32(7 if bits == 4 else 127)
    tiles = a.reshape(m // 64, 64, n // 64, 64).transpose(0, 2, 1, 3)
    sc = np.abs(tiles).max(axis=(2, 3))
    sc = np.where(sc == 0, f32(1), sc).astype(f32)
    with np.errstate(over="ignore"):          # qm / subnormal s: inf
        mult = (qm / sc).astype(f32)
    out = np.zeros((m, n // 2 if bits == 4 else n), np.uint8)
    ti, tj = np.meshgrid(np.arange(m // 64), np.arange(n // 64),
                         indexing="ij")
    for tid in range(256):
        r, k = tid >> 3, tid & 7
        c0 = np.uint64(philox.M0) * (
            (ti * 64 + r) * n + tj * 64 + 4 * k).astype(np.uint64)
        for h in range(2):
            row = ti * 64 + r + 32 * h
            c = c0 + np.uint64(philox.M0 * 32 * n * h)
            t = {}
            for off in SR_OFFSETS:
                x = a[row, tj * 64 + 4 * k + off]
                w = _philox_rounds_32(seed, c + np.uint64(philox.M0 * off))
                u = (w & np.uint64(0xFFFFFF)).astype(np.float64) * 2.0 ** -24
                mag = (u + (np.abs(x) * mult).astype(np.float64)).astype(f32)
                magic = SR_MAGIC + 8 if bits == 4 and off < 32 else SR_MAGIC
                t[off] = _sr_bits_tail(x, mag, qm, magic).astype(np.uint64)
            lo = _low_bytes(*(t[j] for j in range(4)))
            hi = _low_bytes(*(t[32 + j] for j in range(4)))
            words = ([lo | ((hi << 4) & 0xF0F0F0F0)] if bits == 4
                     else [lo, hi])
            for q, word in enumerate(words):
                col = tj * (32 if bits == 4 else 64) + 4 * k + 32 * q
                for j in range(4):
                    out[row, col + j] = (word >> (8 * j)) & 0xFF
    codes, scales = tt.kernels.quantize_mat_plain(torch.from_numpy(a), bits,
                                                  seed, True)
    np.testing.assert_array_equal(out, codes.numpy().view(np.uint8))
    np.testing.assert_array_equal(sc, scales.numpy())
