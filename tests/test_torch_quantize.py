"""clover_tpu_torch quantize/restore (the quantize kernel's plain version)
against clover_tpu and its golden oracle.

Deterministic mode is bit-identical to clover_tpu's XLA path, its Pallas
kernels in interpret mode, and golden.py.  Stochastic rounding draws the
port's own Philox stream, so SR is held to statistics: unbiased within 1
LSB on average over generators, exactly reproducible per generator.
"""

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
from torch_helpers import assert_same, element_codes, to_torch

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


def _philox_word0_32(seed: int, idx: np.ndarray) -> np.ndarray:
    """csrc/quantize.cu philox_word0_32 in NumPy, on uint32 words held in
    uint64: rounds 0-2 folded around the counter (index, 0, 0, 0), the key
    words from the host."""
    key = _philox_keys(seed)
    mask, shift = np.uint64(0xFFFFFFFF), np.uint64(32)

    def mul(m, x):
        p = np.uint64(m) * (np.asarray(x, np.uint64) & mask)
        return p >> shift, p & mask

    hi, lo = mul(philox.M0, idx)                     # round 0
    hi1, lo1 = mul(philox.M1, hi)                    # round 1
    c0, c1 = hi1 ^ np.uint64(key["k0"][1]), lo1
    c2 = lo ^ np.uint64(key["c2_xor"])
    q0h, q0l = mul(philox.M0, c0)                    # round 2
    q1h, q1l = mul(philox.M1, c2)
    c0, c1 = q1h ^ c1 ^ np.uint64(key["k0"][2]), q1l
    c2, c3 = q0h ^ np.uint64(key["c2_xor_2"]), q0l
    for r in range(3, philox.ROUNDS):
        s0h, s0l = mul(philox.M0, c0)
        s1h, s1l = mul(philox.M1, c2)
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
