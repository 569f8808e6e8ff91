"""The arithmetic of the batched MVM kernel (csrc/mvm_batched.cu) in NumPy,
on the words the kernel loads: its int8 tensor-core block dots, its split
of a row's blocks over warps, and the rows, blocks and vectors its launch
covers.  The card holds the kernel itself to its plain version bit for
bit (chip_smoke.py phase 2); these tests hold the kernel's design to the
plain version and to clover_tpu's nibble format on the CPU.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu_torch.kernels import mvm_batched_f32_plain
from clover_tpu_torch.kernels.mvm import groups

SOURCE = (Path(__file__).resolve().parents[1] / "clover_tpu_torch" / "csrc"
          / "mvm_batched.cu").read_text()
MODES = [(4, 4), (4, 8), (8, 8)]
# shapes with a partial last chunk of blocks (n_pad / 64 not a multiple
# of G), one with 10 bands (test_torch_mvm.py's EDGES)
EDGES = [(128, 16512), (640, 1152)]
BATCHES = [1, 5, 8, 9, 31, 32]
MAGIC_BITS, MAGIC = 0x4B400000, np.float32(12582912.0)


def _constant(pattern: str) -> tuple:
    found = re.search(pattern, SOURCE)
    assert found, pattern
    return tuple(int(v) for v in found.groups())


# the kernel's geometry, read from its source: the warps (lane groups) of
# a CTA for 4- and 8-bit A, and the m16 tiles per warp (mb_tiles: 4 for
# 4-bit A up to NT_MT4 n-tiles, else 2)
WARPS = dict(zip((4, 8), _constant(
    r"mb_groups\(\) \{\s*return BA == 4 \? (\d+) : (\d+);")))
(NT_MT4,) = _constant(
    r"mb_tiles\(\) \{\s*return BA == 4 && NT <= (\d) \? 4 : 2;")


def tiles(bits_a: int, b: int) -> int:
    """m16 tiles per warp the kernel launches for B = b."""
    return 4 if bits_a == 4 and -(-b // 8) <= NT_MT4 else 2


def _words(b: np.ndarray) -> np.ndarray:
    """uint8 bytes (..., 4k) -> little-endian uint32 words (..., k)."""
    return np.ascontiguousarray(b, dtype=np.uint8).view("<u4")


def _lo(w):
    """The kernel's nibbles_lo: signed codes of the low nibbles."""
    return ((w & np.uint32(0x0F0F0F0F)) + np.uint32(0x78787878)) \
        ^ np.uint32(0x80808080)


def _hi(w):
    """The kernel's nibbles_hi: signed codes of the high nibbles."""
    return ((((w >> np.uint32(4)) & np.uint32(0x0F0F0F0F))
             ^ np.uint32(0x08080808)) + np.uint32(0x78787878)) \
        ^ np.uint32(0x80808080)


def _s8(word) -> np.ndarray:
    """The 4 signed bytes of one uint32 register."""
    return np.array([word], "<u4").view(np.int8).astype(np.int64)


def _fragments(a_rows, x_vecs, bits_a, bits_x):
    """Every lane's mma operands for one block of 16 rows and 8 vectors,
    placed by the PTX layout of mma.m16n8k32 .s8 (A registers {row r
    k 4t.., row r+8 k 4t.., row r k 16+4t.., row r+8 k 16+4t..}, B
    registers {k 4t.., k 16+4t..} of vector r, for lane 4r + t): -> A (2
    steps, 16, 32), B (2, 32, 8) and how often each place was written."""
    A, B = np.zeros((2, 16, 32), np.int64), np.zeros((2, 32, 8), np.int64)
    na, nbx = np.zeros(A.shape, int), np.zeros(B.shape, int)
    for lane in range(32):
        r, t = lane >> 2, lane & 3
        if bits_a == 4:
            lo, hi = (_words(a_rows[q, 8 * t:8 * t + 8]) for q in (r, r + 8))
            af = [[_lo(lo[0]), _lo(hi[0]), _lo(lo[1]), _lo(hi[1])],
                  [_hi(lo[0]), _hi(hi[0]), _hi(lo[1]), _hi(hi[1])]]
        else:
            lo, hi = (_words(a_rows[q, 16 * t:16 * t + 16])
                      for q in (r, r + 8))
            af = [[lo[0], hi[0], lo[1], hi[1]], [lo[2], hi[2], lo[3], hi[3]]]
        if bits_x == 4:
            xw = _words(x_vecs[r, 8 * t:8 * t + 8])
            bf = [[_lo(xw[0]), _lo(xw[1])], [_hi(xw[0]), _hi(xw[1])]]
        else:
            xw = _words(np.concatenate(
                [x_vecs[r, 8 * t:8 * t + 8], x_vecs[r, 32 + 8 * t:40 + 8 * t]])
                if bits_a == 4 else x_vecs[r, 16 * t:16 * t + 16])
            bf = [[xw[0], xw[1]], [xw[2], xw[3]]]
        for s in range(2):
            for i in range(4):
                row, col = r + 8 * (i % 2), 4 * t + 16 * (i // 2)
                A[s, row, col:col + 4] = _s8(af[s][i])
                na[s, row, col:col + 4] += 1
            for i in range(2):
                k = 4 * t + 16 * i
                B[s, k:k + 4, r] = _s8(bf[s][i])
                nbx[s, k:k + 4, r] += 1
    return A, B, na, nbx


def _block_codes(rng, rows, bits, extremes):
    """(rows, 64) int codes of one block and their packed bytes."""
    q = 7 if bits == 4 else 127
    if extremes:
        codes = rng.choice([-q, q], (rows, 64))
    else:
        lo = -8 if bits == 4 else -128
        codes = rng.integers(lo, q + 1, (rows, 64))
    if bits == 8:
        return codes, codes.astype(np.int8).view(np.uint8)
    packed = (codes[:, :32] + 8) | ((codes[:, 32:] & 15) << 4)
    return codes, packed.astype(np.uint8)


@pytest.mark.parametrize("extremes", [False, True])
@pytest.mark.parametrize("bits_a,bits_x", MODES)
def test_mma_fragments_give_block_dots(rng, bits_a, bits_x, extremes):
    """The lanes' loads, the nibble unpacking and the m16n8k32 fragment
    places give each (row, vector) block's exact integer dot: every place
    of A and B written once, the two steps' products summed into an
    accumulator that enters as 0x4B400000 equal to the dot of the codes
    clover_tpu unpacks, and float(d) one f32 subtract.  Every code,
    codes at +-7 / +-127, and random words."""
    for _ in range(8):
        a_codes, a_bytes = _block_codes(rng, 16, bits_a, extremes)
        x_codes, x_bytes = _block_codes(rng, 8, bits_x, extremes)
        A, B, na, nbx = _fragments(a_bytes, x_bytes, bits_a, bits_x)
        assert (na == 1).all() and (nbx == 1).all()
        d = MAGIC_BITS + A[0] @ B[0] + A[1] @ B[1]
        # the reference's own unpacking of the packed bytes
        if bits_a == 4:
            a_ref = np.asarray(ct.formats.unpack_nibbles(
                jnp.asarray(a_bytes.view(np.int8))))
            np.testing.assert_array_equal(a_ref, a_codes)
        if bits_x == 4:
            x_ref = np.asarray(ct.formats.unpack_nibbles(
                jnp.asarray(x_bytes.view(np.int8))))
            np.testing.assert_array_equal(x_ref, x_codes)
        want = a_codes.astype(np.int64) @ x_codes.astype(np.int64).T
        np.testing.assert_array_equal(d - MAGIC_BITS, want)
        got = d.astype(np.int32).view(np.float32) - MAGIC
        np.testing.assert_array_equal(got, want.astype(np.float32))
    # every dot the kernel can meet: |d| <= 64 * 128 * 128 = 2^20
    d = np.arange(-(1 << 20), (1 << 20) + 1, dtype=np.int32)
    got = (d + np.int32(MAGIC_BITS)).view(np.float32) - MAGIC
    np.testing.assert_array_equal(got.view(np.uint32),
                                  d.astype(np.float32).view(np.uint32))


@pytest.fixture(scope="module")
def edge_problems():
    """(mode, shape) -> the kernel's operands for 32 vectors and the plain
    f32 version's sums, from a seeded NumPy draw."""
    rng = np.random.default_rng(9)
    out = {}
    for bits_a, bits_x in MODES:
        for m, n in EDGES:
            a = tt.quantize(torch.from_numpy(
                rng.random((m, n), dtype=np.float32) * 2 - 1), bits_a)
            xs = tt.stack_vectors([tt.quantize(torch.from_numpy(
                rng.standard_normal(n, dtype=np.float32)), bits_x)
                for _ in range(32)])
            ops = (a.codes, a.scales, xs.codes, xs.scales)
            out[bits_a, bits_x, m, n] = (ops, mvm_batched_f32_plain(
                bits_a, bits_x, *ops).numpy())
    return out


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("m,n", EDGES)
@pytest.mark.parametrize("bits_a,bits_x", MODES)
def test_group_split_is_blocked_sum(edge_problems, bits_a, bits_x, m, n, b):
    """The kernel's sums, emulated in f32: warp g adds the products
    ((sA/qA) * (sx/qx)) * float(d) of blocks g, g+G, ... from 0 (+0 past
    the row's last block), and the G partials reduce (g, g+G/2), ...:
    bit for bit the plain version's sums, at shapes with a partial last
    chunk."""
    (a_codes, a_scales, x_codes, x_scales), want = \
        edge_problems[bits_a, bits_x, m, n]
    G = WARPS[bits_a]
    assert G == groups(bits_a)          # the plain version's lane groups
    unpack = tt.formats.unpack_nibbles
    a = (unpack(a_codes) if bits_a == 4 else a_codes).numpy()
    x = (unpack(x_codes[:b]) if bits_x == 4 else x_codes[:b]).numpy()
    nb = a.shape[1] // 64
    assert nb % G
    dots = np.einsum("mbk,vbk->mbv", a.reshape(m, nb, 64).astype(np.int64),
                     x.reshape(b, nb, 64).astype(np.int64))
    d = (dots + MAGIC_BITS).astype(np.int32).view(np.float32) - MAGIC
    qa = np.float32(7 if bits_a == 4 else 127)
    qx = np.float32(7 if bits_x == 4 else 127)
    saq = np.repeat(a_scales.numpy() / qa, 64, axis=0)      # (m, nb)
    sxq = x_scales[:b].numpy() / qx                         # (b, nb)
    prods = (saq[:, :, None] * sxq.T[None]) * d             # (m, nb, b)
    part = []
    for g in range(G):
        acc = np.zeros((m, b), np.float32)
        for c in range(-(-nb // G)):
            blk = c * G + g
            acc = acc + (prods[:, blk] if blk < nb else np.float32(0))
        part.append(acc)
    h = G // 2
    while h:
        part = [part[k] + part[k + h] for k in range(h)]
        h //= 2
    np.testing.assert_array_equal(part[0].T.view(np.uint32),
                                  want[:b].view(np.uint32))


@pytest.mark.parametrize("bits_a", [4, 8])
def test_launch_covers_each_row_group_vector_once(bits_a):
    """Over the kernel's grid (one CTA per 16 MT rows, a cluster of 4 / MT
    CTAs per band), its warps (lane groups), lanes, m-tiles, n-tiles and
    accumulator registers, every (row, block, vector < B) is multiplied
    exactly once, by the warp of its block's group; the tree's items write
    every (row, vector < B) sum once, into its band's row."""
    G = WARPS[bits_a]
    for m_pad, n_pad, b in ((64, 576, 9), (640, 1152, 5), (128, 16512, 31),
                            (256, 4096, 32), (192, 320, 1), (128, 1024, 24),
                            (128, 1024, 8)):
        mt = tiles(bits_a, b)
        rows, cluster = 16 * mt, 4 // mt
        nb, nt = n_pad // 64, -(-b // 8)
        grid = m_pad // rows
        assert rows * cluster == 64 and grid % cluster == 0
        seen = np.zeros((m_pad, nb, b), int)
        cta, warp, lane, m, j, i, c = np.meshgrid(
            np.arange(grid), np.arange(G), np.arange(32), np.arange(mt),
            np.arange(nt), np.arange(4), np.arange(-(-nb // G)),
            indexing="ij")
        r, t = lane >> 2, lane & 3
        row = cta * rows + 16 * m + r + 8 * (i // 2)
        vec = 8 * j + 2 * t + i % 2
        blk = c * G + warp
        live = (blk < nb) & (vec < b)
        np.add.at(seen, (row[live], blk[live], vec[live]), 1)
        assert (seen == 1).all()
        assert ((blk % G) == warp).all()
        # the tree: item k of CTA q is (row k // V, vector k % V), stored
        # at band row (q % cluster) * rows + k // V of band q // cluster
        v = 8 * nt
        q, k = np.meshgrid(np.arange(grid), np.arange(rows * v),
                           indexing="ij")
        keep = k % v < b
        band_row = (q % cluster) * rows + k // v
        out = (q // cluster) * 64 + band_row
        written = np.zeros((m_pad, b), int)
        np.add.at(written, (out[keep], (k % v)[keep]), 1)
        assert (written == 1).all() and (band_row < 64).all()


@pytest.mark.parametrize("b", range(1, 33))
def test_scale_quotients_reach_their_lanes(b):
    """The kernel divides each block scale once per warp: lane l holds A's
    quotient of chunk l of every 32, and the x quotient of (chunk l // BP,
    vector l % BP) of every 32 // BP chunks (BP = B rounded up to a power
    of 2).  The lane each accumulator's shuffle reads, k + 8j + 2t (+ 1)
    for k = (c % (32 // BP)) * BP, holds its own (chunk, vector) for every
    live vector."""
    bp = 1 << (b - 1).bit_length()
    cps = 32 // bp
    lane = np.arange(32)
    holds = {(c, int(v)) for c in range(cps)
             for v, lc in zip(lane % bp, lane // bp) if lc == c and v < b}
    assert len(holds) == cps * b          # every (chunk, vector) once
    nt = -(-b // 8)
    for c in range(cps):
        k = c * bp
        for j in range(nt):
            for t in range(4):
                for i in range(2):
                    vec = 8 * j + 2 * t + i
                    src = k + vec
                    if vec < b:
                        assert src < 32 and src // bp == c
                        assert src % bp == vec
