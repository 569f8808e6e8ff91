"""Shared helpers for the tests of clover_tpu_torch against clover_tpu.

Containers cross between the packages as NumPy copies of their leaves
(clover_tpu_torch.interop), so both packages compute on the same bytes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
from clover_tpu_torch.interop import from_numpy, to_numpy


def to_torch(q):
    """clover_tpu (or clover_tpu_torch) container -> clover_tpu_torch."""
    kind, codes, scales, meta = to_numpy(q)
    return from_numpy(kind, codes, scales, **meta)


def to_jax(q):
    """clover_tpu_torch (or clover_tpu) container -> clover_tpu."""
    kind, codes, scales, meta = to_numpy(q)
    cls = getattr(ct.formats, kind)
    if scales is None:
        return cls(values=jnp.asarray(codes), **meta)
    return cls(codes=jnp.asarray(codes), scales=jnp.asarray(scales), **meta)


def element_codes(q) -> np.ndarray:
    """int32 element codes of a 4/8-bit container of either package."""
    _, codes, _, _ = to_numpy(q)
    if q.bits == 4:
        codes = np.asarray(ct.formats.unpack_nibbles(jnp.asarray(codes)))
    return codes.astype(np.int32)


def warp_order_sums(prods: torch.Tensor, G: int) -> np.ndarray:
    """Row sums of (rows, blocks) f32 products as a warp of the MVM kernel
    (csrc/mvm.cu) adds them, vectorized over rows: group g adds blocks g,
    g+G, ... from 0, then the groups reduce by xor-shuffles (g, g^G/2),
    ..., (g, g^1)."""
    t = prods.numpy()
    acc = [np.zeros(t.shape[0], np.float32) for _ in range(G)]
    for c in range(-(-t.shape[1] // G)):
        for g in range(G):
            if G * c + g < t.shape[1]:
                acc[g] = acc[g] + t[:, G * c + g]
    off = G // 2
    while off:
        acc = [acc[g] + acc[g ^ off] for g in range(G)]
        off //= 2
    return acc[0]


def assert_same(got, want):
    """Byte-identical leaves and equal meta (both packages accepted)."""
    kg, cg, sg, mg = to_numpy(got)
    kw, cw, sw, mw = to_numpy(want)
    assert (kg, mg) == (kw, mw), ((kg, mg), (kw, mw))
    assert cg.dtype == cw.dtype and cg.shape == cw.shape
    np.testing.assert_array_equal(cg.view(np.uint8), cw.view(np.uint8))
    if sw is not None:
        np.testing.assert_array_equal(sg.view(np.uint32), sw.view(np.uint32))


def assert_within_lsb(got, want, rtol=1e-5):
    """MVM/AXPY tolerance: codes within 1 LSB, scales within ``rtol`` --
    the f32 block sums may be taken in another order (fp contraction /
    summation order), as tests/test_kernels.py allows the TPU kernels."""
    kg, _, sg, mg = to_numpy(got)
    kw, _, sw, mw = to_numpy(want)
    assert (kg, mg) == (kw, mw)
    assert np.abs(element_codes(got) - element_codes(want)).max() <= 1
    np.testing.assert_allclose(sg, sw, rtol=rtol)


def byte_perm(x, y, selector: int):
    """__byte_perm on uint32 arrays: result byte i is byte (selector >> 4i)
    & 7 of the 8 bytes x0..x3, y0..y3."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(selector >> (4 * i)) & 7] << (8 * i) for i in range(4))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for a module of many small solves (import it
    into the module): the suite's workers share the cores, and more
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
