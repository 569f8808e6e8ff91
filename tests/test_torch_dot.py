"""clover_tpu_torch dot (the dot kernel's plain versions) against clover_tpu
and golden.py, and the kernel's summation order (csrc/dot.cu) modelled lane
by lane in NumPy against dot_plain_ordered.

Tolerances: against clover_tpu's dot (its XLA path, and its Pallas kernel
in interpret mode), 1e-5 of the sum of |terms|: the per-block terms agree
bit for bit (exact integer block sums, the same two IEEE divides and two
products), and only the order of the f32 sum over blocks differs; the same
between the two plain versions, which sum in torch's and in the kernel's
order.  Against golden.py, the reference's reordered-accumulation
tolerance 0.02 * max(1, |ref| / 10) (tests/test_kernels.py).  The model of
the kernel's order and dot_plain_ordered agree bit for bit.
"""

import re
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu import golden
from clover_tpu.kernels.dot import dot_pallas, dot_pallas_eligible
from clover_tpu_torch import golden as port_golden
from clover_tpu_torch.kernels import (dot_cuda, dot_plain, dot_plain_ordered,
                                      dot_terms)
from clover_tpu_torch.kernels import dot as kdot
from torch_helpers import element_codes, to_torch

SIZES = [128, 200, 1000, 4096, 65536]


def _pair(rng, n, bits):
    u = rng.random(n, dtype=np.float32) * 2 - 1
    v = rng.random(n, dtype=np.float32) * 2 - 1
    return [ct.quantize(jnp.asarray(w), bits) for w in (u, v)]


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("n", SIZES)
def test_dot_matches_jax(rng, bits, n):
    ju, jv = _pair(rng, n, bits)
    u, v = to_torch(ju), to_torch(jv)
    got = tt.dot(u, v)
    assert got.shape == () and got.dtype == torch.float32
    if bits in (4, 8):
        terms = dot_terms(u.codes, u.scales, v.codes, v.scales, bits)
        tol = 1e-5 * float(terms.abs().sum())
    else:
        tol = 1e-5 * float((u.values.float() * v.values.float()).abs().sum())
    assert abs(float(got) - float(ct.ops.dot(ju, jv))) <= tol
    if bits in (4, 8) and n <= 4096 and dot_pallas_eligible(ju, jv):
        assert abs(float(got) - float(dot_pallas(ju, jv))) <= tol


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", SIZES)
def test_dot_matches_golden(rng, bits, n):
    ju, jv = _pair(rng, n, bits)
    u, v = to_torch(ju), to_torch(jv)
    got = float(tt.dot(u, v))
    ref = float(golden.dot(element_codes(ju), np.asarray(ju.scales),
                           element_codes(jv), np.asarray(jv.scales), bits))
    assert abs(got - ref) <= 0.02 * max(1.0, abs(ref) / 10), (got, ref)
    # the port's own oracle copy gives the same reference
    assert float(port_golden.dot(element_codes(ju), np.asarray(ju.scales),
                                 element_codes(jv), np.asarray(jv.scales),
                                 bits)) == ref


def test_dot_terms_op_order(rng):
    """t_b = ((su/q) * (sv/q)) * acc_b, each quotient rounded first: bit for
    bit the NumPy f32 expression of golden.py."""
    ju, jv = _pair(rng, 4096, 8)
    u, v = to_torch(ju), to_torch(jv)
    su, sv = np.asarray(ju.scales), np.asarray(jv.scales)
    acc = (element_codes(ju).astype(np.int64).reshape(-1, 64)
           * element_codes(jv).astype(np.int64).reshape(-1, 64)).sum(axis=1)
    want = (su / np.float32(127.0)) * (sv / np.float32(127.0)) \
        * acc.astype(np.float32)
    got = dot_terms(u.codes, u.scales, v.codes, v.scales, 8).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert float(dot_plain(u.codes, u.scales, v.codes, v.scales, 8)) == \
        float(dot_terms(u.codes, u.scales, v.codes, v.scales, 8).sum())


@pytest.mark.parametrize("bits", [4, 8])
def test_dot_reaches_its_kernel(monkeypatch, bits):
    """CUDA operands go to dot_cuda (a counting stand-in here); the real
    wrapper refuses CPU tensors before it builds anything; mismatched
    precisions or lengths raise."""
    ops_dot = sys.modules["clover_tpu_torch.ops.dot"]
    u = tt.quantize(torch.linspace(-1, 1, 300), bits)
    calls = []

    def kernel(*args):
        calls.append(args[-1])
        return dot_plain(*args)

    with pytest.raises(ValueError, match="CUDA"):
        dot_cuda(u.codes, u.scales, u.codes, u.scales, bits)
    monkeypatch.setattr(ops_dot, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ops_dot, "dot_cuda", kernel)
    assert float(tt.dot(u, u)) == float(dot_plain(u.codes, u.scales, u.codes,
                                                  u.scales, bits))
    assert calls == [bits]
    with pytest.raises(ValueError, match="precision"):
        tt.dot(u, tt.quantize(torch.linspace(-1, 1, 300), 12 - bits))
    with pytest.raises(ValueError, match="precision"):
        tt.dot(u, tt.quantize(torch.linspace(-1, 1, 600), bits))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", SIZES)
def test_dot_plain_ordered_matches(rng, bits, n):
    """The kernel-order plain version against the torch-order one and
    clover_tpu's Pallas kernel (interpret mode), within 1e-5 of sum |t_b|."""
    ju, jv = _pair(rng, n, bits)
    u, v = to_torch(ju), to_torch(jv)
    ops = (u.codes, u.scales, v.codes, v.scales, bits)
    got = dot_plain_ordered(*ops)
    assert got.shape == () and got.dtype == torch.float32
    tol = 1e-5 * float(dot_terms(*ops).abs().sum())
    assert abs(float(got) - float(dot_plain(*ops))) <= tol
    assert dot_pallas_eligible(ju, jv)
    assert abs(float(got) - float(dot_pallas(ju, jv))) <= tol


def _kernel_order(terms: np.ndarray, bits: int, grid: int) -> np.float32:
    """csrc/dot.cu's sum of the terms, lane by lane in f32: CTA c takes
    tiles c, c + grid, ...; warp w's step s reads blocks tile * TILE +
    (s * WARPS + w) * G + g; each lane adds its group's terms in step
    order, then shuffle-xor trees over the groups and the warps; the last
    CTA's thread j adds partials j, j + THREADS, ..., then the same trees."""
    f = np.float32
    lanes = 2 if bits == 4 else 4
    groups = 32 // lanes
    tile, warps, threads = kdot.TILE, kdot.WARPS, kdot.THREADS
    steps = tile // (warps * groups)
    tiles = -(-len(terms) // tile)

    def xor_tree(vals, first, last):
        o = first
        while o >= last:
            vals = [f(vals[j] + vals[j ^ o]) for j in range(32)]
            o //= 2
        return vals[0]

    partial = np.zeros(tiles, np.float32)
    for cta in range(grid):
        for t in range(cta, tiles, grid):
            sums = []
            for w in range(warps):
                acc = [f(0)] * 32
                for lane in range(32):
                    for s in range(steps):
                        b = t * tile + (s * warps + w) * groups + lane // lanes
                        acc[lane] = f(acc[lane] + (terms[b] if b < len(terms)
                                                   else f(0)))
                sums.append(xor_tree(acc, 16, lanes))
            partial[t] = xor_tree(sums + [f(0)] * (32 - warps), warps // 2, 1)
    c = [f(0)] * threads
    for j in range(threads):
        for i in range(j, tiles, threads):
            c[j] = f(c[j] + partial[i])
    sums = [xor_tree(c[32 * w:32 * w + 32], 16, 1) for w in range(warps)]
    return xor_tree(sums + [f(0)] * (32 - warps), warps // 2, 1)


@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [128, 1000, 40000])
def test_dot_plain_ordered_is_the_kernel_order(rng, n, bits, grid):
    """dot_plain_ordered equals the lane-level model of the kernel's sum
    bit for bit, at one tile and at three (4-bit 40000: 626 blocks), at
    grids 1 and 3."""
    u, v = (tt.quantize(torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)), bits) for _ in range(2))
    ops = (u.codes, u.scales, v.codes, v.scales, bits)
    want = _kernel_order(dot_terms(*ops).numpy(), bits, grid)
    got = dot_plain_ordered(*ops).numpy()
    assert got.view(np.uint32) == np.float32(want).view(np.uint32)


def test_dot_order_constants_are_the_sources():
    """kernels/dot.py's TILE, THREADS and steps are csrc/dot.cu's."""
    src = (Path(kdot.__file__).resolve().parent.parent / "csrc" /
           "dot.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("DOT_TILE")) == kdot.TILE
    assert int(const("DOT_THREADS")) == kdot.THREADS
    assert const("DOT_WARPS") == "DOT_THREADS / 32"
    assert re.search(r"static constexpr int LANES = BITS == 4 \? 2 : 4;", src)
    assert re.search(r"static constexpr int STEPS = DOT_TILE / "
                     r"\(DOT_WARPS \* G\);", src)
    assert (kdot.steps(4), kdot.steps(8)) == (2, 4)
