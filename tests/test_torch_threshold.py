"""clover_tpu_torch threshold (the 4- and 8-bit kernels' plain versions)
against clover_tpu: exact top-K in golden order (|value| descending, index
ascending), bit-identical codes, scales untouched -- across tie storms,
integer-valued data, k > nnz and ragged lengths."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu import golden
from clover_tpu.kernels.threshold import (threshold4_pallas,
                                          threshold4_pallas_eligible,
                                          threshold8_pallas,
                                          threshold8_pallas_eligible)
from clover_tpu.ops.threshold import _threshold4_xla
from clover_tpu_torch.kernels import threshold8_plain
from clover_tpu_torch.kernels.threshold import golden_keep
from torch_helpers import assert_same, element_codes, to_torch


def _cases(rng, n, k):
    v = rng.random(n, dtype=np.float32) * 2 - 1
    ints = rng.integers(-3, 4, n).astype(np.float32)
    storm = np.repeat(rng.random(-(-n // 64), dtype=np.float32), 64)[:n]
    sparse = np.zeros(n, np.float32)
    sparse[rng.permutation(n)[:max(1, k // 2)]] = 1.0     # k > nnz: tau == 0
    return {"uniform": v, "integer": ints, "storm": storm, "sparse": sparse}


@pytest.mark.parametrize("n,k", [(256, 3), (300, 50), (1024, 64),
                                 (4096, 1024), (4096, 257), (16384, 4096)])
def test_threshold4_matches_jax(rng, n, k):
    for name, v in _cases(rng, n, k).items():
        jq = ct.quantize(jnp.asarray(v), 4)
        tq = to_torch(jq)
        got = tt.threshold(tq, k)
        assert got.scales is tq.scales, name
        assert_same(got, ct.threshold(jq, k))
        assert_same(got, _threshold4_xla(jq, k))
        if threshold4_pallas_eligible(jq, k) and n <= 4096:
            assert_same(got, threshold4_pallas(jq, k))
        want = golden.threshold(element_codes(jq), np.asarray(jq.scales), k,
                                n, 4)
        np.testing.assert_array_equal(element_codes(got), want)


def test_threshold_edge_k():
    q = tt.quantize(torch.linspace(-1, 1, 300), 4)
    assert tt.threshold(q, 300) is q and tt.threshold(q, 10 ** 6) is q
    zero = tt.threshold(q, 0)
    assert torch.all(zero.codes == 0x08) and zero.scales is q.scales
    one = tt.threshold(q, 1)
    assert int((tt.unpack_nibbles(one.codes) != 0).sum()) == 1
    with pytest.raises(ValueError):
        tt.threshold(q, -1)


def test_threshold4_ties_break_to_lower_index():
    """Identical values: the lowest indices win, across block boundaries
    and both nibble halves of a byte."""
    v = torch.ones(512)
    q = tt.quantize(v, 4)
    for k in (1, 31, 33, 64, 65, 200):
        kept = tt.unpack_nibbles(tt.threshold(q, k).codes) != 0
        assert torch.equal(kept, torch.arange(512) < k), k


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_threshold_dense_matches_jax(rng, bits):
    n, k = 1000, 97
    for v in (rng.random(n, dtype=np.float32) * 2 - 1,
              rng.integers(-3, 4, n).astype(np.float32)):
        jq = ct.quantize(jnp.asarray(v), bits)
        assert_same(tt.threshold(to_torch(jq), k), ct.threshold(jq, k))


@pytest.mark.parametrize("n,k", [(256, 3), (300, 50), (1024, 64),
                                 (4096, 1024), (4096, 257), (16384, 4096)])
def test_threshold8_matches_jax(rng, n, k):
    """8-bit: bit-identical to clover_tpu's dense XLA path, its Pallas
    kernel in interpret mode and golden.py, with k in {k, 1, 0}.
    clover_tpu's dense path refuses k=0 (approx_max_k), so k=0 is held to
    golden.py alone."""
    for name, v in _cases(rng, n, k).items():
        jq = ct.quantize(jnp.asarray(v), 8)
        tq = to_torch(jq)
        for kk in (k, 1, 0):
            got = tt.threshold(tq, kk)
            assert got.scales is tq.scales, name
            if kk:
                assert_same(got, ct.threshold(jq, kk))
                if threshold8_pallas_eligible(jq, kk) and n <= 4096:
                    assert_same(got, threshold8_pallas(jq, kk))
            want = golden.threshold(element_codes(jq), np.asarray(jq.scales),
                                    kk, n, 8)
            np.testing.assert_array_equal(element_codes(got), want)
            np.testing.assert_array_equal(
                threshold8_plain(tq.codes, tq.scales, kk, n).numpy(),
                got.codes.numpy())


def test_threshold8_ties_break_to_lower_index():
    """Identical values across blocks, and k > nnz (the zero ties fill in
    index order, writing zero codes)."""
    q = tt.quantize(torch.ones(512), 8)
    for k in (1, 63, 64, 65, 200):
        kept = tt.threshold(q, k).codes != 0
        assert torch.equal(kept, torch.arange(512) < k), k
    v = torch.zeros(512)
    v[[5, 100, 400]] = torch.tensor([0.5, -1.0, 0.25])
    got = tt.threshold(tt.quantize(v, 8), 64)
    assert torch.equal(torch.nonzero(got.codes).flatten(),
                       torch.tensor([5, 100, 400]))


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_threshold_plain_builds_its_mask_on_the_data_device(bits):
    """The plain 8/16/32-bit threshold builds the padding mask where the
    data lives: on a meta tensor (as on a CUDA one) nothing mixes devices.
    A mask built on the CPU fails here with 'Tensor on device meta is not
    on the expected device cpu'."""
    n, length, k = 384, 300, 10
    if bits == 8:
        codes = torch.zeros(n, dtype=torch.int8, device="meta")
        scales = torch.ones(n // 64, device="meta")
        out = threshold8_plain(codes, scales, k, length)
        assert out.device.type == "meta" and out.dtype == torch.int8
    else:
        values = torch.zeros(n, device="meta")
        out = golden_keep(values, k, length)
        assert out.device.type == "meta" and out.dtype == torch.bool
    assert out.shape == (n,)
    # the CPU-built mask this replaces
    with pytest.raises(RuntimeError, match="device"):
        torch.where(torch.arange(n) < length,
                    torch.zeros(n, dtype=torch.int64, device="meta"),
                    torch.full((n,), -1, dtype=torch.int64, device="meta")
                    ).sum()


@pytest.mark.parametrize("bits", [16, 32])
def test_threshold16_32_runs_where_the_data_lives(bits):
    """The 16/32-bit threshold is plain torch on every device (clover_tpu
    computes it in XLA, with no kernel): on a meta tensor, as on a CUDA
    one, it neither raises nor leaves the data's device."""
    n, length, k = 384, 300, 10
    cls = tt.QVec16 if bits == 16 else tt.QVec32
    dtype = torch.float16 if bits == 16 else torch.float32
    out = tt.threshold(cls(values=torch.zeros(n, dtype=dtype, device="meta"),
                           length=length), k)
    assert type(out) is cls and out.length == length
    assert out.values.device.type == "meta" and out.values.dtype == dtype
    assert out.values.shape == (n,)
