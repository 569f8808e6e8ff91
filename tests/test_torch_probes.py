"""The measurement probes' plain versions (kernels/probes.py) against a
NumPy band checksum, and the stacking of dma_probe_stream against
clover_tpu's (tests/test_kernels.py test_dma_probe_stream_stacking).

The kernels write, per 64-row band, salt + float(int32 sum of the band's
code bytes): exact in any order, so the comparisons are exact."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.kernels import probes as jax_probes
from clover_tpu_torch import kernels
from clover_tpu_torch.kernels import probes
from torch_helpers import to_torch


def _band_checksum(codes: np.ndarray) -> np.ndarray:
    s = codes.astype(np.int64).reshape(codes.shape[0] // 64, -1).sum(axis=1)
    return ((s + 2**31) % 2**32 - 2**31).astype(np.int32).astype(np.float32)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(256, 512), (200, 300), (128, 4096)])
def test_plain_probes_equal_a_numpy_checksum(rng, bits, shape):
    q = tt.quantize(torch.from_numpy(
        rng.random(shape, dtype=np.float32) * 2 - 1), bits)
    want = _band_checksum(q.codes.numpy())
    got = probes.dma_probe_plain(q.codes)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    salt = torch.tensor([0.25])
    np.testing.assert_array_equal(
        probes.salted_probe_plain(q.codes, salt).numpy(),
        np.float32(0.25) + want)


def test_band_sum_wraps_as_int32():
    codes = torch.full((64, 1 << 19), 127, dtype=torch.int8)
    exact = 64 * (1 << 19) * 127
    want = np.float32(np.int32(exact - 2**32)) if exact >= 2**31 \
        else np.float32(exact)
    assert probes.dma_probe_plain(codes).numpy()[0] == want


def test_dma_probe_stream_stacking_matches_clover_tpu(rng):
    a = rng.random((256, 512), np.float32)
    jq = ct.quantize(jnp.asarray(a), 4)
    q = to_torch(jq)
    mk, nbytes, p = probes.dma_probe_stream(q, ring_bytes=1 << 20)
    _, jnbytes, jp = jax_probes.dma_probe_stream(jq, ring_bytes=1 << 20)
    assert (p, nbytes) == (jp, jnbytes)
    assert p == -(-(1 << 20) // q.codes.nbytes)
    assert nbytes == p * q.codes.nbytes
    assert math.isfinite(mk(3)())
    assert math.isfinite(probes.launch_probe("cpu")(3)())
    make, streamed = probes.dma_probe_call(q)
    assert streamed == q.codes.nbytes
    assert math.isfinite(make(3)())


def test_probe_makers_run_the_plain_versions_on_the_cpu(rng):
    q = tt.quantize(torch.rand(128, 256) * 2 - 1, 8)
    stacked, p = probes.stacked_codes(q, ring_bytes=3 * q.codes.nbytes)
    assert p == 3 and torch.equal(stacked[128:256], q.codes)
    make, _, _ = probes.dma_probe_stream(q, ring_bytes=0)
    got = make(1)()
    assert got == float(probes.dma_probe_plain(q.codes)[0])


def test_cuda_wrappers_refuse_cpu_tensors():
    codes = torch.zeros(64, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        probes.dma_probe_cuda(codes)
    with pytest.raises(ValueError, match="CUDA"):
        probes.salted_probe_cuda(codes, torch.zeros(1))
    with pytest.raises(ValueError, match="multiple of 64"):
        probes.dma_probe_cuda(torch.zeros(65, 128, dtype=torch.int8))
    assert kernels.KERNELS["dma_probe"] is probes.dma_probe_cuda
    assert kernels.KERNELS["salted_probe"] is probes.salted_probe_cuda
    assert len(kernels.KERNELS) == 21


def test_dispatch_reaches_the_kernels(monkeypatch):
    """CUDA operands go to the *_cuda wrappers (counting stand-ins here)."""
    calls = []
    monkeypatch.setattr(probes, "on_cuda", lambda *t: True)
    monkeypatch.setattr(probes, "dma_probe_cuda",
                        lambda c: calls.append("dma") or c[:1, :1])
    monkeypatch.setattr(probes, "salted_probe_cuda",
                        lambda c, s: calls.append("salted") or s)
    codes = torch.zeros(64, 128, dtype=torch.int8)
    probes.dma_probe(codes)
    probes.salted_probe(codes, torch.zeros(1))
    assert calls == ["dma", "salted"]
