"""clover_tpu_torch containers, packing, interop and dispatch against
clover_tpu (bit-identical: the formats are one byte layout)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu_torch import formats as tf
from clover_tpu_torch.kernels import dispatch
from torch_helpers import assert_same, to_jax, to_torch

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("shape", [(64,), (384,), (3, 128), (5, 256)])
def test_pack_nibbles_matches_jax(rng, shape):
    codes = rng.integers(-8, 8, shape).astype(np.int8)
    got = tt.pack_nibbles(torch.from_numpy(codes)).numpy()
    want = np.asarray(ct.pack_nibbles(jnp.asarray(codes)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tt.unpack_nibbles(torch.from_numpy(got)).numpy(), codes)


def test_zero_code_packs_to_0x08():
    packed = tt.pack_nibbles(torch.zeros(128, dtype=torch.int8))
    assert packed.dtype == torch.int8
    assert torch.all(packed == 0x08)


def test_unpack_sign_extends_every_byte():
    """All 256 byte values: >> on int8 sign-extends the high nibble and the
    low nibble un-biases, exactly as clover_tpu unpacks."""
    b = np.arange(-128, 128, dtype=np.int8)   # 256 bytes = 8 blocks
    got = tt.unpack_nibbles(torch.from_numpy(b)).numpy()
    want = np.asarray(ct.unpack_nibbles(jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    assert got.min() == -8 and got.max() == 7


def test_pack_rejects_ragged_length():
    with pytest.raises(ValueError):
        tt.pack_nibbles(torch.zeros(96, dtype=torch.int8))


@pytest.mark.parametrize("n", [1, 127, 128, 129, 300])
def test_pad_helpers_match_jax(rng, n):
    assert tt.pad_to(n) == ct.pad_to(n)
    x = rng.random(n, dtype=np.float32)
    np.testing.assert_array_equal(
        tf.pad_vector(torch.from_numpy(x)).numpy(),
        np.asarray(ct.formats.pad_vector(jnp.asarray(x))))
    a = rng.random((n, 200), dtype=np.float32)
    np.testing.assert_array_equal(
        tf.pad_matrix(torch.from_numpy(a)).numpy(),
        np.asarray(ct.formats.pad_matrix(jnp.asarray(a))))


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_zeros_vector_matches_jax(bits):
    assert_same(tt.zeros_vector(bits, 300), ct.zeros_vector(bits, 300))


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_interop_round_trip(rng, bits):
    """JAX container -> port -> JAX keeps every byte, for vectors and
    matrices, and the port's container properties agree."""
    v = ct.quantize(jnp.asarray(rng.random(300, dtype=np.float32) - 0.5), bits)
    a = ct.quantize(jnp.asarray(rng.random((200, 300), dtype=np.float32)
                                - 0.5), bits)
    for jq in (v, a):
        tq = to_torch(jq)
        assert type(tq).__name__ == type(jq).__name__
        assert_same(to_jax(tq), jq)
        assert tq.nbytes == jq.nbytes
    tv, ta = to_torch(v), to_torch(a)
    assert (tv.length, tv.length_pad) == (v.length, v.length_pad)
    assert (ta.rows, ta.cols, ta.rows_pad, ta.cols_pad) == (
        a.rows, a.cols, a.rows_pad, a.cols_pad)
    if bits in (4, 8):
        assert tv.blocks == v.blocks


def test_to_device_copies_every_tensor():
    q = tt.zeros_vector(4, 256)
    q2 = tt.to_device(q, "cpu")
    assert type(q2) is tt.QVec4 and q2.length == 256
    assert torch.equal(q2.codes, q.codes) and torch.equal(q2.scales, q.scales)


def test_import_leaves_jax_out():
    """Importing the port never imports jax or clover_tpu."""
    code = ("import sys, clover_tpu_torch, clover_tpu_torch.kernels, "
            "clover_tpu_torch.serving, clover_tpu_torch.models.batch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'clover_tpu.')) or m == 'clover_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_seed_wrap_and_sources():
    assert dispatch.wrap_i32(2 ** 31) == -2 ** 31
    assert dispatch.wrap_i32(-2 ** 31 - 1) == 2 ** 31 - 1
    assert dispatch.SEED_GOLD == dispatch.wrap_i32(0x9E3779B9)
    assert dispatch.seed_from(None) == (0, False)
    assert dispatch.seed_from(2 ** 32 + 5) == (5, True)
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    s1, s2 = dispatch.seed_from(g1), dispatch.seed_from(g2)
    assert s1 == s2 and s1[1] and -2 ** 31 <= s1[0] < 2 ** 31
    assert dispatch.seed_from(g1) != s1            # the generator advanced
    with pytest.raises(TypeError):
        dispatch.seed_from(1.5)


def test_dispatch_rule():
    """CPU tensors go to the plain version; mixed or other devices raise
    instead of falling back."""
    cpu = torch.zeros(4)
    assert dispatch.on_cuda(cpu, cpu) is False
    with pytest.raises(ValueError):
        dispatch.on_cuda(cpu, torch.zeros(4, device="meta"))
    with pytest.raises(ValueError):
        dispatch.on_cuda(torch.zeros(4, device="meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never computes on the CPU: it checks its operands
    before it builds or launches anything."""
    from clover_tpu_torch.kernels import (
        axpy_cuda, mvm4_cuda, mvm8_cuda, mvm_batched_cuda, quantize_mat_cuda,
        quantize_vec_cuda, restore_vec_cuda, threshold4_cuda,
        threshold8_cuda, transpose4_cuda, transpose8_cuda)
    q = tt.quantize(torch.ones(128, 256), 4)
    x = tt.quantize(torch.ones(256), 4)
    q8 = tt.quantize(torch.ones(128, 256), 8)
    x8 = tt.quantize(torch.ones(256), 8)
    calls = [lambda: quantize_vec_cuda(torch.zeros(128), 4),
             lambda: quantize_mat_cuda(torch.zeros(128, 128), 4),
             lambda: transpose4_cuda(q.codes),
             lambda: transpose8_cuda(q8.codes),
             lambda: mvm4_cuda(q.codes, q.scales, x.codes, x.scales),
             lambda: mvm8_cuda(4, q.codes, q.scales, x8.codes, x8.scales),
             lambda: mvm8_cuda(8, q8.codes, q8.scales, x8.codes, x8.scales),
             lambda: threshold4_cuda(x.codes, x.scales, 3),
             lambda: threshold8_cuda(x8.codes, x8.scales, 3),
             lambda: restore_vec_cuda(x.codes, x.scales, 4),
             lambda: restore_vec_cuda(x8.codes, x8.scales, 8),
             lambda: axpy_cuda(x.codes, x.scales, x.codes, x.scales, 0.5, 4),
             lambda: axpy_cuda(x8.codes, x8.scales, x8.codes, x8.scales,
                               0.5, 8),
             lambda: threshold4_cuda(x.codes[None], x.scales[None], 3),
             lambda: mvm_batched_cuda(4, 4, q.codes, q.scales, x.codes[None],
                                      x.scales[None]),
             lambda: mvm_batched_cuda(8, 8, q8.codes, q8.scales,
                                      x8.codes[None], x8.scales[None])]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_build_finds_sources_and_refuses_without_nvcc(monkeypatch, tmp_path):
    from clover_tpu_torch.kernels import _build
    names = sorted(p.name for p in _build._sources())
    assert names == ["axpy.cu", "dot.cu", "iteration.cu", "mvm.cu",
                     "mvm_batched.cu", "probes.cu", "quantize.cu",
                     "restore.cu", "threshold.cu", "threshold_hybrid.cu",
                     "transpose.cu"]
    assert len(_build._digest()) == 16 and _build._digest() == _build._digest()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert set(_build.SIGNATURES) == {
        "clover_quantize_vec", "clover_quantize_mat", "clover_restore_vec",
        "clover_transpose", "clover_mvm", "clover_threshold", "clover_axpy",
        "clover_mvm_batched", "clover_mvm_f32", "clover_mvm_batched_f32",
        "clover_iteration_occupancy",
        "clover_iteration", "clover_iteration_chain", "clover_restore_mat",
        "clover_dot", "clover_hist4", "clover_mask4", "clover_dma_probe",
        "clover_dma_probe_cluster", "clover_salted_probe"}
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
