"""clover_tpu_torch threshold (the 4- and 8-bit kernels' plain versions,
and the large-n 4-bit hybrid's) against clover_tpu: exact top-K in golden
order (|value| descending, index ascending), bit-identical codes, scales
untouched -- across tie storms, integer-valued data, k > nnz and ragged
lengths."""

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
from clover_tpu_torch.kernels import threshold4_plain, threshold8_plain
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


# -- the large-n 4-bit hybrid: hist4 -> exact selector -> mask4 ------------

def _hybrid_cases(rng, n, k):
    """clover_tpu's hybrid cases (tests/test_ops_extra.py): uniform,
    integer-valued (tie storms) and k > nnz (tau == 0)."""
    z = np.zeros(n, np.float32)
    z[rng.permutation(n)[:max(1, k // 2)]] = 1.0
    return [rng.random(n, dtype=np.float32) * 2 - 1,
            rng.integers(-3, 4, n).astype(np.float32), z]


@pytest.mark.parametrize("n,k", [(256, 3), (1024, 64), (4096, 257),
                                 (65536, 64)])
def test_threshold4_hybrid_matches_jax(rng, monkeypatch, n, k):
    """The port's hybrid (plain hist4 and mask4, torch selector) gives the
    bytes of clover_tpu's _threshold4_hybrid, in its XLA and its kernel
    (interpret) variants: bit-identical codes, scales untouched."""
    import jax
    import clover_tpu.kernels.threshold as jax_kernels
    from clover_tpu.ops.threshold import _threshold4_hybrid as jax_hybrid
    from clover_tpu_torch.ops.threshold import _threshold4_hybrid
    cases = _hybrid_cases(rng, n, k)
    hist4_calls = []
    real_hist4 = jax_kernels.hist4_pallas
    monkeypatch.setattr(jax_kernels, "hist4_pallas",
                        lambda *a: hist4_calls.append(1) or real_hist4(*a))
    for use_kernels in (False, True):
        if use_kernels:
            monkeypatch.setenv("CLOVER_PALLAS", "1")
        else:
            monkeypatch.delenv("CLOVER_PALLAS", raising=False)
        jax.clear_caches()            # the variant is chosen at trace time
        hist4_calls.clear()
        for v in cases:
            jq = ct.quantize(jnp.asarray(v), 4)
            q = to_torch(jq)
            got = _threshold4_hybrid(q, k)
            assert got.scales is q.scales
            assert_same(got, jax.jit(jax_hybrid, static_argnums=1)(jq, k))
        # clover_tpu's kernels engage where hist4 has a geometry
        assert bool(hist4_calls) == (
            use_kernels and jax_kernels.hist4_geometry(jq.length_pad)
            is not None)


@pytest.mark.parametrize("n", [2048, 65536])
def test_hist4_matches_jax(rng, n):
    """hist4_plain against clover_tpu's hist4_pallas (interpret): equal
    counts (int32 here, f32 holding the same integers there)."""
    from clover_tpu.kernels.threshold import hist4_geometry, hist4_pallas
    from clover_tpu_torch.kernels import hist4_plain
    for v in _hybrid_cases(rng, n, 64):
        jq = ct.quantize(jnp.asarray(v), 4)
        assert hist4_geometry(jq.length_pad) is not None
        want = np.asarray(hist4_pallas(jq.codes, jq.length_pad))
        got = hist4_plain(to_torch(jq).codes).numpy()
        assert got.dtype == np.int32 and got.shape == (n // 64, 8)
        np.testing.assert_array_equal(got, want.astype(np.int32))
        assert np.all(got.sum(axis=1) == 64)


def test_hybrid_select_exact_on_ties():
    """tau is the largest candidate whose weight at or above it reaches k
    (0 when the whole multiset fits: keep every nonzero code), fill the
    ties to keep, offsets the ties of earlier blocks."""
    from clover_tpu_torch.ops.threshold import hybrid_select
    hist = torch.zeros(3, 8, dtype=torch.int32)
    hist[:, 0] = 64
    hist[0, 7], hist[1, 7], hist[2, 3] = 2, 5, 4      # values 7, 7, 3
    hist[:, 0] -= hist[:, 1:].sum(dim=1)
    m7 = torch.tensor([1.0, 1.0, 1.0])
    for k, tau, fill in ((1, 7.0, 1), (7, 7.0, 7), (8, 3.0, 1),
                         (10, 3.0, 3), (11, 0.0, 0), (12, 0.0, 1)):
        t, f, off = hybrid_select(hist, m7, k)
        assert (float(t), int(f)) == (tau, fill), k
        ties = [2, 5, 0] if tau == 7.0 else [0, 0, 4] if tau == 3.0 else [0] * 3
        assert off.tolist() == [0, ties[0], ties[0] + ties[1]]
    t, f, _ = hybrid_select(hist, m7, 0)
    assert float(t) == float("inf") and int(f) == 0


def test_threshold4_dispatch_rule(rng, monkeypatch):
    """A 1-D 4-bit vector with 2^19 <= n_pad < 2^24 and k <= 256 takes the
    hybrid, as clover_tpu does; k = 257, shorter vectors and stacked ones
    keep the radix select.  Shown by counting the plain functions."""
    import clover_tpu_torch.ops.threshold as ops_threshold
    from clover_tpu_torch.ops.threshold import hybrid4_eligible
    calls = []
    for name in ("hist4_plain", "mask4_plain", "threshold4_plain"):
        fn = getattr(ops_threshold, name)
        monkeypatch.setattr(ops_threshold, name,
                            lambda *a, _fn=fn, _n=name: calls.append(_n)
                            or _fn(*a))
    n = 1 << 19
    q = tt.quantize(torch.from_numpy(rng.random(n, dtype=np.float32) * 2 - 1),
                    4)
    want = {}
    for k in (64, 256, 257):
        calls.clear()
        got = tt.threshold(q, k)
        want[k] = calls[:]
        assert int((tt.unpack_nibbles(got.codes) != 0).sum()) == k
    assert want == {64: ["hist4_plain", "mask4_plain"],
                    256: ["hist4_plain", "mask4_plain"],
                    257: ["threshold4_plain"]}
    calls.clear()
    assert torch.equal(tt.threshold(q, 200).codes,
                       ops_threshold.threshold4_plain(q.codes, q.scales, 200))
    assert calls == ["hist4_plain", "mask4_plain", "threshold4_plain"]
    for length, ok in ((n - 128, False), (n, True), ((1 << 24) - 128, True),
                       (1 << 24, False)):
        assert hybrid4_eligible(tt.zeros_vector(4, length), 64) is ok, length
    stacked = tt.stack_vectors([tt.zeros_vector(4, n)] * 2)
    assert not hybrid4_eligible(stacked, 64)
    assert not hybrid4_eligible(tt.zeros_vector(8, n), 64)


def test_hybrid_reaches_its_kernels(monkeypatch):
    """On CUDA operands the hybrid launches hist4_cuda and mask4_cuda
    (counting stand-ins here, computing the plain results); the real
    wrappers refuse CPU tensors."""
    import clover_tpu_torch.ops.threshold as ops_threshold
    from clover_tpu_torch.kernels import (hist4_cuda, hist4_plain, mask4_cuda,
                                          mask4_plain)
    q = tt.quantize(torch.linspace(-1, 1, 1 << 19), 4)
    m7 = torch.ones(q.blocks)
    with pytest.raises(ValueError, match="CUDA"):
        hist4_cuda(q.codes)
    with pytest.raises(ValueError, match="CUDA"):
        mask4_cuda(q.codes, m7, torch.tensor(1.0), torch.tensor(3),
                   torch.zeros(q.blocks, dtype=torch.int64))
    calls = []
    monkeypatch.setattr(ops_threshold, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ops_threshold, "hist4_cuda",
                        lambda *a: calls.append("hist4") or hist4_plain(*a))
    monkeypatch.setattr(ops_threshold, "mask4_cuda",
                        lambda *a: calls.append("mask4") or mask4_plain(*a))
    got = tt.threshold(q, 100)
    assert calls == ["hist4", "mask4"]
    assert torch.equal(got.codes, threshold4_plain(q.codes, q.scales, 100))


# -- the kernel's select (csrc/threshold.cuh), modelled in NumPy ----------
# On the bytes and scales the kernel loads: slots of 16 index-contiguous
# elements (a 4-bit slot the low or the high nibbles of 16 bytes), one
# IEEE division a slot, three radix passes of 12, 10 and 10 bits with the
# one-pattern early exit (from the second pass on), the ties ranked in
# index order.

SEL_DIGITS = ((4096, 20), (1024, 10), (1024, 0))   # threshold.cuh passes


def _slot_bytes(codes: np.ndarray, bits: int):
    """(nq, 16) code bytes of each slot, and each slot's byte offset."""
    nq = codes.size * 8 // bits // 16
    g = np.arange(nq)
    off = (g >> 2) * 32 + 16 * (g & 1) if bits == 4 else g * 16
    return codes[off[:, None] + np.arange(16)], off


def _slot_codes(byts: np.ndarray, bits: int) -> np.ndarray:
    """Signed element codes of each slot (quarters q >= 2 of a 4-bit block
    take the high nibbles)."""
    b = byts.astype(np.int32)
    if bits == 8:
        return b
    high = (np.arange(b.shape[0]) & 3) >= 2
    return np.where(high[:, None], b >> 4, (b & 15) - 8)


def _select_passes(pat, k):
    """(tau, fill) from the patterns by the kernel's passes; -> also the
    passes run."""
    if k == 0:
        return 0xFFFFFFFF, 0, 0
    prefix, mask, kk = 0, 0, min(k, pat.size)
    for run, (bins, shift) in enumerate(SEL_DIGITS, 1):
        ps = pat[(pat & np.uint32(mask)) == prefix]
        if run > 1 and ps.min() == ps.max():    # one pattern left: tau
            return int(ps.min()), kk, run
        hist = np.bincount((ps >> shift) & (bins - 1), minlength=bins)
        cum = np.cumsum(hist[::-1])             # descending digits
        i = int(np.searchsorted(cum, kk))       # first bin reaching kk
        kk -= int(cum[i - 1]) if i else 0
        prefix |= (bins - 1 - i) << shift
        mask |= (bins - 1) << shift
    return prefix, kk, len(SEL_DIGITS)


def _select_model(codes: np.ndarray, scales: np.ndarray, k: int, bits: int):
    """The kernel's output bytes, and its passes."""
    qm = np.float32(7 if bits == 4 else 127)
    byts, off = _slot_bytes(codes.view(np.int8), bits)
    nq = byts.shape[0]
    g = np.arange(nq)
    m = scales[g >> 2].astype(np.float32) / qm       # one division a slot
    c = _slot_codes(byts, bits)
    # |code| as 2^23 + |code| - 2^23 in f32, times m
    mag = (np.abs(c) | 0x4B000000).astype(np.uint32).view(np.float32)
    pat = ((mag - np.float32(8388608.0)) * m[:, None]).view(np.uint32)
    tau, fill, runs = _select_passes(pat.ravel(), k)
    tie = (pat == tau).ravel()
    rank = np.cumsum(tie) - tie                 # in slot = index order
    keep = ((pat.ravel() > tau) | (tie & (rank < fill))).reshape(nq, 16)
    out = np.zeros(codes.size, np.uint8)
    b = byts.view(np.uint8)
    if bits == 8:
        out[off[:, None] + np.arange(16)] = np.where(keep, b, 0)
    else:
        lo_q = (g & 3) < 2                      # quarters writing bytes
        lo = np.where(keep[lo_q], b[lo_q] & 0x0F, 0x08)
        hi = np.where(keep[np.flatnonzero(lo_q) + 2], b[lo_q] & 0xF0, 0)
        out[off[lo_q][:, None] + np.arange(16)] = lo | hi
    return out.view(np.int8), runs


# blocks (scale a, scale b, code a, code b) whose values order one way with
# s / qmax divided in IEEE and tie with s * (1 / qmax): a multiply by the
# reciprocal keeps other elements
DIVISION_ORDER = {4: (1071573821, 1066704083, 2, 3),
                  8: (1061287518, 1073648478, 63, 24)}


def _select_cases(rng, n: int, bits: int, k: int):
    """(name, codes, scales): dense, tie storms, k > nnz, every code at
    the top magnitude, subnormal and vanishing s / qmax, and blocks whose
    order needs the IEEE division."""
    def q(v):
        t = tt.quantize(torch.from_numpy(v.astype(np.float32)), bits)
        return t.codes.numpy(), t.scales.numpy()
    storm = np.repeat(rng.random(n // 64), 64)
    sparse = np.zeros(n)
    sparse[rng.permutation(n)[:max(1, k // 2)]] = 1.0
    dense = q(rng.standard_normal(n))
    top = (7 if bits == 4 else 127) * np.where(rng.random(n) < 0.5, 1, -1)
    yield "dense", *dense
    yield "integer", *q(rng.integers(-3, 4, n))
    yield "storm", *q(storm)
    yield "one value", *q(np.full(n, 0.5))
    yield "k > nnz", *q(sparse)
    yield "top codes", *q(top * np.repeat(rng.random(n // 64) + 0.5, 64))
    yield "subnormal m", dense[0], np.full_like(dense[1], 1e-40)
    yield "m = 0", dense[0], np.full_like(dense[1], 1e-45)
    mixed = np.where(rng.random(n // 64) < 0.5, dense[1], dense[1] * 1e-39)
    yield "mixed subnormal", dense[0], mixed.astype(np.float32)
    sa, sb, ca, cb = DIVISION_ORDER[bits]
    pair = np.repeat(np.array([ca, cb], np.int8), 64)
    codes = torch.from_numpy(np.tile(pair, n // 128))
    if bits == 4:
        codes = tt.pack_nibbles(codes)
    scales = np.tile(np.array([sa, sb], np.uint32).view(np.float32), n // 128)
    yield "division order", codes.numpy(), scales


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [128, 1024, 16384, 16512])
def test_select_model_matches_plain(rng, bits, n):
    """The kernel's arithmetic, byte for byte the plain version's, at k in
    {0, 1, K, n} (k > nnz on the sparse case); n = 16512 leaves a partial last chunk of 1024
    slots (and 128 a CTA mostly idle)."""
    plain = (threshold4_plain if bits == 4 else
             lambda c, s, k: threshold8_plain(c, s, k, c.shape[0]))
    K = max(1, n // 4)
    for name, codes, scales in _select_cases(rng, n, bits, K):
        for k in (0, 1, K, n):
            got, _ = _select_model(codes, scales, k, bits)
            want = plain(torch.from_numpy(codes), torch.from_numpy(scales),
                         k).numpy()
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{name} k={k}")


def test_select_model_early_exit():
    """One value everywhere ends in the second pass; dense 4-bit data
    within three; ties at tau over several blocks fill in index order
    across both nibble halves."""
    rng = np.random.default_rng(7)
    codes, scales = next((c, s) for name, c, s in
                         _select_cases(rng, 1024, 4, 256) if name ==
                         "one value")
    out, runs = _select_model(codes, scales, 100, 4)
    assert runs == 2
    kept = tt.unpack_nibbles(torch.from_numpy(out)).numpy() != 0
    np.testing.assert_array_equal(kept, np.arange(1024) < 100)
    dense = tt.quantize(torch.from_numpy(rng.standard_normal(16384)
                                         .astype(np.float32)), 4)
    _, runs = _select_model(dense.codes.numpy(), dense.scales.numpy(),
                            4096, 4)
    assert runs <= 3
