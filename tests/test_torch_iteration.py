"""clover_tpu_torch whole-iteration and chained-iteration kernels (their
plain versions, on the CPU) against clover_tpu's iteration_pallas and
iteration_chain_pallas (interpret mode), the eligibility rule against
clover_tpu's, the solver's dispatch, and the cooperative-launch guard.

Tolerances.  The port's plain versions are its unfused sequence bit for
bit (asserted).  Against the TPU kernels the MVM contract is 1 output LSB
(tests/test_torch_mvm.py); over a whole iteration the two packages' 1-LSB
differences are everywhere at these sizes (the TPU kernels combine scales
as sA*sx/(qA*qx), the port as (sA/qA)*(sx/qx)), and a 1-LSB flip of an
intermediate band's absmax code moves the next AXPY band scale by
|alpha| s1/qO (the floor boundary of ROADMAP queue 3).  So a whole
iteration is held element by element: every restored value within 1.5
output steps of the larger of the two band steps (measured: at most 1.39
over 24 instances), every band scale within 10% (measured: at most 6.2%).
After a threshold a 1-LSB difference can swap a kept element, so a chain
is held by its kept support (at least 85% shared; measured 87.5-100% over
20 instances) and its restored vector (relative l2 distance below 0.25 at
8 bits, 0.6 at 4 bits, where one swapped element of code 7 weighs more;
measured at most 0.17 and 0.47).
"""

import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.kernels.iteration import (
    iteration_chain_pallas, iteration_chain_pallas_eligible, iteration_pallas,
    iteration_pallas_eligible,
)
from clover_tpu_torch.kernels import iteration as fused
from clover_tpu_torch.kernels import seed_from
from clover_tpu_torch.models import solvers
from torch_helpers import assert_same, element_codes, to_torch

MU = 1e-3
SIZES = [(512, 1024), (1024, 512)]


def _problem(rng, m, n, vb):
    """clover_tpu's test_kernels iteration problem: 4-bit Phi, y = Phi v
    scaled to absmax 1, dense x."""
    phi = rng.random((m, n), dtype=np.float32) * 2 - 1
    yv = phi @ (rng.random(n, dtype=np.float32) * 2 - 1)
    yv = yv / np.abs(yv).max()
    xv = rng.random(n, dtype=np.float32) * 2 - 1
    qphi = ct.quantize(jnp.asarray(phi), 4)
    return (qphi, ct.transpose(qphi), ct.quantize(jnp.asarray(yv), vb),
            ct.quantize(jnp.asarray(xv), vb))


def _pairs(*qs):
    return [(q.codes, q.scales) for q in qs]


def _vec(pair, bits, length):
    cls = tt.QVec4 if bits == 4 else tt.QVec8
    return cls(codes=pair[0], scales=pair[1], length=length)


def _restored(q) -> np.ndarray:
    qo = 7.0 if q.bits == 4 else 127.0
    scales = np.asarray(q.scales, np.float64)
    return element_codes(q) * np.repeat(scales / qo, 64), scales


@pytest.mark.parametrize("vb", [4, 8])
@pytest.mark.parametrize("m,n", SIZES)
def test_iteration_plain_matches_pallas(rng, m, n, vb):
    jargs = _problem(rng, m, n, vb)
    Phi, PhiT, y, x = (to_torch(q) for q in jargs)
    got = _vec(fused.iteration_plain(4, vb, *_pairs(Phi, PhiT, y, x), MU),
               vb, n)
    # the port's iteration is its two fused legs, bit for bit
    assert_same(got, tt.mvm_axpy(PhiT, tt.mvm_axpy(Phi, x, y, -1.0), x, MU))
    want = iteration_pallas(*jargs, MU)
    rg, sg = _restored(got)
    rw, sw = _restored(want)
    step = np.repeat(np.maximum(sg, sw) / (7.0 if vb == 4 else 127.0), 64)
    assert np.all(np.abs(rg - rw) <= 1.5 * step)
    np.testing.assert_allclose(sg, sw, rtol=0.1)


@pytest.mark.parametrize("noise", [False, True], ids=["det", "SR"])
@pytest.mark.parametrize("k", [64, None], ids=["iht", "gd"])
@pytest.mark.parametrize("chain", [2, 4])
@pytest.mark.parametrize("vb", [4, 8])
def test_iteration_chain_plain_is_the_unfused_sequence(rng, vb, chain, k,
                                                       noise):
    """[iteration_plain -> ops.threshold] x chain, bit for bit, with the
    seeds s[4 it : 4 it + 4] of iteration it."""
    Phi, PhiT, y, x = (to_torch(q) for q in _problem(rng, 512, 1024, vb))
    seeds = [1000 + 7 * j for j in range(4 * chain)]
    got = fused.iteration_chain_plain(4, vb, *_pairs(Phi, PhiT, y, x), MU, k,
                                      seeds, (noise,) * 4)
    want = x
    for it in range(chain):
        want = _vec(fused.iteration_plain(
            4, vb, *_pairs(Phi, PhiT, y, want), MU, seeds[4 * it:4 * it + 4],
            (noise,) * 4), vb, 1024)
        if k is not None:
            want = tt.threshold(want, k)
    assert_same(_vec(got, vb, 1024), want)
    if k is not None:
        assert int((element_codes(want) != 0).sum()) <= k


@pytest.mark.parametrize("vb", [4, 8])
@pytest.mark.parametrize("m,n", SIZES)
def test_iteration_chain_plain_matches_pallas(rng, m, n, vb):
    k = 64
    jargs = _problem(rng, m, n, vb)
    Phi, PhiT, y, x = (to_torch(q) for q in jargs)
    got = _vec(fused.iteration_chain_plain(4, vb, *_pairs(Phi, PhiT, y, x),
                                           MU, k, [0] * 8), vb, n)
    want = iteration_chain_pallas(*jargs, MU, k, (None,) * 8, chain=2)
    cg, cw = element_codes(got), element_codes(want)
    assert (cg != 0).sum() <= k and (cw != 0).sum() <= k
    assert ((cg != 0) & (cw != 0)).sum() >= 0.85 * k
    rg, rw = _restored(got)[0], _restored(want)[0]
    assert np.linalg.norm(rg - rw) <= (0.6 if vb == 4 else 0.25) * \
        np.linalg.norm(rw)


def _containers(m, n, mb, vb, *, ylen=None, xlen=None, pt=None):
    """Shape-only containers of both packages (meta tensors and JAX shape
    structs), with the option of a wrong y/x length or PhiT shape."""
    mp, np_ = tt.pad_to(m), tt.pad_to(n)
    ylen, xlen = ylen or m, xlen or n
    ptr, ptc = pt or (np_, mp)

    def mat(pkg, rows_pad, cols_pad, rows, cols):
        w = cols_pad * mb // 8
        if pkg == "jax":
            codes = jax.ShapeDtypeStruct((rows_pad, w), jnp.int8)
            scales = jax.ShapeDtypeStruct((rows_pad // 64, cols_pad // 64),
                                          jnp.float32)
            return getattr(ct.formats, f"QMat{mb}")(codes, scales, rows, cols)
        codes = torch.empty(rows_pad, w, dtype=torch.int8, device="meta")
        scales = torch.empty(rows_pad // 64, cols_pad // 64, device="meta")
        return getattr(tt, f"QMat{mb}")(codes, scales, rows, cols)

    def vec(pkg, length):
        npad = tt.pad_to(length)
        if pkg == "jax":
            codes = jax.ShapeDtypeStruct((npad * vb // 8,), jnp.int8)
            scales = jax.ShapeDtypeStruct((npad // 64,), jnp.float32)
            return getattr(ct.formats, f"QVec{vb}")(codes, scales, length)
        codes = torch.empty(npad * vb // 8, dtype=torch.int8, device="meta")
        return getattr(tt, f"QVec{vb}")(codes, torch.empty(
            npad // 64, device="meta"), length)

    return [(mat(p, mp, np_, m, n), mat(p, ptr, ptc, n, m), vec(p, ylen),
             vec(p, xlen)) for p in ("jax", "torch")]


ELIGIBILITY_SIZES = [384, 512, 1000, 1024, 1536, 2048, 4096, 8192, 8704,
                     16384]


@pytest.mark.parametrize("mb,vb", [(4, 4), (4, 8), (8, 8)])
def test_eligibility_matches_jax(mb, vb):
    """The port's rule is clover_tpu's predicates, case for case, over a
    grid of sizes, and for a wrong PhiT, y or x."""
    cases, eligible = 0, 0
    for m in ELIGIBILITY_SIZES:
        for n in ELIGIBILITY_SIZES:
            variants = [{}]
            if (m, n) == (512, 1024):
                variants += [{"ylen": 500}, {"xlen": 1000},
                             {"pt": (1024, 1024)}]
            for kw in variants:
                jx, tx = _containers(m, n, mb, vb, **kw)
                want = iteration_pallas_eligible(*jx)
                assert fused.iteration_eligible(*tx) == want, (m, n, kw)
                for k in (None, 0, 1, 64, n - 1, n):
                    assert fused.iteration_chain_eligible(*tx, k) == \
                        iteration_chain_pallas_eligible(*jx, k), (m, n, kw, k)
                cases += 1
                eligible += want
    # 8x8 never; 4x4 and 4x8 at sides 512 ... 8192 in steps of 512
    assert eligible == (0 if mb == vb == 8 else 49), (cases, eligible)


class _Spy:
    """Counts the plain whole-iteration calls, telling the solver's own
    from those inside a chain."""

    def __init__(self, monkeypatch):
        self.direct = self.in_chain = self.chains = 0
        self._depth = 0
        one, chain = fused.iteration_plain, fused.iteration_chain_plain

        def iteration_plain(*a, **kw):
            if self._depth:
                self.in_chain += 1
            else:
                self.direct += 1
            return one(*a, **kw)

        def iteration_chain_plain(*a, **kw):
            self.chains += 1
            self._depth += 1
            try:
                return chain(*a, **kw)
            finally:
                self._depth -= 1

        monkeypatch.setattr(fused, "iteration_plain", iteration_plain)
        monkeypatch.setattr(fused, "iteration_chain_plain",
                            iteration_chain_plain)


def _unchained(Phi, PhiT, y, x, iters, k, mu, seed0):
    """The solver loop through the unfused ops."""
    for it in range(iters):
        s = solvers._op_seeds(None if seed0 is None else solvers.wrap_i32(
            seed0 + it * solvers.SEED_GOLD))
        t2 = tt.mvm_axpy(Phi, x, y, -1.0, s[0], s[1])
        x = tt.mvm_axpy(PhiT, t2, x, mu, s[2], s[3])
        if k is not None:
            x = tt.threshold(x, k)
    return x


@pytest.mark.parametrize("seed", [None, 77], ids=["det", "SR"])
@pytest.mark.parametrize("k", [64, None], ids=["iht", "gd"])
@pytest.mark.parametrize("vb", [4, 8])
def test_solver_chains_then_runs_the_tail(rng, monkeypatch, vb, k, seed):
    """An untraced 6-iteration solve is one chain of ITER_CHAIN = 4 plus 2
    unchained whole iterations, equal bit for bit to the unfused loop; a
    traced solve never chains."""
    Phi, PhiT, y, _ = (to_torch(q) for q in _problem(rng, 512, 1024, vb))
    x0 = tt.zeros_vector(vb, 1024)
    spy = _Spy(monkeypatch)
    if k is None:
        got = tt.gd(Phi, PhiT, y, 6, MU, generator=seed)
    else:
        got = tt.iht(Phi, PhiT, y, 6, k, MU, generator=seed)
    assert (spy.chains, spy.in_chain, spy.direct) == (1, 4, 2)
    seed0 = None if seed is None else seed_from(seed)[0]
    assert_same(got.x, _unchained(Phi, PhiT, y, x0, 6, k, MU, seed0))
    spy.chains = spy.in_chain = spy.direct = 0
    xs = tt.QVec32(values=torch.zeros(1024), length=1024)
    traced = tt.iht(Phi, PhiT, y, 6, 64, MU, generator=seed, x_star=xs)
    assert (spy.chains, spy.in_chain, spy.direct) == (0, 0, 6)
    if k is not None:
        assert_same(traced.x, got.x)


def test_solver_keeps_the_unfused_path_where_not_eligible(rng, monkeypatch):
    """8x8 and a 384-row Phi run the two fused legs and the threshold."""
    spy = _Spy(monkeypatch)
    for m, n, bits in ((512, 1024, 8), (384, 1024, 4)):
        phi = torch.from_numpy(rng.random((m, n), dtype=np.float32) * 2 - 1)
        q = tt.quantize(phi, bits)
        yq = tt.quantize(phi @ torch.ones(n), bits)
        tt.iht(q, tt.transpose(q), yq, 5, 64, MU)
    assert (spy.chains, spy.in_chain, spy.direct) == (0, 0, 0)


def test_cooperative_grid_guard(monkeypatch):
    """Both kernels' grid is a cluster of CHAIN_CLUSTER CTAs per band capped
    by the co-resident CTAs, in whole clusters; a grid that does not fit
    raises with the numbers, and nothing falls back."""
    capacity = {"n": 3}
    monkeypatch.setattr(fused, "co_resident",
                        lambda *_a: capacity["n"])
    dev = torch.device("cuda", 0)
    c = fused.CHAIN_CLUSTER
    for chained, kind in ((False, "iteration"), (True, "chained iteration")):
        capacity["n"] = 7 * c + 1
        assert fused.launch_grid(dev, 4, 4, chained, bands=16) == 7 * c
        assert fused.launch_grid(dev, 4, 8, chained, bands=2) == 2 * c
        assert fused.launch_grid(dev, 4, 4, chained, bands=16, grid=c) == c
        with pytest.raises(ValueError, match=f"whole clusters of {c} CTAs"):
            fused.launch_grid(dev, 4, 4, chained, bands=16, grid=c + 1)
        with pytest.raises(RuntimeError, match=rf"cooperative launch of "
                           rf"{8 * c} CTAs of the 4x4 {kind} kernel: "
                           rf"{7 * c + 1} fit on cuda:0 at once"):
            fused.launch_grid(dev, 4, 4, chained, bands=16, grid=8 * c)
        capacity["n"] = c - 1
        with pytest.raises(RuntimeError, match=f"{c - 1} fit on cuda:0"):
            fused.launch_grid(dev, 4, 4, chained, bands=16)
        capacity["n"] = 0
        with pytest.raises(RuntimeError, match="0 fit on cuda:0"):
            fused.launch_grid(dev, 4, 8, chained, bands=16)


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    """The wrappers launch or raise; a CPU tensor is not taken to the
    plain version behind the caller's back."""
    Phi, PhiT, y, x = (to_torch(q) for q in _problem(rng, 512, 1024, 4))
    ops = _pairs(Phi, PhiT, y, x)
    with pytest.raises(ValueError, match="CUDA"):
        fused.iteration_cuda(4, 4, *ops, MU)
    with pytest.raises(ValueError, match="CUDA"):
        fused.iteration_chain_cuda(4, 4, *ops, MU, 64, [0] * 16)
    with pytest.raises(ValueError, match="4x4 and 4x8"):
        fused.iteration_cuda(8, 8, *ops, MU)
    assert fused.iteration_cuda.launches == 0
    assert fused.iteration_chain_cuda.launches == 0


CSRC = Path(fused.__file__).resolve().parent.parent / "csrc"


def _constant(source: str, name: str) -> str:
    return re.search(rf"constexpr int {name} = ([^;]+);",
                     (CSRC / source).read_text()).group(1)


def test_chain_geometry_covers_every_row_once():
    """csrc/iteration.cu chain_leg: cluster c of CHAIN_CLUSTER CTAs takes
    bands c, c + clusters, ...; CTA rank r the band's rows
    MV_WARPS * CHAIN_ROWS * r + CHAIN_ROWS * w ... for warp w.  Every
    (band, row) is summed by exactly one warp at every grid the wrapper
    can launch, and the Python cluster size is the source's."""
    rows = int(_constant("iteration.cu", "CHAIN_ROWS"))
    warps = int(_constant("mvm.cuh", "MV_WARPS"))
    assert _constant("iteration.cu", "CHAIN_CLUSTER") == \
        "MV_ROWS / CHAIN_ROWS"
    assert _constant("mvm.cuh", "MV_ROWS") == "64 / MV_WARPS"
    cluster = 64 // warps // rows
    assert cluster == fused.CHAIN_CLUSTER
    for bands in (1, 8, 16, 64, 128):
        for clusters in (1, 7, 64, 66):
            cover = np.zeros((bands, 64), np.int64)
            for cta in range(clusters * cluster):
                rank = cta % cluster
                for band in range(cta // cluster, bands, clusters):
                    for w in range(warps):
                        first = rank * warps * rows + w * rows
                        cover[band, first:first + rows] += 1
            assert (cover == 1).all(), (bands, clusters)


# the H100's co-resident CTAs of both iteration kernels (132 SMs, 2 CTAs an
# SM; chip_smoke.py phase 2 prints them)
H100_CTAS = 264


@pytest.mark.parametrize("m,n", [(512, 1024), (2048, 4096), (4096, 8192)])
def test_iteration_geometry_covers_every_row_once(monkeypatch, m, n):
    """csrc/iteration.cu iteration_kernel runs both legs through chain_leg:
    every (band, row) of leg A (Phi's m / 64 bands) and of leg B (PhiT's
    n / 64) is summed by exactly one warp, at 1, 7 and the default number
    of clusters (launch_grid's on the H100's co-resident CTAs)."""
    src = (CSRC / "iteration.cu").read_text()
    body = src[src.index("iteration_kernel(const"):
               src.index("iteration_chain_kernel(const")]
    assert body.count("chain_leg<BA, BX, LegALoads>(m_pad, phi,") == 1
    assert body.count("chain_leg<BA, BX, Leg") == 3   # leg B: t2 copied or not
    rows = int(_constant("iteration.cu", "CHAIN_ROWS"))
    warps = int(_constant("mvm.cuh", "MV_WARPS"))
    cluster = 64 // warps // rows
    assert cluster == fused.CHAIN_CLUSTER
    monkeypatch.setattr(fused, "co_resident", lambda *_a: H100_CTAS)
    default = fused.launch_grid(torch.device("cuda", 0), 4, 4, False,
                                max(m, n) // 64) // cluster
    assert default == min(max(m, n) // 64, H100_CTAS // cluster)
    for clusters in (1, 7, default):
        for bands in (m // 64, n // 64):
            cover = np.zeros((bands, 64), np.int64)
            for cta in range(clusters * cluster):
                rank = cta % cluster
                for band in range(cta // cluster, bands, clusters):
                    for w in range(warps):
                        first = rank * warps * rows + w * rows
                        cover[band, first:first + rows] += 1
            assert (cover == 1).all(), (bands, clusters)
