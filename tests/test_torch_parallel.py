"""clover_tpu_torch.parallel (the mesh-sharded path on torch.distributed)
against clover_tpu.parallel.

The port runs SPMD: the module fixture starts 8 gloo ranks on the CPU
(tests/torch_parallel_worker.py) once, each with a timeout of its own, and
collects what each saw; clover_tpu runs on the 8-device CPU mesh that
tests/conftest.py forces.  Both see the same bytes (seeded NumPy inputs,
deterministic quantization).

Tolerances, by case:
- the sharded IHT/GD (clover_tpu's 12 MULTICHIP configurations): SR solves
  whose psum order and per-shard SR streams differ from the single solve's,
  so the rules of tests/test_parallel.py:52-58: the first iteration within
  5% (+1e-4), the last within max(1.3x, +0.05) -- against the port's
  single-device solve and against clover_tpu's sharded trace;
- the exact-integer psum, its overlapped form, one exact iteration and
  the global threshold: bit for bit (every sum is an exact integer, or the
  selection is exact);
- the sharded server: codes within 1 LSB of the single-device MVM, scales
  within rtol 1e-5 (the psum changes the f32 sum order);
- replicas along the other mesh dim: bit for bit;
- a 1x1 mesh: bit for bit with tt.iht, SR on and off.
"""

import ast
import os
import socket
import subprocess
import sys
import time
from functools import cache
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
from clover_tpu.models.solvers import iht as jax_iht
from clover_tpu.parallel import make_mesh as jax_make_mesh
from clover_tpu.parallel import shard_matrix as jax_shard_matrix
from clover_tpu.parallel import shard_vector as jax_shard_vector
from clover_tpu.parallel.solvers import gd as jax_gd_sharded
from clover_tpu.parallel.solvers import iht as jax_iht_sharded
from clover_tpu_torch import parallel as par
from clover_tpu_torch.parallel import ops as pops
from torch_helpers import assert_within_lsb, element_codes, to_jax, to_torch
import torch_parallel_worker as W

WORKER = Path(__file__).with_name("torch_parallel_worker.py")
WORLD = 8
RANK_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the 8 ranks once; -> [rank r's results].  A rank that fails
    ends the others at once; each rank gets RANK_TIMEOUT_S."""
    out = tmp_path_factory.mktemp("ranks")
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               str(WORLD), port, str(out)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env) for r in range(WORLD)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or time.monotonic() > deadline:
                r = failed[0] if failed else 0
                pytest.fail(f"rank {r} {'failed' if failed else 'timed out'}"
                            f":\n{(out / f'rank{r}.log').read_text()[-4000:]}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    return [torch.load(out / f"rank{r}.pt", weights_only=True)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jax_make_mesh(8)


def _trajectory_rules(tp, ts):
    """tests/test_parallel.py:52-58 with ts the reference trace."""
    assert np.all(np.isfinite(tp))
    assert abs(tp[0] - ts[0]) <= 0.05 * ts[0] + 1e-4, (tp[0], ts[0])
    assert tp[-1] <= max(1.3 * ts[-1], ts[-1] + 0.05), (tp[-1], ts[-1])


@cache
def _jax_sharded_trace(kind, ba, bx, shape, size=None):
    """clover_tpu's sharded trace of one configuration (its dry run's, or
    at ``size``)."""
    mesh = jax_make_mesh(shape=shape)
    m, n = size or W.solve_sizes(shape)
    phi, x_star, y = W.solve_problem(m, n)
    qphi = ct.quantize(jnp.asarray(phi), ba)
    qphit = ct.transpose(qphi)
    qy = ct.quantize(jnp.asarray(y), bx)
    xs = ct.formats.QVec32(values=ct.formats.pad_vector(jnp.asarray(x_star)),
                           length=n)
    args = (jax_shard_matrix(qphi, mesh),
            jax_shard_matrix(qphit, mesh, transposed=True),
            jax_shard_vector(qy, mesh, "row"))
    key = jax.random.PRNGKey(W.SEED)
    if kind == "iht":
        res = jax_iht_sharded(*args, W.ITERS, W.K, W.MU, mesh, key=key,
                              x_star=xs)
    else:
        res = jax_gd_sharded(*args, W.ITERS, W.MU, mesh, key=key, x_star=xs)
    return np.asarray(res.trace)


SOLVE_CASES = [(kind, ba, bx, shape) for shape in W.MESHES
               for kind, ba, bx in W.SOLVES]


@pytest.mark.parametrize("kind,ba,bx,shape", SOLVE_CASES,
                         ids=[f"{k}-{a}x{b}-{s[0]}x{s[1]}"
                              for k, a, b, s in SOLVE_CASES])
def test_sharded_solve_matches(ranks, jax_mesh, kind, ba, bx, shape):
    """clover_tpu's 12 MULTICHIP configurations, the 10 solves: the
    sharded trace (replicated on every rank) against the port's single
    solve and clover_tpu's sharded trace."""
    got = ranks[0][f"{kind} {ba}x{bx} {shape[0]}x{shape[1]}"]
    tp = got["trace"].numpy()
    assert tp.shape == (W.ITERS,)
    for r in range(1, WORLD):
        np.testing.assert_array_equal(
            ranks[r][f"{kind} {ba}x{bx} {shape[0]}x{shape[1]}"]["trace"]
            .numpy(), tp)
    _trajectory_rules(tp, got["single_trace"].numpy())
    _trajectory_rules(tp, _jax_sharded_trace(kind, ba, bx, shape))
    if kind == "iht":
        x = tt.formats.VECTOR_TYPES[bx](codes=got["codes"],
                                        scales=got["scales"], length=1)
        assert np.count_nonzero(element_codes(x)) <= W.K


def test_sharded_solve_odd_shards(ranks, jax_mesh):
    """A 128x1024 IHT on the 2x4 mesh, whose Phi row shards (and y's) are
    64 long, held padded to 128: the trace replicated on every rank and
    within the regime rules of the single solve and clover_tpu's sharded
    trace, at most K kept."""
    (kind, ba, bx), shape = W.ODD_SOLVES[0], W.MESHES[0]
    name = W.solve_name(kind, ba, bx, shape, W.ODD_SIZE)
    got = ranks[0][name]
    tp = got["trace"].numpy()
    for r in range(1, WORLD):
        np.testing.assert_array_equal(ranks[r][name]["trace"].numpy(), tp)
    _trajectory_rules(tp, got["single_trace"].numpy())
    _trajectory_rules(tp, _jax_sharded_trace(kind, ba, bx, shape,
                                             W.ODD_SIZE))
    x = tt.formats.VECTOR_TYPES[bx](codes=got["codes"], scales=got["scales"],
                                    length=1)
    assert x.codes.shape == (W.ODD_SIZE[1] // 2,)
    assert np.count_nonzero(element_codes(x)) <= W.K


def _want_integer_psum():
    ac, xc = W.integer_mvm_problem()
    return (ac.astype(np.int64) @ xc.astype(np.int64)).astype(np.float32)


def test_mvm_psum_exact_cross_check(ranks):
    """The 12th configuration: bit-identical to the integer product."""
    for res in ranks:
        np.testing.assert_array_equal(res["psum"].numpy(),
                                      _want_integer_psum())


@pytest.mark.parametrize("chunks", W.CHUNKS)
def test_mvm_psum_overlapped_exact(ranks, chunks):
    for res in ranks:
        np.testing.assert_array_equal(res[f"overlapped {chunks}"].numpy(),
                                      _want_integer_psum())


def test_mvm_batched_psum_sr_is_per_vector_psum(ranks):
    """The batched psum's SR requant: vector j equals mvm_psum's with seed
    + j, bit for bit (the f32 sums are the single kernel's, and the folded
    seed is additive)."""
    for res in ranks:
        got = res["batched psum sr"]
        for j, want in enumerate(res["psum sr seed+j"]):
            assert torch.equal(got["codes"][j], want["codes"])
            assert torch.equal(got["scales"][j], want["scales"])


def test_dot_psum_exact(ranks):
    """The sharded dot of two integer vectors: the integer dot, exactly."""
    _, xc = W.integer_mvm_problem()
    want = np.float32(xc.astype(np.int64) @ W.batch_codes(xc)[1]
                      .astype(np.int64))
    for res in ranks:
        assert res["dot"].dtype == torch.float32 and res["dot"].dim() == 0
        assert float(res["dot"]) == want


def test_mvm_psum_overlapped_checks_prepared_length(ranks):
    assert all(res["overlapped wrong length raises"] for res in ranks)


def test_sharded_server_round_trip(ranks):
    """The ShardedMVMServer: 3 vectors, within 1 LSB of the single-device
    MVM (clover_tpu's and the port's)."""
    a, vecs = W.server_problem(W.MESHES[0])
    jA = ct.quantize(jnp.asarray(a), 4)
    got = ranks[0]["server"]
    assert len(got) == len(vecs)
    for leaves, v in zip(got, vecs):
        y = tt.QVec4(codes=leaves["codes"], scales=leaves["scales"],
                     length=a.shape[0])
        jx = ct.quantize(jnp.asarray(v), 4)
        assert_within_lsb(y, ct.mvm(jA, jx))
        assert_within_lsb(y, tt.mvm(to_torch(jA), to_torch(jx)))


def test_sharded_server_fails_a_request_alone(ranks):
    """A request of the wrong padded length and one of a combination the
    MVM refuses fail alone, before any collective, after the server sat
    idle for a few heartbeats; the requests after them are served
    (test_sharded_server_round_trip)."""
    assert ranks[0]["server refused"] == ["ValueError", "TypeError"]


def test_sharded_server_drops_a_batch_that_failed_on_a_rank(ranks):
    """A batch whose local MVM raised on one follower fails on the
    coordinator, naming that rank, and every rank stays in step for the
    next batch."""
    assert (f"rank(s) [{W.SERVER_FAILING_RANK}]"
            in ranks[0]["server rank failure"])


@pytest.mark.parametrize("ba,bx", W.ITER_BITS)
def test_sharded_iteration_exact_cross_check(ranks, ba, bx):
    """One sharded iteration on the exactness-by-construction problem,
    bit-identical to the port's single-device iteration and to
    clover_tpu's op sequence (mvm_axpy, mvm_axpy, threshold).  clover_tpu's
    jitted solve is compared in 4x8 only: in 4x4 XLA's fusion moves some
    of its band scales 1 ulp off its own ops', which flips absmax codes
    (ROADMAP's known gap), while every op of the sequence is exact."""
    acodes, ycodes = W.integer_iteration_problem(512, 1024, ba, bx)
    qa, qy = W.int_matrix(acodes, ba), W.int_vector(ycodes, bx)
    single = tt.iht(qa, tt.transpose(qa), qy, 1, 64, 0.25)
    jqa, jy = to_jax(qa), to_jax(qy)
    jx0 = ct.zeros_vector(bx, 1024)
    jt2 = ct.mvm_axpy(jqa, jx0, jy, -1.0)
    wants = [single.x, ct.threshold(ct.mvm_axpy(ct.transpose(jqa), jt2, jx0,
                                                0.25), 64)]
    if (ba, bx) == (4, 8):
        wants.append(jax_iht(jqa, ct.transpose(jqa), jy, 1, 64, 0.25,
                             key=None).x)
    for res in ranks:
        got = res[f"iteration {ba}x{bx}"]
        x = type(single.x)(codes=got["codes"], scales=got["scales"],
                           length=1024)
        for want in wants:
            np.testing.assert_array_equal(element_codes(x),
                                          element_codes(want))
            np.testing.assert_array_equal(x.scales.numpy(),
                                          np.asarray(want.scales))
    assert np.count_nonzero(element_codes(single.x)) == 64


@pytest.mark.parametrize("kind", W.THRESHOLD_KINDS)
def test_threshold_global_matches_single(ranks, kind):
    """The gathered top-K of an 8-bit vector over 4 col shards equals the
    single threshold, ties included (|value| desc, index asc)."""
    q = tt.quantize(torch.from_numpy(W.threshold_data(kind)), 8)
    want = tt.threshold(q, W.THRESHOLD_K)
    jwant = ct.threshold(to_jax(q), W.THRESHOLD_K)
    np.testing.assert_array_equal(want.codes.numpy(), np.asarray(jwant.codes))
    if kind == "ties":
        kept = want.codes.abs()
        assert (kept == kept[kept > 0].min()).sum() > 1    # a tie is cut
    for res in ranks:
        np.testing.assert_array_equal(res[f"threshold {kind}"]["codes"],
                                      want.codes.numpy())
        np.testing.assert_array_equal(res[f"threshold {kind}"]["scales"],
                                      want.scales.numpy())


@pytest.mark.parametrize("what", ["psum sr", "solutions"])
def test_replicas_bit_identical(ranks, what):
    """An output owned by ROW is computed by every col replica with a seed
    folded by the row only, so the replicas' bytes are equal; the gathered
    solutions are equal on all 8 ranks."""
    if what == "psum sr":
        by_row = {}
        for res in ranks:
            by_row.setdefault(res["row"], []).append(res["psum sr"])
        assert len(by_row) == W.MESHES[0][0]
        for reps in by_row.values():
            for r in reps[1:]:
                assert torch.equal(r["codes"], reps[0]["codes"])
                assert torch.equal(r["scales"].view(torch.int32),
                                   reps[0]["scales"].view(torch.int32))
        return
    for name in (f"{k} {a}x{b} {s[0]}x{s[1]}" for k, a, b, s in SOLVE_CASES):
        for res in ranks[1:]:
            assert torch.equal(res[name]["codes"], ranks[0][name]["codes"])
            assert torch.equal(res[name]["scales"], ranks[0][name]["scales"])


def test_ranks_use_gloo_and_no_jax(ranks):
    assert all(res["backend"] == "gloo" for res in ranks)
    assert not any(res["imports jax"] for res in ranks)


class _Stub:
    """A mesh of the given shape seen from position ``at``."""
    mesh_dim_names = (par.ROW, par.COL)

    def __init__(self, shape, at):
        self.shape, self.at = shape, at

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, axis):
        return self.at[self.mesh_dim_names.index(axis)]


@pytest.mark.parametrize("seed", [0, 1, -1, 77, 2**31 - 1, -2**31,
                                  1234567891])
def test_axis_key_matches_reference(jax_mesh, seed):
    """The port's folded seed equals clover_tpu's axis_key at positions
    0-7 (a 1x8 mesh), wrap-around included."""
    from jax.sharding import PartitionSpec as P
    from clover_tpu.parallel.ops import axis_key as jax_axis_key
    from clover_tpu.parallel.solvers import _shard_map
    mesh18 = jax_make_mesh(shape=(1, 8))
    fn = _shard_map(lambda d: jax_axis_key(jnp.int32(seed) + d[0] * 0,
                                           "col").reshape(1),
                    mesh18, (P("col"),), P("col"))
    want = np.asarray(jax.jit(fn)(jnp.zeros(8, jnp.int32)))
    got = [pops.axis_key(seed, par.COL, _Stub((1, 8), (0, i)))
           for i in range(8)]
    assert got == want.tolist()
    assert pops.axis_key(None, par.COL, _Stub((1, 8), (0, 3))) is None


def _jax_shards(arr, mesh) -> dict:
    """clover_tpu's shard of ``arr`` at each mesh position (r, c)."""
    where = {d: rc for rc, d in np.ndenumerate(mesh.devices)}
    return {where[s.device]: np.asarray(s.data)
            for s in arr.addressable_shards}


@pytest.mark.parametrize("case", ["matrix 4", "matrix 8", "vector 4",
                                  "not a multiple of 64"])
def test_shard_refuses_unaligned_blocks(jax_mesh, monkeypatch, case):
    """Shard sides must be multiples of 64, as clover_tpu asks.  A side
    that is an odd multiple of 64 (a 128x1024 matrix's row shards on a 2x4
    mesh, its 128-long y's) is held padded to 128: the block equal to
    clover_tpu's shard at every position, zero codes and scales 1.0 in the
    pad, the logical sides the block's.  A side of 96 is refused by both."""
    from clover_tpu_torch.parallel import multihost
    monkeypatch.setattr(multihost, "local_device",
                        lambda: torch.device("cpu"))
    mesh = jax_make_mesh(shape=(2, 4))
    if case == "not a multiple of 64":
        q = tt.quantize(torch.zeros(384), 4)
        with pytest.raises(ValueError, match="divisible"):
            par.shard_vector(q, _Stub((2, 4), (0, 0)), par.COL)
        with pytest.raises(AssertionError, match="divisible"):
            jax_shard_vector(to_jax(q), mesh, "col")
        return
    kind, bits = case.split()
    bits = int(bits)
    rng = np.random.default_rng(5)
    zero = 0x08 if bits == 4 else 0
    if kind == "matrix":
        jq = ct.quantize(jnp.asarray(rng.random((128, 1024), np.float32)
                                     * 2 - 1), bits)
        sharded = jax_shard_matrix(jq, mesh)
        width = 256 * bits // 8
    else:
        jq = ct.quantize(jnp.asarray(rng.random(128, np.float32) * 2 - 1),
                         bits)
        sharded = jax_shard_vector(jq, mesh, "row")
        width = 64 * bits // 8
    codes, scales = (_jax_shards(sharded.codes, mesh),
                     _jax_shards(sharded.scales, mesh))
    for (r, c), want in codes.items():
        at = _Stub((2, 4), (r, c))
        if kind == "matrix":
            s = par.shard_matrix(to_torch(jq), at)
            local = s.local
            assert (local.rows, local.cols, s.rows, s.cols) == (64, 256, 128,
                                                                1024)
            assert local.codes.shape == (128, width)
            np.testing.assert_array_equal(local.codes[:64].numpy(), want)
            np.testing.assert_array_equal(local.scales[:1].numpy(),
                                          scales[r, c])
            pad_codes, pad_scales = local.codes[64:], local.scales[1:]
        else:
            s = par.shard_vector(to_torch(jq), at, par.ROW)
            local = s.local
            assert (local.length, s.length) == (64, 128)
            assert local.codes.shape == (2 * width,)
            np.testing.assert_array_equal(local.codes[:width].numpy(), want)
            np.testing.assert_array_equal(local.scales[:1].numpy(),
                                          scales[r, c])
            pad_codes, pad_scales = local.codes[width:], local.scales[1:]
        assert bool((pad_codes == zero).all())
        assert bool((pad_scales == 1.0).all())


@pytest.fixture(scope="module")
def world_of_one():
    """A process group of one rank in this process, on the CPU."""
    import torch.distributed as dist
    par.initialize(device="cpu")
    yield par.make_mesh()
    dist.destroy_process_group()


@pytest.mark.parametrize("bits", [4, "4x8"])
def test_sharded_1x1_bitidentical_to_single(world_of_one, bits):
    """On a 1x1 mesh the sharded solver is the single-device solve: trace
    and solution bit-identical to tt.iht, SR on and off."""
    mesh = world_of_one
    assert tuple(mesh.shape) == (1, 1)
    phi, x_star, y = W.solve_problem(256, 512, 32)
    ba, bx = (4, 8) if bits == "4x8" else (4, 4)
    xs = tt.QVec32(values=tt.formats.pad_vector(torch.from_numpy(x_star)),
                   length=512)
    for gen in (None, 3):
        qphi = tt.quantize(torch.from_numpy(phi), ba)
        qphit = tt.transpose(qphi)
        qy = tt.quantize(torch.from_numpy(y), bx)
        single = tt.iht(qphi, qphit, qy, 10, 32, 0.0042, generator=gen,
                        x_star=xs)
        shard = par.solvers.iht(par.shard_matrix(qphi, mesh),
                                par.shard_matrix(qphit, mesh, True),
                                par.shard_vector(qy, mesh, par.ROW), 10, 32,
                                0.0042, mesh, generator=gen, x_star=xs)
        assert torch.equal(shard.trace, single.trace)
        assert torch.equal(shard.x.codes, single.x.codes)
        assert torch.equal(shard.x.scales, single.x.scales)
        assert shard.x.length == single.x.length == 512


def test_sharded_perf_rows_on_one_rank(world_of_one):
    """-p --sharded on a world of one (CPU): every row, and the sharded
    IHT bit-identical to the single solve."""
    from clover_tpu_torch.harness.perf import bench_sharded
    lines = []
    bench_sharded(lines.append, sizes=(256,), iht_size=(256, 512),
                  device="cpu")
    out = "\n".join(lines)
    for row in ("mvm 4x4 direct n=256", "mvm_psum 4x4 n=256 1x1",
                "mvm_psum-ovl4 4x4 n=256 1x1", "IHT 4-bit single 256x512",
                "IHT 4-bit sharded 256x512 1x1"):
        assert row in out, out
    assert "sharded solution bit-identical to the single solve" in out


def test_parallel_imports_neither_jax_nor_reference():
    """No module of clover_tpu_torch/parallel imports jax or clover_tpu."""
    root = Path(tt.__file__).parent / "parallel"
    for path in sorted(root.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "clover_tpu"), (path.name, name)
