"""One rank of the sharded-path checks in tests/test_torch_parallel.py (not
collected by pytest).  Eight of these form a gloo world on the CPU:

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT_DIR

Each rank builds the same inputs from seeded NumPy draws, runs the port's
sharded path on a 2x4 and an 8x1 mesh (clover_tpu_torch.parallel), and
saves what it saw to OUT_DIR/rank{RANK}.pt; the test compares those with
clover_tpu, which it runs on its 8-device CPU mesh.  The input makers
below are shared with the test, so both packages see the same bytes.
"""

import os
import sys
import time
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import clover_tpu_torch as tt  # noqa: E402
from clover_tpu_torch.formats import pack_nibbles  # noqa: E402

MESHES = ((2, 4), (8, 1))
SOLVES = (("iht", 4, 4), ("iht", 4, 8), ("iht", 8, 8), ("gd", 4, 8),
          ("gd", 4, 4))
ITERS, K, MU, SEED = 20, 32, 2e-3, 0
CHUNKS = (1, 3, 4)
ITER_BITS = ((4, 4), (4, 8))
THRESHOLD_KINDS = ("uniform", "ties")
THRESHOLD_N, THRESHOLD_K = 1024, 50
PSUM_SR_SEED = 123
SERVER_FAILING_RANK = 3       # its first local MVM of the server raises
SERVER_HEARTBEAT_S = 0.05


def solve_sizes(shape):
    """(m, n) of the solves on an R x C mesh: clover_tpu's dry run's."""
    r, c = shape
    return max(128 * r, 256), max(128 * c, 256)


def solve_problem(m: int, n: int, k: int = K):
    """clover_tpu's dry-run problem: Phi ~ U(-1, 1), a K-sparse 0/1 x*,
    y = Phi x* / max|Phi x*|."""
    rng = np.random.default_rng(0)
    phi = rng.random((m, n), dtype=np.float32) * 2 - 1
    x_star = np.zeros(n, np.float32)
    x_star[rng.permutation(n)[:k]] = 1.0
    y = phi @ x_star
    return phi, x_star, y / np.abs(y).max()


def integer_mvm_problem(m: int = 256, n: int = 512):
    """Integer codes in [-7, 7], scale 7 everywhere (tests/test_parallel.py
    _integer_mvm_problem): every partial is an exact integer."""
    rng = np.random.default_rng(7)
    return (rng.integers(-7, 8, (m, n)).astype(np.int8),
            rng.integers(-7, 8, n).astype(np.int8))


def integer_iteration_problem(m: int, n: int, mat_bits: int, vec_bits: int,
                              seed: int = 11):
    """tests/test_parallel.py _integer_iteration_problem's codes: the first
    IHT iteration is exact in any reduction order."""
    rng = np.random.default_rng(seed)
    qa = 7 if mat_bits == 4 else 127
    qv = 7 if vec_bits == 4 else 127
    ac = rng.integers(-qa, qa + 1, (m, n)).astype(np.int8)
    yc = rng.integers(-qv, qv + 1, m).astype(np.int8)
    yc[::64] = qv
    return ac, yc


def batch_codes(xc: np.ndarray) -> list:
    """Three integer vectors from one: itself, negated, rolled a block."""
    return [xc, -xc, np.roll(xc, 64)]


def threshold_data(kind: str) -> np.ndarray:
    """Uniform data (tests/test_parallel.py's), or integer values in
    [-3, 3]: storms of ties at every magnitude."""
    rng = np.random.default_rng(0)
    if kind == "uniform":
        return rng.random(THRESHOLD_N, dtype=np.float32) * 2 - 1
    return rng.integers(-3, 4, THRESHOLD_N).astype(np.float32)


def server_problem(shape):
    """A (128R x 128C) and three request vectors, clover_tpu's dry run's."""
    r, c = shape
    rng = np.random.default_rng(1)
    a = rng.random((128 * r, 128 * c), dtype=np.float32) * 2 - 1
    return a, [rng.random(128 * c, dtype=np.float32) * 2 - 1
               for _ in range(3)]


def int_matrix(codes: np.ndarray, bits: int):
    """A port matrix container of integer codes, scale = qmax per tile."""
    m, n = codes.shape
    q = 7.0 if bits == 4 else 127.0
    c = torch.from_numpy(codes)
    cls = tt.QMat4 if bits == 4 else tt.QMat8
    return cls(codes=pack_nibbles(c) if bits == 4 else c,
               scales=torch.full((m // 64, n // 64), q), rows=m, cols=n)


def int_vector(codes: np.ndarray, bits: int):
    n = codes.shape[0]
    q = 7.0 if bits == 4 else 127.0
    c = torch.from_numpy(codes)
    cls = tt.QVec4 if bits == 4 else tt.QVec8
    return cls(codes=pack_nibbles(c) if bits == 4 else c,
               scales=torch.full((n // 64,), q), length=n)


def leaves(q) -> dict:
    return ({"values": q.values} if q.bits in (16, 32)
            else {"codes": q.codes, "scales": q.scales})


def owned(obj):
    """``obj`` with every tensor copied into storage of its own (a gather
    over a dim of size 1 returns views of one buffer)."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: owned(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [owned(v) for v in obj]
    return obj


def run_solves(par, mesh, shape, res, rank):
    from clover_tpu_torch.parallel import solvers
    m, n = solve_sizes(shape)
    phi, x_star, y = solve_problem(m, n)
    xs = tt.QVec32(values=tt.formats.pad_vector(torch.from_numpy(x_star)),
                   length=n)
    for kind, ba, bx in SOLVES:
        qphi = tt.quantize(torch.from_numpy(phi), ba)
        qphit = tt.transpose(qphi)
        qy = tt.quantize(torch.from_numpy(y), bx)
        args = (par.shard_matrix(qphi, mesh),
                par.shard_matrix(qphit, mesh, transposed=True),
                par.shard_vector(qy, mesh, par.ROW))
        name = f"{kind} {ba}x{bx} {shape[0]}x{shape[1]}"
        if kind == "iht":
            got = solvers.iht(*args, ITERS, K, MU, mesh, generator=SEED,
                              x_star=xs)
        else:
            got = solvers.gd(*args, ITERS, MU, mesh, generator=SEED,
                             x_star=xs)
        res[name] = {"trace": got.trace, **leaves(got.x)}
        if rank == 0:
            single = (tt.iht(qphi, qphit, qy, ITERS, K, MU, generator=SEED,
                             x_star=xs) if kind == "iht" else
                      tt.gd(qphi, qphit, qy, ITERS, MU, generator=SEED,
                            x_star=xs))
            res[name]["single_trace"] = single.trace


def run_exact(par, mesh, res):
    """The exact-integer mvm_psum, its overlapped form, the replicas of an
    SR requant, one exact iteration, the global threshold."""
    from clover_tpu_torch.parallel import ops, solvers
    ac, xc = integer_mvm_problem()
    A = par.shard_matrix(int_matrix(ac, 4), mesh).local
    x = par.shard_vector(int_vector(xc, 4), mesh, par.COL).local
    y = ops.mvm_psum(A, x, par.COL, None, 32, par.ROW, mesh)
    res["psum"] = par.gather_vector(y, mesh, par.ROW, ac.shape[0]).values
    for chunks in CHUNKS:
        y = ops.mvm_psum_overlapped(A, x, par.COL, None, 32, par.ROW, mesh,
                                    chunks=chunks)
        res[f"overlapped {chunks}"] = par.gather_vector(
            y, mesh, par.ROW, ac.shape[0]).values
    try:
        ops.mvm_psum_overlapped(A, x, par.COL, None, 32, par.ROW, mesh,
                                chunks=2,
                                prepared=ops.prepare_psum_chunks(A, 1))
        res["overlapped wrong length raises"] = False
    except ValueError:
        res["overlapped wrong length raises"] = True
    q4 = ops.mvm_psum(A, x, par.COL, PSUM_SR_SEED, 4, par.ROW, mesh)
    res["psum sr"] = leaves(q4)
    res["row"] = mesh.get_local_rank(par.ROW)
    # the batched psum's SR requant: vector j is mvm_psum's with seed + j
    xs = par.shard_vector(tt.stack_vectors([
        int_vector(c, 4) for c in batch_codes(xc)]), mesh, par.COL).local
    yb = ops.mvm_batched_psum(A, xs, par.COL, PSUM_SR_SEED, 4, par.ROW, mesh)
    res["batched psum sr"] = leaves(yb)
    res["psum sr seed+j"] = [leaves(ops.mvm_psum(
        A, tt.vector_at(xs, j), par.COL, PSUM_SR_SEED + j, 4, par.ROW, mesh))
        for j in range(xs.codes.shape[0])]
    res["dot"] = ops.dot_psum(x, par.shard_vector(int_vector(
        batch_codes(xc)[1], 4), mesh, par.COL).local, par.COL, mesh)

    for ba, bx in ITER_BITS:
        m, n = 512, 1024
        acodes, ycodes = integer_iteration_problem(m, n, ba, bx)
        qa = int_matrix(acodes, ba)
        got = solvers.iht(par.shard_matrix(qa, mesh),
                          par.shard_matrix(tt.transpose(qa), mesh, True),
                          par.shard_vector(int_vector(ycodes, bx), mesh,
                                           par.ROW), 1, 64, 0.25, mesh)
        res[f"iteration {ba}x{bx}"] = leaves(got.x)

    for kind in THRESHOLD_KINDS:
        q = tt.quantize(torch.from_numpy(threshold_data(kind)), 8)
        local = par.shard_vector(q, mesh, par.COL).local
        out = ops.threshold_global(local, THRESHOLD_K, par.COL, mesh)
        res[f"threshold {kind}"] = leaves(par.gather_vector(
            out, mesh, par.COL, THRESHOLD_N))


def run_server(par, mesh, shape, res, rank):
    """The sharded server: idle for a few heartbeats, then two requests
    that must fail alone (a wrong padded length, a combination the MVM
    refuses), a batch whose local step fails on SERVER_FAILING_RANK, and
    the three requests of the round trip."""
    from clover_tpu_torch import serving
    a, vecs = server_problem(shape)
    qA = tt.quantize(torch.from_numpy(a), 4)
    real = serving.mvm_batched_f32_fast
    if rank == SERVER_FAILING_RANK:
        calls = []

        def fails_once(*args):
            calls.append(None)
            if len(calls) == 1:
                raise RuntimeError("a local failure")
            return real(*args)
        serving.mvm_batched_f32_fast = fails_once
    serving.HEARTBEAT_S = SERVER_HEARTBEAT_S
    try:
        server = serving.MVMServer(par.shard_matrix(qA, mesh), max_batch=4,
                                   max_wait_s=0.02, mesh=mesh)
    finally:
        serving.mvm_batched_f32_fast = real
    if rank == 0:
        def error(q):
            return server.submit(q).exception(timeout=120)
        quantized = [tt.quantize(torch.from_numpy(v), 4) for v in vecs]
        try:
            time.sleep(4 * SERVER_HEARTBEAT_S)
            res["server refused"] = [type(error(q)).__name__ for q in (
                tt.quantize(torch.from_numpy(vecs[0][:64]), 4),
                tt.quantize(torch.from_numpy(vecs[0]), 16))]
            res["server rank failure"] = str(error(quantized[0]))
            futs = [server.submit(q) for q in quantized]
            res["server"] = [leaves(f.result(timeout=120)) for f in futs]
        finally:
            server.close()


def main(rank: int, world: int, port: int, out: str) -> int:
    torch.set_num_threads(1)
    import torch.distributed as dist
    from clover_tpu_torch import parallel as par
    par.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    res = {"backend": dist.get_backend()}
    try:
        for shape in MESHES:
            mesh = par.make_mesh(shape=shape)
            run_solves(par, mesh, shape, res, rank)
            if shape == MESHES[0]:
                run_exact(par, mesh, res)
                run_server(par, mesh, shape, res, rank)
        res["imports jax"] = any(m == "jax" or m.startswith(("jax.",
                                                             "clover_tpu."))
                                 or m == "clover_tpu" for m in sys.modules)
        torch.save(owned(res), os.path.join(out, f"rank{rank}.pt"))
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)            # the other ranks wait in a collective
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                  sys.argv[4]))
