"""clover_tpu_torch MVMServer (plain versions on the CPU) against per-request
``tt.mvm`` and clover_tpu's server.

A served result is the batched MVM's row, which equals ``tt.mvm`` bit for
bit; against clover_tpu's server the codes agree within 1 LSB (f32 block
sums in another order).  Every wait is bounded, so no test can hang.
"""

import sys
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clover_tpu as ct
import clover_tpu_torch as tt
import clover_tpu_torch.serving as serving
from clover_tpu.serving import MVMServer as JaxServer
from clover_tpu_torch import tracing
from clover_tpu_torch.kernels import MAX_BATCH, seed_from, wrap_i32
from clover_tpu_torch.parallel import ShardedMVMServer
from clover_tpu_torch.serving import MVMServer
from torch_helpers import assert_same, assert_within_lsb, to_torch

WAIT = 60


def _problem(rng, m, n, bits_a, bits_x, count):
    A = rng.random((m, n), dtype=np.float32) * 2 - 1
    jA = ct.quantize(jnp.asarray(A), bits_a)
    jvecs = [ct.quantize(jnp.asarray(rng.random(n, dtype=np.float32) * 2 - 1),
                         bits_x) for _ in range(count)]
    return jA, jvecs


@pytest.mark.parametrize("bits_a,bits_x", [(4, 4), (4, 8), (8, 8)])
def test_server_matches_mvm_and_jax_server(rng, bits_a, bits_x):
    jA, jvecs = _problem(rng, 128, 256, bits_a, bits_x, 10)
    A, vecs = to_torch(jA), [to_torch(v) for v in jvecs]
    server = MVMServer(A, max_batch=4, max_wait_s=0.01)
    try:
        results = [f.result(timeout=WAIT)
                   for f in [server.submit(v) for v in vecs]]
    finally:
        server.close()
    jserver = JaxServer(jA, max_batch=4, max_wait_s=0.01)
    try:
        jresults = [f.result(timeout=WAIT)
                    for f in [jserver.submit(v) for v in jvecs]]
    finally:
        jserver.close()
    for x, got, want in zip(vecs, results, jresults):
        assert_same(got, tt.mvm(A, x))
        assert_within_lsb(got, want)


def _serve_one_batch(monkeypatch, vecs, generator=None):
    """Serve ``vecs`` as one batch; -> (the stacked batches the MVM saw,
    the results)."""
    seen = []
    real = serving.mvm_batched

    def record(A, xs, seed):
        seen.append(xs)
        return real(A, xs, seed)

    monkeypatch.setattr(serving, "mvm_batched", record)
    A = tt.quantize(torch.rand(128, 256) * 2 - 1, 4)
    server = MVMServer(A, max_batch=8, max_wait_s=1.0, generator=generator)
    try:
        futures = [server.submit(v) for v in vecs]
        results = [f.result(timeout=WAIT) for f in futures]
    finally:
        server.close()
    return A, seen, results


def test_server_pads_short_batches_to_the_bucket(monkeypatch):
    """A batch of three requests runs as three vectors, not padded to a
    bucket of 4."""
    vecs = [tt.quantize(torch.linspace(-1, j + 1, 256), 4) for j in range(3)]
    A, seen, results = _serve_one_batch(monkeypatch, vecs)
    assert [xs.codes.shape[0] for xs in seen] == [3]
    for j, (x, y) in enumerate(zip(vecs, results)):
        assert torch.equal(seen[0].codes[j], x.codes)
        assert_same(y, tt.mvm(A, x))


def test_a_batch_rounds_vector_j_with_seed_plus_j(monkeypatch):
    """With a generator, a batch of three draws one seed and vector j's
    answer is ``tt.mvm`` with that seed + j."""
    vecs = [tt.quantize(torch.linspace(-1, j + 1, 256), 4) for j in range(3)]
    A, seen, results = _serve_one_batch(
        monkeypatch, vecs, torch.Generator().manual_seed(7))
    assert [xs.codes.shape[0] for xs in seen] == [3]
    seed = seed_from(torch.Generator().manual_seed(7))[0]
    for j, (x, y) in enumerate(zip(vecs, results)):
        assert_same(y, tt.mvm(A, x, wrap_i32(seed + j)))


def test_lone_client_skips_the_straggler_wait():
    """A lone client's first request waits out ``max_wait_s``; once that
    wait has collected nothing, each later request with nothing queued
    behind it is served at once."""
    A = tt.quantize(torch.rand(128, 256) * 2 - 1, 4)
    vecs = [tt.quantize(torch.linspace(-1, j + 1, 256), 4) for j in range(5)]
    server = MVMServer(A, max_batch=8, max_wait_s=1.0)
    before = tracing.counters().get("server.waits_skipped", 0)
    try:
        results, seconds = [], []
        for v in vecs:
            t0 = time.perf_counter()
            results.append(server.mvm(v, timeout=WAIT))
            seconds.append(time.perf_counter() - t0)
    finally:
        server.close()
    assert tracing.counters()["server.waits_skipped"] - before == 4
    assert max(seconds[1:]) < 0.5, seconds
    for x, y in zip(vecs, results):
        assert_same(y, tt.mvm(A, x))


def test_queued_requests_bring_the_wait_back(monkeypatch):
    """Lone traffic, then three requests queued while a lone batch runs:
    the next batch waits for stragglers and holds all three, and the
    traffic is no longer lone."""
    seen, entered, release = [], threading.Event(), threading.Event()
    real = serving.mvm_batched

    def record(A, xs, seed):
        seen.append(xs)
        if len(seen) == 2:               # the lone batch that skipped
            entered.set()
            assert release.wait(WAIT)
        return real(A, xs, seed)

    monkeypatch.setattr(serving, "mvm_batched", record)
    A = tt.quantize(torch.rand(128, 256) * 2 - 1, 4)
    first = tt.quantize(torch.rand(256) * 2 - 1, 4)
    vecs = [tt.quantize(torch.linspace(-1, j + 1, 256), 4) for j in range(3)]
    server = MVMServer(A, max_batch=8, max_wait_s=0.25)
    before = tracing.counters().get("server.waits_skipped", 0)
    try:
        server.mvm(first, timeout=WAIT)          # its wait makes it lone
        lone = server.submit(first)
        assert entered.wait(WAIT)
        futures = [server.submit(v) for v in vecs]
        release.set()
        lone.result(timeout=WAIT)
        results = [f.result(timeout=WAIT) for f in futures]
        assert not server._lone
    finally:
        release.set()
        server.close()
    assert tracing.counters()["server.waits_skipped"] - before == 1
    assert [xs.codes.shape[0] for xs in seen] == [1, 1, 3]
    for x, y in zip(vecs, results):
        assert_same(y, tt.mvm(A, x))


def test_server_draws_one_seed_per_batch():
    """With a generator, a batch of one takes the seed drawn from it."""
    A = tt.quantize(torch.rand(128, 256) * 2 - 1, 4)
    x = tt.quantize(torch.rand(256) * 2 - 1, 4)
    server = MVMServer(A, max_batch=2,
                       generator=torch.Generator().manual_seed(5))
    try:
        got = server.mvm(x, timeout=WAIT)
    finally:
        server.close()
    seed = seed_from(torch.Generator().manual_seed(5))[0]
    assert_same(got, tt.mvm(A, x, seed))
    assert not torch.equal(got.codes, tt.mvm(A, x).codes)


def test_close_fails_pending_and_submit_after_close_raises():
    class Idle(MVMServer):
        def _drain(self):               # the dispatcher takes nothing
            self._stop.wait(0.01)
            return []

    server = Idle(tt.quantize(torch.ones(128, 128), 4))
    futures = [server.submit(tt.quantize(torch.ones(128), 4))
               for _ in range(2)]
    server.close()
    assert not server._thread.is_alive()
    for f in futures:
        with pytest.raises(RuntimeError, match="closed"):
            f.result(timeout=WAIT)
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(tt.quantize(torch.ones(128), 4))


def test_server_error_propagates():
    server = MVMServer(tt.quantize(torch.ones(128, 128), 4), max_batch=2)
    try:
        fut = server.submit("not a vector")
        with pytest.raises(Exception):
            fut.result(timeout=WAIT)
        ok = server.submit(tt.quantize(torch.ones(128), 4))
        assert ok.result(timeout=WAIT).length == 128   # still serving
    finally:
        server.close()


def test_server_refuses_a_mesh_and_odd_batch_limits():
    """MVMServer takes no mesh; ShardedMVMServer needs this rank's shard of
    the matrix, not the whole one (the sharded server itself is in
    tests/test_torch_parallel.py).  A batch holds 1 to MAX_BATCH requests."""
    A = tt.quantize(torch.ones(128, 128), 4)
    with pytest.raises(TypeError, match="mesh"):
        MVMServer(A, mesh=object())
    with pytest.raises(TypeError, match="ShardedMatrix"):
        ShardedMVMServer(A, object())
    for max_batch in (0, MAX_BATCH + 1):
        with pytest.raises(ValueError, match="max_batch"):
            MVMServer(A, max_batch=max_batch)


def test_server_many_clients():
    """16 client threads, a short switch interval: every result is its own
    request's MVM."""
    A = tt.quantize(torch.rand(128, 256) * 2 - 1, 4)
    g = torch.Generator().manual_seed(3)
    vecs = [tt.quantize(torch.rand(256, generator=g) * 2 - 1, 4)
            for _ in range(64)]
    results = [None] * len(vecs)
    errors = []

    def client(c):
        try:
            futs = [(i, server.submit(vecs[i]))
                    for i in range(c, len(vecs), 16)]
            for i, f in futs:
                results[i] = f.result(timeout=WAIT)
        except Exception as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    server = MVMServer(A, max_batch=8, max_wait_s=0.002)
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
    finally:
        sys.setswitchinterval(interval)
        server.close()
    assert not any(t.is_alive() for t in threads) and not errors
    for x, y in zip(vecs, results):
        assert_same(y, tt.mvm(A, x))
