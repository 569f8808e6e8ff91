"""clover_tpu_torch.tracing: spans only under a profiler, the solver's
spans and its chained-iteration counter, the kernel decorator's counts,
and the MVM server's counters and dispatcher spans.

Everything runs on the CPU with the plain versions; no assertion is made
on a time.  Every wait is bounded, so no test can hang.
"""

import sys
import threading

import pytest
import torch

import clover_tpu_torch as tt
import clover_tpu_torch.serving as serving
from clover_tpu_torch import kernels, tracing
from clover_tpu_torch.serving import MVMServer

WAIT = 60


def _problem(seed=0, m=128, n=256, k=16):
    g = torch.Generator().manual_seed(seed)
    phi = torch.rand(m, n, generator=g) * 2 - 1
    xs = torch.zeros(n)
    xs[torch.randperm(n, generator=g)[:k]] = 1.0
    qphi = tt.quantize(phi, 4)
    return qphi, tt.transpose(qphi), tt.quantize(phi @ xs, 4)


def _profile(all_threads=False):
    kw = {}
    if all_threads:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], **kw)


def _spans(prof, prefix=tracing.SPAN_PREFIX):
    """[(name, start ns, end ns, thread)] of the host events named
    ``prefix``..., by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
            e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(prefix)]
    return sorted(out, key=lambda s: s[1])


class _Counting:
    """A recorder that counts its enters."""
    enters = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).enters += 1

    def __exit__(self, *exc):
        return False


def _serve(vecs, A, max_batch=4, max_wait_s=0.01):
    server = MVMServer(A, max_batch=max_batch, max_wait_s=max_wait_s)
    try:
        futures = [server.submit(v) for v in vecs]
        return [f.result(timeout=WAIT) for f in futures]
    finally:
        server.close()
        assert not server._thread.is_alive()


def test_span_is_one_shared_no_op_without_a_profiler():
    assert tracing.span("clover.a") is tracing.span("clover.b")
    with _profile():
        assert tracing.span("clover.a") is not tracing.span("clover.a")
    assert tracing.span("clover.a") is tracing.span("clover.b")


def test_no_profiler_enters_no_record_function(monkeypatch):
    """A plain-path solve and a served round trip, with every recorder
    counting its enters."""
    class Counting(_Counting):
        enters = 0

    monkeypatch.setattr(tracing, "_recorder", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    Phi, PhiT, y = _problem()
    res = tt.iht(Phi, PhiT, y, 3, 16, 0.004)
    assert res.x.length == 256
    (got,) = _serve([tt.quantize(torch.linspace(-1, 1, 256), 4)], Phi)
    assert got.length == 128
    assert Counting.enters == 0


@pytest.mark.parametrize("solver", ["iht", "gd"])
def test_solve_spans_nest_under_a_cpu_profiler(solver):
    """One ``clover.solve`` span a solve, and inside it, on its thread,
    one ``clover.iteration`` span per (unchained) iteration."""
    Phi, PhiT, y = _problem(1)
    run = ((lambda: tt.iht(Phi, PhiT, y, 3, 16, 0.004)) if solver == "iht"
           else (lambda: tt.gd(Phi, PhiT, y, 3, 0.004)))
    with _profile() as prof:
        run()
    spans = _spans(prof)
    solves = [s for s in spans if s[0] == "clover.solve"]
    iterations = [s for s in spans if s[0] == "clover.iteration"]
    assert len(solves) == 1 and len(iterations) == 3
    (_, start, end, thread), = solves
    for _, a, b, t in iterations:
        assert start <= a <= b <= end and t == thread
    # the plain versions are no kernel calls
    assert not any(s[0].startswith("clover.kernel.") for s in spans)


@pytest.mark.parametrize("iterations,chains,unchained", [(100, 25, 0),
                                                         (6, 1, 2)])
def test_chained_solve_spans(iterations, chains, unchained):
    """An untraced solve of a whole-iteration-eligible problem: one
    ``clover.chain`` span per chained launch of ``ITER_CHAIN`` iterations,
    one ``clover.iteration`` span per iteration of the tail, all inside
    the ``clover.solve`` span on its thread."""
    Phi, PhiT, y = _problem(2, 512, 512, 64)
    with _profile() as prof:
        tt.iht(Phi, PhiT, y, iterations, 64, 1e-3)
    spans = _spans(prof)
    (_, start, end, thread), = [s for s in spans if s[0] == "clover.solve"]
    inner = [s for s in spans if s[0] in ("clover.chain", "clover.iteration")]
    assert [s[0] for s in inner] == (["clover.chain"] * chains
                                     + ["clover.iteration"] * unchained)
    for _, a, b, t in inner:
        assert start <= a <= b <= end and t == thread


@pytest.mark.parametrize("iterations,traced,chained", [
    (100, False, 100), (6, False, 4), (100, True, 0), (2, False, 0)])
def test_chained_iterations_counter(iterations, traced, chained):
    """``solver.chained_iterations`` rises by the iterations a solve
    chained; a solve with an error trace (``x_star``) or of fewer than
    ``ITER_CHAIN`` iterations chains none."""
    Phi, PhiT, y = _problem(3, 512, 512, 64)
    xs = (tt.QVec32(values=torch.ones(512), length=512) if traced
          else None)
    before = tracing.counters().get("solver.chained_iterations", 0)
    tt.iht(Phi, PhiT, y, iterations, 64, 1e-3, x_star=xs)
    after = tracing.counters().get("solver.chained_iterations", 0)
    assert after - before == chained


def test_kernel_decorator_counts_returned_calls_and_opens_its_span():
    def probe_cuda(x, fail=False):
        """doc"""
        if fail:
            raise ValueError("operand")
        return x + 1

    probe = tracing.kernel("probe")(probe_cuda)
    assert probe.__name__ == "probe_cuda" and probe.__doc__ == "doc"
    assert probe.kernel == "probe" and probe.launches == 0
    assert probe(1) == 2 and probe.launches == 1
    with pytest.raises(ValueError):
        probe(1, fail=True)
    assert probe.launches == 1
    with _profile() as prof:
        assert probe(2) == 3
    assert probe.launches == 2
    assert [s[0] for s in _spans(prof)] == ["clover.kernel.probe"]


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_every_kernel_wrapper_is_decorated_with_its_key(name):
    fn = kernels.KERNELS[name]
    assert fn.kernel == name
    assert fn.__name__.endswith("_cuda")
    assert isinstance(fn.launches, int)


def test_launch_counts_and_reset_behave_as_before(monkeypatch):
    for i, fn in enumerate(kernels.KERNELS.values()):
        monkeypatch.setattr(fn, "launches", i + 1)
    counts = kernels.launch_counts()
    assert list(counts) == list(kernels.KERNELS)
    assert list(counts.values()) == list(range(1, len(counts) + 1))
    assert kernels.mvm4_cuda.launches == counts["mvm4"]
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    assert kernels.dot_cuda.launches == 0


def test_server_counts_requests_batches_and_padding(monkeypatch):
    """Over whatever batches form, every request is counted once and every
    stacked row is a request: no batch is padded."""
    buckets = []
    real = serving.mvm_batched

    def record(A, xs, seed):
        buckets.append(xs.codes.shape[0])
        return real(A, xs, seed)

    monkeypatch.setattr(serving, "mvm_batched", record)
    A = tt.quantize(torch.rand(128, 256) * 2 - 1, 4)
    vecs = [tt.quantize(torch.linspace(-1, j + 1, 256), 4) for j in range(11)]
    before = tracing.counters()
    results = _serve(vecs, A)
    after = tracing.counters()
    delta = {k: after[k] - before.get(k, 0) for k in after}
    assert len(results) == 11
    assert delta["server.requests"] == 11
    assert delta["server.batches"] == len(buckets)
    assert sum(buckets) == 11
    assert "server.padded_rows" not in after
    assert delta["server.queue_wait_ns"] >= 0


def test_server_spans_come_from_the_dispatcher_thread():
    A = tt.quantize(torch.rand(128, 256) * 2 - 1, 4)
    vecs = [tt.quantize(torch.linspace(-1, j + 1, 256), 4) for j in range(5)]
    before = tracing.counters().get("server.batches", 0)
    with _profile(all_threads=True) as prof:
        with tracing.span("clover.test.client"):
            _serve(vecs, A, max_batch=2, max_wait_s=0.005)
    batches = tracing.counters()["server.batches"] - before
    spans = _spans(prof)
    (client,) = [s for s in spans if s[0] == "clover.test.client"]
    gathers = [s for s in spans if s[0] == "clover.server.gather"]
    runs = [s for s in spans if s[0] == "clover.server.batch"]
    assert len(gathers) == len(runs) == batches >= 3
    threads = {s[3] for s in gathers + runs}
    assert len(threads) == 1 and client[3] not in threads
    # a batch runs after its gather closes
    for (_, _, gather_end, _), (_, run_start, _, _) in zip(gathers, runs):
        assert gather_end <= run_start


def test_a_batch_closed_with_no_wait_records_its_gather():
    """A lone client: every batch after the first closes with no
    straggler wait, and each still records one ``clover.server.gather``
    span before its ``clover.server.batch``."""
    A = tt.quantize(torch.rand(128, 256) * 2 - 1, 4)
    vecs = [tt.quantize(torch.linspace(-1, j + 1, 256), 4) for j in range(4)]
    before = tracing.counters()
    server = MVMServer(A, max_batch=4, max_wait_s=0.01)
    try:
        with _profile(all_threads=True) as prof:
            for v in vecs:
                server.mvm(v, timeout=WAIT)
    finally:
        server.close()
    after = tracing.counters()
    batches = after["server.batches"] - before.get("server.batches", 0)
    skipped = (after["server.waits_skipped"]
               - before.get("server.waits_skipped", 0))
    spans = _spans(prof, "clover.server.")
    gathers = [s for s in spans if s[0] == "clover.server.gather"]
    runs = [s for s in spans if s[0] == "clover.server.batch"]
    assert batches == 4 and skipped == 3
    assert len(gathers) == len(runs) == batches
    for (_, _, gather_end, _), (_, run_start, _, _) in zip(gathers, runs):
        assert gather_end <= run_start


def test_counters_take_no_lost_update_under_contention():
    """Eight threads, a short switch interval: the decorated call's count
    and a counter both come out exact."""
    probe = tracing.kernel("probe")(lambda: None)
    before = tracing.counters().get("test.contended", 0)
    per_thread, threads = 2000, 8

    def work():
        for _ in range(per_thread):
            probe()
            tracing.add("test.contended")

    interval = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=WAIT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert probe.launches == per_thread * threads
    assert (tracing.counters()["test.contended"] - before
            == per_thread * threads)
