"""Continuous-batching MVM server (counterpart of clover_tpu/serving.py).

Requests accumulate in a queue; a dispatcher thread packs up to
``max_batch`` of them into one stacked container of as many vectors, runs
one batched MVM against the resident matrix on its device
(ops/gemm.mvm_batched: the batched MVM kernel on CUDA, one pass over the
matrix for the whole batch), and resolves each request's future.  A
sharded matrix is served by parallel.ShardedMVMServer.

After taking a batch's first request the dispatcher waits at most
``max_wait_s`` for stragglers, while the traffic shows concurrent
requests.  Once a wait has run to its deadline and collected nothing, the
traffic is lone: a batch whose first request has nothing queued behind it
then closes at once.  A request already queued behind the first brings
the wait back, and a batch of more than one request ends the lone state.

The dispatcher counts what it serves (tracing.counters()):
``server.requests``, ``server.batches``, ``server.queue_wait_ns`` (from
each request's submit to the dispatcher taking it off the queue) and
``server.waits_skipped`` (batches closed with no straggler wait, as lone
traffic's are).  Under a profiler it records the span
``clover.server.gather``, from taking a batch's first request until the
batch closes (with or without a wait), and ``clover.server.batch`` around
its run, the futures' results included.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

from .formats import stack_vectors, vector_at
from .kernels.dispatch import seed_from
from .kernels.mvm_batched import MAX_BATCH
from .ops.gemm import mvm_batched
from .tracing import add, span


class MVMServer:
    def __init__(self, qA, max_batch: int = 8, max_wait_s: float = 0.002,
                 generator=None):
        """``max_batch``: the most requests a batch holds, 1 to
        kernels.MAX_BATCH.  ``max_wait_s``: the longest straggler wait
        after a batch's first request, taken while the traffic shows
        concurrent requests (none while it is lone; see the module
        docstring).  ``generator``: a ``torch.Generator`` for stochastic
        rounding of the outputs (one seed drawn per batch, vector j of the
        batch rounded with seed + j), or None for deterministic outputs."""
        if not 1 <= max_batch <= MAX_BATCH:
            raise ValueError(f"max_batch must be in 1..{MAX_BATCH}")
        self._qA = qA
        self._max_batch = max_batch
        self._max_wait = max_wait_s
        self._lone = False
        self._generator = generator
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._start()

    # -- client API --------------------------------------------------------

    def submit(self, qx) -> Future:
        """Enqueue a quantized vector; resolves to the quantized result.

        Raises ``RuntimeError`` after :meth:`close`, where the dispatcher
        has stopped."""
        if self._stop.is_set():
            raise RuntimeError("MVMServer is closed")
        fut: Future = Future()
        self._q.put((qx, fut, time.perf_counter_ns()))
        return fut

    def mvm(self, qx, timeout: float | None = None):
        """Synchronous convenience wrapper."""
        return self.submit(qx).result(timeout)

    def close(self):
        """Stop the dispatcher and fail every request still queued."""
        self._stop.set()
        self._thread.join(timeout=5)
        # fail anything still queued so no caller blocks forever
        while True:
            try:
                _, fut, _ = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("MVMServer closed"))

    # -- dispatcher --------------------------------------------------------

    def _drain(self):
        """Collect up to max_batch requests as (vector, future) pairs.

        While the traffic is lone and nothing stands behind the first
        request, the batch closes at once.  Otherwise stragglers are
        collected until ``max_wait_s`` after the first request (a single
        deadline for the whole wait, not per get) or ``max_batch``; a wait
        that runs out with the first request alone makes the traffic lone,
        a batch of more than one makes it not."""
        try:
            taken = [(self._q.get(timeout=0.05), time.perf_counter_ns())]
        except queue.Empty:
            return []
        with span("clover.server.gather"):
            if self._lone and self._q.empty():
                add("server.waits_skipped")
            else:
                deadline = time.monotonic() + self._max_wait
                while len(taken) < self._max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        item = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    taken.append((item, time.perf_counter_ns()))
                # one request and room for more: the wait ran out
                self._lone = len(taken) == 1 and self._max_batch > 1
        add("server.queue_wait_ns",
            sum(at - stamp for (_, _, stamp), at in taken))
        return [(qx, fut) for (qx, fut, _), _ in taken]

    def _loop(self):
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            try:
                with span("clover.server.batch"):
                    self._run(batch)
            except Exception as e:         # resolve futures with the error
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def _run(self, batch):
        add("server.requests", len(batch))
        add("server.batches")
        xs = stack_vectors([qx for qx, _ in batch])
        seed = (seed_from(self._generator)[0]
                if self._generator is not None else None)
        ys = self._mvm(xs, seed)
        for i, (_, fut) in enumerate(batch):
            fut.set_result(vector_at(ys, i))

    # -- hooks of a subclass ----------------------------------------------

    def _start(self):
        """Start the dispatcher thread."""
        self._thread.start()

    def _mvm(self, xs, seed):
        """The batch's stacked results, vector j rounded with seed + j."""
        return mvm_batched(self._qA, xs, seed)
