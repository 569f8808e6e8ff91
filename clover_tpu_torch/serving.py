"""Continuous-batching MVM server (counterpart of clover_tpu/serving.py).

Requests accumulate in a queue; a dispatcher thread packs up to
``max_batch`` of them into one stacked container, runs one batched MVM
against the resident matrix (ops/gemm.mvm_batched: the batched MVM kernel
on CUDA, one pass over the matrix for the whole batch), and resolves each
request's future.  Batch sizes are bucketed to powers of two, short
batches padded with the first request's vector and the padding results
dropped, as in clover_tpu.  The dispatcher computes on the matrix's
device (each kernel launch enters that device's context).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

from .formats import stack_vectors, vector_at
from .kernels.dispatch import seed_from
from .ops.gemm import mvm_batched

_BUCKETS = (1, 2, 4, 8, 16, 32)


class MVMServer:
    def __init__(self, qA, max_batch: int = 8, max_wait_s: float = 0.002,
                 generator=None, mesh=None):
        """``generator``: a ``torch.Generator`` for stochastic rounding of
        the outputs (one seed drawn per batch), or None for deterministic
        outputs.  ``mesh`` (a sharded matrix) is not ported yet."""
        if mesh is not None:
            raise NotImplementedError(
                "MVMServer(mesh=...) waits for the parallel/ slice "
                "(ROADMAP.md queue 1 item 10)")
        if max_batch not in _BUCKETS:
            raise ValueError(f"max_batch must be one of {_BUCKETS}")
        self._qA = qA
        self._max_batch = max_batch
        self._max_wait = max_wait_s
        self._generator = generator
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API --------------------------------------------------------

    def submit(self, qx) -> Future:
        """Enqueue a quantized vector; resolves to the quantized result.

        Raises ``RuntimeError`` after :meth:`close`: the dispatcher has
        stopped, so an enqueued future would never resolve."""
        if self._stop.is_set():
            raise RuntimeError("MVMServer is closed")
        fut: Future = Future()
        self._q.put((qx, fut))
        return fut

    def mvm(self, qx, timeout: float | None = None):
        """Synchronous convenience wrapper."""
        return self.submit(qx).result(timeout)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        # fail anything still queued so no caller blocks forever
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("MVMServer closed"))

    # -- dispatcher --------------------------------------------------------

    def _drain(self):
        """Collect up to max_batch requests; ``max_wait_s`` is a single
        deadline for the whole straggler wait, not per get."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self._max_wait
        while len(batch) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            try:
                self._run(batch)
            except Exception as e:         # resolve futures with the error
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def _run(self, batch):
        n = len(batch)
        size = next(b for b in _BUCKETS if b >= n)
        vecs = [qx for qx, _ in batch]
        vecs += [vecs[0]] * (size - n)              # pad to the bucket
        xs = stack_vectors(vecs)
        seed = (seed_from(self._generator)[0]
                if self._generator is not None else None)
        ys = mvm_batched(self._qA, xs, seed)
        for i, (_, fut) in enumerate(batch):
            fut.set_result(vector_at(ys, i))
