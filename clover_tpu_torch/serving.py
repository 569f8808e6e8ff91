"""Continuous-batching MVM server (counterpart of clover_tpu/serving.py).

Requests accumulate in a queue; a dispatcher thread packs up to
``max_batch`` of them into one stacked container, runs one batched MVM
against the resident matrix (ops/gemm.mvm_batched: the batched MVM kernel
on CUDA, one pass over the matrix for the whole batch), and resolves each
request's future.  Batch sizes are bucketed to powers of two, short
batches padded with the first request's vector and the padding results
dropped, as in clover_tpu.  The dispatcher computes on the matrix's
device (each kernel launch enters that device's context).

After taking a batch's first request the dispatcher waits at most
``max_wait_s`` for stragglers, while the traffic shows concurrent
requests.  Once a wait has run to its deadline and collected nothing, the
traffic is lone: a batch whose first request has nothing queued behind it
then closes at once.  A request already queued behind the first brings
the wait back, and a batch of more than one request ends the lone state.

With ``mesh`` the matrix is sharded over a ("row", "col") mesh of ranks
(parallel.shard_matrix) and the server is SPMD, since every rank must join
each batch's collectives.  On the coordinator (rank 0) the dispatcher
packs a batch and broadcasts a header (count, bucket, bits, seed) and the
stacked codes and scales to every rank; every rank runs
parallel/ops.mvm_batched_psum on its block (the batched kernel's
f32-output mode, the psum over COL, the band requant owned by ROW); the
coordinator gathers the row blocks over ROW into full results and
resolves the futures.  On any other rank the constructor runs that
follower loop and returns when the coordinator's ``close()`` broadcasts a
stop; ``submit`` raises there.  Nothing else may run collectives on the
mesh's groups or the default group while the server runs.

The ranks stay in step when a request or a batch fails.  The coordinator
checks each request against what the followers will allocate from the
header (its type, the MVM combination, its padded length) and fails a
request that does not fit, alone, before anything is broadcast.  After
each rank's local step (the f32 partial on its block, the one step of a
batch without a collective) the ranks exchange a status: if any rank
failed, every rank drops the batch and the coordinator fails its futures.
While no request comes, the coordinator broadcasts an idle header every
``HEARTBEAT_S``, so a follower never waits for a header as long as the
process group's timeout.

The dispatcher counts what it serves (tracing.counters()):
``server.requests``, ``server.batches``, ``server.padded_rows`` (the
bucket's rows beyond the requests), ``server.queue_wait_ns`` (from each
request's submit to the dispatcher taking it off the queue) and
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
import traceback
from concurrent.futures import Future

import torch
import torch.distributed as dist

from .formats import VECTOR_TYPES, stack_vectors, to_device, vector_at
from .kernels.dispatch import seed_from
from .ops.gemm import mvm_batched, mvm_batched_f32_fast
from .ops.mvm import _out_bits
from .parallel.mesh import (
    COL, ROW, ShardedMatrix, axis_index, axis_size, gather_vector, padded,
    vec_block,
)
from .parallel.multihost import local_device
from .parallel.ops import _psum, _requant_batched, axis_key
from .tracing import add, span

_BUCKETS = (1, 2, 4, 8, 16, 32)
HEARTBEAT_S = 10.0       # a sharded server's longest silence to its followers


class MVMServer:
    def __init__(self, qA, max_batch: int = 8, max_wait_s: float = 0.002,
                 generator=None, mesh=None):
        """``max_wait_s``: the longest straggler wait after a batch's
        first request, taken while the traffic shows concurrent requests
        (none while it is lone; see the module docstring).
        ``generator``: a ``torch.Generator`` for stochastic rounding of
        the outputs (one seed drawn per batch, on the coordinator), or None
        for deterministic outputs.  ``mesh``: the mesh ``qA`` is sharded
        over (``qA`` is then this rank's parallel.ShardedMatrix); see the
        module docstring."""
        if max_batch not in _BUCKETS:
            raise ValueError(f"max_batch must be one of {_BUCKETS}")
        if mesh is not None and not isinstance(qA, ShardedMatrix):
            raise TypeError("with mesh=, qA is this rank's "
                            "parallel.ShardedMatrix (parallel.shard_matrix)")
        self._qA = qA
        self._max_batch = max_batch
        self._max_wait = max_wait_s
        self._lone = False
        self._generator = generator
        self._mesh = mesh
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = None
        self._last_header = time.monotonic()
        if mesh is not None and dist.get_rank() != 0:
            self._follow()
            self._stop.set()
            return
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API --------------------------------------------------------

    def submit(self, qx) -> Future:
        """Enqueue a quantized vector; resolves to the quantized result.

        Raises ``RuntimeError`` after :meth:`close`, where the dispatcher
        has stopped, and on a follower rank of a sharded server."""
        if self._thread is None:
            raise RuntimeError("submit on a follower rank of a sharded "
                               "MVMServer; requests go to rank 0")
        if self._stop.is_set():
            raise RuntimeError("MVMServer is closed")
        fut: Future = Future()
        self._q.put((qx, fut, time.perf_counter_ns()))
        return fut

    def mvm(self, qx, timeout: float | None = None):
        """Synchronous convenience wrapper."""
        return self.submit(qx).result(timeout)

    def close(self):
        """Stop the dispatcher (on a sharded server's coordinator, after
        broadcasting the stop to the followers); a follower's close does
        nothing."""
        if self._thread is None:
            return
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
                if (self._mesh is not None and time.monotonic()
                        - self._last_header >= HEARTBEAT_S):
                    self._broadcast_header(_header(_IDLE))
                continue
            try:
                with span("clover.server.batch"):
                    self._run(batch)
            except Exception as e:         # resolve futures with the error
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
        if self._mesh is not None:
            self._broadcast_header(_header(_STOP))

    def _run(self, batch):
        if self._mesh is not None:
            batch = self._admit(batch)
            if not batch:
                return
        n = len(batch)
        size = next(b for b in _BUCKETS if b >= n)
        add("server.requests", n)
        add("server.batches")
        add("server.padded_rows", size - n)
        vecs = [qx for qx, _ in batch]
        vecs += [vecs[0]] * (size - n)              # pad to the bucket
        xs = stack_vectors(vecs)
        seed = (seed_from(self._generator)[0]
                if self._generator is not None else None)
        if self._mesh is None:
            ys = mvm_batched(self._qA, xs, seed)
        else:
            xs = to_device(xs, local_device())
            self._broadcast_header(_header(_BATCH, n, size, xs.bits,
                                           seed or 0, int(seed is not None)))
            ys = self._mvm_sharded(self._broadcast_vectors(xs), seed)
        for i, (_, fut) in enumerate(batch):
            fut.set_result(vector_at(ys, i))

    # -- sharded path ------------------------------------------------------

    def _n_pad(self) -> int:
        return self._qA.local.cols * axis_size(self._mesh, COL)

    def _admit(self, batch) -> list:
        """The requests of ``batch`` that fit the sharded matrix; each
        other request's future fails here, before anything is
        broadcast."""
        fits = []
        for qx, fut in batch:
            try:
                self._check_request(qx)
            except (TypeError, ValueError) as e:
                fut.set_exception(e)
                continue
            fits.append((qx, fut))
        return fits

    def _check_request(self, qx):
        """Raise unless ``qx`` is a vector of a type the followers rebuild
        from the header, in a combination the MVM takes, with the leaves a
        follower allocates for it."""
        if type(qx) not in VECTOR_TYPES.values():
            raise TypeError(f"a request is a vector container, not "
                            f"{type(qx).__name__}")
        _out_bits(self._qA.local, qx)
        want = _leaves(_empty_stack(type(qx), 1, self._n_pad(), "meta"))
        got = _leaves(qx)
        if any(g.shape != w.shape[1:] or g.dtype != w.dtype
               for g, w in zip(got, want)):
            raise ValueError(
                f"a request with leaves {[tuple(g.shape) for g in got]} "
                f"does not fit the matrix's {self._n_pad()} padded columns")

    def _broadcast_header(self, header: torch.Tensor) -> torch.Tensor:
        """(go, count, bucket, bits, seed, keyed) from rank 0; go is
        _BATCH, _IDLE or _STOP."""
        header = header.to(local_device())
        dist.broadcast(header, src=0)
        self._last_header = time.monotonic()
        return header

    def _broadcast_vectors(self, xs):
        """The stacked request vectors, from rank 0 to every rank."""
        for t in _leaves(xs):
            dist.broadcast(t, src=0)
        return xs

    def _follow(self):
        """A follower's loop: take each batch's header and vectors from
        rank 0 and join its collectives, until the stop.  A batch that
        failed on any rank is dropped (the coordinator fails its
        futures)."""
        while True:
            go, _, size, bits, seed, keyed = self._broadcast_header(
                _header(_STOP)).tolist()
            if go == _STOP:
                return
            if go == _IDLE:
                continue
            xs = _empty_stack(VECTOR_TYPES[bits], size, self._n_pad(),
                              local_device())
            try:
                self._mvm_sharded(self._broadcast_vectors(xs),
                                  seed if keyed else None)
            except _BatchFailed:
                pass

    def _mvm_sharded(self, xs, seed):
        """mvm_batched_psum on this rank's block of the batch, with a
        status exchange between its local step and its psum; the full
        stacked result on the coordinator (row blocks gathered over ROW),
        None elsewhere.  Raises _BatchFailed on every rank when the local
        step failed on any (after the psum every rank holds the same sums,
        so the requant and the gather fail everywhere or nowhere)."""
        mesh, qA = self._mesh, self._qA
        nl = qA.local.cols
        c = axis_index(mesh, COL)
        xs_l = padded(vec_block(xs, c * nl, (c + 1) * nl))
        rank, err = dist.get_rank(), None
        try:
            part = mvm_batched_f32_fast(qA.local, xs_l)
        except Exception as e:
            err = e
            if rank != 0:
                traceback.print_exc()
        failed = torch.zeros(dist.get_world_size(), dtype=torch.int32,
                             device=local_device())
        failed[rank] = err is not None
        dist.all_reduce(failed)
        if bool(failed.any()):
            raise _BatchFailed(f"sharded MVMServer: the local MVM failed on "
                               f"rank(s) {failed.nonzero().flatten().tolist()}"
                               ) from err
        ys = _requant_batched(_psum(part, COL, mesh), qA.local.rows,
                              _out_bits(qA.local, xs_l),
                              axis_key(seed, ROW, mesh))
        full = gather_vector(ys, mesh, ROW, qA.rows)
        return full if rank == 0 else None


class _BatchFailed(RuntimeError):
    """A batch of a sharded server failed on some rank; every rank drops
    it."""


_BATCH, _IDLE, _STOP = 1, 2, 0


def _header(go: int, *rest: int) -> torch.Tensor:
    """A header (go, count, bucket, bits, seed, keyed), zeros after go
    unless given."""
    h = torch.zeros(6, dtype=torch.int64)
    h[:1 + len(rest)] = torch.tensor([go, *rest])
    return h


def _leaves(q) -> tuple:
    """The tensors of a vector container that a broadcast carries."""
    return (q.values,) if q.bits in (16, 32) else (q.codes, q.scales)


def _empty_stack(cls, size: int, n_pad: int, device):
    """A stacked container of ``size`` vectors of padded length n_pad to
    receive a broadcast."""
    if cls.bits in (16, 32):
        dtype = torch.float16 if cls.bits == 16 else torch.float32
        return cls(values=torch.empty(size, n_pad, dtype=dtype,
                                      device=device), length=n_pad)
    return cls(codes=torch.empty(size, n_pad * cls.bits // 8,
                                 dtype=torch.int8, device=device),
               scales=torch.empty(size, n_pad // 64, device=device),
               length=n_pad)
