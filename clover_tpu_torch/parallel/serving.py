"""The MVM server on a matrix sharded over a ("row", "col") mesh of ranks
(counterpart of clover_tpu/serving.py's ``MVMServer(mesh=)``).

``ShardedMVMServer`` is serving.MVMServer on this rank's block of the
matrix (parallel.shard_matrix), SPMD.  The coordinator (rank 0) runs the
base class's dispatcher and broadcasts each batch's header (count, bits,
seed) and vectors; every rank runs parallel/ops.mvm_batched_psum on its
block (the batched f32-output kernel, the psum over COL, the band requant
owned by ROW); the coordinator gathers the row blocks over ROW and
resolves the futures.  On any other rank the constructor runs that
follower loop until the coordinator's ``close()`` broadcasts a stop.
Nothing else may run collectives on the mesh's groups or the default
group while the server runs.

The ranks stay in step.  The coordinator fails a request that does not
fit what the followers allocate from the header (its type, the MVM
combination, its padded length) alone, before any broadcast.  After each
rank's local step the ranks exchange a status: if any rank failed, every
rank drops the batch and the coordinator fails its futures.  While idle,
the coordinator broadcasts an idle header every ``HEARTBEAT_S``, so a
follower never waits for one as long as the process group's timeout.
"""

from __future__ import annotations

import time
import traceback

import torch
import torch.distributed as dist

from ..formats import VECTOR_TYPES, to_device
from ..ops.gemm import mvm_batched_f32_fast
from ..ops.mvm import out_bits
from ..serving import MVMServer
from .mesh import (
    COL, ROW, ShardedMatrix, axis_index, axis_size, gather_vector, padded,
    vec_block,
)
from .multihost import local_device
from .ops import axis_key, psum, requant_batched

HEARTBEAT_S = 10.0       # the coordinator's longest silence to its followers


class ShardedMVMServer(MVMServer):
    def __init__(self, qA, mesh, max_batch: int = 8,
                 max_wait_s: float = 0.002, generator=None):
        """``qA``: this rank's parallel.ShardedMatrix of ``mesh``; the
        other parameters are serving.MVMServer's (the coordinator draws
        the seeds)."""
        if not isinstance(qA, ShardedMatrix):
            raise TypeError("qA is this rank's parallel.ShardedMatrix "
                            "(parallel.shard_matrix)")
        self._mesh = mesh
        self._coordinator = dist.get_rank() == 0
        self._n_pad = qA.local.cols * axis_size(mesh, COL)
        self._last_header = time.monotonic()
        super().__init__(qA, max_batch, max_wait_s, generator)

    def submit(self, qx):
        """serving.MVMServer.submit; raises ``RuntimeError`` on a follower."""
        if not self._coordinator:
            raise RuntimeError("submit on a follower rank of a "
                               "ShardedMVMServer; requests go to rank 0")
        return super().submit(qx)

    def close(self):
        """Stop the server (a no-op on a follower rank)."""
        if self._coordinator:
            super().close()

    # -- dispatcher --------------------------------------------------------

    def _start(self):
        if self._coordinator:
            super()._start()
        else:
            self._follow()

    def _drain(self):
        batch = super()._drain()
        if not batch and time.monotonic() - self._last_header >= HEARTBEAT_S:
            self._broadcast_header(_header(_IDLE))
        return batch

    def _loop(self):
        super()._loop()
        self._broadcast_header(_header(_STOP))

    def _run(self, batch):
        """Run the requests of ``batch`` that fit the sharded matrix; each
        other request fails here, alone, before any broadcast."""
        fits = []
        for qx, fut in batch:
            try:
                self._check_request(qx)
            except (TypeError, ValueError) as e:
                fut.set_exception(e)
            else:
                fits.append((qx, fut))
        if fits:
            super()._run(fits)

    def _mvm(self, xs, seed):
        xs = to_device(xs, local_device())
        self._broadcast_header(_header(_BATCH, _leaves(xs)[0].shape[0],
                                       xs.bits, seed or 0,
                                       int(seed is not None)))
        return self._mvm_sharded(self._broadcast_vectors(xs), seed)

    def _check_request(self, qx):
        """Raise unless ``qx`` is a vector the MVM takes, of a type and
        with leaves that the followers allocate from the header."""
        if type(qx) not in VECTOR_TYPES.values():
            raise TypeError(f"a request is a vector container, not "
                            f"{type(qx).__name__}")
        out_bits(self._qA.local, qx)
        want = _leaves(_empty_stack(type(qx), 1, self._n_pad, "meta"))
        got = _leaves(qx)
        if any(g.shape != w.shape[1:] or g.dtype != w.dtype
               for g, w in zip(got, want)):
            raise ValueError(
                f"a request with leaves {[tuple(g.shape) for g in got]} "
                f"does not fit the matrix's {self._n_pad} padded columns")

    def _broadcast_header(self, header: torch.Tensor) -> torch.Tensor:
        """(go, count, bits, seed, keyed) from rank 0; go is _BATCH, _IDLE
        or _STOP."""
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
        """A follower's loop: each batch's header and vectors from rank 0
        and its collectives, until the stop.  A batch that failed on any
        rank is dropped (the coordinator fails its futures)."""
        while True:
            go, count, bits, seed, keyed = self._broadcast_header(
                _header(_STOP)).tolist()
            if go == _STOP:
                return
            if go == _IDLE:
                continue
            xs = _empty_stack(VECTOR_TYPES[bits], count, self._n_pad,
                              local_device())
            try:
                self._mvm_sharded(self._broadcast_vectors(xs),
                                  seed if keyed else None)
            except _BatchFailed:
                pass

    def _mvm_sharded(self, xs, seed):
        """mvm_batched_psum on this rank's block of the batch, with a
        status exchange between its local step and its psum: the full
        stacked result on the coordinator, None elsewhere; _BatchFailed on
        every rank when the local step failed on any (the steps after the
        psum see the same sums, so fail everywhere or nowhere)."""
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
        ys = requant_batched(psum(part, COL, mesh), qA.local.rows,
                             out_bits(qA.local, xs_l),
                             axis_key(seed, ROW, mesh))
        full = gather_vector(ys, mesh, ROW, qA.rows)
        return full if rank == 0 else None


class _BatchFailed(RuntimeError):
    """A sharded batch failed on some rank; every rank drops it."""


_BATCH, _IDLE, _STOP = 1, 2, 0


def _header(go: int, *rest: int) -> torch.Tensor:
    """A header (go, count, bits, seed, keyed), zeros after go."""
    h = torch.zeros(5, dtype=torch.int64)
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
