"""Process-group start-up and the job-wide mesh (counterpart of
clover_tpu/parallel/multihost.py).

clover_tpu brings up ``jax.distributed``; the port forms a
``torch.distributed`` process group, one process per shard.  With no
arguments :func:`initialize` reads ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``), and
without that environment forms a world of one, where clover_tpu falls back
to single-process.

Each rank computes on one device: ``cuda:{LOCAL_RANK % device_count}``
unless the caller asks for the CPU.  The backend is NCCL only when every
local rank has a card of its own; otherwise it is gloo, on CPU tensors
and when ranks share a card (NCCL refuses two ranks on one GPU).  That
choice is a transport, not a device fallback: with gloo the tensors stay
on the card, and gloo stages each collective through host memory.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import make_mesh

_DEVICE: list = [None]      # this rank's device, set by initialize


def _rank_device(device, local_rank: int) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank; pass device='cpu' "
                           "to run the plain versions")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None):
    """Form the process group (idempotent).

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of rank
    0's store; with it, ``num_processes`` and ``process_id`` are required
    and a failure to form the group raises.  ``backend`` overrides the
    choice above; ``device`` this rank's device."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and num_processes is None:
        if "WORLD_SIZE" in env and "MASTER_ADDR" in env:        # torchrun
            world, rank, url = int(env["WORLD_SIZE"]), int(env["RANK"]), \
                "env://"
        else:                                                    # alone
            world, rank, url = 1, 0, None
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("coordinator_address, num_processes and "
                             "process_id come together")
        world, rank = int(num_processes), int(process_id)
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    dev = _rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        own_card = (dev.type == "cuda"
                    and local_world <= torch.cuda.device_count())
        backend = "nccl" if own_card and dist.is_nccl_available() else "gloo"
    if url is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=url, rank=rank,
                                world_size=world)
    _DEVICE[0] = dev


def local_device() -> torch.device:
    """This rank's device (forming a world of one first if no group
    exists)."""
    initialize()
    if _DEVICE[0] is None:                 # a group formed by the caller
        _DEVICE[0] = _rank_device(None, int(os.environ.get(
            "LOCAL_RANK", dist.get_rank())))
    return _DEVICE[0]


def pod_mesh(shape: tuple[int, int] | None = None):
    """The ("row", "col") mesh over every rank of the job.  Shard-boundary
    rules (64-block alignment) are enforced by parallel.mesh when
    containers are sharded."""
    return make_mesh(shape=shape)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
