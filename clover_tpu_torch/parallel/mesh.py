"""Process mesh and container sharding rules (counterpart of
clover_tpu/parallel/mesh.py).

clover_tpu runs one process over a ("row", "col") ``jax.sharding.Mesh``
and ``shard_map``s a per-device function.  The port is SPMD: one process
per shard, each at one position of a ``torch.distributed`` DeviceMesh with
the dims ("row", "col").  Rank ``r * C + c`` is position (r, c), the
row-major order of clover_tpu's ``make_mesh``; ``mesh.get_group(ROW)`` and
``mesh.get_group(COL)`` are the groups the psums reduce over.  Matrices are
sharded over both dims, vectors over the dim that matches their role in
the MVM dataflow:

    Phi  : (row, col)   over (m, n)
    PhiT : (col, row)   over (n, m)
    x,t3 : col          (length n)
    y,t1,t2 : row       (length m)

Every rank holds the full container (as clover_tpu's multi-process ``_put``
assumes) and keeps its own block: :func:`shard_matrix` and
:func:`shard_vector` return that block as a local container on the rank's
device, whose sides are the block's padded sides, with the global logical
sizes beside it.  Every shard boundary falls on a 64-element block (64x64
tile) boundary, so no block scale straddles two shards, and every shard's
side is a multiple of 128 (clover_tpu asks 64): the requant, AXPY, restore
and threshold kernels a shard's vectors meet take sides padded to 128, as
every container of the port has.  Only the MVM's f32-output modes take a
64-block side, for :func:`~clover_tpu_torch.parallel.ops.mvm_psum_overlapped`'s
column chunks.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..formats import BLOCK, PAD, QMat16, QMat32, QVec16, QVec32, to_device

ROW, COL = "row", "col"


class ShardedMatrix(NamedTuple):
    local: object          # this rank's block, a matrix container
    rows: int              # the global matrix's logical sides
    cols: int


class ShardedVector(NamedTuple):
    local: object          # this rank's block, a vector container
    length: int            # the global vector's logical length


def make_mesh(n_devices: int | None = None,
              shape: tuple[int, int] | None = None):
    """A ("row", "col") DeviceMesh over every rank of the job (a world of
    one when none was formed), as square as possible by default: 8 ranks
    give 2x4.  SPMD needs every rank in the mesh, so ``n_devices`` must
    be the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    from .multihost import initialize, local_device
    initialize()
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world if shape is None else shape[0] * shape[1]
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of {world}")
    if shape is None:
        r = math.isqrt(n_devices)
        while n_devices % r:
            r -= 1
        shape = (r, n_devices // r)
    if shape[0] * shape[1] != n_devices:
        raise ValueError(f"mesh shape {shape} does not hold {n_devices} ranks")
    return init_device_mesh(local_device().type, tuple(shape),
                            mesh_dim_names=(ROW, COL))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's position along ``axis``."""
    return mesh.get_local_rank(axis)


def _check(dim: int, parts: int, what: str):
    if dim % (parts * PAD):
        raise ValueError(f"{what}={dim} must be divisible by {parts} shards "
                         f"x {PAD}")


def mat_block(q, r0: int, r1: int, c0: int, c1: int):
    """Rows [r0, r1) x cols [c0, c1) of a matrix container, all bounds
    multiples of 64, as a contiguous container of sides (r1-r0, c1-c0).
    A 4-bit row packs each 64-block in its own 32 bytes, so a block range
    is a byte range."""
    if isinstance(q, (QMat16, QMat32)):
        return type(q)(values=q.values[r0:r1, c0:c1].contiguous(),
                       rows=r1 - r0, cols=c1 - c0)
    b0, b1 = (c0, c1) if q.bits == 8 else (c0 // 2, c1 // 2)
    return type(q)(codes=q.codes[r0:r1, b0:b1].contiguous(),
                   scales=q.scales[r0 // BLOCK:r1 // BLOCK,
                                   c0 // BLOCK:c1 // BLOCK].contiguous(),
                   rows=r1 - r0, cols=c1 - c0)


def vec_block(q, l0: int, l1: int):
    """Elements [l0, l1) (multiples of 64) of a vector container, or of
    each vector of a stacked one, as a contiguous container."""
    if isinstance(q, (QVec16, QVec32)):
        return type(q)(values=q.values[..., l0:l1].contiguous(),
                       length=l1 - l0)
    b0, b1 = (l0, l1) if q.bits == 8 else (l0 // 2, l1 // 2)
    return type(q)(codes=q.codes[..., b0:b1].contiguous(),
                   scales=q.scales[..., l0 // BLOCK:l1 // BLOCK].contiguous(),
                   length=l1 - l0)


def shard_matrix(qA, mesh, transposed: bool = False) -> ShardedMatrix:
    """This rank's block of the full matrix ``qA``: layout (row, col), or
    (col, row) with ``transposed`` (PhiT)."""
    from .multihost import local_device
    first, second = (COL, ROW) if transposed else (ROW, COL)
    r_parts, c_parts = axis_size(mesh, first), axis_size(mesh, second)
    _check(qA.rows_pad, r_parts, "rows")
    _check(qA.cols_pad, c_parts, "cols")
    rl, cl = qA.rows_pad // r_parts, qA.cols_pad // c_parts
    r, c = axis_index(mesh, first), axis_index(mesh, second)
    local = mat_block(qA, r * rl, (r + 1) * rl, c * cl, (c + 1) * cl)
    return ShardedMatrix(to_device(local, local_device()), qA.rows, qA.cols)


def shard_vector(qx, mesh, axis: str) -> ShardedVector:
    """This rank's block of the full vector ``qx``, sharded along ``axis``
    and replicated along the other dim."""
    from .multihost import local_device
    parts = axis_size(mesh, axis)
    _check(qx.length_pad, parts, "length")
    nl, i = qx.length_pad // parts, axis_index(mesh, axis)
    return ShardedVector(to_device(vec_block(qx, i * nl, (i + 1) * nl),
                             local_device()), qx.length)


def gather(tensors, mesh, axis: str) -> list[torch.Tensor]:
    """Every rank's copy of each tensor along ``axis``, stacked: one
    ``(parts, *shape)`` tensor each, on every rank of the axis.

    One all_reduce of a zeroed byte buffer in which each rank fills its
    own row with its tensors' bytes: every byte is one rank's plus zeros,
    so the gather is exact for every dtype, on gloo and NCCL alike (gloo's
    all_gather of CUDA tensors is not relied on)."""
    parts, me = axis_size(mesh, axis), axis_index(mesh, axis)
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    sizes = [f.numel() for f in flat]
    buf = torch.zeros(parts, sum(sizes), dtype=torch.uint8,
                      device=flat[0].device)
    buf[me] = torch.cat(flat)
    dist.all_reduce(buf, group=mesh.get_group(axis))
    out, o = [], 0
    for t, s in zip(tensors, sizes):
        out.append(buf[:, o:o + s].contiguous().view(t.dtype)
                   .reshape(parts, *t.shape))
        o += s
    return out


def gather_vector(x_local, mesh, axis: str, length: int):
    """The full vector container, on every rank, from each rank's block
    along ``axis`` (the inverse of :func:`shard_vector`); a stacked
    container gathers each of its vectors."""
    names = ("values",) if isinstance(x_local, (QVec16, QVec32)) \
        else ("codes", "scales")
    parts = gather([getattr(x_local, f) for f in names], mesh, axis)
    # (parts, *lead, w) -> (*lead, parts * w)
    full = {f: torch.movedim(p, 0, -2).reshape(*p.shape[1:-1], -1)
            for f, p in zip(names, parts)}
    return type(x_local)(length=length, **full)
