"""Per-shard building blocks of the sharded path (counterpart of
clover_tpu/parallel/ops.py).

Each rank calls these on its own blocks; every rank of the reduced mesh dim
must make the same call, in the same order (SPMD).  A psum is an
``all_reduce`` over the group of that dim; the f32 partial products are
reduced BEFORE the output requantization, so every shard's band absmax
sees the globally reduced values (clover_tpu's sharded invariant).  Per-shard SR
seeds are folded by the position along the owning dim, so replicas along
the other dim stay bit-identical.  The global top-K is a local top-K, a
gather of the candidates, a merge and a local mask.

clover_tpu's ``pick_psum_chunks`` (a link model with v5e constants) is not
ported: the sharded solver takes the plain psum leg, which is what that
model returns on every mesh unless ``CLOVER_PSUM_LINK_GBS`` names a
DCN-class link.  :func:`mvm_psum_overlapped` is reachable with an explicit
``chunks``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..formats import (
    QVec4, QVec8, QVec16, QVec32, pack_nibbles, stack_vectors, unpack_nibbles,
)
from ..kernels.dispatch import SEED_GOLD, wrap_i32
from ..ops.dot import dot
from ..ops.gemm import mvm_batched_f32_fast
from ..ops.mvm import _requant_output, mvm_f32_fast
from ..ops.quantize import quantize_vec, restore_vec
from .mesh import axis_index, gather, mat_block, vec_block

AXIS_MIX = wrap_i32(SEED_GOLD ^ 0x5851F42D)   # clover_tpu's axis_key stride


def axis_key(key, axis: str, mesh):
    """Fold this rank's position along ``axis`` into an int32 SR seed, so
    each shard of that dim draws its own stream while replicas along the
    other dim stay bit-identical; clover_tpu's int32 arithmetic, wrapped.
    None stays None."""
    if key is None:
        return None
    return wrap_i32(key + (axis_index(mesh, axis) + 1) * AXIS_MIX)


def _psum(t: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def mvm_psum(A_local, x_local, reduce_axis: str, key, out_bits: int,
             out_owner_axis: str, mesh):
    """Local f32 MVM partial -> psum over ``reduce_axis`` -> requantize
    (band absmax and SR, seed folded along ``out_owner_axis``)."""
    y32 = _psum(mvm_f32_fast(A_local, x_local), reduce_axis, mesh)
    return _requant_output(y32, A_local.rows, out_bits,
                           axis_key(key, out_owner_axis, mesh))


def mvm_batched_psum(A_local, xs_local, reduce_axis: str, key,
                     out_bits: int, out_owner_axis: str, mesh):
    """:func:`mvm_psum` for a stacked batch: the batched kernel's
    f32-output mode, the psum of the (B, m_local) partials, then each
    vector's band requant, vector j with seed ``k0 + j`` (k0 the folded
    seed).  Returns a stacked container owned by ``out_owner_axis``."""
    ys = _psum(mvm_batched_f32_fast(A_local, xs_local), reduce_axis, mesh)
    return _requant_batched(ys, A_local.rows, out_bits,
                            axis_key(key, out_owner_axis, mesh))


def _requant_batched(ys: torch.Tensor, rows: int, out_bits: int, k0):
    """The band requant of reduced (B, m_local) sums, vector j with seed
    ``k0 + j`` (None: deterministic): :func:`mvm_batched_psum` after its
    psum."""
    b = ys.shape[0]
    if out_bits in (16, 32):
        return _requant_output(ys, rows, out_bits, None)
    if k0 is None:
        # 64-row bands do not straddle vectors: one flat requant
        q = quantize_vec(QVec32(values=ys.reshape(-1), length=b * rows),
                         out_bits)
        return type(q)(codes=q.codes.reshape(b, -1),
                       scales=q.scales.reshape(b, -1), length=rows)
    return stack_vectors([
        quantize_vec(QVec32(values=ys[j], length=rows), out_bits,
                     wrap_i32(k0 + j)) for j in range(b)])


def _chunk_bounds(A_local, chunks: int) -> list[int]:
    nb = A_local.cols_pad // 64
    chunks = max(1, min(chunks, nb))
    return [round(i * nb / chunks) for i in range(chunks + 1)]


def prepare_psum_chunks(A_local, chunks: int) -> list:
    """The column-chunk matrices of :func:`mvm_psum_overlapped`, made once
    (contiguous copies, 64-block aligned)."""
    b = _chunk_bounds(A_local, chunks)
    return [mat_block(A_local, 0, A_local.rows_pad, 64 * b[c], 64 * b[c + 1])
            for c in range(len(b) - 1)]


def mvm_psum_overlapped(A_local, x_local, reduce_axis: str, key,
                        out_bits: int, out_owner_axis: str, mesh,
                        chunks: int = 4, prepared=None):
    """:func:`mvm_psum` with the k-reduction split into ``chunks`` 64-block
    aligned column groups (at most one per block): each group's partial is
    all_reduced asynchronously as soon as it is computed, so the next
    group's kernel overlaps the previous reduce.  The requant sees the
    fully reduced sum of the reduced partials, in chunk order.

    ``prepared`` (from :func:`prepare_psum_chunks` with the same
    ``chunks``) must hold one matrix per chunk; unlike clover_tpu, a list
    of another length raises."""
    b = _chunk_bounds(A_local, chunks)
    if prepared is None:
        prepared = prepare_psum_chunks(A_local, chunks)
    elif len(prepared) != len(b) - 1:
        raise ValueError(f"{len(prepared)} prepared chunks for "
                         f"{len(b) - 1} chunks")
    group = mesh.get_group(reduce_axis)
    partials = []
    for c, A_c in enumerate(prepared):
        p = mvm_f32_fast(A_c, vec_block(x_local, 64 * b[c], 64 * b[c + 1]))
        partials.append((p, dist.all_reduce(p, group=group, async_op=True)))
    y32 = None
    for p, work in partials:
        work.wait()
        y32 = p if y32 is None else y32 + p
    return _requant_output(y32, A_local.rows, out_bits,
                           axis_key(key, out_owner_axis, mesh))


def threshold_global(x_local, k: int, axis: str, mesh):
    """Global top-K of a vector sharded along ``axis``: local top-K of
    |restore(x)|, a gather of every shard's (value, index) candidates, a
    merge, a local mask.  Tie-break (|value| descending, global index
    ascending), the single-device threshold's: both sorts are stable, so
    equal values keep the gathered (shard, local index) order, which is
    the global index order."""
    vals = restore_vec(x_local).values.abs()
    n = vals.shape[-1]
    kk = min(int(k), n)
    lv, li = torch.sort(vals, descending=True, stable=True)
    gv, gi = gather([lv[:kk], li[:kk]], mesh, axis)          # (parts, kk)
    order = torch.sort(gv.reshape(-1), descending=True,
                       stable=True).indices[:int(k)]
    mine = order // kk == axis_index(mesh, axis)
    # indices that are not mine scatter into a dropped slot: no host sync
    idx = torch.where(mine, gi.reshape(-1)[order], n)
    keep = torch.zeros(n + 1, dtype=torch.bool, device=vals.device)
    keep = keep.scatter(0, idx, True)[:n]

    if isinstance(x_local, QVec4):
        codes = unpack_nibbles(x_local.codes)
        return QVec4(codes=pack_nibbles(torch.where(keep, codes, 0)),
                     scales=x_local.scales, length=x_local.length)
    if isinstance(x_local, QVec8):
        return QVec8(codes=torch.where(keep, x_local.codes, 0),
                     scales=x_local.scales, length=x_local.length)
    v = x_local.values
    return type(x_local)(values=torch.where(keep, v, torch.zeros_like(v)),
                         length=x_local.length)


def dot_psum(u_local, v_local, axis: str, mesh) -> torch.Tensor:
    """Distributed quantized dot: the local blocked dot, psum over
    ``axis``; a 0-dim f32 tensor."""
    return _psum(dot(u_local, v_local).reshape(1), axis, mesh)[0]


def norm2_psum(x32_local: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """||x||_2 of an f32 vector sharded along ``axis``; a 0-dim tensor."""
    return torch.sqrt(_psum((x32_local * x32_local).sum().reshape(1), axis,
                            mesh)[0])

