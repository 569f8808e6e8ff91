"""Mesh-sharded GD and IHT (counterpart of clover_tpu/parallel/solvers.py).

Every rank runs the whole solve on its own blocks; an iteration is two
local MVMs, two psums, local AXPYs and one gathered top-K merge, with no
resharding:

    Phi  (row,col) @ x (col)  --psum col-->  t1 (row)
    t2 = y - t1                                (local on row shards)
    PhiT (col,row) @ t2 (row) --psum row-->  t3 (col)
    x += mu * t3; x = top_k(x, K)              (local + gathered merge)

When C == 1 the first psum is trivial and the Phi leg is the fused MVM+AXPY
with seeds folded by row; when R == 1 the PhiT leg likewise.  A 1x1 mesh
runs the single-device solve itself (models/solvers.py: whole-iteration
and chained kernels included), so it is bit-identical to ``tt.iht`` /
``tt.gd``.  Each iteration takes one int32 seed, strided by ``SEED_GOLD``,
with per-op strides ``SEED_OP``, as the single solve.  Every rank must pass
the same ``generator`` (an int seed, or a ``torch.Generator`` in the same
state): the seed is drawn on each rank.  There is no int4 stream view
(Hopper has no INT4 MMA).
"""

from __future__ import annotations

import dataclasses

import torch

from ..formats import QVec32, pad_vector, zeros_vector
from ..kernels.dispatch import SEED_GOLD, seed_from, wrap_i32
from ..models.solvers import SolveResult, _op_seeds, _solve
from ..ops.axpy import scale_and_add
from ..ops.mvm import mvm_axpy, out_bits
from ..ops.quantize import restore_vec
from .mesh import COL, ROW, axis_index, axis_size, gather_vector
from .multihost import local_device
from .ops import axis_key, mvm_psum, norm2_psum, threshold_global


def _whole(s):
    """The full container of a 1x1 mesh's shard, with its global sides."""
    if hasattr(s, "rows"):
        return dataclasses.replace(s.local, rows=s.rows, cols=s.cols)
    return dataclasses.replace(s.local, length=s.length)


def _solve_sharded(qphi, qphit, qy, x_bits: int, x_star, iterations: int, k,
                   mu: float, generator, mesh) -> SolveResult:
    """k None -> GD.  ``x_star`` is the full f32 container (QVec32)."""
    R, C = axis_size(mesh, ROW), axis_size(mesh, COL)
    n, dev = qphi.cols, local_device()
    if R == C == 1:
        # no collectives anywhere: the single-device solve
        return _solve(_whole(qphi), _whole(qphit), _whole(qy),
                      zeros_vector(x_bits, n, device=dev), x_star,
                      iterations, k, mu, generator)
    phi, phit, y = qphi.local, qphit.local, qy.local
    nl = phit.rows                      # this rank's block of x
    c = axis_index(mesh, COL)
    x = zeros_vector(x_bits, nl, device=dev)
    t_bits = out_bits(phi, x)            # precision of t1/t2 (y's side)
    xs = xs_norm = None
    if x_star is not None:
        xs = pad_vector(x_star.values[c * nl:(c + 1) * nl])
        xs_norm = norm2_psum(xs, COL, mesh)
    seed0 = seed_from(generator)[0] if generator is not None else None
    errs = []
    for it in range(iterations):
        base = wrap_i32(seed0 + it * SEED_GOLD) if seed0 is not None else None
        k1, k2, k3, k4 = _op_seeds(base)
        if C == 1:
            t2 = mvm_axpy(phi, x, y, -1.0, axis_key(k1, ROW, mesh),
                          axis_key(k2, ROW, mesh))
        else:
            t1 = mvm_psum(phi, x, COL, k1, t_bits, ROW, mesh)
            t2 = scale_and_add(y, t1, -1.0, axis_key(k2, ROW, mesh))
        if R == 1:
            x = mvm_axpy(phit, t2, x, mu, axis_key(k3, COL, mesh),
                         axis_key(k4, COL, mesh))
        else:
            t3 = mvm_psum(phit, t2, ROW, k3, x_bits, COL, mesh)
            x = scale_and_add(x, t3, mu, axis_key(k4, COL, mesh))
        if k is not None:
            x = threshold_global(x, k, COL, mesh)
        if xs is not None:
            errs.append(norm2_psum(restore_vec(x).values - xs, COL, mesh)
                        / xs_norm)
    trace = (torch.stack(errs) if errs
             else torch.zeros(iterations, device=dev))
    return SolveResult(x=gather_vector(x, mesh, COL, n), trace=trace)


def iht(qphi, qphit, qy, iterations: int, k: int, mu: float, mesh,
        generator=None, x_star: QVec32 | None = None) -> SolveResult:
    """Mesh-sharded quantized IHT.  ``qphi``, ``qphit`` and ``qy`` are this
    rank's shards (parallel.shard_matrix(qphi, mesh), shard_matrix(qphit,
    mesh, transposed=True), shard_vector(qy, mesh, ROW)); ``x_star``, if
    given, the full padded f32 container.  Returns the full solution on
    every rank and the trace ||x - x*|| / ||x*||, replicated."""
    return _solve_sharded(qphi, qphit, qy, out_bits(qphit.local, qy.local),
                          x_star, iterations, int(k), float(mu), generator,
                          mesh)


def gd(qphi, qphit, qy, iterations: int, mu: float, mesh, generator=None,
       x_star: QVec32 | None = None) -> SolveResult:
    """Mesh-sharded quantized gradient descent."""
    return _solve_sharded(qphi, qphit, qy, out_bits(qphit.local, qy.local),
                          x_star, iterations, None, float(mu), generator,
                          mesh)
