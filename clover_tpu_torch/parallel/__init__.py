"""Mesh-sharded execution on ``torch.distributed`` (counterpart of
clover_tpu/parallel): sharding rules, per-shard collective ops, and the
distributed GD/IHT solvers, one process per shard (SPMD).

    from clover_tpu_torch import parallel
    parallel.initialize()                 # torchrun's env, or a world of one
    mesh = parallel.make_mesh()           # ("row", "col"), 8 ranks -> 2x4
    res = parallel.solvers.iht(parallel.shard_matrix(qphi, mesh),
                               parallel.shard_matrix(qphit, mesh, True),
                               parallel.shard_vector(qy, mesh, parallel.ROW),
                               iterations, k, mu, mesh)
"""

from .mesh import (
    COL, ROW, ShardedMatrix, ShardedVector, gather_vector, make_mesh,
    shard_matrix, shard_vector,
)
from .multihost import initialize, is_coordinator, local_device, pod_mesh
from .ops import dot_psum, mvm_psum, threshold_global
from . import solvers

__all__ = [
    "make_mesh", "shard_matrix", "shard_vector", "ROW", "COL",
    "mvm_psum", "dot_psum", "threshold_global", "solvers",
    "initialize", "pod_mesh", "is_coordinator",
    "ShardedMatrix", "ShardedVector", "gather_vector", "local_device",
]
