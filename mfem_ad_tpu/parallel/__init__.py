"""Multi-device parallelism: element-sharded assembly over a device mesh.

The JAX replacement for the reference's MPI domain decomposition
(ParMesh + hypre, SURVEY.md §2.8).  Two models:

- ``ShardedForm``: elements sharded with ``shard_map``, dof vectors
  replicated, one ``psum`` per assembly (hypre ParallelAssemble as one ICI
  collective, ex4.cpp:119-120) — any mesh, the compatibility path.
- ``HaloShardedForm``: dof vectors DISTRIBUTED in an owner-zero layout;
  the matvec exchanges only the partition-interface dof planes via
  ``ppermute`` — O(surface) bytes per Krylov iteration (hypre true-dof
  partitioning semantics, tools.hpp:179-198).  Structured meshes.
"""

from .halo import HaloShardedForm
from .sharding import ShardedForm


def auto_sharded(form, devices=None, axis_name: str = "elems"):
    """The best available sharded view of ``form``: the O(surface)
    halo-exchange layout when its banding constraints hold (structured
    spaces, outer cell count divisible by the device count), else the
    replicated-dof ``ShardedForm`` (any mesh, any element count)."""
    try:
        return HaloShardedForm(form, devices=devices, axis_name=axis_name)
    except (ValueError, NotImplementedError):
        return ShardedForm(form, devices=devices, axis_name=axis_name)


__all__ = ["ShardedForm", "HaloShardedForm", "auto_sharded"]
