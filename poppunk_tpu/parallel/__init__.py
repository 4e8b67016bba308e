"""Multi-device scaling: device meshes, sharded distance tiles, collectives.

The reference has no distributed execution at all (SURVEY.md §2.3/§5.8 —
single process, OpenMP threads, one optional CUDA device). This package is
the from-scratch replacement: a `jax.sharding.Mesh` over the devices, the
reference sketch tensor sharded along the mesh's ``r`` axis, query batches
data-parallel along ``q``, and the distance/assignment pipeline jitted over
the mesh with XLA collectives.
"""

from .mesh import get_mesh, mesh_shape_for  # noqa: F401
from .dists import (  # noqa: F401
    sharded_pairwise_block,
    sharded_query_dists,
    sharded_self_dists,
)
from .distributed import init_distributed, is_primary, pod_mesh  # noqa: F401
