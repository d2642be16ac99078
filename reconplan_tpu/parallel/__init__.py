"""Multi-chip scaling: device meshes, sharded TSDF fusion, sharded IK.

The reference is single-process CPU (SURVEY.md §2 checklist row); here the
communication backend is ``jax.sharding`` over a 1-D device mesh (on GPUs,
NVLink joins every card to every other, so the mesh follows the
algorithm alone):

  * **spatial sharding**: the TSDF grid splits along z over the mesh; every
    device integrates all frames into its slab (frames are small and
    replicated; the grid is big and never moves) — zero collectives in
    steady state, one ``all_gather`` only at mesh extraction.
  * **brick sharding** (:mod:`parallel.brick`): the sparse engine's brick
    rows split over the mesh; every device runs the single-card chunk loop
    on its own range;
  * **data parallelism**: IK/NN batches shard over devices (roadmap
    expansion waves, arc solves).

Tested on a virtual 8-device CPU mesh (tests/conftest.py); validated by the
driver through ``__graft_entry__.dryrun_multichip``.
"""

from reconplan_tpu.parallel.mesh import make_mesh, shard_grid, replicate
from reconplan_tpu.parallel.fusion import (
    sharded_integrate_frames,
    make_sharded_grid,
    gather_grid,
)
from reconplan_tpu.parallel.ik import sharded_ik_solve

__all__ = [
    "make_mesh",
    "shard_grid",
    "replicate",
    "sharded_integrate_frames",
    "make_sharded_grid",
    "gather_grid",
    "sharded_ik_solve",
]
