"""reconplan_tpu — a JAX 3D reconstruction + redundancy-resolution planning framework.

A ground-up JAX/XLA rebuild of the capabilities of
``geconf/3d-reconstruction-planning`` (UR10 + RealSense D435 object
reconstruction with Expansion-GRR global redundancy resolution), designed
for an accelerator from the first line:

- arrays instead of object graphs (padded ``(N, ...)`` arrays + CSR neighbor
  lists instead of networkx),
- batched damped-least-squares IK under ``vmap``/``lax.while_loop`` instead of
  Klampt/PyBullet C++ IK,
- brute-force batched top-k nearest neighbors as matrix products instead
  of BallTree/NNDescent/GNAT,
- XLA kernels for backprojection, ICP, voxel filtering, TSDF fusion,
  marching cubes and spectral Poisson reconstruction instead of Open3D,
- ``jax.sharding`` meshes + collectives for multi-chip scaling (spatially
  sharded TSDF grids, data-parallel frame batches, sharded IK batches).

Subpackages
-----------
core      SE3/quaternion math, sampling grids (reference ``grr/utils.py``)
kin       kinematic chains, FK/Jacobian/IK, collision (reference ``grr/robot.py``)
ops       device kernels: point clouds, NN, ICP, TSDF, marching cubes
recon     reconstruction pipelines: stitcher, fusion, Poisson, metrics
grr       Expansion-GRR workspace/solver/resolution (reference ``grr/``)
parallel  device meshes, sharded fusion/IK
io        frame feeds, mesh/image IO, config, checkpoints, robot drivers
apps      CLI entry points mirroring ``redundancy.py`` / ``main.py`` / ``stitcher.py``
utils     profiling, logging
viz       host-side visualization exports
"""

__version__ = "0.1.0"
