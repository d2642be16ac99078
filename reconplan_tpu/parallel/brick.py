"""Brick-sharded TSDF fusion over a device mesh.

The brick axis is the natural parallel axis of the sparse engine: each
device owns a contiguous range of bricks (its slab of the volume in brick
order), frames replicate, and every device runs the SAME chunk loop as a
single card (``ops.tsdf_brick.integrate_chunks``) on its own range — no
collectives at all during integration (surface work divides across the
mesh; the grid moves only at extraction).

Implementation: ``shard_map`` over a 1-D mesh. Each shard computes the
global active bits (cheap, replicated math), slices its own brick range,
compacts locally, and updates its rows with the global-id offset of its
range.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from reconplan_tpu.ops import tsdf_brick as tb
from reconplan_tpu.parallel.mesh import make_mesh


def make_sharded_brick_grid(dims, origin, voxel_size, mesh=None, trunc=None):
    """BrickGrid whose (sdf, weight) rows are split evenly over the mesh
    (sharded on axis 0)."""
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    grid = tb.make_brick_grid(dims, origin, voxel_size, trunc)
    nb = grid.sdf.shape[0]
    if nb % n_dev:
        raise ValueError(f"{nb} bricks not divisible by {n_dev} devices")
    sharding = NamedSharding(mesh, P(mesh.axis_names[0], None, None))
    return grid._replace(
        sdf=jax.device_put(grid.sdf, sharding),
        weight=jax.device_put(grid.weight, sharding),
    )


@partial(
    jax.jit,
    static_argnames=("mesh", "brick_dims", "max_active", "voxel_size",
                     "trunc", "depth_scale", "depth_max", "max_weight"),
    donate_argnums=(0, 1),
)
def _sharded_chunks(sdf, weight, depths, poses, intr, origin, mesh,
                    brick_dims, max_active, voxel_size, trunc, depth_scale,
                    depth_max, max_weight):
    axis = mesh.axis_names[0]
    nb_local = sdf.shape[0] // mesh.devices.size
    vol = P(axis, None, None)

    def shard_fn(sdf_l, w_l, depths_r, poses_r, intr_r, origin_r):
        sdf_o, w_o, _, n_active = tb.integrate_chunks(
            sdf_l, w_l, None, poses_r, intr_r, depths_r, None, origin_r,
            jax.lax.axis_index(axis) * nb_local, brick_dims, max_active,
            voxel_size, trunc, depth_scale, depth_max, max_weight,
            tb.FRAMES_PER_CHUNK,
        )
        return sdf_o, w_o, n_active[None]

    return shard_map(
        shard_fn, mesh=mesh, in_specs=(vol, vol, P(), P(), P(), P()),
        out_specs=(vol, vol, P(axis)), check_vma=False,
    )(sdf, weight, depths, poses, intr, origin)


def sharded_integrate_frames_bricked(
    grid,
    depths,
    poses_cam_to_world,
    fx, fy, cx, cy,
    mesh=None,
    depth_scale=1000.0,
    depth_max=3.0,
    max_weight=64.0,
    max_active_per_device=4096,
):
    """Integrate frames into a brick-sharded grid from
    :func:`make_sharded_brick_grid`. Returns (grid, n_active) with
    ``n_active`` (n_devices, n_chunks) the unclamped active brick count of
    each device's range per chunk."""
    sdf, w, n_active = _sharded_chunks(
        grid.sdf, grid.weight,
        jnp.asarray(depths, dtype=jnp.float32),
        jnp.asarray(poses_cam_to_world, dtype=jnp.float32),
        jnp.asarray([fx, fy, cx, cy], dtype=jnp.float32),
        grid.origin, mesh or make_mesh(), grid.brick_dims,
        max_active_per_device, grid.voxel_size, grid.trunc, depth_scale,
        depth_max, max_weight,
    )
    return grid._replace(sdf=sdf, weight=w), n_active


def gather_brick_grid(grid):
    """Copy a brick-sharded grid whole onto the first device for
    extraction."""
    device = jax.devices()[0]
    return grid._replace(
        sdf=jax.device_put(grid.sdf, device),
        weight=jax.device_put(grid.weight, device),
    )
