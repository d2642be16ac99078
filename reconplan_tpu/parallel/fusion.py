"""Spatially-sharded TSDF fusion over a device mesh.

The 512^3 north-star grid is 0.5-1 GB of state; frames are ~1 MB each. So
the grid shards along z across the device mesh and NEVER moves; depth frames
replicate to every device. The integration kernel
(:func:`reconplan_tpu.ops.tsdf.integrate_frames`) is purely elementwise
over the grid plus gathers from the (replicated) frames, so under GSPMD the
z-sharding propagates straight through — zero collectives in steady state,
each device sweeping only its slab. An ``all_gather`` happens only when the
host extracts the mesh (:func:`gather_grid`).

This deliberately uses jit + sharding annotations rather than shard_map:
the computation is embarrassingly spatial, exactly the case where XLA's
SPMD partitioner does the right thing from annotations alone
(scaling-book recipe: annotate, let XLA insert collectives, profile).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from reconplan_tpu.ops import tsdf as tsdf_ops
from reconplan_tpu.parallel.mesh import make_mesh, replicate, shard_grid


def make_sharded_grid(dims, origin, voxel_size, mesh=None, trunc=None,
                      with_color=False):
    """Allocate a TSDF grid with its volume arrays sharded along z."""
    mesh = mesh or make_mesh()
    grid = tsdf_ops.make_grid(dims, origin, voxel_size, trunc, with_color)
    vol_sharding = shard_grid(mesh)
    rep = replicate(mesh)
    return tsdf_ops.TSDFGrid(
        sdf=jax.device_put(grid.sdf, vol_sharding),
        weight=jax.device_put(grid.weight, vol_sharding),
        color=jax.device_put(grid.color, vol_sharding if grid.has_color else rep),
        origin=jax.device_put(grid.origin, rep),
        voxel_size=jax.device_put(grid.voxel_size, rep),
        trunc=jax.device_put(grid.trunc, rep),
    )


def sharded_integrate_frames(grid, depths, poses, fx, fy, cx, cy, mesh=None,
                             colors=None, **kwargs):
    """Integrate frames into a z-sharded grid.

    ``depths``/``poses`` are replicated across the mesh; the existing
    single-chip kernel runs unchanged — GSPMD partitions the grid sweep by
    the sharding of ``grid``.
    """
    mesh = mesh or make_mesh()
    rep = replicate(mesh)
    depths = jax.device_put(jnp.asarray(depths), rep)
    poses = jax.device_put(jnp.asarray(poses), rep)
    if colors is not None:
        colors = jax.device_put(jnp.asarray(colors), rep)
    return tsdf_ops.integrate_frames(
        grid, depths, poses, fx, fy, cx, cy, colors=colors, **kwargs
    )


def gather_grid(grid):
    """Pull a sharded grid to fully-replicated (for host-side extraction)."""
    dev = jax.devices()[0]
    return jax.tree.map(lambda x: jax.device_put(x, dev), grid)
