"""TSDF fusion pipelines: frames -> grid -> mesh.

The flagship compute path of the framework (BASELINE.json configs 1/3/4/5):
RGBD frames + camera poses stream through :func:`integrate_frames` into a
dense TSDF, and meshes come out via marching cubes. For multi-chip scaling
see ``reconplan_tpu.parallel.sharded_fusion``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from reconplan_tpu.io.frames import FrameSet
from reconplan_tpu.ops import tsdf as tsdf_ops
from reconplan_tpu.ops.marching import marching_cubes


@dataclass
class FusionPipeline:
    """Stateful fusion session around one TSDF grid.

    ``engine``:
      * "brick" (default): the brick-sparse engine (ops.tsdf_brick) —
        surface-proportional work; color integrates as a packed-RGB brick
        plane with dense-engine averaging semantics.
      * "dense": the dense reference engine (ops.tsdf) — every call
        sweeps the whole grid.
    """

    dims: tuple = (256, 256, 256)
    origin: tuple = (-0.25, -0.25, -0.25)
    voxel_size: float = 0.5 / 255
    trunc: float | None = None
    with_color: bool = False
    depth_scale: float = 1000.0
    depth_max: float = 3.0
    engine: str = "brick"

    def __post_init__(self):
        if self.engine == "brick":
            from reconplan_tpu.ops import tsdf_brick as tb

            self.grid = tb.make_brick_grid(
                self.dims, self.origin, self.voxel_size, self.trunc,
                with_color=self.with_color,
            )
        else:
            self.grid = tsdf_ops.make_grid(
                self.dims, self.origin, self.voxel_size, self.trunc, self.with_color
            )

    def integrate(self, frames: FrameSet, intrinsics=None):
        """Integrate a FrameSet (poses required) into the grid."""
        if frames.poses is None:
            raise ValueError("FusionPipeline.integrate requires camera poses")
        fx, fy, cx, cy = intrinsics or frames.intrinsics
        if self.engine == "brick":
            from reconplan_tpu.ops import tsdf_brick as tb

            self.grid, _ = tb.integrate_frames_bricked_device(
                self.grid,
                jnp.asarray(frames.depth),
                jnp.asarray(frames.poses),
                fx, fy, cx, cy,
                colors=(
                    frames.color
                    if self.with_color and frames.color is not None
                    else None
                ),
                depth_scale=frames.depth_scale or self.depth_scale,
                depth_max=self.depth_max,
            )
            return self
        colors = None
        if self.with_color and frames.color is not None:
            colors = jnp.asarray(frames.color, dtype=jnp.float32)
            colors = jnp.where(colors.max() > 1.5, colors / 255.0, colors)
        self.grid = tsdf_ops.integrate_frames(
            self.grid,
            jnp.asarray(frames.depth),
            jnp.asarray(frames.poses),
            fx, fy, cx, cy,
            colors=colors,
            depth_scale=frames.depth_scale or self.depth_scale,
            depth_max=self.depth_max,
        )
        return self

    def _dense_grid(self):
        if self.engine == "brick":
            from reconplan_tpu.ops import tsdf_brick as tb

            sdf, weight = tb.to_dense(self.grid)
            color = (
                tb.to_dense_color(self.grid)
                if self.grid.rgb is not None
                else jnp.zeros((0, 0, 0, 3), dtype=jnp.float32)
            )
            return tsdf_ops.TSDFGrid(
                sdf, weight, color,
                self.grid.origin, jnp.float32(self.grid.voxel_size),
                jnp.float32(self.grid.trunc),
            )
        return self.grid

    def extract_mesh(self, weight_min=1.0, with_colors=False):
        """Zero iso-surface as a (T, 3, 3) triangle array (world frame).
        ``with_colors`` also returns (T, 3, 3) per-vertex RGB in [0, 1]
        sampled from the color volume (nearest voxel)."""
        grid = self._dense_grid()
        tris = marching_cubes(grid, weight_min=weight_min)
        if not with_colors:
            return tris
        return tris, self._sample_colors(grid, tris.reshape(-1, 3)).reshape(
            tris.shape
        )

    @staticmethod
    def _sample_colors(grid, points):
        """Nearest-voxel color lookup for world-space points."""
        if not grid.has_color:
            raise ValueError("grid has no color channel")
        D, H, W = grid.sdf.shape
        ijk = jnp.round(
            (jnp.asarray(points) - grid.origin) / grid.voxel_size
        ).astype(jnp.int32)
        k = jnp.clip(ijk[:, 0], 0, W - 1)
        j = jnp.clip(ijk[:, 1], 0, H - 1)
        i = jnp.clip(ijk[:, 2], 0, D - 1)
        return np.asarray(grid.color[i, j, k])

    def extract_points(self, weight_min=1.0, with_colors=False):
        grid = self._dense_grid()
        pts, mask = tsdf_ops.extract_surface_points(grid, weight_min)
        pts = np.asarray(pts)[np.asarray(mask)]
        if not with_colors:
            return pts
        return pts, self._sample_colors(grid, pts)


def fuse_frameset(frames: FrameSet, dims=(256, 256, 256), origin=None,
                  voxel_size=None, with_color=False, weight_min=1.0):
    """One-shot fusion of a posed FrameSet. Auto-fits the grid to the
    observed volume when origin/voxel_size are omitted (from the frustum
    of the poses at median depth)."""
    if origin is None or voxel_size is None:
        # estimate bounds from camera positions and look directions
        eyes = frames.poses[:, :3, 3]
        centers = eyes + frames.poses[:, :3, 2] * np.median(
            frames.depth[frames.depth > 0] / (frames.depth_scale or 1000.0)
        )
        lo = centers.min(axis=0) - 0.2
        hi = centers.max(axis=0) + 0.2
        origin = tuple(lo)
        voxel_size = float((hi - lo).max() / (max(dims) - 1))
    pipe = FusionPipeline(
        dims=dims, origin=tuple(origin), voxel_size=voxel_size, with_color=with_color
    )
    pipe.integrate(frames)
    return pipe
