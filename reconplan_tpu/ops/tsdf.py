"""TSDF volumetric fusion (KinectFusion-style), dense reference engine.

The reference ships YCB ``tsdf/`` meshes as data but implements no fusion
(SURVEY.md intro note); this module is the plain XLA engine that the
brick-sparse engine (``ops.tsdf_brick``) is tested against. Both engines
share :func:`world_to_camera`, :func:`project_to_pixels` and
:func:`fuse_observation`, so a voxel sees the same pixel and the same
update in either.

Design:
  * voxel-centric GATHER formulation: every voxel projects into the depth
    image and samples it — an elementwise pass plus one gather, which XLA
    fuses into a single sweep of the grid per frame batch.
  * fixed shapes everywhere; the grid is a pytree (works under jit/donate
    and shards spatially over a device mesh along z — see
    ``reconplan_tpu.parallel``).
  * multi-frame integration amortizes grid traffic: ``integrate_frames``
    folds F frames in one pass over the grid (the grid is read+written
    once, not F times).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


class TSDFGrid(NamedTuple):
    """Dense truncated signed distance grid.

    sdf is stored in truncation units (range [-1, 1], 1 = empty space in
    front of any surface by >= trunc meters). weight counts integrated
    observations (clamped at ``max_weight`` for drift robustness).
    """

    sdf: jnp.ndarray  # (D, H, W) f32, init +1
    weight: jnp.ndarray  # (D, H, W) f32, init 0
    color: jnp.ndarray  # (D, H, W, 3) f32 or (0, 0, 0, 3) when colorless
    origin: jnp.ndarray  # (3,) world position of voxel (0,0,0) CENTER
    voxel_size: jnp.ndarray  # () meters
    trunc: jnp.ndarray  # () meters

    @property
    def shape(self):
        return self.sdf.shape

    @property
    def has_color(self):
        return self.color.shape[:3] == self.sdf.shape


def make_grid(
    dims, origin, voxel_size, trunc=None, with_color=False, dtype=jnp.float32
) -> TSDFGrid:
    """Allocate an empty grid. ``dims`` = (D, H, W) voxels; ``origin`` is
    the world position of the (0,0,0) voxel center; ``trunc`` defaults to
    5 voxels (the usual KinectFusion setting)."""
    D, H, W = dims
    if trunc is None:
        trunc = 5.0 * voxel_size
    color = (
        jnp.zeros((D, H, W, 3), dtype=dtype)
        if with_color
        else jnp.zeros((0, 0, 0, 3), dtype=dtype)
    )
    return TSDFGrid(
        sdf=jnp.ones((D, H, W), dtype=dtype),
        weight=jnp.zeros((D, H, W), dtype=dtype),
        color=color,
        origin=jnp.asarray(origin, dtype=jnp.float32),
        voxel_size=jnp.asarray(voxel_size, dtype=jnp.float32),
        trunc=jnp.asarray(trunc, dtype=jnp.float32),
    )


def _voxel_world_coords(grid: TSDFGrid):
    """(D, H, W, 3) world coordinates of voxel centers, built from iota (no
    materialized meshgrid input — XLA fuses it into the consumer)."""
    D, H, W = grid.sdf.shape
    zi = jax.lax.broadcasted_iota(jnp.float32, (D, H, W), 0)
    yi = jax.lax.broadcasted_iota(jnp.float32, (D, H, W), 1)
    xi = jax.lax.broadcasted_iota(jnp.float32, (D, H, W), 2)
    # grid axes: (z, y, x) index order -> world x from axis 2, etc.
    coords = jnp.stack([xi, yi, zi], axis=-1)
    return grid.origin + coords * grid.voxel_size


def world_to_camera(wx, wy, wz, T_w2c):
    """Camera coordinates of world points given as separate x/y/z planes.

    The rotation is applied as 9 scalar multiply-adds, which XLA fuses
    into the consuming elementwise kernel (no (..., 3) tensor is ever
    materialized: at 512^3 one costs 1.5 GB per frame).
    """
    R = T_w2c[:3, :3]
    t = T_w2c[:3, 3]
    x = R[0, 0] * wx + R[0, 1] * wy + R[0, 2] * wz + t[0]
    y = R[1, 0] * wx + R[1, 1] * wy + R[1, 2] * wz + t[1]
    z = R[2, 0] * wx + R[2, 1] * wy + R[2, 2] * wz + t[2]
    return x, y, z


def project_to_pixels(x, y, z, fx, fy, cx, cy, Hd, Wd):
    """Nearest pixel of camera-frame points.

    Returns (flat row-major pixel index, clamped into the image; inside:
    in front of the camera and within the image)."""
    z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    ui = jnp.round(x / z_safe * fx + cx).astype(jnp.int32)
    vi = jnp.round(y / z_safe * fy + cy).astype(jnp.int32)
    inside = (z > 1e-4) & (ui >= 0) & (ui < Wd) & (vi >= 0) & (vi < Hd)
    flat = jnp.clip(vi, 0, Hd - 1) * Wd + jnp.clip(ui, 0, Wd - 1)
    return flat, inside


def fuse_observation(sdf, weight, color, d, z, inside, c_obs,
                     trunc, depth_max, max_weight):
    """One frame's projective TSDF update of voxels at camera depth ``z``
    that observe depth ``d`` (meters) at their pixel.

    ``sdf`` is in truncation units, ``weight`` counts observations; the
    new sdf and ``color`` (``(..., 3)``, any scale, or None) are running
    averages weighted by observation count (Open3D semantics). Returns
    (sdf, weight, color)."""
    ok = inside & (d > 0.0) & (d < depth_max)
    sdf_obs = d - z  # meters, positive in front of the surface
    ok = ok & (sdf_obs > -trunc)
    tsdf_obs = jnp.clip(sdf_obs / trunc, -1.0, 1.0)
    w_obs = ok.astype(sdf.dtype)
    w_new = weight + w_obs
    denom = jnp.maximum(w_new, 1.0)
    sdf_new = (sdf * weight + tsdf_obs * w_obs) / denom
    sdf_new = jnp.where(w_new > 0, sdf_new, 1.0)
    if color is not None:
        color = (
            color * weight[..., None] + c_obs * w_obs[..., None]
        ) / denom[..., None]
    return sdf_new, jnp.minimum(w_new, max_weight), color


def _integrate_chunk(sdf, weight, color, z_index0, origin, voxel,
                     depths, colors, T_w2c_all, params):
    """Fold all F frames into one z-chunk of the grid (its first slice
    is z index ``z_index0``).

    The frame loop unrolls as elementwise chains over the chunk; with
    chunks sized ~16M voxels only a couple of chunk-sized temporaries are
    live at once, while the grid itself is still read and written exactly
    once for the whole F-frame batch.
    """
    fx, fy, cx, cy, depth_scale, depth_max, trunc, max_weight = params
    F, Hd, Wd = depths.shape
    shape = sdf.shape
    # world coordinates as origin + integer index * voxel (the brick
    # engine forms them the same way, so both see identical points)
    zi = jax.lax.broadcasted_iota(jnp.float32, shape, 0) + z_index0
    yi = jax.lax.broadcasted_iota(jnp.float32, shape, 1)
    xi = jax.lax.broadcasted_iota(jnp.float32, shape, 2)
    wx = origin[0] + xi * voxel
    wy = origin[1] + yi * voxel
    wz = origin[2] + zi * voxel

    use_color = color is not None and colors is not None
    for f in range(F):
        x, y, z = world_to_camera(wx, wy, wz, T_w2c_all[f])
        flat, inside = project_to_pixels(x, y, z, fx, fy, cx, cy, Hd, Wd)
        d = depths[f].reshape(-1)[flat].astype(jnp.float32) / depth_scale
        c_obs = (
            colors[f].reshape(-1, 3)[flat].astype(sdf.dtype)
            if use_color else None
        )
        sdf, weight, c_new = fuse_observation(
            sdf, weight, color if use_color else None, d, z, inside, c_obs,
            trunc, depth_max, max_weight,
        )
        if use_color:
            color = c_new
    return sdf, weight, color


@partial(
    jax.jit,
    static_argnames=("depth_scale", "depth_max", "max_weight"),
    donate_argnums=(0,),
)
def integrate_frames(
    grid: TSDFGrid,
    depths: jnp.ndarray,  # (F, H, W) raw depth
    poses_cam_to_world: jnp.ndarray,  # (F, 4, 4)
    fx, fy, cx, cy,
    colors: jnp.ndarray | None = None,  # (F, H, W, 3) in [0,1]
    depth_scale: float = 1000.0,
    depth_max: float = 3.0,
    max_weight: float = 64.0,
) -> TSDFGrid:
    """Integrate a batch of F frames into the grid in ONE grid sweep.

    The grid is processed in z-chunks (``lax.map``): within a chunk the
    frame loop unrolls into fused elementwise chains, so sdf/weight are
    read and written once for the whole batch (per-frame HBM traffic drops
    by ~F versus per-frame calls) while peak temp memory stays bounded by
    a few chunk-sized buffers. Poses are camera->world; inverted once.
    """
    T_w2c = jnp.linalg.inv(poses_cam_to_world)
    params = (
        jnp.float32(fx),
        jnp.float32(fy),
        jnp.float32(cx),
        jnp.float32(cy),
        depth_scale,
        depth_max,
        grid.trunc,
        max_weight,
    )
    D, H, W = grid.sdf.shape
    # chunk to ~16M voxels to bound temporaries (512^3 would otherwise OOM)
    target = 1 << 24
    n_chunks = 1
    while (D % (2 * n_chunks) == 0) and (D // n_chunks) * H * W > target:
        n_chunks *= 2
    Dc = D // n_chunks

    has_color = grid.has_color
    sdf_c = grid.sdf.reshape(n_chunks, Dc, H, W)
    w_c = grid.weight.reshape(n_chunks, Dc, H, W)
    col_c = grid.color.reshape(n_chunks, Dc, H, W, 3) if has_color else None
    z_starts = jnp.arange(n_chunks, dtype=jnp.float32) * Dc

    def chunk_fn(args):
        if has_color:
            sdf_k, w_k, col_k, z_start = args
        else:
            (sdf_k, w_k, z_start), col_k = args, None
        sdf_k, w_k, col_k = _integrate_chunk(
            sdf_k, w_k, col_k, z_start, grid.origin, grid.voxel_size,
            depths, colors if has_color else None, T_w2c, params,
        )
        if has_color:
            return sdf_k, w_k, col_k
        return sdf_k, w_k

    if has_color:
        sdf_c, w_c, col_c = jax.lax.map(chunk_fn, (sdf_c, w_c, col_c, z_starts))
    else:
        sdf_c, w_c = jax.lax.map(chunk_fn, (sdf_c, w_c, z_starts))

    return TSDFGrid(
        sdf_c.reshape(D, H, W),
        w_c.reshape(D, H, W),
        col_c.reshape(D, H, W, 3) if has_color else grid.color,
        grid.origin,
        grid.voxel_size,
        grid.trunc,
    )


@partial(jax.jit, static_argnames=("max_points",))
def extract_surface_points(grid: TSDFGrid, weight_min: float = 1.0, max_points: int = 0):
    """Surface voxel centers (|sdf| < 1 voxel) with validity mask.

    Cheap alternative to marching cubes for Chamfer-style evaluation:
    returns (points (N, 3), valid (N,)) with N = D*H*W (fixed shape); use
    ``ops.marching_cubes`` for true meshes.
    """
    world = _voxel_world_coords(grid)
    band = grid.voxel_size / grid.trunc
    mask = (jnp.abs(grid.sdf) < band) & (grid.weight >= weight_min)
    return world.reshape(-1, 3), mask.reshape(-1)


@partial(jax.jit, static_argnames=("height", "width", "n_steps"))
def raycast_depth(
    grid: TSDFGrid,
    T_cam_to_world: jnp.ndarray,
    fx, fy, cx, cy,
    height: int,
    width: int,
    near: float = 0.1,
    far: float = 3.0,
    n_steps: int = 192,
):
    """Render a depth map from the TSDF by fixed-step ray marching with
    sign-change interpolation (the KinectFusion surface prediction step;
    used for frame-to-model tracking and for model inspection).
    """
    u = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1)
    v = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0)
    dirs_cam = jnp.stack(
        [(u - cx) / fx, (v - cy) / fy, jnp.ones_like(u)], axis=-1
    )
    R = T_cam_to_world[:3, :3]
    eye = T_cam_to_world[:3, 3]
    dirs = jnp.tensordot(dirs_cam, R.T, axes=1, precision=_HI)

    D, H, W = grid.sdf.shape
    inv_vox = 1.0 / grid.voxel_size

    def sample_sdf(p):
        g = (p - grid.origin) * inv_vox
        xi = jnp.clip(jnp.round(g[..., 0]).astype(jnp.int32), 0, W - 1)
        yi = jnp.clip(jnp.round(g[..., 1]).astype(jnp.int32), 0, H - 1)
        zi = jnp.clip(jnp.round(g[..., 2]).astype(jnp.int32), 0, D - 1)
        inside = (
            (g[..., 0] >= 0) & (g[..., 0] <= W - 1)
            & (g[..., 1] >= 0) & (g[..., 1] <= H - 1)
            & (g[..., 2] >= 0) & (g[..., 2] <= D - 1)
        )
        s = grid.sdf[zi, yi, xi]
        w = grid.weight[zi, yi, xi]
        return jnp.where(inside & (w > 0), s, 1.0)

    step = (far - near) / n_steps

    def body(i, state):
        t_hit, prev_s = state
        t = near + i * step
        p = eye + dirs * t
        s = sample_sdf(p)
        crossed = (prev_s > 0) & (s <= 0) & (t_hit < 0)
        # linear interpolation of the crossing point
        frac = prev_s / jnp.maximum(prev_s - s, 1e-9)
        t_cross = t - step + frac * step
        t_hit = jnp.where(crossed, t_cross, t_hit)
        return t_hit, s

    t0 = jnp.full((height, width), -1.0)
    s0 = jnp.ones((height, width))
    t_hit, _ = jax.lax.fori_loop(0, n_steps, body, (t0, s0))
    # dirs_cam has z == 1, so the camera-frame depth of a hit equals t_hit
    return jnp.where(t_hit > 0, t_hit, 0.0)
