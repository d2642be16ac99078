"""Brick-sparse TSDF fusion: the production engine.

Only bricks near a frame's observed surface are updated, so work follows
the surface area instead of the volume (~5-20k of 131k bricks for a 512^3
scan of a tabletop object). Per chunk of frames:

  1. **selection** (:func:`select_active_bits`): a per-frame bit word per
     brick from a conservative depth-bin occupancy test
     (:func:`_build_depth_occupancy`, :func:`active_brick_bits`),
     intersected with an exact centre-sample test dilated one brick
     (:func:`_exact_frame_bits_dilated`); a brick is active in the chunk
     when any of its bits is set;
  2. **compaction** (:func:`_compact`): the active brick ids, in index
     order, padded to a static cap with distinct out-of-range ids;
  3. **update** (:func:`integrate_bricks`): gather the active brick rows,
     apply every frame of the chunk through the dense engine's own
     per-voxel rule (``ops.tsdf.fuse_observation``), and scatter the rows
     back; padding rows are dropped by the scatter.

A voxel of an active brick therefore gets exactly the dense engine's
update for every frame of the chunk, so its weight never exceeds the
dense weight. It misses what the dense engine adds in chunks where its
brick is inactive: mostly free-space observations far in front of the
surface, and a few in-band ones, because both selection tests sample
the frame at the brick's centre only. The exact test reads one pixel,
which a silhouette or grazing surface can leave out of band while some
voxel of the brick is in band; the occupancy test reads one dilated
cell, which misses in-band voxels once the projected brick radius
exceeds the dilation's reach (see :func:`_build_depth_occupancy`).

The update is plain XLA: a single card and a device mesh
(``parallel.brick``) run the same :func:`integrate_chunks`.

Memory layout: the volume lives as BRICKED arrays ``(NB, 8, 128)``, one
row per 8x8x16-voxel brick (axis 1 = local z, axis 2 = local y*16 + x).
Dense (D, H, W) views are produced on demand for marching cubes.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from reconplan_tpu.ops.tsdf import (
    fuse_observation,
    project_to_pixels,
    world_to_camera,
)

BRICK_Z, BRICK_Y, BRICK_X = 8, 8, 16  # 8x8x16 voxels per brick
BRICK_VOX = BRICK_Y * BRICK_X
# pixels per occupancy cell of the selection's depth-bin mip
OCC_CELL = 8
# occupancy candidates the exact selection test examines per chunk (a
# compaction-cost bound, not a coverage limit; see select_active_bits)
REFINE_CAP = 4096
# frames per selection/update chunk (one i32 bit word per brick per chunk)
FRAMES_PER_CHUNK = 8


class BrickGrid(NamedTuple):
    """Bricked TSDF volume. Logical voxel (z, y, x) lives at brick
    (z//8, y//8, x//16), row position (z%8, (y%8)*16 + x%16)."""

    sdf: jnp.ndarray  # (NB, 8, 128) f32
    weight: jnp.ndarray  # (NB, 8, 128) f32
    dims: tuple  # (D, H, W) logical voxels
    origin: jnp.ndarray  # (3,)
    voxel_size: float
    trunc: float
    rgb: jnp.ndarray | None = None  # (NB, 8, 128) i32 packed B<<16|G<<8|R

    @property
    def brick_dims(self):
        D, H, W = self.dims
        return (D // BRICK_Z, H // BRICK_Y, W // BRICK_X)


def make_brick_grid(dims, origin, voxel_size, trunc=None,
                    with_color=False) -> BrickGrid:
    D, H, W = dims
    if D % BRICK_Z or H % BRICK_Y or W % BRICK_X:
        raise ValueError(f"dims {dims} must be multiples of (8, 8, 16)")
    nb = (D // BRICK_Z) * (H // BRICK_Y) * (W // BRICK_X)
    if trunc is None:
        trunc = 5.0 * voxel_size
    return BrickGrid(
        sdf=jnp.ones((nb, BRICK_Z, BRICK_VOX), dtype=jnp.float32),
        weight=jnp.zeros((nb, BRICK_Z, BRICK_VOX), dtype=jnp.float32),
        dims=tuple(dims),
        origin=jnp.asarray(origin, dtype=jnp.float32),
        voxel_size=float(voxel_size),
        trunc=float(trunc),
        rgb=(
            jnp.zeros((nb, BRICK_Z, BRICK_VOX), dtype=jnp.int32)
            if with_color
            else None
        ),
    )


def _debrick(a, dims):
    D, H, W = dims
    bd, bh, bw = D // BRICK_Z, H // BRICK_Y, W // BRICK_X
    a = a.reshape(bd, bh, bw, BRICK_Z, BRICK_Y, BRICK_X)
    return a.transpose(0, 3, 1, 4, 2, 5).reshape(D, H, W)


def to_dense(grid: BrickGrid):
    """Bricked -> dense (D, H, W) sdf/weight (for extraction)."""
    return _debrick(grid.sdf, grid.dims), _debrick(grid.weight, grid.dims)


def _unpack_rgb(p):
    """Packed B<<16|G<<8|R i32 -> (..., 3) f32 in [0, 255]."""
    return jnp.stack([p & 255, (p >> 8) & 255, (p >> 16) & 255],
                     axis=-1).astype(jnp.float32)


def _pack_rgb(c):
    """(..., 3) f32 in [0, 255] -> packed i32 (rounded, clamped)."""
    q = jnp.clip(c + 0.5, 0.0, 255.0).astype(jnp.int32)
    return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)


def to_dense_color(grid: BrickGrid):
    """Bricked packed RGB -> dense (D, H, W, 3) f32 in [0, 1]."""
    if grid.rgb is None:
        raise ValueError("grid has no color plane (with_color=False)")
    return _unpack_rgb(_debrick(grid.rgb, grid.dims)) / 255.0


def from_dense(sdf, weight, origin, voxel_size, trunc) -> BrickGrid:
    D, H, W = sdf.shape
    bd, bh, bw = D // BRICK_Z, H // BRICK_Y, W // BRICK_X

    def brick(a):
        a = a.reshape(bd, BRICK_Z, bh, BRICK_Y, bw, BRICK_X)
        return a.transpose(0, 2, 4, 1, 3, 5).reshape(-1, BRICK_Z, BRICK_VOX)

    return BrickGrid(
        brick(sdf), brick(weight), (D, H, W),
        jnp.asarray(origin, dtype=jnp.float32), float(voxel_size), float(trunc),
    )


def _brick_coords(ids, brick_dims):
    """(bz, by, bx) i32 brick coordinates of global brick ids."""
    _, bh, bw = brick_dims
    return ids // (bh * bw), (ids // bw) % bh, ids % bw


def _brick_centers(ids, brick_dims, origin, voxel_size):
    """World coordinates (x, y, z planes) of brick centres."""
    bz, by, bx = _brick_coords(ids, brick_dims)
    return (
        origin[0] + (bx.astype(jnp.float32) * BRICK_X + BRICK_X / 2) * voxel_size,
        origin[1] + (by.astype(jnp.float32) * BRICK_Y + BRICK_Y / 2) * voxel_size,
        origin[2] + (bz.astype(jnp.float32) * BRICK_Z + BRICK_Z / 2) * voxel_size,
    )


# half the brick diagonal: a voxel lies within this of its brick's centre
BRICK_RADIUS_VOX = 0.5 * float(np.sqrt(BRICK_X**2 + BRICK_Y**2 + BRICK_Z**2))


# ---------------------------------------------------------------------------
# active brick selection
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("depth_scale", "depth_max", "mip_cell", "mip_rounds"),
)
def _build_depth_occupancy(
    depths, depth_scale=1000.0, depth_max=3.0, mip_cell=8, mip_rounds=4
):
    """Per-cell depth-occupancy bitmask over 64 ADAPTIVE bins spanning the
    chunk's valid-depth range, returned as two i32 planes (bins 0-31,
    32-63) plus the (b0, bin_size) parameters.

    A min/max depth interval per cell is hopeless at
    silhouettes — [min, max] spans object-to-background, so a band test
    activates the whole depth column between them (measured 3810 active
    bricks/chunk vs 683 exact at 512^3). A bin is set iff some valid pixel
    in the (dilated) neighborhood has depth in that bin, so bricks near NO
    surface sample stop matching. Bins are fitted to the chunk's observed
    [min, max] depth (>= 2 mm each) because fixed depth_max/64 bins are
    coarser than the activation band itself. Dilation is a bitwise OR —
    trivially conservative. Defaults (8 px cells, 4 rounds) give a
    32-40 px guaranteed reach, covering projected brick radii for
    surfaces beyond ~0.3 m at 512^3 scale.
    """
    F, Hd, Wd = depths.shape
    Hm, Wm = -(-Hd // mip_cell), -(-Wd // mip_cell)
    # pad to whole cells with invalid (zero) depth
    d = jnp.pad(
        depths.astype(jnp.float32) / depth_scale,
        ((0, 0), (0, Hm * mip_cell - Hd), (0, Wm * mip_cell - Wd)),
    )
    valid = (d > 0.0) & (d < depth_max)
    gmin = jnp.min(jnp.where(valid, d, jnp.inf))
    gmax = jnp.max(jnp.where(valid, d, -jnp.inf))
    gmin = jnp.where(jnp.isfinite(gmin), gmin, 0.0)
    gmax = jnp.where(jnp.isfinite(gmax), gmax, 0.0)
    bs = jnp.maximum((gmax - gmin) / 62.0, 0.002)
    b0 = gmin - bs  # bin 1 starts at gmin; 0 and 63 stay as margin
    bins = jnp.clip(((d - b0) / bs).astype(jnp.int32), 0, 63)
    cells = bins.reshape(F, Hm, mip_cell, Wm, mip_cell)
    vcells = valid.reshape(F, Hm, mip_cell, Wm, mip_cell)
    b = jnp.where(vcells, cells, 0)
    # clamp the shift operand BEFORE the select: an i32 shift by >= 32 or
    # < 0 would set garbage bins
    lo_bit = jnp.where(
        vcells & (b < 32),
        jnp.left_shift(jnp.int32(1), jnp.clip(b, 0, 31)),
        0,
    )
    hi_bit = jnp.where(
        vcells & (b >= 32),
        jnp.left_shift(jnp.int32(1), jnp.clip(b - 32, 0, 31)),
        0,
    )
    lo_bit = lo_bit.transpose(0, 1, 3, 2, 4).reshape(F, Hm, Wm, -1)
    hi_bit = hi_bit.transpose(0, 1, 3, 2, 4).reshape(F, Hm, Wm, -1)
    occ0 = jax.lax.reduce(lo_bit, np.int32(0), jax.lax.bitwise_or, (3,))
    occ1 = jax.lax.reduce(hi_bit, np.int32(0), jax.lax.bitwise_or, (3,))
    for _ in range(mip_rounds):  # separable 3x3 OR dilation
        for ax in (1, 2):
            occ0 = occ0 | jnp.roll(occ0, 1, ax) | jnp.roll(occ0, -1, ax)
            occ1 = occ1 | jnp.roll(occ1, 1, ax) | jnp.roll(occ1, -1, ax)
    return occ0, occ1, jnp.stack([b0, bs])


def _lowmask(n):
    """Vector i32 bits [0..n] inclusive; n < 0 -> 0, n >= 31 -> all ones."""
    base = jnp.left_shift(jnp.int32(1), jnp.clip(n + 1, 0, 31)) - 1
    base = jnp.where(n >= 31, jnp.int32(-1), base)
    return jnp.where(n < 0, jnp.int32(0), base)


def active_brick_bits(
    brick_dims, origin, voxel_size, trunc,
    occ0, occ1, binp, T_w2c, intr, mip_cell=OCC_CELL,
):
    """(NB,) i32 conservative per-frame occupancy bits (bit f set = the
    brick may hold an in-band voxel in frame f; union = bits != 0).

    ``occ0``/``occ1``/``binp`` are the depth-bin occupancy planes and bin
    parameters of :func:`_build_depth_occupancy` for the frame chunk.
    A brick is active in frame f when some occupied depth bin in the
    cell its centre projects to overlaps [z_c - band, z_c + band], band =
    trunc + r_brick + margin: a voxel can only satisfy |d - z| < trunc when
    |z_c - d| <= r_b + trunc and d's bin is occupied, so this misses no
    in-band update while the brick's voxels project within the occupancy
    dilation's reach of its centre's cell, and unlike a [min, max]-interval
    band test it does not activate the empty slab between object and
    background at silhouettes.
    """
    F, Hm, Wm = occ0.shape
    NB = brick_dims[0] * brick_dims[1] * brick_dims[2]
    ccx, ccy, ccz = _brick_centers(
        jnp.arange(NB, dtype=jnp.int32), brick_dims, origin, voxel_size
    )
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    band = trunc + BRICK_RADIUS_VOX * voxel_size + 2e-3
    b0 = binp[0]
    inv_bs = 1.0 / binp[1]
    active = jnp.zeros((NB,), dtype=jnp.int32)
    for f in range(F):
        x, y, z = world_to_camera(ccx, ccy, ccz, T_w2c[f])
        zs = jnp.maximum(z, 1e-6)
        uci = jnp.clip((x / zs * fx + cx).astype(jnp.int32) // mip_cell, 0, Wm - 1)
        vci = jnp.clip((y / zs * fy + cy).astype(jnp.int32) // mip_cell, 0, Hm - 1)
        g0 = occ0[f, vci, uci]
        g1 = occ1[f, vci, uci]
        # bins overlapping [z - band, z + band] (floor-extended: a bin
        # [b0 + b*bs, b0 + (b+1)*bs) intersects iff b_lo - 1 <= b <= b_hi)
        b_lo = jnp.floor((z - band - b0) * inv_bs).astype(jnp.int32) - 1
        b_hi = jnp.floor((z + band - b0) * inv_bs).astype(jnp.int32)
        m0 = _lowmask(jnp.minimum(b_hi, 31)) & ~_lowmask(jnp.minimum(b_lo, 32) - 1)
        m1 = _lowmask(b_hi - 32) & ~_lowmask(b_lo - 33)
        hit = (z > 1e-4) & (((g0 & m0) | (g1 & m1)) != 0)
        active = active | jnp.where(hit, jnp.int32(1 << f), 0)
    return active


def _exact_frame_bits_dilated(
    occ_bits, depths, T_w2c, origin, voxel_size, trunc, intr,
    brick_dims, cap, depth_scale, depth_max,
):
    """Per-frame EXACT center-sample bits on the occupancy candidates,
    dilated one brick in each axis direction (brick-space OR of the bit
    words, so dilation is per-frame too). Intersecting the conservative
    occupancy superset with this reproduces the round-1 exact+dilate
    coverage class while pruning the occupancy's cell/bin quantization
    bleed (~3x looser per frame at silhouettes).

    When more than ``cap`` candidate bricks are occupancy-active, the
    overflow candidates are NOT refined — they keep their conservative
    occupancy bits instead of being zeroed, so coverage never drops below
    the occupancy superset regardless of cap (they merely miss the
    per-frame pruning)."""
    bd, bh, bw = brick_dims
    NB = bd * bh * bw
    cap = min(cap, NB)  # small grids: argsort can't yield more than NB ids
    F, Hd, Wd = depths.shape
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    # stable-argsort compaction (see _compact): actives first
    # in index order, padding -> NB sentinel
    n_cand = jnp.sum(occ_bits != 0).astype(jnp.int32)
    cand = jnp.argsort(
        jnp.where(occ_bits != 0, jnp.int32(0), jnp.int32(1)), stable=True
    )[:cap]
    cand = jnp.where(jnp.arange(cap) < n_cand, cand, NB)
    cidx = jnp.minimum(cand, NB - 1)
    ccx, ccy, ccz = _brick_centers(cidx, brick_dims, origin, voxel_size)
    band = trunc + BRICK_RADIUS_VOX * voxel_size
    ebits = jnp.zeros(cand.shape, dtype=jnp.int32)
    for f in range(F):
        x, y, z = world_to_camera(ccx, ccy, ccz, T_w2c[f])
        zs = jnp.maximum(z, 1e-6)
        uf = x / zs * fx + cx
        vf = y / zs * fy + cy
        ui = jnp.clip(jnp.round(uf).astype(jnp.int32), 0, Wd - 1)
        vi = jnp.clip(jnp.round(vf).astype(jnp.int32), 0, Hd - 1)
        inside = (z > 1e-4) & (uf >= 0) & (uf < Wd) & (vf >= 0) & (vf < Hd)
        d = depths[f].reshape(-1)[vi * Wd + ui] / depth_scale
        hit = inside & (d > 0) & (d < depth_max) & (jnp.abs(d - z) < band)
        ebits = ebits | jnp.where(hit, jnp.int32(1 << f), 0)
    # candidates past the cap keep their occupancy bits (conservative):
    # rank = position among actives in index order, matching the stable
    # argsort compaction above, so rank < cap <=> examined.
    rank = jnp.cumsum(occ_bits != 0) - 1
    unexamined = (occ_bits != 0) & (rank >= cap)
    base = jnp.where(unexamined, occ_bits, 0)
    dense = jnp.concatenate(
        [base, jnp.zeros(1, jnp.int32)]
    ).at[cand].max(ebits)
    m = dense[:NB].reshape(bd, bh, bw)
    for ax in range(3):
        m = m | jnp.roll(m, 1, ax) | jnp.roll(m, -1, ax)
    return m.reshape(-1)


def select_active_bits(
    depths, T_w2c, intr, origin, brick_dims, voxel_size, trunc,
    refine_cap, depth_scale, depth_max,
):
    """(NB,) i32 per-frame active bits of one frame chunk: the
    conservative occupancy superset, pruned by the exact centre-sample
    test dilated one brick. The refine cap only bounds the compaction
    cost: candidates past it keep their occupancy bits."""
    occ0, occ1, binp = _build_depth_occupancy(
        depths, depth_scale, depth_max, OCC_CELL
    )
    bits = active_brick_bits(
        brick_dims, origin, voxel_size, trunc, occ0, occ1, binp, T_w2c, intr,
    )
    return bits & _exact_frame_bits_dilated(
        bits, depths, T_w2c, origin, voxel_size, trunc, intr,
        brick_dims, refine_cap, depth_scale, depth_max,
    )


def _compact(active, cap):
    """Ids of the set entries of ``active`` (in index order), padded to
    ``cap`` with DISTINCT out-of-range ids (len(active) + k), so the
    write-back scatter drops them and every index it keeps is unique.
    Returns (ids, unclamped active count)."""
    n = active.shape[0]
    cap = min(cap, n)
    n_active = jnp.sum(active).astype(jnp.int32)
    # stable argsort on the active flag keeps actives first, in index order
    ids = jnp.argsort(
        jnp.where(active, jnp.int32(0), jnp.int32(1)), stable=True
    )[:cap].astype(jnp.int32)
    k = jnp.arange(cap, dtype=jnp.int32)
    return jnp.where(k < n_active, ids, n + k), n_active


@partial(
    jax.jit,
    static_argnames=("brick_dims", "voxel_size", "trunc", "depth_scale",
                     "depth_max", "max_weight"),
    donate_argnums=(0, 1, 2),
)
def integrate_bricks(
    sdf_b, weight_b, rgb_b, ids, id_base, origin, T_w2c, intr,
    depths, colors, brick_dims, voxel_size, trunc, depth_scale, depth_max,
    max_weight,
):
    """Fold a frame chunk into the brick rows ``ids`` (one update step).

    ``ids`` index rows of ``sdf_b``/``weight_b``/``rgb_b``; ids past the
    last row are padding: their gather reads a dummy value and their
    scatter is dropped. Row r holds global brick ``r + id_base`` (a
    mesh shard's offset; 0 on one device). Every frame of the chunk
    updates every row, exactly as the dense engine updates those voxels.
    ``rgb_b``/``colors`` (packed i32, (F, H, W)) are None for depth only.
    Returns (sdf_b, weight_b, rgb_b).
    """
    F, Hd, Wd = depths.shape
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    sdf = sdf_b.at[ids].get(mode="fill", fill_value=1.0)
    w = weight_b.at[ids].get(mode="fill", fill_value=0.0)
    col = (
        _unpack_rgb(rgb_b.at[ids].get(mode="fill", fill_value=0))
        if rgb_b is not None else None
    )

    # voxel world coordinates as origin + integer index * voxel, the
    # same points the dense engine forms
    bz, by, bx = _brick_coords(ids + id_base, brick_dims)
    lz = jax.lax.broadcasted_iota(jnp.int32, (1, BRICK_Z, BRICK_VOX), 1)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, BRICK_Z, BRICK_VOX), 2)
    xi = bx[:, None, None] * BRICK_X + lane % BRICK_X
    yi = by[:, None, None] * BRICK_Y + lane // BRICK_X
    zi = bz[:, None, None] * BRICK_Z + lz
    wx = origin[0] + xi.astype(jnp.float32) * voxel_size
    wy = origin[1] + yi.astype(jnp.float32) * voxel_size
    wz = origin[2] + zi.astype(jnp.float32) * voxel_size

    for f in range(F):
        x, y, z = world_to_camera(wx, wy, wz, T_w2c[f])
        flat, inside = project_to_pixels(x, y, z, fx, fy, cx, cy, Hd, Wd)
        d = depths[f].reshape(-1)[flat] / depth_scale
        c_obs = (
            _unpack_rgb(colors[f].reshape(-1)[flat])
            if col is not None else None
        )
        sdf, w, col = fuse_observation(
            sdf, w, col, d, z, inside, c_obs, trunc, depth_max, max_weight
        )

    def put(plane, rows):
        return plane.at[ids].set(rows, mode="drop", unique_indices=True)

    return (
        put(sdf_b, sdf),
        put(weight_b, w),
        put(rgb_b, _pack_rgb(col)) if col is not None else None,
    )


def integrate_chunks(
    sdf_b, weight_b, rgb_b, poses, intr, depths, colors, origin,
    id_base, brick_dims, max_active, voxel_size, trunc, depth_scale,
    depth_max, max_weight, frames_per_dispatch,
):
    """Select, compact and update, chunk by chunk of
    ``frames_per_dispatch`` frames, the rows of one brick range: global
    bricks [id_base, id_base + len(sdf_b)). ``poses`` are camera->world.
    Selection is computed over the whole volume, so every range sees the
    same active set. Returns (sdf_b, weight_b, rgb_b, n_active) with
    ``n_active`` the UNCLAMPED active brick count of the range per chunk
    (a chunk above ``max_active`` dropped its highest-index bricks)."""
    T_w2c = jnp.linalg.inv(poses)
    n_rows = sdf_b.shape[0]
    n_active = []
    for f0 in range(0, depths.shape[0], frames_per_dispatch):
        sl = slice(f0, f0 + frames_per_dispatch)
        # stable scope names in the HLO op metadata, for reading traces
        with jax.named_scope("brick_select"):
            bits = select_active_bits(
                depths[sl], T_w2c[sl], intr, origin, brick_dims, voxel_size,
                trunc, REFINE_CAP, depth_scale, depth_max,
            )
        with jax.named_scope("brick_compact"):
            active = jax.lax.dynamic_slice(bits, (id_base,), (n_rows,)) != 0
            ids, n_chunk = _compact(active, max_active)
        n_active.append(n_chunk)
        with jax.named_scope("brick_update"):
            sdf_b, weight_b, rgb_b = integrate_bricks(
                sdf_b, weight_b, rgb_b, ids, id_base, origin, T_w2c[sl],
                intr, depths[sl], colors[sl] if colors is not None else None,
                brick_dims, voxel_size, trunc, depth_scale, depth_max,
                max_weight,
            )
    return sdf_b, weight_b, rgb_b, jnp.stack(n_active)


_integrate_device_all = jax.jit(
    integrate_chunks,
    static_argnames=(
        "brick_dims", "max_active", "voxel_size", "trunc", "depth_scale",
        "depth_max", "max_weight", "frames_per_dispatch",
    ),
    donate_argnums=(0, 1, 2),
)


def pack_colors(colors):
    """(F, H, W, 3) u8 or float ([0, 1] or [0, 255]) colours -> (F, H, W)
    packed i32."""
    c = jnp.asarray(colors)
    if c.dtype != jnp.uint8:
        c = jnp.clip(
            jnp.where(c.max() > 1.5, c, c * 255.0), 0, 255
        ).astype(jnp.uint8)
    c = c.astype(jnp.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)


def integrate_frames_bricked_device(
    grid: BrickGrid,
    depths,
    poses_cam_to_world,
    fx, fy, cx, cy,
    colors=None,  # (F, H, W, 3) uint8/float, only if grid has a color plane
    depth_scale=1000.0,
    depth_max=3.0,
    max_weight=64.0,
    max_active=8192,
    frames_per_dispatch=FRAMES_PER_CHUNK,
):
    """Integrate a frame batch into the brick grid in one jitted dispatch
    with no host synchronization (the production/bench path).

    ``colors`` enables the packed-RGB channel (requires a grid built with
    ``with_color=True``); colors are u8 per channel, averaged with the
    same weights as the TSDF (dense-engine / Open3D semantics).

    ``max_active`` is a static cap on bricks updated per chunk of
    ``frames_per_dispatch`` frames; overflow drops the highest-index
    bricks. Returns (grid, n_active) with ``n_active`` the UNCLAMPED active
    brick count per chunk, so any entry above ``max_active`` flags a drop.
    """
    depths = jnp.asarray(depths, dtype=jnp.float32)
    poses = jnp.asarray(poses_cam_to_world, dtype=jnp.float32)
    intr = jnp.asarray([fx, fy, cx, cy], dtype=jnp.float32)
    packed = None
    if colors is not None:
        if grid.rgb is None:
            raise ValueError(
                "colors given but grid has no color plane — build with "
                "make_brick_grid(..., with_color=True)"
            )
        packed = pack_colors(colors)
    sdf_b, w_b, rgb_b, n_active = _integrate_device_all(
        grid.sdf, grid.weight,
        grid.rgb if packed is not None else None,
        poses, intr, depths, packed, grid.origin,
        0, grid.brick_dims, max_active, grid.voxel_size, grid.trunc,
        depth_scale, depth_max, max_weight, frames_per_dispatch,
    )
    return (
        grid._replace(
            sdf=sdf_b, weight=w_b,
            rgb=rgb_b if rgb_b is not None else grid.rgb,
        ),
        n_active,
    )
