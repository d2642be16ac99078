"""Poisson surface reconstruction via spectral (FFT) solve.

NEW capability per the north star (BASELINE.json config 2: "Poisson surface
reconstruction from stitched cloud vs poisson/ reference output"). The
reference ships YCB ``poisson/nontextured.ply`` as data but has no Poisson
code.

Method (Kazhdan, "Reconstruction of Solid Models from Oriented Point Sets",
SGP 2005 — the Fourier formulation of Poisson reconstruction, which maps
onto dense FFTs on the accelerator):
  1. splat the oriented normal field V onto a regular grid (trilinear),
  2. smooth V with a Gaussian in Fourier space,
  3. solve the Poisson equation  div grad chi = div V  spectrally:
     chi_hat(k) = (i k . V_hat(k)) / (-|k|^2),
  4. pick the iso-level as the mean of chi over the input samples,
  5. extract the iso-surface with marching cubes.

Everything is dense FFTs + elementwise math — no octree, no sparse solver,
no host round trips. Periodic boundary artifacts are pushed outside the
domain by padding the bounding box.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from reconplan_tpu.ops.marching import marching_cubes
from reconplan_tpu.ops.tsdf import TSDFGrid


def _trilinear_splat(grid_shape, idx_f, values):
    """Scatter-add values (N, C) at fractional grid coords idx_f (N, 3)
    [x, y, z order] into a (D, H, W, C) grid."""
    D, H, W = grid_shape
    C = values.shape[-1]
    out = jnp.zeros((D, H, W, C), dtype=values.dtype)
    base = jnp.floor(idx_f).astype(jnp.int32)
    frac = idx_f - base
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = (
                    (frac[:, 0] if dx else 1 - frac[:, 0])
                    * (frac[:, 1] if dy else 1 - frac[:, 1])
                    * (frac[:, 2] if dz else 1 - frac[:, 2])
                )
                xi = jnp.clip(base[:, 0] + dx, 0, W - 1)
                yi = jnp.clip(base[:, 1] + dy, 0, H - 1)
                zi = jnp.clip(base[:, 2] + dz, 0, D - 1)
                out = out.at[zi, yi, xi].add(values * w[:, None])
    return out


def _trilinear_gather(vol, idx_f):
    """Sample (D, H, W) volume at fractional [x, y, z] coords (N, 3)."""
    D, H, W = vol.shape
    base = jnp.floor(idx_f).astype(jnp.int32)
    frac = idx_f - base
    acc = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = (
                    (frac[:, 0] if dx else 1 - frac[:, 0])
                    * (frac[:, 1] if dy else 1 - frac[:, 1])
                    * (frac[:, 2] if dz else 1 - frac[:, 2])
                )
                xi = jnp.clip(base[:, 0] + dx, 0, W - 1)
                yi = jnp.clip(base[:, 1] + dy, 0, H - 1)
                zi = jnp.clip(base[:, 2] + dz, 0, D - 1)
                acc = acc + vol[zi, yi, xi] * w
    return acc


@partial(jax.jit, static_argnames=("depth",))
def _poisson_indicator(points, normals, origin, voxel, depth: int,
                       smooth_sigma=0.85, screen=0.0):
    """Solve for the indicator-like field chi on a depth^3 grid.

    The normal field is DENSITY-NORMALIZED before the solve: the raw
    trilinear splat carries local sampling density as amplitude, so
    densely-sampled high-curvature regions overdrive the divergence and
    bias the iso-surface (~7 mm on synthetic bumps). Dividing by the
    smoothed scalar density recovers a unit-magnitude surface-delta
    approximation (Kazhdan's density weighting).

    ``screen`` > 0 adds a uniform Tikhonov/screening term: chi_hat =
    div_hat / (-(k2 + screen/extent^2)), damping the weakly-constrained
    low-frequency modes of the pure Poisson solve (screened-Poisson's
    interpolation term restricted to its spectral diagonal). The uniform
    term attenuates every mode by k2/(k2+alpha); at the default
    screen=4.0 the measured exact-residual cost of that attenuation on
    the bumpy-sphere fixture is < 0.1 mm while it removes the multi-mm
    low-frequency drift of the pure solve — round-4 measurements at the
    sigma=0.85 default (eval_poisson_fidelity.py, depth=128): screened
    0.174 mm mean / 0.15% coverage gap vs pure 0.256 mm / 1.92% vs
    local-iso 0.159 mm / 0.96%.

    Returns (chi (D, D, D), iso scalar).
    """
    D = depth
    idx_f = (points - origin) / voxel  # fractional [x, y, z] grid coords

    V = _trilinear_splat((D, D, D), idx_f, normals)  # (D, D, D, 3)
    rho = _trilinear_splat(
        (D, D, D), idx_f, jnp.ones((points.shape[0], 1), points.dtype)
    )[..., 0]

    k1 = jnp.fft.fftfreq(D) * (2.0 * jnp.pi / voxel)
    kz = k1[:, None, None]
    ky = k1[None, :, None]
    kx = k1[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz

    g = jnp.exp(-0.5 * (smooth_sigma * voxel) ** 2 * k2)

    # smooth the density with the same kernel, then normalize the
    # (smoothed) normal field where points exist
    rho_s = jnp.real(jnp.fft.ifftn(jnp.fft.fftn(rho) * g))
    mean_rho = jnp.sum(rho) / jnp.maximum(
        jnp.sum((rho_s > 1e-6).astype(jnp.float32)), 1.0
    )
    norm = jnp.maximum(rho_s, 0.05 * mean_rho)

    Vx = jnp.fft.fftn(jnp.real(jnp.fft.ifftn(jnp.fft.fftn(V[..., 0]) * g)) / norm)
    Vy = jnp.fft.fftn(jnp.real(jnp.fft.ifftn(jnp.fft.fftn(V[..., 1]) * g)) / norm)
    Vz = jnp.fft.fftn(jnp.real(jnp.fft.ifftn(jnp.fft.fftn(V[..., 2]) * g)) / norm)

    alpha = screen / (D * voxel) ** 2
    div_hat = 1j * (kx * Vx + ky * Vy + kz * Vz)
    denom = jnp.where(k2 == 0, 1.0, -(k2 + alpha))
    chi_hat = jnp.where(k2 == 0, 0.0, div_hat / denom)
    chi = jnp.real(jnp.fft.ifftn(chi_hat))

    iso = jnp.mean(_trilinear_gather(chi, idx_f))
    return chi, iso


@partial(jax.jit, static_argnames=("depth",))
def _sample_iso_field(chi, idx_f, depth: int, iso_sigma_frac=0.08):
    """Spatially-varying iso-level: the smooth field of per-sample chi.

    The pure (screen=0) Poisson solve leaves its low-frequency modes
    weakly constrained — chi's "surface value" drifts slowly across the
    domain (the pre-round-2 ~7 mm bias class). Screened Poisson's cure is
    a data-fidelity term pinning chi at the samples; its uniform-spectral
    approximation deforms the shape (see :func:`_poisson_indicator`).
    Here the pinning happens OUTSIDE the solve: gather chi at every
    sample, splat those values (density-weighted) onto the grid, smooth
    both with a wide Gaussian whose width is a fraction of the DOMAIN
    (depth-independent physics), and divide — a smoothly-extrapolated
    local iso-level b(x). The final field chi - b(x) is zero exactly
    where the surface should pass and the shape spectrum is untouched.

    Measured (round 4, sigma=0.85, exact analytic residual on the bumpy
    sphere at depth=128): local-iso 0.159 mm mean / 0.96% coverage gap
    vs screened 0.174 mm / 0.15%, banana Chamfer a tie, at ~5x the FFT
    cost — so screening stays the default (best two-sided coverage) and
    this remains an opt-in for screening-sensitive shapes.
    """
    D = depth
    chi_s = _trilinear_gather(chi, idx_f)  # (N,)
    num = _trilinear_splat((D, D, D), idx_f, chi_s[:, None])[..., 0]
    den = _trilinear_splat(
        (D, D, D), idx_f, jnp.ones((idx_f.shape[0], 1), chi.dtype)
    )[..., 0]
    k1 = jnp.fft.fftfreq(D) * 2.0 * jnp.pi  # per-voxel units
    k2 = (
        k1[:, None, None] ** 2 + k1[None, :, None] ** 2
        + k1[None, None, :] ** 2
    )
    g = jnp.exp(-0.5 * (iso_sigma_frac * D) ** 2 * k2)
    num_s = jnp.real(jnp.fft.ifftn(jnp.fft.fftn(num) * g))
    den_s = jnp.real(jnp.fft.ifftn(jnp.fft.fftn(den) * g))
    global_iso = jnp.sum(chi_s) / idx_f.shape[0]
    # far from any sample the ratio degrades to the global iso
    eps = 1e-3 * jnp.max(jnp.abs(den_s))
    return (num_s + eps * global_iso) / (den_s + eps)


def poisson_reconstruct(points, normals, depth=128, padding=0.2,
                        return_grid=False, screen=4.0, local_iso=False,
                        smooth_sigma=0.85):
    """Reconstruct a triangle mesh from an oriented point cloud.

    Args:
        points: (N, 3) float array (meters).
        normals: (N, 3) outward-oriented unit normals.
        depth: grid resolution per axis (power of two recommended for FFT).
        padding: bounding-box padding fraction (pushes the periodic wrap
            of the spectral solve away from the surface).
        return_grid: also return the (TSDFGrid-shaped) chi field.
        screen: uniform spectral screening strength (0 = classic Poisson);
            damps the weakly-constrained low-frequency modes (units of
            inverse squared box extents).
        local_iso: subtract the spatially-varying sample-iso field
            (:func:`_sample_iso_field`) instead of one global iso level —
            an alternative low-frequency fix that leaves the shape
            spectrum untouched (slower; see the measured comparison in
            that function's docstring).
        smooth_sigma: Gaussian pre-smoothing width of the splatted
            normal field, in VOXELS. Round 4's two-sided fidelity sweep
            (benchmarks/eval_poisson_fidelity.py + the coverage metric)
            showed the old 1.5-voxel default was the dominant error
            source — it washed out deep concave valleys (bumpy-sphere
            exact residual 0.402 mm mean with a 4.9% >2 mm coverage-gap
            tail at depth=128; sigma=0.85 measures 0.18 mm / 0.33% and
            the banana Chamfer improves 0.453 -> ~0.43 mm with a 0.00%
            gap). Below ~0.7 the residual rises again as splat noise
            leaks through.

    Returns triangles (T, 3, 3) world-space (and the grid if requested).
    """
    points = np.asarray(points, dtype=np.float32)
    normals = np.asarray(normals, dtype=np.float32)
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    extent = float((hi - lo).max())
    pad = extent * padding
    origin = lo - pad
    voxel = (extent + 2 * pad) / (depth - 1)

    chi, iso = _poisson_indicator(
        jnp.asarray(points),
        jnp.asarray(normals),
        jnp.asarray(origin, dtype=jnp.float32),
        jnp.float32(voxel),
        depth,
        smooth_sigma=smooth_sigma,
        screen=screen,
    )
    # With the indicator convention chi=1 inside and OUTWARD normals n, the
    # smoothed indicator satisfies grad chi = -n*delta, so solving
    # lap chi = div V (V = n*delta) yields chi LOWER inside.  marching
    # expects sdf < 0 inside, so (chi - iso) is already correctly signed.
    if local_iso:
        idx_f = (jnp.asarray(points) - jnp.asarray(origin)) / jnp.float32(voxel)
        iso = _sample_iso_field(chi, idx_f, depth)
    field = (chi - iso).astype(jnp.float32)
    grid = TSDFGrid(
        sdf=field,
        weight=jnp.ones_like(field),
        color=jnp.zeros((0, 0, 0, 3), dtype=jnp.float32),
        origin=jnp.asarray(origin, dtype=jnp.float32),
        voxel_size=jnp.float32(voxel),
        trunc=jnp.float32(voxel),
    )
    tris = marching_cubes(grid)
    if return_grid:
        return tris, grid
    return tris
